"""The port's landing simulation == pikazoo_tpu's, exactly, and the contract
of its kernel wrapper on the CPU.

The JAX side runs as the JAX package's own tests run it here: the Pallas
kernel in interpret mode and ``vmap`` of the lax loop.  The CUDA kernel
itself runs only on a card; ``chip_smoke.py`` holds it against the plain
version there."""

import os
import stat

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.core.predict import _landing_sims_impl
from pikazoo_tpu.core.predict_pallas import landing_sims_batched as jax_kernel
from pikazoo_tpu.core.state import init_ball_construction
from pikazoo_tpu_torch import _build
from pikazoo_tpu_torch.core import predict_cuda
from pikazoo_tpu_torch.core.predict import landing_sims_any

NET_TRAP_CASES = np.array([
    [216, 180, 0, 1],    # pure net trap (fast exit)
    [216, 192, 0, 0],    # boundary of the strict < 192 band
    [200, 177, 3, 10],   # in-column moving
    [230, 190, -1, -5],
    [56, 0, 0, 1],       # fresh serve
    [432, 100, 20, -60],  # wall-hugging lob
], np.int32)


def random_ball_states(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(20, 433, n), rng.integers(0, 253, n),
                     rng.integers(-20, 21, n), rng.integers(-60, 61, n)]
                    ).astype(np.int32)


def jax_landing(cols):
    """(expected (n,), candidates (n, 6)) from both JAX paths, which agree."""
    x, y, vx, vy = map(jnp.asarray, cols)
    exp_k, cand_k = jax_kernel(x, y, vx, vy, interpret=True)
    balls = jax.tree.map(lambda leaf: jnp.broadcast_to(leaf, x.shape),
                         init_ball_construction())._replace(
        x=x, y=y, x_velocity=vx, y_velocity=vy)
    exp_l, cand_l = jax.jit(jax.vmap(_landing_sims_impl))(balls)
    np.testing.assert_array_equal(np.asarray(exp_k), np.asarray(exp_l))
    np.testing.assert_array_equal(np.asarray(cand_k), np.asarray(cand_l))
    return np.asarray(exp_k), np.asarray(cand_k)


@pytest.mark.parametrize("name", ["random", "net_trap"])
def test_plain_landing_matches_jax(name):
    # n = 300 is deliberately not a multiple of the Pallas kernel's block.
    cols = random_ball_states(300, 0) if name == "random" else NET_TRAP_CASES.T
    want_exp, want_cand = jax_landing(cols)
    x, y, vx, vy = (torch.from_numpy(c.copy()) for c in cols)
    exp, cand = predict_cuda.landing_sims_batched(x, y, vx, vy)
    assert predict_cuda.landing_sims_batched.launches == 0  # the plain path
    assert exp.shape == want_exp.shape and cand.shape == want_cand.shape
    np.testing.assert_array_equal(exp.numpy(), want_exp)
    np.testing.assert_array_equal(cand.numpy(), want_cand)
    # The shape-generic form: candidates on axis 0, any batch shape.
    exp2, cand2 = landing_sims_any(*(c.reshape(-1, 2) for c in (x, y, vx, vy)))
    assert exp2.shape == (len(x) // 2, 2) and cand2.shape == (6, len(x) // 2, 2)
    np.testing.assert_array_equal(exp2.reshape(-1).numpy(), want_exp)
    np.testing.assert_array_equal(cand2.reshape(6, -1).numpy(), want_cand.T)


def test_plain_landing_scalar_state():
    """One env's ball as 0-d tensors, as the JAX package's scalar path."""
    x, y, vx, vy = (int(v) for v in random_ball_states(1, 5)[:, 0])
    want_exp, want_cand = _landing_sims_impl(init_ball_construction()._replace(
        x=jnp.int32(x), y=jnp.int32(y), x_velocity=jnp.int32(vx),
        y_velocity=jnp.int32(vy)))
    exp, cand = landing_sims_any(*(torch.tensor(v, dtype=torch.int32)
                                   for v in (x, y, vx, vy)))
    assert exp.shape == () and cand.shape == (6,)
    assert int(exp) == int(want_exp)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(want_cand))


def _balls(n=8):
    return tuple(torch.from_numpy(c.copy()) for c in random_ball_states(n, 1))


def test_wrapper_rejects_bad_inputs():
    x, y, vx, vy = _balls()
    with pytest.raises(TypeError):
        predict_cuda.landing_sims_batched(x.long(), y, vx, vy)
    strided = torch.zeros(16, dtype=torch.int32)[::2]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        predict_cuda.landing_sims_batched(strided, y, vx, vy)
    with pytest.raises(ValueError):
        predict_cuda.landing_sims_batched(x[:4], y, vx, vy)
    with pytest.raises(ValueError):
        predict_cuda.landing_sims_batched(x.reshape(2, 4), y.reshape(2, 4),
                                          vx.reshape(2, 4), vy.reshape(2, 4))
    meta = tuple(t.to("meta") for t in (x, y, vx, vy))
    with pytest.raises(ValueError, match="no version"):
        predict_cuda.landing_sims_batched(*meta)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build("landing", predict_cuda.SOURCES)
    assert not (tmp_path / "kernels").exists() or \
        not list((tmp_path / "kernels").iterdir())


def test_build_reports_nvcc_errors(monkeypatch, tmp_path):
    """A refused build raises with nvcc's output and leaves no library."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "nvcc"
    fake.write_text("#!/bin/sh\necho 'landing.cu(1): error: refused' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="error: refused"):
        _build.build("landing", predict_cuda.SOURCES)
    assert os.listdir(tmp_path / "kernels") == []


def test_library_path_follows_source():
    path = _build.library_path("landing", predict_cuda.SOURCES)
    assert path.parent == _build.BUILD_DIR and path.name.startswith("liblanding_")
    assert path == _build.library_path("landing", predict_cuda.SOURCES)
