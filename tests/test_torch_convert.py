"""Env state carried across between the JAX package and the port: the round
trip is exact, and a carried-across state steps exactly as in JAX."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pikazoo_tpu.envs import EnvConfig as JaxConfig
from pikazoo_tpu.envs import PikaZoo as JaxZoo
from pikazoo_tpu_torch import EnvConfig, PikaZoo
from pikazoo_tpu_torch.convert import env_state_from_numpy, env_state_to_numpy
from torch_helpers import assert_same

REPO = Path(__file__).resolve().parents[1]
B = 32


def test_round_trip_is_exact():
    """A JAX state taken mid-game (every field away from its reset value,
    keys with words >= 2^31) survives numpy -> torch -> numpy."""
    env = JaxZoo(JaxConfig(serve="random"))
    state, _ = env.reset_batch(jax.random.key(5), B)
    step = jax.jit(env.step_batch)
    rng = np.random.default_rng(0)
    for _ in range(40):
        state, _ = step(state, jnp.asarray(rng.integers(0, 18, (B, 2)), jnp.int32))
    want = jax.device_get(state)
    assert (np.asarray(want.rng_key) >= 2 ** 31).any()
    carried = env_state_from_numpy(want)
    assert {t.dtype for t in carried.p1 + carried.p2 + carried.ball + carried[3:]} \
        == {torch.int32}
    assert_same(want, env_state_to_numpy(carried))


def test_rejects_other_leaf_types():
    env = JaxZoo(JaxConfig())
    state = jax.device_get(env.reset_batch(jax.random.key(0), 2)[0])
    with pytest.raises(TypeError):
        env_state_from_numpy(state._replace(step_count=np.zeros(2, np.float32)))


@pytest.mark.parametrize("computer", [False, True])
def test_carried_state_steps_like_jax(computer):
    kw = dict(winning_score=2, serve="alternate", is_player1_computer=computer,
              is_player2_computer=computer)
    jax_env, env = JaxZoo(JaxConfig(**kw)), PikaZoo(EnvConfig(**kw))
    jax_state, _ = jax_env.reset_batch(jax.random.key(9), B)
    state = env_state_from_numpy(jax.device_get(jax_state))
    step = jax.jit(jax_env.step_batch)
    rng = np.random.default_rng(1)
    for _ in range(60):
        actions = rng.integers(0, 18, (B, 2)).astype(np.int32)
        jax_state, jax_ts = step(jax_state, jnp.asarray(actions))
        state, ts = env.step_batch(state, torch.from_numpy(actions))
        assert_same(jax.device_get((jax_state, jax_ts)),
                    (env_state_to_numpy(state), ts))


def test_port_imports_no_jax():
    """The machine with the card has no JAX, gymnasium, pettingzoo or pygame:
    neither the package (the PettingZoo drop-in included) nor chip_smoke.py
    may import JAX, and none of them imports the other three at import
    time."""
    code = ("import sys; import pikazoo_tpu_torch, pikazoo_tpu_torch.convert, "
            "pikazoo_tpu_torch.core.predict_cuda, pikazoo_tpu_torch.train, "
            "pikazoo_tpu_torch.train.ppo, pikazoo_tpu_torch.train.fused_update, "
            "pikazoo_tpu_torch.train.run, pikazoo_tpu_torch.tools.k1_precision_probe, "
            "pikazoo_tpu_torch.pikazoo_v0, pikazoo_tpu_torch.compat, "
            "pikazoo_tpu_torch.compat.wrappers, pikazoo_tpu_torch.render, "
            "pikazoo_tpu_torch.native, pikazoo_tpu_torch.parity, pikazoo_tpu_torch.version, "
            "pikazoo_tpu_torch.parallel, pikazoo_tpu_torch.tools.multihost_smoke, "
            "chip_smoke; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'pikazoo_tpu', 'gymnasium', "
            "'pettingzoo', 'pygame')); "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_imports_no_chip_smoke():
    """chip_smoke.py is a script at the checkout's root that imports the
    package's tools; no module of the package imports it back."""
    offenders = []
    for path in sorted((REPO / "pikazoo_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [alias.name for alias in node.names]
            else:
                continue
            if any(name.split(".")[0] == "chip_smoke" for name in names):
                offenders.append(f"{path.relative_to(REPO)}:{node.lineno}")
    assert not offenders, offenders
