"""The port's meshed trainer (``parallel/`` on ``torch.distributed``) on the
CPU, two ranks over gloo, each a subprocess of the port's
``tools/multihost_smoke.py``.

* Against the JAX package's 2-device mesh (``make_env_mesh(jax.devices()[:2])``,
  ``fused_update="off"``, the sizes of ``tests/test_sharding.py:55-70``): the
  two ranks take JAX's params, env state and uniforms from an ``.npz``.  The
  rollout (env state, observations, actions, rewards, dones) is bit-equal
  in JAX's per-shard seat-blocked layout; log-probs and values agree to
  1e-6 (the port's network rounds its f32 outputs differently from XLA's at
  the last bit, as it does unmeshed); losses within rtol 1e-4, atol 1e-5 and params
  within ``2 * lr * steps + 1e-5``, the bounds ``tests/test_torch_ppo.py``
  puts on the unmeshed port.
* Port against port: two ranks of K1's plain version with the global row
  count against one rank, within JAX's own mesh-vs-single bound (rtol 2e-3,
  atol 2e-5, ``tests/test_fused_update.py:309-311``), with and without
  ``learner_seats="p1"``; losses and params bit-identical across ranks; the
  rollout makes no collective.
* The one-rank mesh is ``mesh=None`` bit for bit; a checkpoint saved by two
  ranks restores on one and one saved by one rank resumes on two; the CLI's
  ``--distributed`` runs a world of one.

Every subprocess has its own timeout; on expiry both ranks are killed."""

import json
import os
import socket
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
from pikazoo_tpu.parallel import env_sharding as jax_env_sharding
from pikazoo_tpu.parallel import make_env_mesh as jax_make_env_mesh
from pikazoo_tpu.parallel import shard_batch as jax_shard_batch
from pikazoo_tpu.train import PPOConfig as JaxPPOConfig
from pikazoo_tpu.train import make_ppo_trainer as jax_make_trainer
from pikazoo_tpu_torch import EnvConfig, PikaZoo
from pikazoo_tpu_torch.convert import env_state_from_numpy, params_from_flax
from pikazoo_tpu_torch.parallel import (EnvMesh, all_reduce_sum, gather_batch,
                                        make_env_mesh, replicated, shard_batch)
from pikazoo_tpu_torch.train import PPOConfig, checkpoint, make_ppo_trainer
from torch_helpers import named_leaves

ROOT = Path(__file__).resolve().parents[1]
SIZES = dict(num_envs=32, rollout_length=16, num_minibatches=2, update_epochs=2,
             hidden=(32, 32))
B, T = SIZES["num_envs"], SIZES["rollout_length"]
STEPS = SIZES["update_epochs"] * SIZES["num_minibatches"]  # optimizer steps an update
LR = 3e-4
TIMEOUT = 180


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world: int, mode: str, out: Path, inp: str = "-", *extra: str):
    """Run ``world`` ranks of the smoke tool on the CPU; returns each rank's
    output arrays."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pikazoo_tpu_torch.tools.multihost_smoke", str(r), str(world),
         str(port), "cpu", mode, inp, str(out), *extra],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"process {r}: loss=" in log and "OK" in log, log
    stem = str(out)[:-len(".npz")]
    return [dict(np.load(f"{stem}.rank{r}.npz")) for r in range(world)]


def joined(ranks, prefix: str):
    """Each rank's shard of a trajectory leaf joined along its last axis
    (JAX's per-shard seat-blocked global layout)."""
    return np.concatenate([r[prefix] for r in ranks], axis=-1)


def params_of(arrays, prefix="params."):
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def env_leaves(state):
    """(dotted name, int32 numpy leaf) of an env state, as the tool names them."""
    return {f"env.{name}": np.asarray(leaf).view(np.int32)
            for name, leaf in named_leaves(state)}


def assert_ranks_identical(ranks):
    for k in ranks[0]:
        if k.startswith(("params.", "metrics", "env.", "last_obs", "grad.")):
            for other in ranks[1:]:
                np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=k)


# ---------------------------------------------------------------- vs JAX --
@pytest.fixture(scope="module")
def jax_vs_port(tmp_path_factory):
    """JAX's meshed trainer on 2 of the 8 virtual devices, one update, and
    the port's two ranks from the same params, state and uniforms; the
    ranks also checkpoint their final runner."""
    tmp = tmp_path_factory.mktemp("vs_jax")
    env = JaxZoo(JaxConfig(winning_score=2))
    cfg = JaxPPOConfig(**SIZES, fused_update="off")
    mesh = jax_make_env_mesh(jax.devices()[:2])
    init_fn, train_step, _ = jax_make_trainer(env, cfg, mesh=mesh)
    runner = init_fn(jax.random.key(5))
    runner = runner._replace(env_state=jax_shard_batch(runner.env_state, mesh),
                             last_obs=jax.device_put(runner.last_obs, jax_env_sharding(mesh)))
    (_, _, _), traj = jax.jit(train_step.rollout_fn)(runner.params, runner.env_state,
                                                     runner.last_obs, runner.key)
    after, metrics = jax.jit(train_step)(runner)
    key, uniforms = runner.key, []
    for _ in range(T):
        key, akey = jax.random.split(key)
        uniforms.append(np.asarray(jax.random.uniform(akey, (1, 2 * B), jnp.float32)))
    port_params = params_from_flax(jax.device_get(runner.params))
    inp = dict({f"params.{k}": v.numpy() for k, v in port_params.items()},
               **env_leaves(env_state_from_numpy(jax.device_get(runner.env_state))),
               last_obs=np.asarray(runner.last_obs), uniforms=np.stack(uniforms))
    np.savez(tmp / "in.npz", **inp)
    ckpt = tmp / "two_ranks.pt"
    ranks = run_ranks(2, "off", tmp / "out.npz", str(tmp / "in.npz"), "--save", str(ckpt))
    return dict(traj=jax.device_get(traj), after=jax.device_get(after),
                metrics=jax.device_get(metrics), ranks=ranks, ckpt=ckpt)


def test_rollout_matches_jax_two_device_mesh(jax_vs_port):
    """The two ranks' rollout == JAX's per shard: observations, actions,
    rewards and dones bit for bit, log-probs and values to 1e-6 (the
    network's f32 outputs, rounded differently at the last bit), and the env
    state after it leaf for leaf."""
    traj, ranks = jax_vs_port["traj"], jax_vs_port["ranks"]
    for field in ("action", "reward", "done"):
        np.testing.assert_array_equal(joined(ranks, f"traj.{field}"),
                                      np.asarray(getattr(traj, field)), err_msg=field)
    np.testing.assert_array_equal(joined(ranks, "traj.obs"),
                                  np.asarray(traj.obs).view(np.int16))
    for field in ("log_prob", "value"):
        np.testing.assert_allclose(joined(ranks, f"traj.{field}"),
                                   np.asarray(getattr(traj, field)), rtol=0, atol=1e-6,
                                   err_msg=field)
    want = env_leaves(env_state_from_numpy(jax_vs_port["after"].env_state))
    for name, leaf in want.items():
        np.testing.assert_array_equal(ranks[0][name], leaf, err_msg=name)
    np.testing.assert_array_equal(ranks[0]["last_obs"], np.asarray(jax_vs_port["after"].last_obs))


def test_update_matches_jax_two_device_mesh(jax_vs_port):
    """Losses within rtol 1e-4, atol 1e-5 of JAX's; episodes exactly; params
    after the update within 2 * lr * steps + 1e-5."""
    ranks, m = jax_vs_port["ranks"], jax_vs_port["metrics"]
    want = np.asarray([m.total_loss, m.policy_loss, m.value_loss, m.entropy, m.approx_kl])
    np.testing.assert_allclose(ranks[0]["metrics"][0, :5], want, rtol=1e-4, atol=1e-5)
    assert ranks[0]["metrics"][0, 6] == float(m.episodes_finished)
    want_params = params_from_flax(jax_vs_port["after"].params)
    got = params_of(ranks[0])
    assert set(got) == set(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=0, atol=2 * LR * STEPS + 1e-5,
                                   err_msg=k)


def test_ranks_agree_and_rollout_makes_no_collective(jax_vs_port):
    """Losses, params and the gathered runner bit-identical across ranks;
    the rollout makes no collective; the update one grad ``all_reduce`` a
    minibatch plus the advantage statistics' two, and one for the metrics."""
    ranks = jax_vs_port["ranks"]
    assert_ranks_identical(ranks)
    for r in ranks:
        assert int(r["rollout_collectives"]) == 0
        assert int(r["all_reduce_calls"]) == STEPS * 3 + 1
        assert int(r["update_collectives"]) == int(r["all_reduce_calls"])


def test_two_rank_checkpoint_restores_on_one(jax_vs_port):
    """The two ranks' checkpoint, restored without a mesh, holds the
    gathered runner: env state, last observations, params."""
    init_fn, _, _ = make_ppo_trainer(PikaZoo(EnvConfig(winning_score=2)),
                                     PPOConfig(**SIZES, fused_update="off"), device="cpu")
    restored = checkpoint.restore(jax_vs_port["ckpt"], init_fn(0))
    ranks = jax_vs_port["ranks"]
    assert restored.update_index == 1
    for name, leaf in env_leaves(restored.env_state).items():
        np.testing.assert_array_equal(leaf, ranks[0][name], err_msg=name)
    np.testing.assert_array_equal(restored.last_obs.numpy(), ranks[0]["last_obs"])
    for k, v in params_of(ranks[0]).items():
        np.testing.assert_array_equal(restored.params[k].numpy(), v, err_msg=k)


# ---------------------------------------------------------- port vs port --
def one_rank_run(mode: str, seats: str = "both", resume_from=None, updates: int = 1):
    """The unmeshed trainer in this process, seeded as the tool seeds it:
    (start runner, final runner, metrics of the last update)."""
    cfg = PPOConfig(**SIZES, fused_update=mode, learner_seats=seats)
    init_fn, train_step, _ = make_ppo_trainer(PikaZoo(EnvConfig(winning_score=2)), cfg,
                                              device="cpu")
    start = init_fn(0)
    if resume_from is not None:
        start = checkpoint.restore(resume_from, start)
    runner, metrics = start, None
    for _ in range(updates):
        runner, metrics = train_step(runner)
    return start, runner, metrics


def assert_port_runs_agree(ranks, start, final, metrics):
    """Two ranks against one: the starting runner and the final env state
    bit-equal (sampling and the rollout are bit-identical), losses and
    params within JAX's mesh-vs-single bound."""
    assert_ranks_identical(ranks)
    got = ranks[0]
    for name, leaf in env_leaves(start.env_state).items():
        np.testing.assert_array_equal(got[f"start.{name}"], leaf, err_msg=name)
    for name, leaf in env_leaves(final.env_state).items():
        np.testing.assert_array_equal(got[name], leaf, err_msg=name)
    np.testing.assert_array_equal(got["last_obs"], final.last_obs.numpy())
    np.testing.assert_allclose(got["metrics"][-1, :5],
                               torch.stack(list(metrics[:5])).numpy(), rtol=2e-3, atol=2e-5)
    for k, v in final.params.items():
        np.testing.assert_allclose(got[f"params.{k}"], v.numpy(), rtol=2e-3, atol=2e-5,
                                   err_msg=k)
    assert all(int(r["rollout_collectives"]) == 0 for r in ranks)


def test_two_ranks_fm_resume_match_one_rank(tmp_path):
    """K1 (plain on the CPU) with the global row count: a one-rank
    checkpoint taken after one update, resumed on two ranks for one more,
    against one rank resumed alike.  The two ranks start from the
    checkpoint's runner, params and all."""
    _, mid, _ = one_rank_run("fm")
    ckpt = tmp_path / "one_rank.pt"
    checkpoint.save(str(ckpt), mid)
    restored, final, metrics = one_rank_run("fm", resume_from=str(ckpt))
    ranks = run_ranks(2, "fm", tmp_path / "out.npz", "-", "--resume", str(ckpt))
    assert_port_runs_agree(ranks, restored, final, metrics)
    for k, v in mid.params.items():
        np.testing.assert_array_equal(ranks[0][f"start.params.{k}"], v.numpy(), err_msg=k)


def test_two_ranks_learner_seat_p1_match_one_rank(tmp_path):
    """``learner_seats="p1"`` slices the first half of each rank's columns."""
    start, final, metrics = one_rank_run("fm", seats="p1")
    ranks = run_ranks(2, "fm,p1", tmp_path / "out.npz")
    assert_port_runs_agree(ranks, start, final, metrics)


# --------------------------------------------------------------- one rank --
def test_one_rank_mesh_is_mesh_none():
    """``make_env_mesh`` without a process group is the one-rank mesh, and
    the trainer on it equals ``mesh=None`` bit for bit over two updates."""
    mesh = make_env_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.distributed) == (0, 1, False)
    cfg = PPOConfig(**SIZES, fused_update="fm")
    runs = []
    for m in (None, mesh):
        init_fn, train_step, _ = make_ppo_trainer(PikaZoo(EnvConfig(winning_score=2)), cfg,
                                                  device="cpu", mesh=m)
        runner = init_fn(3)
        for _ in range(2):
            runner, metrics = train_step(runner)
        runs.append((runner, metrics))
    (a, ma), (b, mb) = runs
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for x, y in zip(named_leaves(tuple(a.env_state)), named_leaves(tuple(b.env_state))):
        np.testing.assert_array_equal(x[1], y[1])
    for x, y in zip(ma[:7], mb[:7]):
        assert torch.equal(x, y)


def test_one_rank_helpers_are_the_identity():
    mesh = EnvMesh(0, 1, torch.device("cpu"))
    tree = (torch.arange(6), {"a": torch.ones(2, 3)})
    for fn in (shard_batch, gather_batch, replicated):
        assert fn(tree, mesh) is tree
    flat = torch.arange(4.0)
    assert all_reduce_sum(flat, mesh) is flat


def test_cli_distributed_world_of_one(tmp_path):
    """``--distributed`` from the torchrun environment with a world of one:
    the header says world_size 1, the run checkpoints and finishes."""
    metrics = tmp_path / "m.jsonl"
    env = dict(os.environ, RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "pikazoo_tpu_torch.train.run", "--distributed", "--device",
         "cpu", "--num-envs", "8", "--rollout-length", "8", "--updates", "2", "--metrics",
         str(metrics), "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert lines[0]["provenance"]["world_size"] == 1
    assert [row["step"] for row in lines[1:]] == [0, 1]
    assert "done: 2 updates" in proc.stdout
    assert (tmp_path / "ck" / "latest").is_file()
