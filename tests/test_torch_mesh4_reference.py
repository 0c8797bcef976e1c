"""Four ranks of the meshed trainer (``make_ppo_trainer(..., mesh=)``) against
the benchmark's plain reference at the global batch, on the CPU.

Each rank is a process of ``pikazoo_tpu_torch.tools.multihost_smoke`` over
gloo: 64 envs in all (16 a rank), T=8, 4 epochs x 4 minibatches, hidden
(16, 16), K1's plain version (``fused_update="fm"``), weights drawn from a
seed as the benchmark draws them (``benchmark/traffic/ppo_updates.py::
make_weights``) and one update's global uniforms drawn from a seed.  The
reference (``benchmark/reference/learner.py::follow``) follows that update
from its own reset, with the ranks' actions laid out in the global batch's
order (each rank's seat-1 columns, then each rank's seat-2 columns) and the
same uniforms.  The ranks run with the program's spans on, which change
nothing they compute.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import learner as ref_learner
from benchmark.reference.pika import env as ref_env
from benchmark.traffic.ppo_updates import make_weights
from benchmark.traffic_common import packed_state
from pikazoo_tpu_torch import EnvConfig, PikaZoo
from pikazoo_tpu_torch.tools.multihost_smoke import env_state_from

ROOT = Path(__file__).resolve().parents[1]
WORLD, B, T, HIDDEN = 4, 64, 8, (16, 16)
EPOCHS, MINIBATCHES = 4, 4
STEPS = EPOCHS * MINIBATCHES
SEED = 3  # the env's reset
TIMEOUT = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _packed(arrays: dict, prefix: str) -> torch.Tensor:
    """The env leaves ``{prefix}env.*`` of a rank's output as packed rows."""
    like, _ = PikaZoo(EnvConfig(winning_score=2)).reset_batch(SEED, B, device="cpu")
    leaves = {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix + "env.")}
    return packed_state(env_state_from(leaves, like, torch.device("cpu")))


@pytest.fixture(scope="module")
def mesh4(tmp_path_factory):
    """The four ranks' outputs, the seed's weights and the followed
    reference."""
    tmp = tmp_path_factory.mktemp("mesh4")
    params = make_weights(5, HIDDEN, 18, torch.device("cpu"))
    uniforms = torch.rand((T, 1, 2 * B), generator=torch.Generator().manual_seed(7))
    np.savez(tmp / "in.npz", uniforms=uniforms.numpy(),
             **{f"params.{k}": v.numpy() for k, v in params.items()})
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pikazoo_tpu_torch.tools.multihost_smoke", str(r), str(WORLD),
         str(port), "cpu", "fm", str(tmp / "in.npz"), str(tmp / "out.npz"),
         "--num-envs", str(B), "--rollout-length", str(T), "--minibatches", str(MINIBATCHES),
         "--epochs", str(EPOCHS), "--hidden", *map(str, HIDDEN), "--seed", str(SEED),
         "--spans"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
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
        assert p.returncode == 0 and f"process {r}: loss=" in log, log
    ranks = [dict(np.load(tmp / f"out.rank{r}.npz")) for r in range(WORLD)]
    b = B // WORLD
    actions = [r["traj.action"] for r in ranks]
    global_actions = np.concatenate([a[:, :b] for a in actions] + [a[:, b:] for a in actions],
                                    axis=1)
    cfg = ref_env.EnvConfig(winning_score=2)
    start = ref_env.reset_packed(cfg, SEED, 0, B, torch.device("cpu"))
    recipe = ref_learner.Recipe(num_envs=B, rollout_length=T, num_minibatches=MINIBATCHES,
                                update_epochs=EPOCHS, hidden=HIDDEN)
    followed = ref_learner.follow(lambda packed, a1, a2: ref_env.learner_step(cfg, packed, a1, a2),
                                  start, dict(params), recipe, [uniforms],
                                  [torch.from_numpy(global_actions)])
    return dict(ranks=ranks, params0=params, start=start, followed=followed)


def test_env_leaves_bit_equal_to_the_reference(mesh4):
    """The ranks' reset and their env state after the update, gathered in
    rank order, equal the reference's packed rows bit for bit."""
    ranks, followed = mesh4["ranks"], mesh4["followed"]
    rows = packed_state(PikaZoo(EnvConfig()).reset_batch(0, 1, device="cpu")[0]).shape[0]
    assert torch.equal(_packed(ranks[0], "start."), mesh4["start"][:rows])
    assert torch.equal(_packed(ranks[0], ""), followed.packed[:rows])
    assert followed.sample_gaps[0] < 1e-4  # each action is the reference policy's own draw


def test_losses_and_params_within_tolerance(mesh4):
    """The update's five mean loss terms within one bf16 rounding step
    (rtol 2**-8, atol 1e-6 for terms near zero): both sides take the same
    bf16 products and differ only in the order of their float32 sums (the
    program's over ranks among them), which moves a rounded activation by a
    step at most.  Each leaf's change over the update within 5% of the
    reference's change, relative L2: Adam scales each step to about the
    learning rate, so an element whose gradient sits near 0 can move either
    way on a rounding difference (1.5% of a leaf at most, measured at this
    size)."""
    ranks, followed, params0 = mesh4["ranks"], mesh4["followed"], mesh4["params0"]
    np.testing.assert_allclose(ranks[0]["metrics"][0, :5], followed.losses[0].numpy(),
                               rtol=2 ** -8, atol=1e-6)
    for k, want in followed.params.items():
        got = torch.from_numpy(ranks[0][f"params.{k}"])
        change = want - params0[k]
        gap = torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(change)
        assert gap < 0.05, (k, float(gap))


def test_ranks_bit_identical(mesh4):
    """Parameters, metrics and the gathered runner equal rank 0's on every
    rank, bit for bit."""
    ranks = mesh4["ranks"]
    for k, v in ranks[0].items():
        if k.startswith(("params.", "metrics", "env.", "last_obs", "start.")):
            for other in ranks[1:]:
                np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_all_reduce_calls_and_bytes(mesh4):
    """An update makes 3 ``all_reduce`` a minibatch (the advantages' mean and
    variance, one float32 each; the gradients and the five loss terms) and
    one of the two episode metrics: 49 at 4 x 4 minibatches."""
    weights = sum(v.numel() for v in mesh4["params0"].values())
    for r in mesh4["ranks"]:
        assert int(r["all_reduce_calls"]) == 3 * STEPS + 1 == 49
        assert int(r["all_reduce_bytes"]) == STEPS * 4 * (1 + 1 + weights + 5) + 4 * 2


def test_spans_name_each_reduction(mesh4):
    """With the spans on, each ``pikazoo.mesh.all_reduce`` lies inside the
    span of its reduction: 32 in ``ppo.adv_stats``, 16 in ``ppo.grad_sum``,
    the metrics' one directly in ``ppo.train_step``."""
    r = mesh4["ranks"][0]
    under = {k[len("all_reduce_under."):]: int(v) for k, v in r.items()
             if k.startswith("all_reduce_under.")}
    assert under == {"ppo.adv_stats": 2 * STEPS, "ppo.grad_sum": STEPS, "ppo.train_step": 1}


def test_init_distributed_binds_the_card_for_nccl(monkeypatch):
    """Under nccl the rank's card becomes the current card and the group's
    ``device_id``; under gloo the group is joined as before."""
    from pikazoo_tpu_torch.parallel import mesh

    calls, current = [], []
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(mesh.dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    rendezvous = dict(init_method="tcp://127.0.0.1:1", rank=2, world_size=4)
    mesh.init_distributed(backend="nccl", device="cuda:2", **rendezvous)
    mesh.init_distributed(backend="gloo", device="cpu", **rendezvous)
    assert calls == [dict(backend="nccl", device_id=torch.device("cuda", 2), **rendezvous),
                     dict(backend="gloo", **rendezvous)]
    assert current == [torch.device("cuda", 2)]


def test_zero_counts_resets_the_bytes():
    from pikazoo_tpu_torch.parallel import mesh

    mesh.all_reduce_sum.calls, mesh.all_reduce_sum.bytes = 3, 12
    mesh.zero_counts()
    assert (mesh.all_reduce_sum.calls, mesh.all_reduce_sum.bytes) == (0, 0)
