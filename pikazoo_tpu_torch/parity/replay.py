"""Replay a recorded :class:`~pikazoo_tpu_torch.parity.harness.ReferenceTrace`
through the port's env in oracle mode and hold it frame by frame."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pikazoo_tpu_torch.envs import EnvConfig, PikaZoo
from pikazoo_tpu_torch.parity.harness import ReferenceTrace

ORACLE_CAPACITY = 1 << 15


def pad_oracle(draws: np.ndarray, capacity: int = ORACLE_CAPACITY,
               device="cuda") -> torch.Tensor:
    """The trace's draws zero-padded to ``(capacity,)`` int32 on ``device``."""
    if draws.shape[0] > capacity:
        raise ValueError(f"{draws.shape[0]} draws do not fit an oracle of {capacity}")
    buf = np.zeros((capacity,), np.int32)
    buf[: draws.shape[0]] = draws
    return torch.from_numpy(buf).to(device)


def replay_and_compare(trace: ReferenceTrace, config: EnvConfig,
                       check_draw_counts: bool = True,
                       env: Optional[PikaZoo] = None, device="cuda") -> None:
    """Replay ``trace`` through :class:`PikaZoo` in oracle mode on ``device``
    (the card unless the caller asks for the CPU) and assert frame-by-frame
    equality of observations, rewards, terminations, scores and (with
    ``check_draw_counts``) the draw counter.  Each frame comes to the host
    in one copy.  ``env`` may be any ``PikaZoo``-shaped object (a wrapper
    stack) built on ``config``."""
    if config.auto_reset:
        raise ValueError("a parity replay needs PettingZoo semantics (auto_reset=False)")
    env = env or PikaZoo(config)
    oracle = pad_oracle(trace.draws, device=device)
    state, ts = env.reset(0, device, oracle=oracle)
    np.testing.assert_array_equal(ts.obs.cpu().numpy(), trace.obs[0],
                                  err_msg="reset obs mismatch")
    if check_draw_counts:
        assert int(state.draw_counter) == trace.draw_count_after_reset

    actions = torch.from_numpy(np.ascontiguousarray(trace.actions, np.int32)).to(device)
    for t in range(actions.shape[0]):
        state, ts = env.step(state, actions[t], oracle)
        host = torch.cat([ts.obs.reshape(-1).to(torch.float64),
                          ts.rewards.reshape(-1).to(torch.float64),
                          ts.terminated.reshape(1).to(torch.float64),
                          ts.scores.reshape(-1).to(torch.float64),
                          state.draw_counter.reshape(1).to(torch.float64)]).cpu().numpy()
        obs = host[:70].reshape(2, 35)
        if not np.array_equal(obs, trace.obs[t + 1]):
            diff = np.argwhere(obs != trace.obs[t + 1])
            raise AssertionError(
                f"obs mismatch at step {t}: dims {diff.tolist()} "
                f"ref={trace.obs[t + 1][tuple(diff[0])]} got={obs[tuple(diff[0])]}")
        np.testing.assert_array_equal(host[70:72], trace.rewards[t],
                                      err_msg=f"reward mismatch at step {t}")
        assert bool(host[72]) == bool(trace.terminations[t]), \
            f"termination mismatch at step {t}"
        np.testing.assert_array_equal(host[73:75], trace.scores[t],
                                      err_msg=f"score mismatch at step {t}")
        if check_draw_counts:
            assert int(host[75]) == int(trace.draw_count_after_step[t]), \
                (f"draw counter mismatch at step {t}: "
                 f"ref={trace.draw_count_after_step[t]} got={int(host[75])}")
