"""The port replays the JAX package's golden production trajectory
(``tests/golden_trajectory.npz``, recorded by ``tests/test_golden_trajectory.py``)
bit for bit: 400 frames at B=4, rule-AI seats, ``serve="random"``, auto
reset, key 2026, actions from ``default_rng(816)``.  It pins the production
threefry streams, the key folding, the AI and auto reset; ``chip_smoke.py``
replays it on the card."""

import os

import numpy as np
import torch

from pikazoo_tpu_torch import EnvConfig, PikaZoo

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden_trajectory.npz")


def test_golden_production_trajectory():
    data = np.load(GOLDEN)
    env = PikaZoo(EnvConfig(auto_reset=True, winning_score=3, serve="random",
                            is_player1_computer=True, is_player2_computer=True))
    B, T = 4, 400
    state, _ = env.reset_batch(2026, B, device="cpu")
    rng = np.random.default_rng(816)
    for t in range(T):
        actions = torch.from_numpy(rng.integers(0, 18, size=(B, 2)).astype(np.int32))
        state, ts = env.step_batch(state, actions)
        np.testing.assert_array_equal(ts.obs.numpy(), data["obs"][t],
                                      err_msg=f"obs diverged at frame {t}")
        np.testing.assert_array_equal(ts.rewards.numpy(), data["rewards"][t],
                                      err_msg=f"rewards diverged at frame {t}")
    np.testing.assert_array_equal(state.scores.numpy(), data["final_scores"])
    np.testing.assert_array_equal(state.draw_counter.numpy(), data["final_draws"])
