"""The learner step's kernel (host build) == the eager step == JAX's, bit
for bit, frame by frame, with the rule AI in both seats (``learner_step_cases``)."""

import pytest

from learner_step_cases import (MODE_IDS, MODES, hold_frames,  # noqa: F401 (fixtures)
                                host_library, one_thread)


@pytest.mark.parametrize("serve,auto_reset", MODES, ids=MODE_IDS)
def test_host_build_matches_eager_and_jax(host_library, serve, auto_reset):
    hold_frames(host_library, "ai_both", serve, auto_reset, seed=13)
