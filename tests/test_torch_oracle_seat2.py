"""The oracle draw mode against the JAX package's with a computer in seat
2 alone: every serve mode, 300 frames at batch shapes ``(B,)`` and ``()``
(the cases of ``tests/test_torch_oracle.py``, split off with seat 1's in
``tests/test_torch_oracle_seat1.py`` to keep each file about a minute on
one process)."""

import pytest

from test_torch_oracle import SERVES, check_oracle_config


@pytest.mark.parametrize("serve", SERVES)
def test_oracle_mode_matches_jax_computer_in_seat_2(serve):
    check_oracle_config(False, True, serve)
