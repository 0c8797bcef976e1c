"""The oracle draw mode against the JAX package's with a computer in seat
1 alone: every serve mode, 300 frames at batch shapes ``(B,)`` and ``()``
(the cases of ``tests/test_torch_oracle.py``, split off with seat 2's in
``tests/test_torch_oracle_seat2.py`` to keep each file about a minute on
one process)."""

import pytest

from test_torch_oracle import SERVES, check_oracle_config


@pytest.mark.parametrize("serve", SERVES)
def test_oracle_mode_matches_jax_computer_in_seat_1(serve):
    check_oracle_config(True, False, serve)
