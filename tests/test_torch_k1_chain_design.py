"""Which kernel A serves K1's bf16 and int8fwd modes on the card
(``fused_update.chain_design``, which the wrapper passes to the launch): a
plain function of the shapes and the mode; the launch count of each design.
The kernels build only with nvcc: chip_smoke.py holds both designs against
the plain version on the card and checks the count."""

import pytest

from pikazoo_tpu_torch.train import fused_update as fu
from test_torch_fused_update_split import KW, make_inputs

A = KW["num_actions"]
FLAGSHIP = (256, 256)

# (hidden, obs_dim, num_actions, quant, bwd_bf16, design)
CASES = [
    (FLAGSHIP, 35, A, "none", False, "wgmma"),     # the flagship learner's update
    (FLAGSHIP, 48, A, "none", False, "wgmma"),     # 48 features: no padding
    (FLAGSHIP, 1, A, "none", False, "wgmma"),      # padded to 16
    (FLAGSHIP, 35, 31, "none", False, "wgmma"),    # 31 actions and the value: 32 head rows
    (FLAGSHIP, 49, A, "none", False, "mma"),       # 64 padded features
    (FLAGSHIP, 35, A, "int8fwd", False, "mma"),    # the int8 forward
    (FLAGSHIP, 35, A, "none", True, "mma"),        # the bf16 backward chain
    (FLAGSHIP, 35, A, "int8fwd", True, "mma"),
    ((256,), 35, A, "none", False, "mma"),         # one layer
    ((256, 256, 256), 35, A, "none", False, "mma"),
    ((128, 128), 35, A, "none", False, "mma"),     # narrower
    ((256, 128), 35, A, "none", False, "mma"),
    ((128, 256), 35, A, "none", False, "mma"),
]


@pytest.mark.parametrize("hidden,obs_dim,num_actions,quant,bwd_bf16,design", CASES)
def test_chain_design_is_a_function_of_shapes_and_mode(hidden, obs_dim, num_actions, quant,
                                                       bwd_bf16, design):
    assert fu.chain_design(hidden, obs_dim, num_actions, quant, bwd_bf16) == design
    # A list or a tuple of widths alike; the activation is not an input.
    assert fu.chain_design(list(hidden), obs_dim, num_actions, quant, bwd_bf16) == design


def test_design_counts_read_zero_on_cpu():
    """Both kernel A designs have a launch count; a CPU call runs the plain
    version and counts nothing."""
    fu.zero_fm_counts()
    counts = fu.fused_ppo_grads_fm.launches_by_kernel
    assert counts["bf16_chain"] == 0 and counts["bf16_chain_wgmma"] == 0
    _, port, _, args = make_inputs((32, 32), "tanh", 2, 64, seed=3)
    fu.fused_ppo_grads_fm(port, *args, activation="tanh", **KW)
    fu.k1_chain(port, *args, activation="tanh", **KW)
    assert counts == dict.fromkeys(counts, 0)
    assert fu.fused_ppo_grads_fm.launches == 0


def test_k1_chunks_count_each_design():
    """``_count`` adds kernel A under the design's key and kernel B under
    ``bf16_dw``, once a chunk."""
    fu.zero_fm_counts()
    counts = fu.fused_ppo_grads_fm.launches_by_kernel
    fu._count(fu.fused_ppo_grads_fm, fu.STAGE_CHAIN | fu.STAGE_DW, 32, "bf16", "chain_wgmma")
    fu._count(fu.fused_ppo_grads_fm, fu.STAGE_CHAIN, 3, "bf16")
    fu._count(fu.fused_ppo_grads_fm, fu.STAGE_DW, 2, "bf16", "chain_wgmma")
    assert (counts["bf16_chain_wgmma"], counts["bf16_chain"], counts["bf16_dw"]) == (32, 3, 34)
    fu.zero_fm_counts()
