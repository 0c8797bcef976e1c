"""Probe tools of the port, each run by hand on a card (``python3 -m
pikazoo_tpu_torch.tools.<name>``; ``--device cpu`` where a tool takes it):
the compaction probe (``flat_sims``, ``csrc/flat_sims.cu``), the products-only
floor of K1 (``mm_grads``, ``csrc/fm_roofline.cu``), the feature-major
prototype (``fm_grads``, ``csrc/fm_kernel_probe.cu``), K1's precision probe,
K2's leap probe (``k2_leap_probe``: the leap modes beside another tree's
build, the SASS of one jump) and K3's probe (``k3_probe``: the fused
rollout's times beside another tree's build, its landing pool's lane
efficiency, the plain version's landing work).  ``chip_smoke.py`` at the
checkout's root drives the first three and takes the others' helpers (K1's
minibatch recipe, the live ball states, ``k3_probe``'s counts); no tool
imports it back.  Nothing runs at import."""
