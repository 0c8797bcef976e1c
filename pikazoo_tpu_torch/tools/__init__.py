"""Probe tools of the port, each run by hand on a card (``python3 -m
pikazoo_tpu_torch.tools.<name>``; ``--device cpu`` where a tool takes it):
the compaction probe (``flat_sims``, ``csrc/flat_sims.cu``), the products-only
floor of K1 (``mm_grads``, ``csrc/fm_roofline.cu``), the feature-major
prototype (``fm_grads``, ``csrc/fm_kernel_probe.cu``), K1's precision and
split probes, and K3's probe (``k3_probe``: the fused rollout's times beside
other builds, its landing pool's lane efficiency, the plain version's
landing work).  ``chip_smoke.py`` drives the first three and uses
``k3_probe``'s counts; nothing runs at import."""
