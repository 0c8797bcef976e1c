"""Probe tools of the port, each run by hand on a card (``python3 -m
pikazoo_tpu_torch.tools.<name>``; ``--device cpu`` where a tool takes it):
the compaction probe (``flat_sims``, ``csrc/flat_sims.cu``), the products-only
floor of K1 (``mm_grads``, ``csrc/fm_roofline.cu``), the feature-major
prototype (``fm_grads``, ``csrc/fm_kernel_probe.cu``) and K1's precision
probe.  ``chip_smoke.py`` drives the first three; nothing runs at import."""
