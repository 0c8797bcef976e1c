"""fused.overhead_ms: what a call costs beyond K3: the mean wall time of the
window's calls (host clock, unprofiled) less K3's mean device time a call
in the traced calls.  The packing, unpacking, launch and read-back."""

from benchmark.layers import device_s_per_unit

KERNELS = ("fused_rollout_kernel",)


def read(run):
    k3 = device_s_per_unit(run.profile, "fused_rollout", KERNELS)
    if not k3 or sum(k3) == 0:
        return None
    wall_ms = sum(u["ms"] for u in run.units) / len(run.units)
    return wall_ms - sum(k3) / len(k3) * 1e3
