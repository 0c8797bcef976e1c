"""k3.ms: K3's device time a call, from the profiler's trace, averaged over
the traced calls.  K3 is the kernel below (``csrc/fused_step.cu``)."""

from benchmark.layers import device_s_per_unit

KERNELS = ("fused_rollout_kernel",)


def read(run):
    per_call = device_s_per_unit(run.profile, "fused_rollout", KERNELS)
    if not per_call or sum(per_call) == 0:
        return None
    return sum(per_call) / len(per_call) * 1e3
