"""k3_roofline: K3's share of its roofline in the first traced call: the
roofline time (the larger of the call's needed operations over the int32
peak and the packed state read and written once over HBM's rate, see
``benchmark/counts.py``) over K3's device time in that call.  The work is
counted on the benchmark's reference over a sample of envs, so it reads the
same whatever implements the call."""

from benchmark.counts import k3_traced_bound
from benchmark.layers import device_s_per_unit

KERNELS = ("fused_rollout_kernel",)


def collect(run):
    k3_traced_bound(run)


def read(run):
    per_call = device_s_per_unit(run.profile, "fused_rollout", KERNELS)
    if not per_call or per_call[0] == 0:
        return None
    return k3_traced_bound(run)[0] / per_call[0] * 100
