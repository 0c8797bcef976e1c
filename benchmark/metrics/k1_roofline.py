"""k1_roofline: K1 bf16's share of its roofline in the profiled update: the
sum of each call's bound (its shapes at the bf16 peak and HBM's rate, see
``benchmark/counts.py::grad_bound_s``) over the device time of K1's kernels
below (kernel A, kernel B and the partials' reduction of
``csrc/fused_update_bf16.cu``)."""

from benchmark.counts import grad_bound_s
from benchmark.layers import device_s_per_unit

KERNELS = ("chain_kernel", "dw_kernel", "reduce_partials")


def read(run):
    learner = run.session.learner
    per_update = device_s_per_unit(run.profile, "train_step", KERNELS)
    if not per_update or per_update[0] == 0:
        return None
    calls = learner["update_epochs"] * learner["num_minibatches"]
    columns = learner["rollout_length"] // learner["num_minibatches"] * 2 * learner["num_envs"]
    return calls * grad_bound_s(columns, learner["hidden"])[0] / per_update[0] * 100
