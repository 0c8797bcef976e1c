"""train_mfu: model FLOPs of an update over the wall time of an update and
the card's bf16 peak (989 TFLOP/s).  Model FLOPs are 2 P a column of the
rollout's forward and of ``last_value``, and 6 P a column an epoch in the
update, P the weights of the network from its shapes; the wall time is the
mean of the window's (unprofiled) updates."""

from benchmark.counts import PEAK_OPS_PER_S, update_model_flops


def read(run):
    learner = run.session.learner
    flops = update_model_flops(learner["num_envs"], learner["rollout_length"],
                               learner["update_epochs"], learner["hidden"])
    seconds = sum(u["ms"] for u in run.units) / 1e3 / len(run.units)
    return flops / seconds / PEAK_OPS_PER_S["bf16"] * 100
