"""train_env_steps_per_s: env-steps of every whole update in the window over
their total wall time; an update ends when its losses are on the host."""

from benchmark.counts import rate


def read(run):
    return rate(sum(u["env_steps"] for u in run.units), sum(u["ms"] for u in run.units) / 1e3)
