"""env_steps_per_s: env-steps of every call completed in the window (batch x
frames x calls) over the window's time, by the host's clock."""

from benchmark.counts import rate


def read(run):
    return rate(sum(u["env_steps"] for u in run.units), run.window_s)
