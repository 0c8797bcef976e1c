"""device_idle.train: the share of the profiled update's window in which
the card ran no kernel, copy or set."""


def read(run):
    return (1 - run.profile.busy_s / run.profile.window_s) * 100
