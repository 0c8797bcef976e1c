"""ppo.update_ms: CUDA-event milliseconds of the update
(``train_step.update_fn``: the epochs' minibatch gradients and Adam) in the
same phase-driven update as ``ppo.rollout_ms``."""


def collect(run):
    run.once("phases", run.session.time_phases)


def read(run):
    return run.readings["phases"].get("update")
