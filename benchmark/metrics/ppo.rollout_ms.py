"""ppo.rollout_ms: CUDA-event milliseconds of the learner rollout
(``train_step.rollout_fn``: the policy's sample and the env's learner step,
a frame at a time) in one more update driven through the trainer's phase
attributes after the window."""


def collect(run):
    run.once("phases", run.session.time_phases)


def read(run):
    return run.readings["phases"].get("rollout")
