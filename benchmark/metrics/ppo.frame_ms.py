"""ppo.frame_ms: the host's mean time of one learner frame, the program's
``pikazoo.ppo.frame`` span (``policy_sample``, the env's learner step and
the trajectory's stores), over the 128 frames of the host pass's update,
tracing on and no profiler (``benchmark/program_spans.py``); 128 times it
is the rollout's frame time."""

from benchmark.program_spans import durations_ms, host_spans


def collect(run):
    host_spans(run)


def read(run):
    frames = durations_ms(host_spans(run), "ppo.frame")
    return sum(frames) / len(frames) if frames else None
