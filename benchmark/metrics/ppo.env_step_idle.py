"""ppo.env_step_idle: the device-idle time inside the program's
``pikazoo.env.step`` spans over the device-idle time inside
``pikazoo.ppo.rollout``, in the profiled pass
(``benchmark/program_spans.py``): the share of the rollout's idling that
falls in the env's step rather than in the policy or the stores."""

from benchmark.program_spans import idle_share, profiled


def collect(run):
    profiled(run)


def read(run):
    p = profiled(run)
    if p is None:
        return None
    return idle_share(p, p.named("env.step"), p.named("ppo.rollout"))
