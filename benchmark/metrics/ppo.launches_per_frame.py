"""ppo.launches_per_frame: the host's kernel launches (``cudaLaunchKernel*``,
``cuLaunchKernel*``, ``cudaGraphLaunch``) inside each ``pikazoo.ppo.frame``
span of the profiled pass, averaged over the update's frames
(``benchmark/program_spans.py``)."""

from benchmark.program_spans import profiled


def collect(run):
    profiled(run)


def read(run):
    p = profiled(run)
    if p is None or not p.launch_times():
        return None
    counts = p.launches_in(p.named("ppo.frame"))
    return sum(counts) / len(counts) if counts else None
