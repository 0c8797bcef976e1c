"""mesh.all_reduce_calls: the program's ``pikazoo.mesh.all_reduce`` spans an
update in the host pass (rank 0's; ``benchmark/program_spans.py``): two
under each minibatch's ``pikazoo.ppo.adv_stats``, one under its
``pikazoo.ppo.grad_sum``, and the episode metrics' one.  None where the
program does not name its sums over ranks (no ``pikazoo.ppo.grad_sum``
span)."""

from benchmark.program_spans import PROGRAM_PREFIX, host_spans


def collect(run):
    host_spans(run)


def read(run):
    names = [s.name[len(PROGRAM_PREFIX):] for s in host_spans(run) or ()]
    updates = names.count("ppo.train_step")
    if not updates or "ppo.grad_sum" not in names:
        return None
    return names.count("mesh.all_reduce") / updates
