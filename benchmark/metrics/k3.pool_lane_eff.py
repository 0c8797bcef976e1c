"""k3.pool_lane_eff: the landing pool's lane efficiency in K3, the share of
the warp's 32 lanes that run a landing iteration in each pool step:
``iterations / (32 x pool_steps)``, in %.  Counted by the kernel's counting
instance (``fused_step.rollout_packed_counted``) on a copy of the first
traced call's input, the input ``k3_roofline`` counts on: the same work on
the same input, counted where it happens, while the timed instance counts
nothing."""


def count(run):
    from pikazoo_tpu_torch.core import fused_step

    s = run.session
    if run.device.type != "cuda" or getattr(s, "trace_input", None) is None:
        return None
    packed = fused_step.pack_state(s.trace_input, s.action_key).clone()
    counts = fused_step.rollout_packed_counted(packed, s.cfg, s.frames)
    return counts["iterations"], counts["pool_steps"]


def collect(run):
    run.once("k3_pool_counts", lambda: count(run))


def read(run):
    counts = run.readings.get("k3_pool_counts")
    if not counts or not counts[1]:
        return None
    iterations, pool_steps = counts
    return iterations / (32 * pool_steps) * 100
