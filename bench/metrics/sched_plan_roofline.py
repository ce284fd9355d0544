"""Scheduling kernel: the least time of the traced replans' plan work
(``harness.launch_least_ms``: bytes and f64 operations against the card's
peaks) over the device time of ``sched_plan_kernel`` in the trace, %."""

KERNEL = "sched_plan_kernel"


def read(run):
    if run.trace is None:
        return None
    device_ms = sum(e["dur"] for e in run.trace.kernels(KERNEL)) / 1e3
    least = sum(run.plan_work[(s.segment, s.replan)] for s in run.steps
                if s.profiled and s.replan is not None)
    if not device_ms or not least:
        return None
    return 100.0 * least / device_ms
