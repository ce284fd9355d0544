"""Device: the time a traced step keeps the card busy (the union of its
kernels, copies and sets), ms: the device side of a step, steady where
the host paces the step's wall time."""


def read(run):
    if run.trace is None or not run.trace.steps:
        return None
    return 1e3 * run.trace.busy_s / run.trace.steps
