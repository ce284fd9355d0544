"""Serving engine: kernel launches a step in the trace."""


def read(run):
    if run.trace is None or not run.trace.steps:
        return None
    return len(run.trace.kernels()) / run.trace.steps
