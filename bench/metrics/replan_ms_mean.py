"""Session and scheduler: the host clock around each drift replan
(``DSMSEngine.retime``) of the window, meaned."""


def read(run):
    return sum(run.replan_ms) / len(run.replan_ms) if run.replan_ms else None
