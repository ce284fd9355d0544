"""The DSMS serving engine, ported (twin of :mod:`repro.serve`)."""
from .engine import DSMSEngine, Query, StepResult

__all__ = ["DSMSEngine", "Query", "StepResult"]
