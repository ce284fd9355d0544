"""Core paper algorithms, ported: contention-aware, load-balanced static
list scheduling for stream-processing DAGs on heterogeneous processors
and networks, with the candidate evaluation on the card.
"""
from .api import (HSV_CC, HVLB_CC_A, HVLB_CC_B, HVLB_CC_IC, Plan, Policy,
                  ReplayStats, Scheduler, SweepResult)
from .backends import (CandidateEvaluator, CudaBackend, ScalarBackend,
                       available_backends, resolve_backend_name)
from .convert import (spg_arrays, spg_from_arrays, topology_arrays,
                      topology_from_arrays)
from .engine import (DEFAULT_BATCH_MAX, CompiledInstance, DecisionTrace,
                     plan_waves)
from .faults import (FaultSpec, InfeasibleScheduleError, WaveTimeoutError)
from .graph import PAPER_COMP, PAPER_COMP_EXP5, PAPER_EDGES, SPG, paper_spg
from .imprecise import precision, precision_curve, schedule_holes
from .ranks import hprv_a, hprv_b, hrank, ldet_cc, priority_queue, rank_matrix
from .scheduler import (MessagePlacement, Schedule, SchedulingFailure,
                        list_schedule)
from .tgff import random_spg
from .topology import Topology, fully_switched_topology, paper_topology
from .validate import (ScheduleValidationError, check_graph, check_topology,
                       schedule_violations, validate_schedule)

__all__ = [
    "Scheduler", "Plan", "Policy", "ReplayStats", "SweepResult",
    "HSV_CC", "HVLB_CC_A", "HVLB_CC_B", "HVLB_CC_IC",
    "CompiledInstance", "DecisionTrace", "DEFAULT_BATCH_MAX", "plan_waves",
    "CandidateEvaluator", "CudaBackend", "ScalarBackend",
    "available_backends", "resolve_backend_name",
    "spg_arrays", "spg_from_arrays", "topology_arrays",
    "topology_from_arrays",
    "FaultSpec", "InfeasibleScheduleError", "WaveTimeoutError",
    "SPG", "paper_spg", "PAPER_EDGES", "PAPER_COMP", "PAPER_COMP_EXP5",
    "Topology", "paper_topology", "fully_switched_topology",
    "rank_matrix", "hrank", "hprv_a", "hprv_b", "ldet_cc", "priority_queue",
    "Schedule", "MessagePlacement", "SchedulingFailure", "list_schedule",
    "schedule_holes", "precision", "precision_curve", "random_spg",
    "schedule_violations", "validate_schedule", "ScheduleValidationError",
    "check_graph", "check_topology",
]
