"""Core paper algorithms, ported: contention-aware, load-balanced static
list scheduling for stream-processing DAGs on heterogeneous processors
and networks, with the candidate evaluation on the card.

Exports what ``repro.core`` exports, except the reference's
``default_backend`` (the port's default is ``cuda``, and it reads no
environment variable); its backends are ``cuda``, ``scalar``,
``vector`` and ``auto``.
"""
from .api import (HSV_CC, HVLB_CC_A, HVLB_CC_B, HVLB_CC_IC, FleetPlan,
                  Plan, Policy, ReplayStats, Scheduler, SweepResult)
from .backends import (BackendCompatError, CandidateEvaluator, CudaBackend,
                       ScalarBackend, VectorBackend, available_backends,
                       resolve_backend_name, vector_compatible)
from .convert import (spg_arrays, spg_from_arrays, topology_arrays,
                      topology_from_arrays)
from .engine import (DEFAULT_BATCH_MAX, CompiledInstance, DecisionTrace,
                     plan_waves)
from .faults import (ComputeSpike, Fault, FaultSpec, InfeasibleScheduleError,
                     LinkDegraded, LinkDown, ProcessorDown, WaveTimeoutError,
                     apply_to_graph, apply_to_topology)
from .graph import PAPER_COMP, PAPER_COMP_EXP5, PAPER_EDGES, SPG, paper_spg
from .hsv_cc import schedule_hsv_cc
from .hvlb_cc import schedule_hvlb_cc, schedule_hvlb_cc_best
from .imprecise import precision, precision_curve, schedule_holes
from .metrics import load_balance, sfr, slr, speedup
from .ranks import hprv_a, hprv_b, hrank, ldet_cc, priority_queue, rank_matrix
from .scheduler import (MessagePlacement, Schedule, SchedulingFailure,
                        list_schedule)
from .tgff import random_spg
from .topology import Topology, fully_switched_topology, paper_topology
from .validate import (FLOAT32_RTOL, ScheduleValidationError, check_graph,
                       check_topology, schedule_violations, validate_schedule)

__all__ = [
    # session API (the supported public surface)
    "Scheduler", "Plan", "FleetPlan", "Policy", "ReplayStats",
    "HSV_CC", "HVLB_CC_A", "HVLB_CC_B", "HVLB_CC_IC", "SweepResult",
    "CompiledInstance", "DecisionTrace", "DEFAULT_BATCH_MAX", "plan_waves",
    # candidate-evaluation backends
    "BackendCompatError", "CandidateEvaluator", "CudaBackend",
    "ScalarBackend", "VectorBackend", "available_backends",
    "resolve_backend_name", "vector_compatible",
    "spg_arrays", "spg_from_arrays", "topology_arrays",
    "topology_from_arrays",
    # fault model + independent validation
    "Fault", "FaultSpec", "ProcessorDown", "LinkDegraded", "LinkDown",
    "ComputeSpike", "InfeasibleScheduleError", "WaveTimeoutError",
    "apply_to_topology", "apply_to_graph",
    "schedule_violations", "validate_schedule", "ScheduleValidationError",
    "FLOAT32_RTOL",
    "SPG", "paper_spg", "PAPER_EDGES", "PAPER_COMP", "PAPER_COMP_EXP5",
    "Topology", "paper_topology", "fully_switched_topology",
    "rank_matrix", "hrank", "hprv_a", "hprv_b", "ldet_cc", "priority_queue",
    "Schedule", "MessagePlacement", "SchedulingFailure", "list_schedule",
    "schedule_holes", "precision", "precision_curve",
    "slr", "speedup", "load_balance", "sfr", "random_spg",
    "check_graph", "check_topology",
    # deprecated one-shot shims
    "schedule_hsv_cc", "schedule_hvlb_cc", "schedule_hvlb_cc_best",
]
