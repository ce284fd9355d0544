"""Streaming DSMS serving engine — the paper's application layer on top of
the model runtime, the twin of :mod:`repro.serve.engine`.

Queries are registered ahead of time (the DSMS principle: register once,
execute continuously); each query is an operator chain over the decoded
model output (the "stream").  The engine:

  1. builds the serving SPG (backbone + query operators),
  2. statically schedules it through a long-lived
     :class:`repro_torch.core.Scheduler` session with the
     imprecise-computation policy ``HVLB_CC_IC`` (HSV_CC cannot order
     these multi-sink graphs — Section 3.2); on the card every plan and
     replan runs ``sched_plan_kernel``, and the plan carries the
     schedule holes directly,
  3. runs batched decode steps, executing query operators according to
     the static schedule,
  4. supports imprecise-computation queries: each operator has a mandatory
     function and an optional refinement that only runs inside its
     schedule hole (HVLB_CC_IC, Section 4.4).

Registration is O(1): ``register()`` only marks the plan dirty, and the
schedule is recomputed once — lazily, on the first ``step()`` (or an
explicit ``ensure_plan()``) after any number of registrations.  ``replans``
counts the actual scheduler invocations.  Task-time drift re-plans go
through ``Scheduler.update`` (:meth:`retime`), which replays only the
affected suffix of the decision trace.

The model is any decoder family of :mod:`repro_torch.models` (dense,
vlm, moe, ssm, hybrid); its decode state (KV cache, SSM state, conv
rows) comes from ``init_cache`` and is updated in place each step.
Everything runs on ``device``: the card (the default) or, when the
caller asks for it, the CPU.  The weights are cast once, here, to the
config's dtype; the decode step's own cast is then a no-op.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..configs.base import SHAPES, ModelConfig
from ..core import HVLB_CC_IC, Scheduler
from ..core.backends.cuda import check_device
from ..core.graph import SPG
from ..models import model as M
from ..models.params import tree_map
from ..planner import gpu_slice_topology, serving_query_graph


@dataclasses.dataclass
class Query:
    name: str
    mandatory: Callable[[torch.Tensor], Any]
    optional: Optional[Callable[[Any], Any]] = None
    # estimated cost ratio of optional part vs mandatory (for IC planning)
    optional_ratio: float = 1.0


@dataclasses.dataclass
class StepResult:
    tokens: np.ndarray
    query_outputs: Dict[str, Any]
    precise: Dict[str, bool]
    # Per-query precision loss report (Eq. 22 shape): 1.0 when the optional
    # refinement ran (or the query has none), else the mandatory-only
    # fraction mand/(mand + opt).
    precision: Dict[str, float] = dataclasses.field(default_factory=dict)


class DSMSEngine:
    """``params``: the model's weights (f32 masters or already in the
    config's dtype); the engine keeps a copy in the config's dtype on
    ``device``, so a caller may drop its own tree once this returns.
    The scheduler runs on one 8-GPU node cut into ``n_slices`` slices
    (``gpu_slice_topology(n_slices, gpus_per_slice=2, nodes=1)``) with
    ``backend`` (``"cuda"``, the default, ``"scalar"``, ``"vector"`` or
    ``"auto"``)."""

    def __init__(self, cfg: ModelConfig, params, batch_size: int,
                 max_seq: int, n_slices: int = 4,
                 backend: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = check_device(device)
        self.cfg = cfg
        f = M._dtype(cfg)
        self.params = tree_map(
            lambda a: a.to(device=self.device,
                           dtype=f if a.dtype == torch.float32 else a.dtype),
            params)
        self.batch = batch_size
        self.max_seq = max_seq
        self.queries: List[Query] = []
        self.cache = M.init_cache(cfg, batch_size, max_seq, self.device)
        self.pos = 0
        self._step = lambda p, c, t, q: M.decode_step(cfg, p, c, t, q)
        self.topology = gpu_slice_topology(n_slices=n_slices,
                                           gpus_per_slice=2, nodes=1)
        self.scheduler = Scheduler(
            self.topology, policy=HVLB_CC_IC(alpha_max=2.0, alpha_step=0.1),
            backend=backend, device=self.device)
        self.plan = None
        self.holes: Dict[int, float] = {}
        self.replans = 0                    # scheduler invocations
        self._dirty = True
        self._graph: Optional[SPG] = None
        self._query_nodes: Dict[int, int] = {}

    def register(self, q: Query) -> None:
        """Register a continuous query (before streaming starts).

        O(1): the schedule is recomputed lazily on the next ``step()`` —
        registering Q queries costs one re-plan, not Q.
        """
        self.queries.append(q)
        self._dirty = True

    def ensure_plan(self) -> None:
        """Re-plan if the query set changed since the last schedule."""
        if not self._dirty:
            return
        shape = dataclasses.replace(SHAPES["decode_32k"],
                                    global_batch=self.batch,
                                    seq_len=self.max_seq)
        g = serving_query_graph(self.cfg, shape,
                                n_queries=max(1, len(self.queries)))
        plan = self.scheduler.submit(g)
        self.replans += 1
        self._graph = g
        self.plan = plan.schedule
        self.holes = plan.holes
        # query q -> its first operator node, from the graph's own mapping
        self._query_nodes = {qi: g.query_ops[qi][0]
                             for qi in range(len(self.queries))}
        self._dirty = False

    def retime(self, task_rates) -> None:
        """Re-plan after task computation-time drift (Section 4.4's varying
        arrival rates) via the incremental ``Scheduler.update`` path.

        Accepts either one ``{task: factor}`` dict or a sequence of such
        dicts (a pending batch of drift events, oldest first) — the batch
        is folded into one combined suffix replay, bit-identical to
        applying the events one ``retime`` at a time.
        """
        self.ensure_plan()
        plan = self.scheduler.update(task_rates=task_rates,
                                     graph=self._graph)
        self._adopt(plan)

    def mark_failed(self, *, proc: Optional[int] = None,
                    link: Optional[str] = None) -> None:
        """Report a failed processor or link; replans the serving graph.

        Graceful IC degradation: the replan typically leaves fewer/smaller
        schedule holes, so optional query refinements stop running and the
        per-query ``StepResult.precision`` drops below 1.0 — the engine
        keeps serving rather than failing
        (:class:`repro_torch.core.InfeasibleScheduleError` still
        propagates when no feasible placement remains at all).
        """
        self.ensure_plan()
        self._adopt(self.scheduler.mark_failed(proc=proc, link=link,
                                               graph=self._graph))

    def degrade(self, *, link: Optional[str] = None,
                task: Optional[int] = None, factor: float) -> None:
        """Report a degraded link (or a task compute spike); replans."""
        self.ensure_plan()
        self._adopt(self.scheduler.degrade(link=link, task=task,
                                           factor=factor,
                                           graph=self._graph))

    def restore(self, *, proc: Optional[int] = None,
                link: Optional[str] = None) -> None:
        """Clear a previously reported fault; replans from scratch."""
        self.ensure_plan()
        self._adopt(self.scheduler.restore(proc=proc, link=link,
                                           graph=self._graph))

    def _adopt(self, plan) -> None:
        self.replans += 1
        self._graph = plan.graph
        self.plan = plan.schedule
        self.holes = plan.holes

    def _has_hole(self, qi: int, q: Query) -> bool:
        node = self._query_nodes.get(qi)
        if node is None or self.plan is None:
            return False
        hole = self.holes.get(node, 0.0)
        g = self.plan.graph
        mand = g.comp(node, int(self.plan.proc[node]), self.topology.rates)
        return hole >= q.optional_ratio * mand

    def step(self, tokens: np.ndarray) -> StepResult:
        """Feed one token per stream; run queries per the static plan."""
        self.ensure_plan()
        t = torch.as_tensor(tokens.reshape(self.batch, 1),
                            dtype=torch.int64).to(self.device)
        pos = torch.full((self.batch,), self.pos, dtype=torch.int64,
                         device=self.device)
        logits, self.cache = self._step(self.params, self.cache, t, pos)
        self.pos += 1
        out_tok = logits[:, -1].argmax(dim=-1).cpu().numpy()
        outputs: Dict[str, Any] = {}
        precise: Dict[str, bool] = {}
        precision: Dict[str, float] = {}
        for qi, q in enumerate(self.queries):
            res = q.mandatory(logits)
            ok = False
            if q.optional is not None and self._has_hole(qi, q):
                res = q.optional(res)
                ok = True
            outputs[q.name] = res
            precise[q.name] = ok or q.optional is None
            precision[q.name] = 1.0 if precise[q.name] \
                else 1.0 / (1.0 + q.optional_ratio)
        return StepResult(out_tok, outputs, precise, precision)
