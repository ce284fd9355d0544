"""One run of one cell: set-up, the measured window, the check of what the
window produced, and the metrics.

Set-up: the weights from the seed (bf16, on the device), a serving
engine (``repro_torch.serve.DSMSEngine``) over them with the mix's
queries registered and planned, warm-up steps with a drift replan on a
first engine that is then freed, and a fresh engine planned for the
window.  The window: a closed loop of steps until ``seconds`` have
passed; before a step that carries a drift event, ``DSMSEngine.retime``;
then ``DSMSEngine.step`` with one tuple a stream, and every query's
results brought to the host.  A stream set that reaches its lifetime is
freed and a fresh engine over the same weights takes over.  After the
window: the device's peak memory, the check that no JAX module was
loaded, the engine freed, then the comparison with the plain references
(``bench/reference``) and the per-layer readers (``bench/metrics``).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import queries as Q
from . import traffic as TR
from . import weights as W
from .reference import plan as PR
from .trace import Profiler, REPLAN_SPAN, STEP_SPAN, Trace
from .yardstick import bound, decision_ops, table_bytes

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def reference_module(kind: str):
    """The plain reference of a model family, ``bench/reference/<kind>.py``."""
    return importlib.import_module(f"bench.reference.{kind}")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` in ``BENCHMARK.json``: its
    configuration's file, its traffic mix ``bench/traffic/<traffic>.json``,
    its limits ``bench/limits/<workload>.json`` and the metrics it
    reports."""
    bj = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bj["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bj["configs"]}[w["config"]]
    limits = json.loads(
        (root / "bench" / "limits" / f"{workload}.json").read_text())

    def mine(metrics):
        return [x for x in metrics if workload in x.get("workloads",
                                                         [workload])]

    return Cell(workload, int(w["chips"]),
                json.loads((root / conf["file"]).read_text()),
                TR.load(root / "bench" / "traffic" / f"{w['traffic']}.json"),
                limits, mine(bj["end_to_end"]), mine(bj["per_layer"]))


def files_cell(config: str, traffic: str, root: Path = ROOT) -> Cell:
    """A configuration file ``bench/configs/<config>.json`` under a
    traffic mix, whether or not ``BENCHMARK.json`` has the pair as a
    cell: held to no limit (the readings that a limit is set from)."""
    return Cell(f"{config}.{traffic}", 1,
                json.loads((root / "bench" / "configs"
                            / f"{config}.json").read_text()),
                TR.load(root / "bench" / "traffic" / f"{traffic}.json"),
                {}, [], [])


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's, compared whole."""
    return sorted({n for n in list(sys.modules)
                   if n.split(".", 1)[0] in FORBIDDEN})


def snap(eng) -> tuple:
    """The plan in force: placements, start and finish times, holes."""
    return (eng.plan.proc.copy(), eng.plan.start.copy(),
            eng.plan.finish.copy(), dict(eng.holes))


@dataclasses.dataclass
class Step:
    segment: int
    position: int
    ms: float
    plan_index: int              # the segment's plan in force
    replan: Optional[int] = None  # the plan this step's drift made
    profiled: bool = False


@dataclasses.dataclass
class Segment:
    """One stream set: its plans (the first, then one a drift event), the
    drift events, and its steps' tuples and answers (compared streams)."""
    plans: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)
    tokens: list = dataclasses.field(default_factory=list)
    served: list = dataclasses.field(default_factory=list)
    answers: list = dataclasses.field(default_factory=list)
    precise: list = dataclasses.field(default_factory=list)


class Run:
    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", started: Optional[float] = None,
                 hook: Optional[Callable] = None,
                 steps: Optional[int] = None) -> None:
        """``steps``: run that many steps in place of ``seconds`` (the
        readings and the tests); ``hook``: called with each new engine
        and the run (the tests' planted faults)."""
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace_on = trace
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.started = time.perf_counter() if started is None else started
        self.hook = hook
        self.max_steps = steps
        self.m = cell.config["model"]
        self.pub = cell.config["published"]
        self.spec = cell.traffic
        self.B = int(self.spec["streams"])
        self.life = int(self.spec["lifetime"])
        # the streams whose answers are compared, drawn from the seed
        self.rows = TR.sample_streams(self.spec, seed)

    # ------------------------------------------------------------ set-up
    def _engine(self):
        eng = self.DSMSEngine(self.mcfg, self.weights, batch_size=self.B,
                              max_seq=self.life, device=self.dev)
        for q in Q.make(self.Query, self.spec["queries"]):
            eng.register(q)
        if self.hook is not None:
            self.hook(eng, self)
        eng.ensure_plan()
        return eng

    def _free(self, eng) -> None:
        eng.cache = None
        del eng
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def _fetch(self, res) -> tuple:
        """Every query's results on the host in one copy; the widths of
        each query's parts."""
        parts, widths = [], []
        for q in self.queries:
            out = res.query_outputs[q]
            out = [out] if isinstance(out, torch.Tensor) else list(out)
            widths.append([1 if t.dim() == 1 else t.shape[-1] for t in out])
            parts.extend(t.reshape(self.B, -1).to(torch.float64)
                         for t in out)
        host = torch.cat(parts, dim=1).cpu().numpy()
        return host, widths

    def setup(self) -> None:
        """Everything before the window; ``setup_parts`` times its parts
        (s from the process's start, where given)."""
        parts = self.setup_parts = {
            "before_setup": time.perf_counter() - self.started}
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.configs.base import ModelConfig
        from repro_torch.serve import DSMSEngine, Query
        if self.cuda:
            torch.cuda.init()
        parts["program_imported_cuda_ready"] = \
            time.perf_counter() - self.started
        self.DSMSEngine, self.Query = DSMSEngine, Query
        self.mcfg = ModelConfig(**self.m)
        self.queries = [q.name for q in Q.make(Query, self.spec["queries"])]
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        self.weights = W.make(self.m, self.seed, self.dev)
        parts["weights_made"] = time.perf_counter() - self.started
        self.graph0 = PR.serving_graph(self.m, self.B, self.life,
                                       self.spec["queries"]["count"])
        self.traffic = TR.Traffic(self.spec, self.seed, self.m["vocab"],
                                  self.graph0.n)
        eng = self._engine()
        warm = TR.warmup_tokens(self.spec, self.seed, self.m["vocab"],
                                int(self.spec["warmup_steps"]))
        for i, tok in enumerate(warm):
            if i == 1:
                eng.retime({self.graph0.n - 1: 1.1})
            self._fetch(eng.step(tok))
        self._free(eng)
        parts["warmed_up"] = time.perf_counter() - self.started
        self.eng = self._engine()
        self.build_peak = 0
        if self.cuda:
            torch.cuda.synchronize()
            self.build_peak = torch.cuda.max_memory_allocated()
        self.setup_s = time.perf_counter() - self.started

    # ------------------------------------------------------------ window
    def _profiled_span(self) -> range:
        """The traced steps: ``trace_steps`` from the first step that
        carries a drift event."""
        first = next(k for k in range(1 << 20) if self.traffic.drift(k))
        return range(first, first + int(self.spec["trace_steps"]))

    def window(self) -> None:
        span = self._profiled_span() if self.trace_on else range(0)
        prof = Profiler(ROOT) if self.trace_on else None
        self.trace: Optional[Trace] = None
        seg = Segment(plans=[snap(self.eng)])
        self.segments, self.steps, self.replan_ms = [seg], [], []
        rows = self.rows
        eng = self.eng
        t0 = time.perf_counter()
        deadline = t0 + self.seconds
        k = 0
        while True:
            if self.max_steps is not None:
                if k >= self.max_steps:
                    break
            elif k and time.perf_counter() >= deadline:
                break
            if k == span.start and prof is not None:
                prof.start()
            ts = time.perf_counter()
            replan = None
            with torch.profiler.record_function(STEP_SPAN):
                if eng is None:
                    eng = self._engine()
                    seg = Segment(plans=[snap(eng)])
                    self.segments.append(seg)
                ev = self.traffic.drift(k)
                if ev:
                    r0 = time.perf_counter()
                    with torch.profiler.record_function(REPLAN_SPAN):
                        eng.retime(ev)
                    self.replan_ms.append((time.perf_counter() - r0) * 1e3)
                    seg.plans.append(snap(eng))
                    seg.events.append(ev)
                    replan = len(seg.plans) - 1
                tok = self.traffic.tokens(k)
                position = eng.pos
                res = eng.step(tok)
                host, widths = self._fetch(res)
            te = time.perf_counter()
            self.steps.append(Step(len(self.segments) - 1, position,
                                   (te - ts) * 1e3, len(seg.plans) - 1,
                                   replan, k in span))
            if prof is not None and k == span.stop - 1:
                self.trace = prof.stop()
                prof = None
            seg.tokens.append(tok)
            seg.served.append(np.asarray(res.tokens)[rows])
            seg.answers.append((host[rows], widths))
            seg.precise.append([res.precise[q] for q in self.queries])
            if eng.pos == self.life:
                self._free(eng)
                eng = None
            k += 1
            self.window_end = te
        if prof is not None:
            self.trace = prof.stop()
        self.window_s = self.window_end - t0
        self.eng = eng
        self.memory_peak = torch.cuda.max_memory_allocated() \
            if self.cuda else 0
        self.jax = forbidden_modules()
        if self.eng is not None:
            self._free(self.eng)
            self.eng = None

    # ------------------------------------------------------------- check
    def answers(self, seg: Segment):
        """The program's answers of segment ``seg`` on the compared
        streams: served tokens (S, T), and per query its parts (S, T, w)."""
        served = np.stack(seg.served, axis=1)
        per_query: Dict[str, list] = {q: [] for q in self.queries}
        for host, widths in seg.answers:
            col = 0
            for q, ws in zip(self.queries, widths):
                parts = []
                for w_ in ws:
                    parts.append(host[:, col:col + w_])
                    col += w_
                per_query[q].append(parts)
        return served, per_query

    def check(self) -> Dict[str, float]:
        """Every number compared, by name."""
        if self.cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        nums = self.check_plans()
        seg = self.segments[0]
        ref = reference_module(self.cell.config["reference"])
        tokens = torch.as_tensor(np.stack(seg.tokens, axis=1),
                                 device=self.dev)
        rows = torch.as_tensor(self.rows, device=self.dev)
        with torch.no_grad():
            h, self.picked = ref.hidden(self.weights, self.pub, tokens, rows,
                                        dtype=ref_dtype(self.m))
            served, per_query = self.answers(seg)
            nums.update(compare_logits(h, W.head(self.weights), served,
                                       per_query))
            nums["refinements_wrong"] = float(refinements_wrong(
                per_query, seg.precise, self.queries))
        return nums

    def check_plans(self) -> Dict[str, float]:
        """The plans against the reference's, from scratch on the same
        drifted graphs, and each step's precise flags against the
        reference plan in force."""
        tg = PR.slice_topology()
        ratio = self.spec["queries"]["optional_ratio"]
        kinds = [Q.kind_of(q) for q in self.queries]
        differing = precise_bad = 0
        self.plan_work: Dict[tuple, float] = {}
        for si, seg in enumerate(self.segments):
            sess = PR.Session(self.graph0, tg)
            refs = [sess.current]
            differing += not same_plan(seg.plans[0], sess.current)
            for pi, ev in enumerate(seg.events, start=1):
                prev = sess.current
                new = sess.drift(ev)
                refs.append(new)
                differing += not same_plan(seg.plans[pi], new)
                self.plan_work[(si, pi)] = launch_least_ms(prev, new, tg)
            runs = [[Q.KINDS[kd][1] is None or sess_runs(p, q, ratio)
                     for q, kd in enumerate(kinds)] for p in refs]
            seg_steps = [s for s in self.steps if s.segment == si]
            for st, flags in zip(seg_steps, seg.precise):
                precise_bad += sum(a != b for a, b in
                                   zip(flags, runs[st.plan_index]))
        return {"plans_differing": float(differing),
                "precise_differing": float(precise_bad)}

    def control(self) -> Dict[str, float]:
        """The control's numbers: the reference with every product in fp8
        put in the program's place, against the f32 reference."""
        seg = self.segments[0]
        ref = reference_module(self.cell.config["reference"])
        tokens = torch.as_tensor(np.stack(seg.tokens, axis=1),
                                 device=self.dev)
        rows = torch.as_tensor(self.rows, device=self.dev)
        head = W.head(self.weights)
        with torch.no_grad():
            h, _ = ref.hidden(self.weights, self.pub, tokens, rows)
            hc, _ = ref.hidden(self.weights, self.pub, tokens, rows, fp8=True)
            served, per_query = answers_of(hc, head, self.queries, fp8=True)
            return compare_logits(h, head, served, per_query)


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=float), q))


def result(run: Run, nums: Dict[str, float]) -> dict:
    """The run's result line: ``correct`` (every number that the cell's
    limits name at or under its limit), the tuples attempted, the
    metrics (end-to-end, or per-layer from the traced run), the device,
    the traced run's breakdown, and last ``checks``: each number
    compared with its limit."""
    metrics = {}
    if run.trace_on:
        for mdef in run.cell.per_layer:
            mod = importlib.import_module(f"bench.metrics.{mdef['name']}")
            v = mod.read(run)
            if v is not None:
                metrics[mdef["name"]] = {"value": v, "unit": mdef["unit"]}
    else:
        e2e = {"tokens_per_s": len(run.steps) * run.B / run.window_s,
               "step_ms_p95": percentile([s.ms for s in run.steps], 95),
               "setup_s": run.setup_s}
        for mdef in run.cell.end_to_end:
            metrics[mdef["name"]] = {"value": e2e[mdef["name"]],
                                     "unit": mdef["unit"]}
    device = {"platform": "gpu" if run.cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if run.cuda else "cpu",
              "count": run.cell.chips, "memory_peak_bytes": run.memory_peak}
    out = {"correct": False, "attempted": len(run.steps) * run.B,
           "failed": 0, "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    checks = {k: {"value": nums.get(k, float("nan")), "limit": lim}
              for k, lim in run.cell.limits.items()}
    out["correct"] = all(lim is not None and c["value"] <= lim
                         for c, lim in ((c, c["limit"])
                                        for c in checks.values()))
    out["checks"] = checks
    return out


def ref_dtype(m: dict) -> torch.dtype:
    """The references compute in f32, or in f64 for a model run in f64
    (the tests' exact witness)."""
    return torch.float64 if m["dtype"] == "float64" else torch.float32


def sess_runs(p: PR.Plan, q: int, ratio: float) -> bool:
    node = p.graph.query_ops[q][0]
    mand = p.comp[node, int(p.schedule.proc[node])]
    return p.holes.get(node, 0.0) >= ratio * mand


def same_plan(got: tuple, want: PR.Plan) -> bool:
    proc, start, finish, holes = got
    s = want.schedule
    return (np.array_equal(proc, s.proc) and np.array_equal(start, s.start)
            and np.array_equal(finish, s.finish) and holes == want.holes)


def clean_prefix(prev: PR.Plan, new: PR.Plan) -> int:
    """Queue positions whose task, computation row and LDET row a drift
    left as they were, up to the first that changed."""
    k = 0
    for a, b in zip(prev.queue, new.queue):
        if a != b or not (np.array_equal(prev.comp[a], new.comp[b])
                          and np.array_equal(prev.ldet[a], new.ldet[b])):
            break
        k += 1
    return k


def launch_least_ms(prev: PR.Plan, new: PR.Plan, tg: PR.Topology) -> float:
    """The least time of the plan kernel's work for a drift replan: every
    alpha of the grid re-deciding the queue from the first changed
    position, reading each table row it needs once (the predecessors'
    processors as the new plan places them) and writing each decision's
    processor and times and each message's interval once."""
    g, s = new.graph, new.schedule
    tail = new.queue[clean_prefix(prev, new):]
    A = int(round(PR.ALPHA_MAX / PR.ALPHA_STEP)) + 1
    P = tg.P
    R = max(len(r) for r in tg.routes.values())
    H = max(len(x) for r in tg.routes.values() for x in r)
    K = max([1] + [len(g.pred[j]) for j in range(g.n)])
    pairs = {(i, j, int(s.proc[i])) for j in tail for i in g.pred[j]}
    srcs = {int(s.proc[i]) for j in tail for i in g.pred[j]}
    edges = sum(len(g.pred[j]) for j in tail)
    moved = table_bytes(P, R, H, len(pairs), len(srcs), len(set(tail))) \
        + A * (len(tail) * (4 + 8 + 8) + edges * 16)
    ops = decision_ops(A * len(tail), P, K, R, H)
    return bound(moved, ops)[0]


def answers_of(h: torch.Tensor, head: torch.Tensor, queries: List[str],
               fp8: bool = False, block: int = 16):
    """Answers computed from hidden states ``h (S, T, D)`` the way the
    queries compute them from the program's logits (the control's)."""
    from .reference.common import Linear
    mm = Linear(fp8)
    S, T, _ = h.shape
    served = np.zeros((S, T), dtype=np.int64)
    conf = np.zeros((S, T, 1), dtype=np.float32)
    vals = np.zeros((S, T, 5), dtype=np.float32)
    idx = np.zeros((S, T, 5), dtype=np.float32)
    for t0 in range(0, T, block):
        lg = mm(h[:, t0:t0 + block], head.t())
        served[:, t0:t0 + block] = lg.argmax(-1).cpu().numpy()
        conf[:, t0:t0 + block, 0] = torch.softmax(lg, -1).max(-1).values \
            .cpu().numpy()
        top = torch.topk(lg, 5)
        vals[:, t0:t0 + block] = top.values.cpu().numpy()
        idx[:, t0:t0 + block] = top.indices.cpu().numpy()
    per_query = {}
    for q in queries:
        if Q.kind_of(q) == "argmax_conf":
            per_query[q] = [[conf[:, t]] for t in range(T)]
        else:
            per_query[q] = [[vals[:, t], idx[:, t]] for t in range(T)]
    return served, per_query


def sample_errors(h: torch.Tensor, head: torch.Tensor, served: np.ndarray,
                  per_query: Dict[str, list], block: int = 16
                  ) -> Dict[str, np.ndarray]:
    """Against the reference's logits ``h @ head.T``, each compared answer
    (stream, step): the gap by which the served token's logit lies below
    the reference's best (``token_gap``), the widest gap between a
    reported top-5 logit and the reference's logit of that token
    (``top5_error``), and the relative error of the reported top-token
    confidence against the reference's softmax (``conf_rel_error``),
    each the widest over the queries that report it; (S, T) each."""
    S, T, _ = h.shape
    head = head.to(h.dtype)
    dev = h.device
    out = {k: np.zeros((S, T)) for k in ("token_gap", "top5_error",
                                          "conf_rel_error")}
    for t0 in range(0, T, block):
        t1 = min(T, t0 + block)
        lg = h[:, t0:t1] @ head.t()                      # (S, b, V)
        best = lg.max(-1).values
        st = torch.as_tensor(served[:, t0:t1], device=dev)
        out["token_gap"][:, t0:t1] = (
            best - lg.gather(-1, st[..., None])[..., 0]).cpu().numpy()
        pmax = None
        for q, steps in per_query.items():
            parts = steps[t0:t1]
            if Q.kind_of(q) == "argmax_conf":
                if pmax is None:
                    pmax = torch.softmax(lg, -1).max(-1).values
                got = torch.as_tensor(np.stack([p[0][:, 0] for p in parts],
                                               axis=1), device=dev,
                                      dtype=h.dtype)
                err, key = (got - pmax).abs() / pmax, "conf_rel_error"
            else:
                v = torch.as_tensor(np.stack([p[0] for p in parts], axis=1),
                                    device=dev, dtype=h.dtype)
                i = torch.as_tensor(np.stack([p[1] for p in parts], axis=1),
                                    device=dev).long()
                err = (v - lg.gather(-1, i)).abs().max(-1).values
                key = "top5_error"
            np.maximum(out[key][:, t0:t1], err.cpu().numpy(),
                       out=out[key][:, t0:t1])
    return out


def compare_logits(h: torch.Tensor, head: torch.Tensor, served: np.ndarray,
                   per_query: Dict[str, list]) -> Dict[str, float]:
    """The widest of each of :func:`sample_errors`' numbers over every
    compared answer: one wrong answer of one stream at one step sets
    it."""
    errs = sample_errors(h, head, served, per_query)
    return {k: float(v.max()) for k, v in errs.items()}


def refinements_wrong(per_query: Dict[str, list], precise: list,
                      queries: List[str]) -> int:
    """Answers whose refinement is wrong: a query that ran it must give
    its 5 values sorted descending, one that did not must give none."""
    bad = 0
    for qi, q in enumerate(queries):
        if Q.kind_of(q) != "topk":
            continue
        for t, parts in enumerate(per_query[q]):
            ran = precise[t][qi]
            if ran != (len(parts) == 3):
                bad += 1
            elif ran and not np.array_equal(
                    parts[2], -np.sort(-parts[0], axis=-1)):
                bad += 1
    return bad
