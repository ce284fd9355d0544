#!/usr/bin/env python3
"""The CPU sides of ``chip_smoke.py``'s two f64 holds, as stand-ins run by
children pinned to the host's CPUs one by one: to tell a CPU of the host
that computes another value from a condition of the software chosen per
process.

    python3 tools/cpu_sweep.py [--children N] [--olmoe-runs N]
                               [--qwen2-runs N] [--group-olmoe-runs N]
                               [--hashseeds K] [--setarch N]
                               [--phases PHASE,...]
                               [--record] [--reduced] [--out PATH]

The stand-ins:

- **olmoe**: the embedding and layer 0's attention of olmoe-1b-7b at full
  width (d 2048, 16 heads of 128, q/k norms, RoPE, the core, ``wo``) on
  the seed-1 masters as ``chip_smoke.moe_card_vs_cpu`` draws them
  (``cut_params``, on the card) cast to f64, and the tokens of
  ``decode_tokens``.  A run digests the stages ``chip_smoke.moe_cpu_run``
  digests there (the tokens, the embedding, each of layer 0's attention
  stages), after its own leaves (``leaves``).  Its leaves (the
  embedding's rows for the tokens, since a gather copies them exactly,
  layer 0's ``norm1`` and attention: about 130 MB of f64) and the f32
  masters are saved once under ``build/cpu_sweep/``.  After its runs a
  child runs the whole 2-layer forward once (``whole``: the masters, the
  tokens and every stage of ``M.forward``, as ``moe_cpu_run`` digests
  them, and the hash of its logits as ``tools/moe_f64_probe.py`` hashes
  them, matched by value against the hashes seen before, ``KNOWN``).
- **qwen2**: one f64 train step of the mesh hold's staged case
  (``chip_smoke.mesh_cpu_step``: qwen2-0.5b at full width cut to 2
  layers, batch 4 x 256) with its stage digests, unsharded, in one
  process.

The phases (``--phases``, all by default, in this order), each child a
fresh process:

- ``pinning``: whether the host honours a CPU set: one child times a
  fixed busy loop alone, then four children pinned to one CPU time it
  together (a ratio near 4 where it does, near 1 where it does not).
- ``single``: each logical CPU of this process, ``--children`` children
  pinned to it (``os.sched_setaffinity``) at one thread, which together
  run ``--olmoe-runs`` olmoe stand-ins (and one whole forward each) and
  ``--qwen2-runs`` qwen2 stand-ins a CPU; children run concurrently, as
  many as the host's free memory allows.
- ``groups``: each core group the host names (each L3 domain, each NUMA
  node, each core's SMT siblings, read from
  ``/sys/devices/system/{cpu,node}``; all of this process's CPUs where it
  names none), one child pinned to it at the holds' thread counts
  (olmoe ``chip_smoke.MOE_CPU_THREADS``, qwen2
  ``chip_smoke.MESH_CPU_THREADS``), the groups one at a time.
- ``hashseed``: ``--hashseeds`` children with ``PYTHONHASHSEED`` 0..K-1,
  unpinned, at the holds' thread counts, one at a time, as a hold's CPU
  side runs; every tenth also runs the qwen2 stand-in.
- ``setarch``: ``--setarch`` children under ``setarch -R`` (the child's
  own address layout, not randomised), where the container allows it;
  where it refuses, the line says so.

It prints one JSON line a child; then one a CPU or group (its digests,
with counts) and one a digest (the children that gave it).  A digest is
usual where it is its stand-in's most common at its thread count.  For
each other digest a ``parted`` line gives the first stage at which its
stages part from the usual ones, the first element that differs there
and the XOR of the two elements' words (``oplog.bit_parting``), and the
signature: one flipped bit in one element marks the host, many bits or
many elements a path of the software.  With ``--record`` the condition
of each parted child is run again under ``OpLog`` beside a usual one, and
``first_parting`` names the op.  The first line gives the host (CPU
model, logical CPUs, a hash of its name, the card's name and power
limit), the last the counts.  Lines go also to ``--out`` (default
``chiprun_out/cpu_sweep.jsonl``).  ``--reduced`` runs both stand-ins at
reduced widths on CPU-drawn masters (a rehearsal; its digests are not
the card host's).  Its children import the port, which makes each
vector-math function's first call on one thread
(``layers.first_calls_on_one_thread``; ``tools/vml_first_call.py`` holds
first calls without it).  The summary holds the usual whole forward's
stages at
``MOE_CPU_THREADS`` against ``chip_smoke.MOE_CPU_USUAL_STAGES``
(``whole_vs_usual_table``).  It changes no setting of the machine: it
only reads ``/sys`` and ``/proc``.
"""
import argparse
import dataclasses
import gzip
import hashlib
import json
import os
import platform
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.launch.oplog import (OpLog, Stages,  # noqa: E402
                                      bit_parting, cpu_conditions,
                                      cpu_model, cpulist, first_parting,
                                      joined, parse_cpulist, parted_stage)
from repro_torch.models import (init_params, tree_leaves,  # noqa: E402
                                tree_map)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

WORK = ROOT / "build" / "cpu_sweep"
OLMOE, QWEN2 = "olmoe-1b-7b", "qwen2-0.5b"
N_LAYERS, BATCH, TOKENS = 2, 4, 16
KEEP = 1 << 22          # a stage's tensors are kept up to this many elements
MEMORY_SHARE = 0.75     # of the host's free memory, for children at once
# the olmoe forward's logits hashed as tools/moe_f64_probe.py hashes them
# (the card machine's host, torch 2.11.0+cu128, 8 threads): the usual
# hash and the second one (4 of 321 fresh processes before the port made
# its vector-math first calls on one thread)
KNOWN = {"3bb6365f80c9e295": "usual",
         "135a97a6aeee031c": "second"}
WHATS = ("olmoe", "whole", "qwen2")


def _chip_smoke():
    import chip_smoke as C
    return C


# ------------------------------------------------------------ the stand-ins
def olmoe_config(reduced: bool):
    cfg = dataclasses.replace(get_arch(OLMOE), n_layers=N_LAYERS)
    if reduced:
        cfg = dataclasses.replace(reduced_config(cfg), n_layers=N_LAYERS)
    return cfg


def qwen2_case(reduced: bool):
    C = _chip_smoke()
    if not reduced:
        return C.mesh_cpu_case(QWEN2)
    cfg = dataclasses.replace(reduced_config(get_arch(QWEN2)),
                              dtype="float64")
    return cfg, C.SyntheticTokenPipeline(cfg, C.ShapeConfig(
        "t", 32, 4, "train"))


def olmoe_leaves(cfg, masters, toks) -> dict:
    """The stand-in's leaves from the f32 ``masters``, cast to f64 as the
    hold casts them (elementwise, so a part casts as the whole does): the
    embedding's rows of the tokens (``rows``, and ``at``, each token's row
    among them), layer 0's ``norm1`` and attention."""
    uniq, at = torch.unique(toks, return_inverse=True)
    layer = M.layer_params(masters["blocks"], cfg.n_layers)[0]
    sub = {"rows": masters["embed"][uniq], "norm1": layer["norm1"],
           "attn": layer["attn"]}
    sub = tree_map(lambda a: a.clone(), M._cast(sub, torch.float64))
    return {"tokens": toks, "at": at, **sub}


def olmoe_standin(cfg, leaves: dict, stages: Stages) -> torch.Tensor:
    """The embedding and layer 0's attention of the olmoe forward on
    ``leaves`` (:func:`olmoe_leaves`), each stage digested into
    ``stages`` as ``chip_smoke.moe_cpu_run`` digests it; returns the
    attention's output (``layer 0 attn``)."""
    c = dataclasses.replace(cfg, dtype="float64")
    stages("leaves", [leaves["rows"], leaves["norm1"]]
           + [leaves["attn"][k] for k in sorted(leaves["attn"])])
    stages("tokens", leaves["tokens"])
    with stages:
        x = L.tap("embed", M._embed_tokens(c, {"embed": leaves["rows"]},
                                           {"tokens": leaves["at"]}))
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32).expand(B, S)
        h, _ = L.attention(c, leaves["attn"],
                           L.rms_norm(x, leaves["norm1"], c.norm_eps),
                           positions)
        return L.tap("attn", h)


def olmoe_whole(cfg, masters, toks, stages: Stages) -> torch.Tensor:
    """The whole olmoe forward in f64 on the f32 ``masters``, its stages
    digested as ``chip_smoke.moe_cpu_run`` digests the forward's (the
    masters as cast, the tokens, every stage of ``M.forward``)."""
    c = dataclasses.replace(cfg, dtype="float64")
    params = M._cast(masters, torch.float64)
    stages("masters", tree_leaves(params))
    stages("tokens", toks)
    with stages:
        return M.forward(c, params, {"tokens": toks})


def qwen2_standin(cfg, pipe, stages: Stages):
    """``chip_smoke.mesh_cpu_step`` without a mesh, digested into
    ``stages``."""
    with stages:
        return _chip_smoke().mesh_cpu_step(cfg, pipe, stages)


class Flip(Stages):
    """``Stages`` that flips bit ``bit`` of element ``element`` (flat) of
    stage ``stage``'s first tensor, in place, before it is digested: the
    computation goes on from the changed value."""

    def __init__(self, stage: str, element: int, bit: int, **kw) -> None:
        super().__init__(**kw)
        self.stage, self.element, self.bit = stage, element, bit

    def __call__(self, label, tensors):
        if label == self.stage:
            t = tensors if isinstance(tensors, torch.Tensor) else tensors[0]
            words = t.detach().view(-1).view(torch.int64)
            mask = 1 << self.bit
            words[self.element] ^= mask - (1 << 64) * (self.bit == 63)
        super().__call__(label, tensors)


# ------------------------------------------------------------ a child
def child(spec: dict) -> dict:
    """One child of the sweep, as ``spec`` says: its CPU set and thread
    counts, its runs of each stand-in, a planted flip or a record.  Each
    stand-in's digests are counted; the kept tensors of each digest's
    first run go to ``<work>/<name>.<what>.<digest>.pt``."""
    if spec.get("cpus") is not None:
        os.sched_setaffinity(0, spec["cpus"])
    work, name = Path(spec["work"]), spec["name"]
    reduced = spec.get("reduced", False)
    plant = spec.get("plant") or {}
    out = {"name": name, "phase": spec.get("phase"), "cpus": spec.get("cpus"),
           "hashseed": os.environ.get("PYTHONHASHSEED"),
           "setarch": spec.get("setarch", False)}
    t0 = time.perf_counter()
    if spec.get("busy"):
        torch.set_num_threads(1)
        a = torch.ones(256, 256, dtype=torch.float64)
        t1 = time.perf_counter()
        for _ in range(spec["busy"]):
            a = (a @ a) / 256.0
        out["busy_s"] = time.perf_counter() - t1
        out["conditions"] = cpu_conditions()
        return out

    def counted(what, threads, runs, fn):
        torch.set_num_threads(threads)
        seen, t1 = {}, time.perf_counter()
        for i in range(runs):
            flip = plant.get("what") == what and plant.get("run", 0) == i
            stages = Flip(plant["stage"], plant["element"], plant["bit"],
                          keep=KEEP) if flip else Stages(keep=KEEP)
            record = spec.get("record") == what and i == 0
            if record:
                with OpLog() as log:
                    got = fn(stages)
                with gzip.open(work / f"{name}.ops.json.gz", "wt") as f:
                    json.dump(log.rows, f)
            else:
                got = fn(stages)
            d = joined([r[1] for r in stages.rows])
            if d not in seen:
                seen[d] = {"runs": 0, "first_run": i, "rows": stages.rows}
                if what == "whole":
                    seen[d]["forward"] = _sha16(got)
                torch.save(stages.kept, work / f"{name}.{what}.{d}.pt")
            seen[d]["runs"] += 1
            del got, stages
        out[what] = {"threads": threads, "runs": runs, "digests": seen,
                     "seconds": time.perf_counter() - t1,
                     "conditions": cpu_conditions()}

    cfg = olmoe_config(reduced)
    if spec.get("olmoe_runs"):
        leaves = torch.load(work / "olmoe_standin.pt")
        counted("olmoe", spec["olmoe_threads"], spec["olmoe_runs"],
                lambda s: olmoe_standin(cfg, leaves, s))
        del leaves
    if spec.get("whole"):
        masters = torch.load(work / "olmoe_masters.pt", mmap=True)
        toks = torch.load(work / "olmoe_standin.pt")["tokens"]
        counted("whole", spec["olmoe_threads"], 1,
                lambda s: olmoe_whole(cfg, masters, toks, s))
        del masters
    if spec.get("qwen2_runs"):
        qcfg, pipe = qwen2_case(reduced)
        counted("qwen2", spec["qwen2_threads"], spec["qwen2_runs"],
                lambda s: qwen2_standin(qcfg, pipe, s)[0])
    out["seconds"] = time.perf_counter() - t0
    out["max_rss_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    out["conditions"] = cpu_conditions()
    return out


def _sha16(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:16]


# ------------------------------------------------------------ the host
def host() -> dict:
    """The host: its CPU model, logical CPUs (this process's CPU set and
    the machine's), a hash of its name, torch, the card's name and power
    limit (``nvidia-smi``), and its free memory."""
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    except FileNotFoundError:
        card = "no nvidia-smi"
    return {"cpu_model": cpu_model(), "logical_cpus": os.cpu_count(),
            "affinity": cpulist(os.sched_getaffinity(0)),
            "capability": torch.backends.cpu.get_cpu_capability(),
            "host_hash": hashlib.sha256(
                platform.node().encode()).hexdigest()[:16],
            "torch": torch.__version__, "threads": torch.get_num_threads(),
            "card": card, "mem_available_gb": mem_available_gb()}


def mem_available_gb() -> float:
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) / 2 ** 20
    return 0.0


def core_groups(cpus) -> dict:
    """The core groups the host names among ``cpus``: each L3 domain,
    each NUMA node and each core's SMT siblings, as CPU lists, each set
    once under every name that gives it; ``{"all": cpus}`` where the host
    names none."""
    sysfs = Path("/sys/devices/system")

    def read(path):
        try:
            return frozenset(parse_cpulist(path.read_text())) & cpus
        except OSError:
            return None

    named = {}

    def name(group, kind):
        if group:
            named.setdefault(group, set()).add(
                kind if kind.startswith("node") else
                f"{kind} {cpulist(group)}")

    for c in sorted(cpus):
        d = sysfs / "cpu" / f"cpu{c}"
        for idx in sorted(d.glob("cache/index*")):
            try:
                level = (idx / "level").read_text().strip()
            except OSError:
                continue
            if level == "3":
                name(read(idx / "shared_cpu_list"), "l3")
        name(read(d / "topology" / "thread_siblings_list"), "core")
    for node in sorted(sysfs.glob("node/node[0-9]*")):
        name(read(node / "cpulist"), node.name)
    if not named:
        return {"all": sorted(cpus)}
    return {" / ".join(sorted(names)): sorted(g)
            for g, names in named.items()}


def setarch_allowed() -> dict:
    """Whether ``setarch -R`` may set a child's personality here."""
    try:
        r = subprocess.run(["setarch", platform.machine(), "-R", "true"],
                           capture_output=True, text=True)
    except FileNotFoundError:
        return {"allowed": False, "why": "no setarch"}
    return {"allowed": r.returncode == 0, "rc": r.returncode,
            "why": r.stderr.strip()[-300:]}


# ------------------------------------------------------------ the parent
def prepare(work: Path, reduced: bool) -> dict:
    """The olmoe leaves and masters, saved once under ``work``: drawn on
    the card where there is one (and not ``reduced``), else on the
    CPU."""
    work.mkdir(parents=True, exist_ok=True)
    cfg = olmoe_config(reduced)
    if torch.cuda.is_available() and not reduced:
        C = _chip_smoke()
        masters = tree_map(lambda a: a.cpu(), C.cut_params(cfg, 1))
        toks, drawn = C.decode_tokens(cfg).cpu(), "card"
        torch.cuda.empty_cache()
    else:
        masters = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab, (BATCH, TOKENS)))
        drawn = "cpu"
    torch.save(masters, work / "olmoe_masters.pt")
    leaves = olmoe_leaves(cfg, masters, toks)
    torch.save(leaves, work / "olmoe_standin.pt")
    return {"drawn_on": drawn, "d_model": cfg.d_model,
            "standin_mb": sum(a.numel() * a.element_size()
                              for a in tree_leaves(leaves)) / 2 ** 20,
            "masters_mb": sum(a.numel() * a.element_size()
                              for a in tree_leaves(masters)) / 2 ** 20}


class Sweep:
    """Runs children working in ``work``, keeps their lines and writes
    them out.  Children run together while the most memory any child
    has taken so far (at first ``need_gb``) fits ``MEMORY_SHARE`` of the
    memory that was free when the sweep began."""

    def __init__(self, work: Path, out: Path, reduced: bool = False,
                 record: bool = False, need_gb: float = 12.0) -> None:
        self.work, self.out = work, out
        self.reduced, self.record = reduced, record
        self.children, self.rss_gb, self.measured = [], need_gb, False
        self.budget_gb = mem_available_gb() * MEMORY_SHARE
        work.mkdir(parents=True, exist_ok=True)
        out.parent.mkdir(parents=True, exist_ok=True)

    def emit(self, obj) -> None:
        line = json.dumps(obj)
        print(line, flush=True)
        with self.out.open("a") as f:
            f.write(line + "\n")

    def command(self, spec: dict):
        path = self.work / f"{spec['name']}.spec.json"
        path.write_text(json.dumps(spec))
        cmd = [sys.executable, str(Path(__file__).resolve()), "--child",
               str(path)]
        if spec.get("setarch"):
            cmd = ["setarch", platform.machine(), "-R"] + cmd
        env = dict(os.environ)
        env.pop("PYTHONHASHSEED", None)
        if spec.get("hashseed") is not None:
            env["PYTHONHASHSEED"] = str(spec["hashseed"])
        return cmd, env

    def run(self, specs: list, at_once: int) -> list:
        """``specs`` as children, at most ``at_once`` together and as many
        as the memory allows; their lines, in order."""
        got, queue, live = [], list(specs), []
        while queue or live:
            fits = max(1, int(self.budget_gb // self.rss_gb))
            while queue and len(live) < min(at_once, fits):
                spec = {"work": str(self.work), "reduced": self.reduced,
                        **queue.pop(0)}
                cmd, env = self.command(spec)
                live.append((spec, subprocess.Popen(
                    cmd, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True)))
            spec, proc = live.pop(0)
            stdout, stderr = proc.communicate()
            lines = stdout.strip().splitlines()
            rec = json.loads(lines[-1]) if proc.returncode == 0 and lines \
                else {"name": spec["name"], "phase": spec.get("phase"),
                      "failed": proc.returncode, "stderr": stderr[-3000:]}
            rec["spec"] = {k: v for k, v in spec.items()
                           if k not in ("work", "reduced")}
            if "max_rss_gb" in rec and not rec.get("busy_s"):
                self.rss_gb = max(self.rss_gb if self.measured else 0.0,
                                  rec["max_rss_gb"])
                self.measured = True
            self.children.append(rec)
            self.emit({"sweep": "child", **_brief(rec)})
            got.append(rec)
        return got


def _brief(rec: dict) -> dict:
    """A child's line: its digests with counts, not their stage rows."""
    out = {k: v for k, v in rec.items() if k not in WHATS}
    for what in WHATS:
        if what in rec:
            r = rec[what]
            out[what] = {"threads": r["threads"], "seconds": r["seconds"],
                         "conditions": r["conditions"],
                         "digests": {d: {k: v for k, v in x.items()
                                         if k != "rows"}
                                     for d, x in r["digests"].items()}}
    return out


def usual_digests(children: list) -> dict:
    """The most common digest of each stand-in at each thread count, by
    runs, and its stage rows: ``{(what, threads): (digest, rows, child
    name)}``."""
    runs, rows = {}, {}
    for rec in children:
        for what in WHATS:
            if what not in rec:
                continue
            key = (what, rec[what]["threads"])
            for d, x in rec[what]["digests"].items():
                runs.setdefault(key, {})
                runs[key][d] = runs[key].get(d, 0) + x["runs"]
                rows.setdefault((key, d), (x["rows"], rec["name"]))
    return {key: (max(c, key=c.get), *rows[key, max(c, key=c.get)])
            for key, c in runs.items()}


def signature(bits) -> str:
    if bits is None:
        return "not kept"
    if bits["elements_differing"] == 1 and bits["most_bits"] == 1:
        return "one bit in one element: the host"
    return "several elements or bits: a path of the software"


def analyse(sweep: Sweep) -> dict:
    """The per-CPU and per-digest lines, and a ``parted`` line for each
    digest other than its condition's usual one; the counts."""
    children = [r for r in sweep.children if "failed" not in r
                and "busy_s" not in r]
    usual = usual_digests(children)
    where, per_cpu, parted = {}, {}, []
    for rec in children:
        label = _where(rec)
        for what in WHATS:
            if what not in rec:
                continue
            threads = rec[what]["threads"]
            cell = per_cpu.setdefault(label, {})
            for d, x in rec[what]["digests"].items():
                cell.setdefault(what, {})
                cell[what][d] = cell[what].get(d, 0) + x["runs"]
                w = where.setdefault((what, threads, d), {
                    "runs": 0, "where": [], "forward": x.get("forward")})
                w["runs"] += x["runs"]
                w["where"].append(label)
                if d != usual[what, threads][0]:
                    parted.append((rec, what, threads, d, x))
    for label, cell in per_cpu.items():
        sweep.emit({"sweep": "cpu", "where": label, **cell})
    for (what, threads, d), w in where.items():
        line = {"sweep": "digest", "what": what, "threads": threads,
                "digest": d, "usual": d == usual[what, threads][0],
                "runs": w["runs"], "children": len(w["where"]),
                "where": sorted(set(w["where"]))}
        if w["forward"]:
            line["forward"] = w["forward"]
            line["forward_known"] = KNOWN.get(w["forward"])
        sweep.emit(line)
    reports = []
    for rec, what, threads, d, x in parted:
        u, urows, uname = usual[what, threads]
        stage = parted_stage(x["rows"], urows)
        bits = None
        if stage.get("stage") is not None:
            mine = torch.load(sweep.work / f"{rec['name']}.{what}.{d}.pt")
            theirs = torch.load(sweep.work / f"{uname}.{what}.{u}.pt")
            if stage["stage"] in mine and stage["stage"] in theirs:
                bits = bit_parting(mine[stage["stage"]],
                                   theirs[stage["stage"]])
        report = {"sweep": "parted", "what": what, "threads": threads,
                  "digest": d, "usual": u, "child": rec["name"],
                  "where": _where(rec), "run": x["first_run"],
                  "runs": x["runs"], "stage": stage, "element": bits,
                  "signature": signature(bits)}
        if sweep.record:
            report["parting"] = rerun_recorded(sweep, rec, uname, what)
        sweep.emit(report)
        reports.append(report)
    C = _chip_smoke()
    table = C.MOE_CPU_USUAL_STAGES.get(C.usual_key(C.MOE_CPU_THREADS))
    whole = usual.get(("whole", C.MOE_CPU_THREADS))
    return {"usual": {f"{w} threads {t}": v[0]
                      for (w, t), v in usual.items()},
            "whole_vs_usual_table": None if table is None or whole is None
            or sweep.reduced else parted_stage(whole[1], table),
            "second_digests": len(reports), "reports": reports}


def _where(rec: dict) -> str:
    spec = rec.get("spec", {})
    if spec.get("phase") == "single":
        return f"cpu {cpulist(spec['cpus'])}"
    if spec.get("phase") == "groups":
        return f"group {spec['group']} ({cpulist(spec['cpus'])})"
    if spec.get("phase") == "hashseed":
        return f"hashseed {spec['hashseed']}"
    return f"{spec.get('phase')} {rec['name']}"


def rerun_recorded(sweep: Sweep, rec: dict, uname: str, what: str) -> dict:
    """The parted child's condition and a usual child's, each run once
    more under ``OpLog`` (``what`` only); ``first_parting`` between the
    two records, and the reruns' digests."""
    usual = next(r for r in sweep.children if r["name"] == uname)
    specs = []
    for tag, r in (("usual", usual), ("parted", rec)):
        spec = {k: v for k, v in r["spec"].items()
                if k not in ("olmoe_runs", "whole", "qwen2_runs")}
        spec.update(name=f"record_{tag}_{r['name']}", phase="record",
                    record=what, olmoe_runs=int(what == "olmoe"),
                    whole=what == "whole", qwen2_runs=int(what == "qwen2"))
        specs.append(spec)
    got = sweep.run(specs, at_once=1)
    if any("failed" in g for g in got):
        return {"failed": [g.get("stderr") for g in got]}
    rows = []
    for spec in specs:
        with gzip.open(sweep.work / f"{spec['name']}.ops.json.gz",
                       "rt") as f:
            rows.append(json.load(f))
    return {"digests": [list(g[what]["digests"]) for g in got],
            "first_parting": first_parting(*rows)}


def pinning(sweep: Sweep, cpus: list, loops: int) -> dict:
    """The busy loop alone, then in four children pinned to one CPU."""
    one = sweep.run([{"name": "pin_alone", "phase": "pinning",
                      "cpus": [cpus[0]], "busy": loops}], 1)[0]
    four = sweep.run([{"name": f"pin_shared_{k}", "phase": "pinning",
                       "cpus": [cpus[0]], "busy": loops}
                      for k in range(4)], 4)
    shared = max(r.get("busy_s", 0.0) for r in four)
    ratio = shared / one["busy_s"] if one.get("busy_s") else None
    out = {"sweep": "pinning", "cpu": cpus[0], "alone_s": one.get("busy_s"),
           "four_on_one_cpu_s": shared, "ratio": ratio,
           "honoured": ratio is not None and ratio > 2.0,
           "last_cpus": [r["conditions"]["last_cpu"] for r in [one] + four
                         if "conditions" in r]}
    sweep.emit(out)
    return out


def main() -> int:
    if "--child" in sys.argv:
        spec = json.loads(Path(sys.argv[sys.argv.index("--child")
                                        + 1]).read_text())
        print(json.dumps(child(spec)), flush=True)
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="pinning,single,groups,hashseed,setarch")
    ap.add_argument("--children", type=int, default=5,
                    help="children a CPU in the single phase")
    ap.add_argument("--olmoe-runs", type=int, default=200,
                    help="olmoe stand-in runs a CPU in the single phase")
    ap.add_argument("--qwen2-runs", type=int, default=5,
                    help="qwen2 stand-in runs a CPU in the single phase")
    ap.add_argument("--group-olmoe-runs", type=int, default=200)
    ap.add_argument("--group-qwen2-runs", type=int, default=2)
    ap.add_argument("--hashseeds", type=int, default=50)
    ap.add_argument("--hashseed-olmoe-runs", type=int, default=20)
    ap.add_argument("--setarch", type=int, default=8)
    ap.add_argument("--busy-loops", type=int, default=2000)
    ap.add_argument("--cpus", default=None,
                    help="a CPU list (default: this process's CPU set)")
    ap.add_argument("--record", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "cpu_sweep.jsonl"))
    args = ap.parse_args()
    phases = args.phases.split(",")
    C = _chip_smoke()
    t0 = time.perf_counter()
    sweep = Sweep(WORK, Path(args.out), args.reduced, args.record,
                  need_gb=0.5 if args.reduced else 12.0)
    cpus = parse_cpulist(args.cpus) if args.cpus \
        else sorted(os.sched_getaffinity(0))
    groups = core_groups(frozenset(cpus))
    arch = setarch_allowed()
    sweep.emit({"sweep": "host", **host(), "cpus": cpulist(cpus),
                "groups": {k: cpulist(v) for k, v in groups.items()},
                "setarch": arch, "args": vars(args)})
    sweep.emit({"sweep": "prepared", **prepare(WORK, args.reduced)})
    usual_threads = {"olmoe_threads": C.MOE_CPU_THREADS,
                     "qwen2_threads": C.MESH_CPU_THREADS}
    if "pinning" in phases:
        pinning(sweep, cpus, args.busy_loops)
    if "single" in phases:
        specs = []
        for k in range(args.children):
            for c in cpus:
                share = lambda n: n // args.children + (  # noqa: E731
                    k < n % args.children)
                specs.append({"name": f"cpu{c}_{k}", "phase": "single",
                              "cpus": [c], "olmoe_threads": 1,
                              "qwen2_threads": 1,
                              "olmoe_runs": share(args.olmoe_runs),
                              "whole": True,
                              "qwen2_runs": share(args.qwen2_runs)})
        sweep.run(specs, at_once=len(cpus))
    if "groups" in phases:
        for g, members in groups.items():
            sweep.run([{"name": "group_" + "_".join(g.split()).replace(
                "/", ""), "phase": "groups", "group": g, "cpus": members,
                "olmoe_runs": args.group_olmoe_runs, "whole": True,
                "qwen2_runs": args.group_qwen2_runs, **usual_threads}], 1)
    if "hashseed" in phases:
        sweep.run([{"name": f"hashseed{k}", "phase": "hashseed",
                    "hashseed": k, "olmoe_runs": args.hashseed_olmoe_runs,
                    "whole": True, "qwen2_runs": int(k % 10 == 0),
                    **usual_threads} for k in range(args.hashseeds)], 1)
    if "setarch" in phases:
        if arch["allowed"]:
            sweep.run([{"name": f"setarch{k}", "phase": "setarch",
                        "setarch": True,
                        "olmoe_runs": args.hashseed_olmoe_runs,
                        "whole": True, "qwen2_runs": 0, **usual_threads}
                       for k in range(args.setarch)], 1)
        else:
            sweep.emit({"sweep": "setarch", "refused": arch})
    found = analyse(sweep)
    failed = [r["name"] for r in sweep.children if "failed" in r]
    counts = {}
    for rec in sweep.children:
        for what in WHATS:
            if what in rec:
                key = f"{rec['spec'].get('phase')} {what}"
                counts[key] = counts.get(key, 0) + rec[what]["runs"]
    phase_children = {}
    for rec in sweep.children:
        p = rec["spec"].get("phase")
        phase_children[p] = phase_children.get(p, 0) + 1
    sweep.emit({"sweep": "summary", "children": phase_children,
                "runs": counts, "failed": failed,
                "usual": found["usual"],
                "whole_vs_usual_table": found["whole_vs_usual_table"],
                "second_digests": found["second_digests"],
                "seconds": time.perf_counter() - t0})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
