"""A record of every local aten op a process runs, to tell two runs of one
computation apart op by op: which op parts first, whether what fed it
agreed, and by how much its outputs differ.

:class:`OpLog` is a dispatch mode below DTensor (an op on DTensors is
left to DTensor, which runs it on the rank's shards, and those come
here).  It keeps one row an op::

    [index, "namespace.op", site, input shapes, output shapes and dtypes,
     inputs, output digests, flags, output stats]

- ``site``: the innermost line outside torch and the standard library
  (the model's, the step's, the caller's), with the autograd node
  running (a backward's only trace).
- ``inputs``: for each input tensor, the index of the op that last wrote
  its storage, or ``["outside", digest]`` where no recorded op did.  Two
  runs whose ops agree up to op i and whose op i was fed by the same ops
  had equal inputs there.
- ``output digests``: a 64-bit hash of each output's bytes (a weighted
  sum of its words, modulo 2**64, with odd weights: any one changed
  word changes it).  None for a view (it restates its storage, which may
  not be written yet), for a new empty tensor and for a collective's
  result before it is waited on.
- ``stats``: for each floating output, its sum in float64 and its
  largest magnitude, so that the first op that parts also gives the
  size of the difference.
- ``flags``: ``view``; ``reads_pending`` / ``writes_pending`` (with the
  collective's index) for an op that reads a collective's result before
  its ``wait_tensor``, or writes a collective's input before then;
  ``thread`` for an op off the recording thread; ``nan_out`` for an op
  that wrote NaN.

The recorder only reads: its own reductions run with the mode off, in
scratch buffers of its own.  :attr:`OpLog.seconds` is the time they took.
:func:`first_parting` compares two records of one computation.

:class:`Stages` is the plain run's counterpart: no dispatch mode, only a
digest of the rank's own part of each stage the caller names (the
draw, the masters, the batch, the loss, each gradient) and of each
activation the model hands ``models.layers.tap`` (the embedding, each
layer's attention, router, MoE or MLP and output, the final norm, the
logits).  :func:`parted_stage` names the first stage at which two such
records part, :func:`bit_parting` the first element of a stage's kept
tensors at which they part, with the bits that differ there.
:func:`cpu_conditions` reads the conditions a process computes under:
its CPU set, the CPU it last ran on, its threads, its hash seed and the
CPU model.
"""
import hashlib
import math
import os
import sys
import sysconfig
import threading
import time
from pathlib import Path

import torch
from torch.distributed._functional_collectives import AsyncCollectiveTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, \
    _disable_current_modes

AROUND = 3          # ops shown before and after the first that parts
_NOT_SITES = (str(Path(torch.__file__).parent), sysconfig.get_paths()["stdlib"],
              __file__)


def _plain(t) -> bool:
    return type(t) is torch.Tensor and t.device.type == "cpu"


def _flat(x):
    if isinstance(x, (list, tuple)):
        for y in x:
            yield from _flat(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _flat(y)
    else:
        yield x


def _site() -> str:
    """The innermost caller's line outside torch, the standard library and
    this module, with the autograd node running."""
    node = torch._C._current_autograd_node()
    where, f = "", sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if not name.startswith(_NOT_SITES) and not name.startswith("<"):
            where = f"{Path(name).name}:{f.f_lineno} {f.f_code.co_name}"
            break
        f = f.f_back
    return f"{where} [{node.name()}]" if node is not None else where


class Digest:
    """A 64-bit hash of a tensor's bytes: its bytes read as 8-byte words
    (the last few bytes, where they do not fill a word, each widened) in
    rows of ``ROW``, each row's sum of word times an odd weight, then the
    rows' sum of row sum times an odd weight, all modulo 2**64.  Every
    word's weight is odd, so a change in any one word changes the hash.
    Computed with torch's own integer ops: the rows' sums in one
    matrix-vector product, which needs no scratch."""

    ROW = 1 << 14

    def __init__(self) -> None:
        g = torch.Generator().manual_seed(0x5EED)
        self.w = torch.randint(-(1 << 62), 1 << 62, (self.ROW,),
                               generator=g, dtype=torch.int64) | 1
        self.v = torch.empty(0, dtype=torch.int64)
        self.g = g

    def _row_weights(self, n: int) -> torch.Tensor:
        if self.v.numel() < n:
            more = torch.randint(-(1 << 62), 1 << 62, (n - self.v.numel(),),
                                 generator=self.g, dtype=torch.int64) | 1
            self.v = torch.cat([self.v, more])
        return self.v[:n]

    @staticmethod
    def _words(t: torch.Tensor):
        """``t``'s bytes as int64 words, and the bytes after the last
        whole word, each widened."""
        x = t.contiguous().reshape(-1)
        if x.storage_offset() * x.element_size() % 8:
            x = x.clone()
        b = x.view(torch.uint8)
        whole = b.numel() // 8 * 8
        return b[:whole].view(torch.int64), b[whole:].to(torch.int64)

    def __call__(self, t: torch.Tensor) -> int:
        t = t.detach()
        if t.is_conj() or t.is_neg():
            t = t.resolve_conj().resolve_neg()
        if t.is_complex():
            t = torch.view_as_real(t)
        x, rest = self._words(t)
        n = x.numel()
        rows = -(-n // self.ROW) + bool(rest.numel())
        sums = torch.empty(rows, dtype=torch.int64)
        full = n // self.ROW
        torch.mv(x[:full * self.ROW].view(full, self.ROW), self.w,
                 out=sums[:full])
        if full * self.ROW < n:
            tail = x[full * self.ROW:]
            sums[full] = (tail * self.w[:tail.numel()]).sum()
        if rest.numel():
            sums[-1] = (rest * self.w[:rest.numel()]).sum()
        return int((sums * self._row_weights(rows)).sum())


def stats(t: torch.Tensor):
    """``[sum in float64, largest magnitude]`` of a floating tensor (NaN
    where it holds NaN), else None."""
    if not t.is_floating_point() or t.numel() == 0:
        return None
    lo, hi = torch.aminmax(t.detach())
    return [float(t.detach().sum(dtype=torch.float64)),
            float(torch.maximum(lo.abs(), hi.abs()))]


class OpLog(TorchDispatchMode):
    """Every local aten op and every collective a process runs, one row
    each (the module's docstring gives the row).  A collective's result is
    pending until its ``wait_tensor``: it is not read for a digest before,
    and an op that reads or writes it, or writes a collective's input,
    before then is flagged."""

    COLLECTIVE = ("_c10d_functional", "c10d", "_dtensor")
    WRAPPERS = (DTensor, AsyncCollectiveTensor)
    NO_READ = ("wait_tensor", "_wrap_tensor_autograd")
    EMPTY = ("empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided")

    def __init__(self) -> None:
        super().__init__()
        self.rows = []
        self.seconds = 0.0
        self.digest = Digest()
        self.writer = {}            # storage -> index of the op that wrote it
        self.outside = {}           # storage -> digest, read but not written
        self.pending_out, self.pending_in = {}, {}
        self.thread = threading.get_ident()

    @staticmethod
    def _key(t) -> int:
        return t.untyped_storage().data_ptr()

    def _source(self, t):
        key = self._key(t)
        if key in self.writer:
            return self.writer[key]
        if key not in self.outside:
            self.outside[key] = self.digest(t) if t.numel() else 0
        return ["outside", self.outside[key]]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self.WRAPPERS) for t in types):
            return NotImplemented        # run on the shards: they come here
        if types:                        # fake tensors: shapes, no data
            return func(*args, **kwargs)
        ns, name = func.namespace, str(func.overloadpacket).split(".")[-1]
        outs_given = {id(v) for k, v in kwargs.items()
                      if k == "out" or k.startswith("out")}
        ins = [t for t in _flat((args, kwargs))
               if _plain(t) and id(t) not in outs_given]
        written = [a for a, s in zip(args, func._schema.arguments)
                   if s.alias_info is not None and s.alias_info.is_write
                   and _plain(a)]
        flags = {}
        keys = [self._key(t) for t in ins]
        if name not in self.NO_READ and not func.is_view:
            hit = [self.pending_out[k] for k in keys if k in self.pending_out]
            if hit:
                flags["reads_pending"] = hit[0]
            hit = [self.pending_in[self._key(t)] for t in written
                   if self._key(t) in self.pending_in]
            if hit:
                flags["writes_pending"] = hit[0]
        if func.is_view:
            flags["view"] = 1
        if threading.get_ident() != self.thread:
            flags["thread"] = threading.get_ident()
        t0 = time.perf_counter()
        sources = [self._source(t) for t in ins]
        self.seconds += time.perf_counter() - t0
        out = func(*args, **kwargs)
        t0 = time.perf_counter()
        outs = [t for t in _flat(out) if _plain(t)]
        seen = {id(t) for t in outs}
        outs += [t for t in written if id(t) not in seen]
        idx = len(self.rows)
        if ns in self.COLLECTIVE:
            if name == "wait_tensor":
                # a wait ends the collective whose result this is
                done = {self.pending_out.pop(k) for k in keys
                        if k in self.pending_out}
                self.pending_in = {k: v for k, v in self.pending_in.items()
                                   if v not in done}
            elif ns == "_c10d_functional" and name not in self.NO_READ:
                for t in outs:
                    self.pending_out[self._key(t)] = idx
                for t in ins:
                    self.pending_in[self._key(t)] = idx
        if func.is_view or name in self.EMPTY or (
                ns in self.COLLECTIVE and name != "wait_tensor"):
            digests, sizes = [None] * len(outs), [None] * len(outs)
        else:
            digests = [self.digest(t) if t.numel() else 0 for t in outs]
            sizes = [stats(t) for t in outs]
            if any(s is not None and math.isnan(s[1]) for s in sizes):
                flags["nan_out"] = 1
        if not func.is_view:
            for t in outs:
                self.writer[self._key(t)] = idx
                self.outside.pop(self._key(t), None)
        self.rows.append([
            idx, f"{ns}.{name}", _site(),
            [list(t.shape) for t in ins],
            [f"{list(t.shape)}{str(t.dtype)[6:]}" for t in outs],
            sources, digests, flags, sizes])
        self.seconds += time.perf_counter() - t0
        return out


def flag_summary(rows: list) -> dict:
    """Per flag, how many ops carry it, and the first ops (not views) that
    wrote NaN (with every new tensor NaN-filled: where memory that no op
    had written was read, or a buffer was left partly unwritten)."""
    out = {"nan_ops": []}
    for r in rows:
        for k in r[7]:
            if k != "view":
                out[k] = out.get(k, 0) + 1
        if "nan_out" in r[7] and "view" not in r[7] \
                and len(out["nan_ops"]) < 8:
            out["nan_ops"].append(r[:3] + [r[7]])
    return out


def _size(x: list, y: list) -> list:
    """Each output's stats in the two runs and their differences."""
    out = []
    for a, b in zip(x[8], y[8]):
        if a is None or b is None:
            out.append(None)
            continue
        out.append({"sum": [a[0], b[0]], "abs_max": [a[1], b[1]],
                    "sum_diff": a[0] - b[0], "abs_max_diff": a[1] - b[1]})
    return out


def first_parting(a: list, b: list) -> dict:
    """Where two records of one computation first part: the op sequence
    (another op, or other shapes or dtypes: ``kind`` "sequence"), or the
    first op whose output digests differ, whether it was fed by the same
    ops ("op chose differently (inputs agree)") or not ("inputs differ"),
    its name, site, shapes and dtypes, and the size of the difference of
    each output (``size``: sums and largest magnitudes in both runs); with
    the rows around it in both records (``first``, ``second``).  A view's
    digest is not compared: it restates its storage."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x[1] != y[1] or x[3] != y[3] or x[4] != y[4]:
            kind = "sequence"
        elif x[6] != y[6] and "view" not in x[7]:
            kind = "op chose differently (inputs agree)" \
                if x[5] == y[5] else "inputs differ"
        else:
            continue
        lo = max(0, i - AROUND)
        return {"index": i, "kind": kind, "ops": len(a), "op": x[1],
                "site": x[2], "inputs": x[3], "outputs": x[4],
                "other": [y[1], y[3], y[4]] if kind == "sequence" else None,
                "inputs_agree": x[5] == y[5], "size": _size(x, y),
                "first": a[lo:i + AROUND + 1],
                "second": b[lo:i + AROUND + 1]}
    if len(a) != len(b):
        return {"index": min(len(a), len(b)), "kind": "length",
                "ops": [len(a), len(b)]}
    return {"index": None, "kind": "equal", "ops": len(a)}


# ------------------------------------------------------------ stage digests
def hex16(d: int) -> str:
    """A :class:`Digest` as 16 hex digits, mixed (f64 values widened from
    f32 leave the sum's low bits zero)."""
    return hashlib.sha256((d % (1 << 64)).to_bytes(8, "little")
                          ).hexdigest()[:16]


def joined(digests) -> str:
    """One 16-hex digest of several, in order."""
    return hashlib.sha256(" ".join(digests).encode()).hexdigest()[:16]


def local_part(t: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``t``: a DTensor's local shard (its collective
    waited on, as the next op that reads it would), else ``t``."""
    with torch.no_grad():
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, AsyncCollectiveTensor):
            t = t.trigger_wait()
        return t.detach()


class Stages:
    """A digest (:class:`Digest`, 16 hex digits) of each stage of a plain
    run, in order: ``rows``, one ``[label, digest, parts]`` a stage, where
    ``parts`` is each tensor's digest for a stage of several tensors
    (else None).  The caller names its own stages (``stages(label,
    tensors)``); while the record is entered, the model's activations
    come through ``models.layers.tap`` and are labelled by layer: the
    ``layer`` tap ends a layer, whose inner stages (all but ``OUTSIDE``)
    carry its index; a label seen before (a chunk of attention rows, a
    recomputed layer) gets its count, ``#2`` on.  With ``keep`` the
    tensors of a stage of at most ``keep`` elements are kept (``kept``,
    label to clones).  It only reads; :attr:`seconds` is what the
    digests took, :attr:`waited` what the waits for a DTensor's pending
    collective took (the next op would have waited for it)."""

    OUTSIDE = ("embed", "final_norm", "logits")

    def __init__(self, keep: int = 0) -> None:
        self.rows, self.kept, self.keep = [], {}, keep
        self.seconds = self.waited = 0.0
        self.layer = 0
        self.seen = {}
        self.digest = Digest()
        self._saved = None

    def __call__(self, label: str, tensors) -> None:
        t0 = time.perf_counter()
        if isinstance(tensors, torch.Tensor):
            tensors = [tensors]
        parts = [local_part(t) for t in tensors]
        t1 = time.perf_counter()
        self.waited += t1 - t0
        # the digests under no dispatch mode: a recorder running beside
        # this record (OpLog) sees the waits above, not the hashing
        with _disable_current_modes():
            digests = [hex16(self.digest(t)) if t.numel() else "0" * 16
                       for t in parts]
            if self.keep and sum(t.numel() for t in parts) <= self.keep:
                self.kept[label] = [t.clone() for t in parts]
        one = len(digests) == 1
        self.rows.append([label, digests[0] if one else joined(digests),
                          None if one else digests])
        self.seconds += time.perf_counter() - t1

    def tap(self, name: str, x: torch.Tensor) -> None:
        if name == "layer":
            label, self.layer = f"layer {self.layer}", self.layer + 1
        elif name in self.OUTSIDE:
            label = name
        else:
            label = f"layer {self.layer} {name}"
        n = self.seen[label] = self.seen.get(label, 0) + 1
        self(label if n == 1 else f"{label} #{n}", x)

    def __enter__(self) -> "Stages":
        # by its full name: tools load this file on its own
        from repro_torch.models import layers
        self._saved, layers.TAP = layers.TAP, self.tap
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.models import layers
        layers.TAP = self._saved


def parted_stage(a: list, b) -> dict:
    """Where record ``a`` (:class:`Stages` rows) first parts from ``b``
    (rows, or a dict of label to digest, or to its parts' digests, as a
    table of usual digests keeps them): ``kind`` "equal", "digest" (the
    label's digest differs; ``part``, the first part that differs where
    both give parts), "sequence" (another label there) or "length"."""
    if isinstance(b, dict):
        b = [[label, d, None] if isinstance(d, str)
             else [label, joined(d), list(d)] for label, d in b.items()]
    for i, (x, y) in enumerate(zip(a, b)):
        if x[0] != y[0]:
            return {"index": i, "kind": "sequence", "stage": x[0],
                    "other": y[0]}
        if x[1] != y[1]:
            part = None
            if x[2] is not None and y[2] is not None:
                part = next((j for j, (p, q) in enumerate(zip(x[2], y[2]))
                             if p != q), None)
            return {"index": i, "kind": "digest", "stage": x[0],
                    "digest": x[1], "other": y[1], "part": part}
    if len(a) != len(b):
        return {"index": min(len(a), len(b)), "kind": "length",
                "stages": [len(a), len(b)]}
    return {"index": None, "kind": "equal", "stages": len(a)}


# an element's bytes as one integer word, by its size
_WORDS = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


def bit_parting(a: list, b: list) -> dict:
    """Where two runs' tensors of one stage (lists of equal shapes and
    dtypes, as :attr:`Stages.kept` keeps them) first part element by
    element: ``part`` (the tensor), ``element`` (its flat index) and
    ``at`` (its index), both ``values``, the XOR of the two elements'
    words (``xor``, hex) and its set ``bits`` (0 the lowest); and, over
    the stage, how many elements differ and how many bits differ in
    each at most (``elements_differing``, ``most_bits``).  None where
    the tensors are equal."""
    first, count, most = None, 0, 0
    for j, (x, y) in enumerate(zip(a, b)):
        word = _WORDS[x.element_size()]
        u = x.detach().contiguous().reshape(-1).view(word)
        v = y.detach().contiguous().reshape(-1).view(word)
        xor = (u ^ v).to(torch.int64)
        where = torch.nonzero(xor).reshape(-1)
        if not where.numel():
            continue
        count += where.numel()
        d, pop, bits = xor[where], torch.zeros_like(where), []
        for k in range(8 * x.element_size()):
            on = (d >> k) & 1
            pop += on
            bits.append(int(on.sum()))
        most = max(most, int(pop.max()))
        if first is None:
            i = int(where[0])
            w = int(xor[i]) & ((1 << 8 * x.element_size()) - 1)
            first = {"part": j, "element": i,
                     "at": [int(k) for k in torch.unravel_index(
                         torch.tensor(i), x.shape)],
                     "values": [x.reshape(-1)[i].item(),
                                y.reshape(-1)[i].item()],
                     "xor": f"{w:0{2 * x.element_size()}x}",
                     "bits": [k for k in range(8 * x.element_size())
                              if w >> k & 1],
                     "bit_counts": {k: n for k, n in enumerate(bits) if n}}
    if first is None:
        return None
    return {**first, "elements_differing": count, "most_bits": most}


def parse_cpulist(text: str) -> list:
    """The CPUs of a list as the kernel writes one (``0-3,8``)."""
    out = []
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            out += range(int(lo), int(hi or lo) + 1)
    return out


def cpulist(cpus) -> str:
    """``cpus`` written as the kernel writes a CPU list."""
    cpus, runs = sorted(cpus), []
    for c in cpus:
        if runs and c == runs[-1][1] + 1:
            runs[-1][1] = c
        else:
            runs.append([c, c])
    return ",".join(f"{a}" if a == b else f"{a}-{b}" for a, b in runs)


def last_cpu() -> int:
    """The CPU this process's main thread last ran on: field 39 of
    ``/proc/self/stat``."""
    stat = Path("/proc/self/stat").read_text()
    return int(stat[stat.rindex(")") + 2:].split()[36])


def cpu_model() -> str:
    """The host's CPU model, as ``/proc/cpuinfo`` names it."""
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        if line.startswith("model name"):
            return line.split(":", 1)[1].strip()
    return "unknown"


def cpu_conditions() -> dict:
    """The conditions this process computes under on the CPU: its CPU
    set (``affinity``, a CPU list), the CPU its main thread last ran on
    (``last_cpu``), torch's intra-op ``threads``, ``PYTHONHASHSEED``
    (None where unset) and the CPU model.  Reads only."""
    return {"affinity": cpulist(os.sched_getaffinity(0)),
            "last_cpu": last_cpu(), "threads": torch.get_num_threads(),
            "hashseed": os.environ.get("PYTHONHASHSEED"),
            "cpu_model": cpu_model()}
