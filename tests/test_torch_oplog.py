"""The op recorder (``repro_torch.launch.oplog``) and the report a failing
mesh hold prints (``chip_smoke.mesh_cpu_parting``).

Two records of one computation that part at a known op, one of its
outputs moved by one ulp, must be reported at that op: its index, name
and site, its inputs agreeing, and a difference of the size made.  An
input moved from outside is reported as inputs that differ; a view's
digest is never a parting; the recorder changes no value.  Then
``chip_smoke.py``'s failure path at a reduced qwen2-0.5b on 4 gloo ranks:
a first, plain spawn whose stage digests are altered at one stage of
one rank, the report naming that stage against the usual digests; a
second spawn from this process, recorded, whose record is altered at one
op of one rank, a third from a fresh interpreter, recorded, both with
the first's digest, and the report naming the altered op on that rank
only.
"""
import contextlib
import copy
import dataclasses
import gzip
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.oplog import Digest, OpLog, first_parting, stats

ROOT = Path(__file__).resolve().parents[1]


class Bump(TorchDispatchMode):
    """Moves the largest-magnitude element of the ``nth`` call of ``op``
    one ulp away from zero, after the op ran."""

    def __init__(self, op, nth: int = 0) -> None:
        super().__init__()
        self.op, self.nth, self.seen = op, nth, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket is self.op:
            if self.seen == self.nth:
                flat = out.view(-1)
                i = int(flat.abs().argmax())
                flat[i] = torch.nextafter(flat[i], flat[i] * math.inf)
            self.seen += 1
        return out


def inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s)) for s in
            ((16, 32), (32, 24), (24,))]


def compute(x, w, b):
    h = torch.tanh(x @ w + b)
    return (h * h).sum(1).softmax(0)


def record(fn, *args, bump=None):
    """``fn(*args)`` under the recorder; ``bump`` (a :class:`Bump`) acts
    below it, so the recorder sees the bumped output."""
    with bump or contextlib.nullcontext(), OpLog() as log:
        out = fn(*args)
    return log, out


def test_one_ulp_in_one_output_names_that_op():
    x, w, b = inputs()
    a, _ = record(compute, x, w, b)
    got, _ = record(compute, x, w, b, bump=Bump(torch.ops.aten.tanh))
    at = next(r[0] for r in a.rows if r[1] == "aten.tanh")
    p = first_parting(a.rows, got.rows)
    assert p["index"] == at
    assert p["op"] == "aten.tanh"
    assert p["kind"] == "op chose differently (inputs agree)"
    assert p["inputs_agree"] is True
    assert p["site"].startswith("test_torch_oplog.py:")
    assert p["site"].endswith(" compute")
    assert p["outputs"] == ["[16, 24]float64"]
    size, = p["size"]
    top = size["abs_max"][0]
    ulp = float(np.spacing(top))
    assert size["abs_max_diff"] == -ulp
    assert abs(size["sum_diff"]) <= 4 * float(np.spacing(size["sum"][0]))
    # the rows around it, from both records
    assert [r[0] for r in p["first"]] == [r[0] for r in p["second"]]
    assert at in [r[0] for r in p["first"]]


def test_an_input_moved_from_outside_is_inputs_differ():
    x, w, b = inputs()
    a, _ = record(compute, x, w, b)
    x2 = x.clone()
    x2[3, 5] = torch.nextafter(x2[3, 5], torch.tensor(math.inf,
                                                      dtype=x.dtype))
    got, _ = record(compute, x2, w, b)
    p = first_parting(a.rows, got.rows)
    assert p["kind"] == "inputs differ" and p["inputs_agree"] is False
    assert p["op"] == "aten.mm"


def test_same_inputs_give_equal_records_and_the_same_values():
    x, w, b = inputs()
    plain = compute(x, w, b)
    a, out_a = record(compute, x, w, b)
    c, out_c = record(compute, x, w, b)
    assert torch.equal(out_a, plain) and torch.equal(out_c, plain)
    assert first_parting(a.rows, c.rows) == {"index": None, "kind": "equal",
                                             "ops": len(a.rows)}
    assert a.seconds > 0


def test_a_view_digest_alone_is_no_parting():
    x, w, b = inputs()
    a, _ = record(lambda t: (t.t() * 2.0).t().contiguous(), x)
    views = [r[0] for r in a.rows if "view" in r[7]]
    assert views, a.rows
    b_rows = copy.deepcopy(a.rows)
    for i in views:
        b_rows[i][6] = [12345 for _ in b_rows[i][6]]
    assert first_parting(a.rows, b_rows)["kind"] == "equal"
    mul, = [r[0] for r in a.rows if r[1] == "aten.mul"]
    b_rows[mul][6] = [1 + b_rows[mul][6][0]]
    assert first_parting(a.rows, b_rows)["index"] == mul


def test_another_op_is_a_sequence_parting():
    x, w, b = inputs()
    a, _ = record(compute, x, w, b)
    got, _ = record(lambda *t: compute(*t).exp(), x, w, b)
    assert first_parting(a.rows, got.rows)["kind"] == "length"
    got, _ = record(lambda x, w, b: torch.tanh(x @ w - b), x, w, b)
    p = first_parting(a.rows, got.rows)
    assert p["kind"] == "sequence" and p["op"] == "aten.add"
    assert p["other"][0] == "aten.sub"


@pytest.mark.parametrize("dtype", (torch.float64, torch.float32,
                                   torch.bfloat16, torch.int64, torch.bool))
def test_digest_sees_any_one_element(dtype):
    d = Digest()
    rng = np.random.default_rng(1)
    n = Digest.ROW * 3 + 17          # whole rows and a tail
    x = torch.from_numpy(rng.standard_normal(n) * 100)
    x = x.to(dtype) if dtype != torch.bool else x > 0
    h = d(x)
    assert d(x.clone()) == h
    words = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}
    for i in (0, Digest.ROW - 1, Digest.ROW * 2 + 5, n - 1):
        y = x.clone()
        y.view(words[y.element_size()])[i] ^= 1      # its lowest bit
        assert d(y) != h, (dtype, i)
    j = int((x != x[0]).nonzero()[0])      # two elements that differ
    swapped = x.clone()
    swapped[[0, j]] = x[[j, 0]]
    assert d(swapped) != h
    # a strided tensor hashes as its contiguous copy
    m = x[: n - n % 4].view(4, -1)
    assert d(m.t()) == d(m.t().contiguous())


def test_stats_give_sum_and_largest_magnitude():
    x = torch.tensor([1.5, -4.0, 2.0], dtype=torch.float64)
    assert stats(x) == [-0.5, 4.0]
    assert stats(torch.arange(3)) is None
    assert math.isnan(stats(torch.tensor([1.0, math.nan]))[1])


# ---------------------------------------------- chip_smoke's failure path
@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as C
        yield C
    finally:
        sys.path.remove(str(ROOT))


def test_failing_hold_report_names_the_parting_op(chip_smoke, tmp_path,
                                                  capsys, monkeypatch):
    """The first spawn runs plain; its stage digests of rank 2 are
    altered at ``layer 1`` (the usual ones are the unaltered run's).  The
    second spawn's record of rank 2 is altered at one op (its first
    output one ulp larger in magnitude at its largest element, as a
    second result would read there); the third, from a fresh
    interpreter, is not.  The report names the stage first, on a line of
    its own, then holds the second spawn's record against the third's."""
    C = chip_smoke
    from repro_torch.configs import reduced_config
    arch = C.MESH_CPU_STAGED
    cfg = dataclasses.replace(reduced_config(C.get_arch(arch)),
                              dtype="float64")
    cases = {arch: (cfg, C.SyntheticTokenPipeline(cfg, C.ShapeConfig(
        "t", 32, 4, "train")))}
    work = tmp_path / "mesh_cpu"
    C.mesh_cpu_spawn(work, cases, None)
    assert not list(work.glob("ops.*"))             # the hold runs plain
    whole = C.mesh_cpu_whole(work, arch)
    digest = C.mesh_cpu_digest(whole)
    monkeypatch.setitem(C.MESH_CPU_USUAL_STAGES,
                        C.usual_key(C.MESH_CPU_THREADS), {
        r[0]: r[2] for r in C.mesh_cpu_stage_rows(whole)})
    layer = next(r for r in whole["stages"][2]["rows"] if r[0] == "layer 1")
    layer[1] = "0" * 16
    spawn, state = C.mesh_cpu_spawn, {}

    def altered(where, cs, record):
        wall = spawn(where, cs, record)
        if where.name.endswith("_again"):
            path = where / f"ops.{arch}.2.json.gz"
            with gzip.open(path, "rt") as f:
                rows = json.load(f)
            at = next(r[0] for r in rows if r[1] == "aten.bmm" and r[8][0]
                      and "[" in r[2])
            ulp = float(np.spacing(rows[at][8][0][1]))
            rows[at][6][0] += 1
            rows[at][8][0][1] += ulp
            with gzip.open(path, "wt") as f:
                json.dump(rows, f)
            state.update(at=at, ulp=ulp, site=rows[at][2])
        return wall

    monkeypatch.setattr(C, "mesh_cpu_spawn", altered)
    got = C.mesh_cpu_parting(work, cases, arch, whole, digest)
    stage = got["first"]["parted_from_usual"]
    assert (stage["kind"], stage["stage"], stage["part"]) == (
        "digest", "layer 1", 2), stage
    assert [s["from"] for s in got["spawns"]] == ["this process",
                                                  "a fresh interpreter"]
    assert all(s["digest"] == digest for s in got["spawns"])
    for s in got["spawns"]:
        assert (s["first_parted"]["stage"], s["first_parted"]["part"]) == (
            "layer 1", 2), s
    kinds = [r["kind"] for r in got["ranks"]]
    assert kinds == ["equal", "equal", "op chose differently (inputs agree)",
                     "equal"], kinds
    p = got["ranks"][2]
    at = state["at"]
    assert (p["index"], p["op"], p["site"]) == (at, "aten.bmm",
                                                state["site"])
    assert p["inputs_agree"] is True
    assert p["size"][0]["abs_max_diff"] == state["ulp"]
    assert p["size"][0]["sum_diff"] == 0.0
    printed = capsys.readouterr().out
    assert printed.index('"mesh_cpu_parted_stage"') < printed.index(
        '"mesh_cpu_parting"')
    assert f'"index": {at}' in printed
