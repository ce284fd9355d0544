"""Stage digests (``repro_torch.launch.oplog.Stages``) on the two CPU
sides of ``chip_smoke.py``'s f64 holds, which run plain: a digest of each
stage's own part, named in order, so that a second result names the
first stage at which it parts.

The mesh hold's ranks (``chip_smoke.mesh_cpu_rank``: 4 gloo ranks, a
2 x 2 mesh, f64, one train step from seed-1 masters), here at a reduced
qwen2-0.5b, spawned twice by ``tools/mesh_f64_probe.py``: the first
spawn runs the step four times in each rank (as the hold runs it,
without the digests, with one rank's f32 draw one ulp larger, with one
rank's layer output one ulp larger), the second once.  Two spawns give
equal digests, the step gives the same result bit for bit with the
digests on and off, and each planted change is named at its stage and
rank.  Then olmoe-1b-7b's f64 CPU forward (``chip_smoke.moe_cpu_run``),
reduced, in this process: the same, one run at a time.
"""
import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.oplog import Stages, joined, parted_stage
from repro_torch.models import layers

ROOT = Path(__file__).resolve().parents[1]
ATTN = ("attn q", "attn k", "attn v", "attn rope q", "attn rope k",
        "attn q rows", "attn scores", "attn weights", "attn chunk",
        "attn core", "attn")
MESH_STAGES = (["draw", "masters", "batch", "embed"]
               + [f"layer {i}{s}" for i in range(2)
                  for s in [f" {a}" for a in ATTN] + [" mlp", ""]]
               + ["final_norm", "logits", "loss"])


@pytest.fixture(scope="module")
def probe():
    """The probe as a module; ``tools/`` stays on ``sys.path`` while the
    fixture lives, since a spawned rank imports the probe by name."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        yield importlib.import_module("mesh_f64_probe")
    finally:
        sys.path.remove(str(ROOT / "tools"))


@pytest.fixture(scope="module")
def spawns(probe, tmp_path_factory):
    C = probe.C
    from repro_torch.configs import reduced_config
    cfg = dataclasses.replace(reduced_config(C.get_arch(probe.ARCH)),
                              dtype="float64")
    case = (cfg, C.SyntheticTokenPipeline(cfg, C.ShapeConfig(
        "t", 32, 4, "train")))
    root = tmp_path_factory.mktemp("stage_digest")
    first = probe.ranks("a", [None] * 4, case=case, root=root,
                        runs=(None, "off", ("draw", 1), ("layer 1", 2)))
    return first["runs"], probe.ranks("b", [None] * 4, case=case, root=root)


def test_two_spawns_give_equal_stage_digests(spawns):
    (plain, *_), again = spawns
    assert parted_stage(again["stages"], plain["stages"])["kind"] == "equal"
    assert again["stages"] == plain["stages"]
    assert again["digest"] == plain["digest"]
    labels = [r[0] for r in plain["stages"]]
    assert labels[:len(MESH_STAGES)] == MESH_STAGES
    assert labels[-1] == "params"
    assert all(x.startswith("grad ") for x in labels[len(MESH_STAGES):-1])
    # a row's digest joins the 4 ranks' own
    assert all(len(r[2]) == 4 and r[1] == joined(r[2])
               for r in plain["stages"])
    assert max(plain["stages_s"]) < 1.0


def test_step_is_bit_equal_with_digests_on_and_off(spawns):
    plain, off = spawns[0][:2]
    assert off["stages"] is None and off["stages_s"] == []
    assert off["loss"] == plain["loss"]
    assert all(torch.equal(a, b) for a, b in zip(off["grads"],
                                                 plain["grads"]))
    assert off["digest"] == plain["digest"]


@pytest.mark.parametrize("run, stage, rank", [(2, "draw", 1),
                                              (3, "layer 1", 2)],
                         ids=("f32_draw", "layer_output"))
def test_planted_ulp_is_named_at_its_stage_and_rank(spawns, run, stage,
                                                    rank):
    plain, planted = spawns[0][0], spawns[0][run]
    got = parted_stage(planted["stages"], plain["stages"])
    assert (got["kind"], got["stage"], got["part"]) == ("digest", stage,
                                                        rank), got
    at = got["index"]
    assert planted["stages"][:at] == plain["stages"][:at]
    # the other ranks' digests of that stage are their usual ones
    mine, usual = planted["stages"][at][2], plain["stages"][at][2]
    assert [a == b for a, b in zip(mine, usual)] == [r != rank
                                                     for r in range(4)]
    # the step went on from the changed value
    assert planted["digest"] != plain["digest"]
    # and a table of usual digests, a rank's digests a stage, names it too
    table = {r[0]: r[2] for r in plain["stages"]}
    assert parted_stage(planted["stages"], table) == got


# ------------------------------------------------------ olmoe's CPU forward
@pytest.fixture(scope="module")
def moe(probe):
    """One thread: the reduced forward's ops are small, and a worker's
    threads beside the other workers' slow them a hundredfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _moe(probe)
    finally:
        torch.set_num_threads(threads)


def _moe(probe):
    C = probe.C
    from repro_torch.configs import reduced_config
    cfg = reduced_config(C.get_arch("olmoe-1b-7b"))
    host = C.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 16)))
    c = dataclasses.replace(cfg, dtype="float64")

    def run(stages=None, masters=host):
        p = C.M._cast(masters, torch.float64)
        if stages is None:
            return C.routed(lambda: C.decode_and_forward(c, p, toks))
        return C.routed(lambda: C.moe_cpu_run(c, p, toks, stages))

    return C, run, host


def test_moe_forward_stage_digests_repeat(moe):
    C, run, _ = moe
    a, b = Stages(), Stages()
    run(a)
    run(b)
    assert a.rows == b.rows and parted_stage(a.rows, b.rows)["kind"] == \
        "equal"
    labels = [r[0] for r in a.rows]
    assert labels == ["masters", "tokens", "embed"] + [
        f"layer {i}{s}" for i in range(2)
        for s in [f" {x}" for x in ATTN] + [" router", " moe", ""]] + [
        "final_norm", "logits"]
    got = C.moe_cpu_stages(a)
    assert list(got["stages"]) == labels and got["usual_known"] is (
        C.usual_key(C.MOE_CPU_THREADS) in C.MOE_CPU_USUAL_STAGES)


def test_moe_forward_is_bit_equal_with_digests_on_and_off(moe):
    _, run, _ = moe
    (dec, full), picks = run()
    (dec2, full2), picks2 = run(Stages())
    assert torch.equal(dec, dec2) and torch.equal(full, full2)
    assert all(torch.equal(a, b) for a, b in zip(picks, picks2))
    assert layers.TAP is None


def test_moe_planted_ulp_in_the_f32_draw_is_named_at_the_masters(moe):
    C, run, host = moe
    want, got = Stages(), Stages()
    run(want)
    bumped = dict(host)
    leaf = bumped["embed"].clone()
    leaf[0, 0] = torch.nextafter(leaf[0, 0], torch.tensor(np.inf))
    bumped["embed"] = leaf
    run(got, bumped)
    p = parted_stage(got.rows, want.rows)
    assert (p["kind"], p["stage"], p["index"]) == ("digest", "masters", 0)
    assert p["part"] == C.leaf_names(host).index("embed")


@pytest.mark.parametrize("stage", ["layer 0", "layer 1", "layer 0 attn",
                                   "layer 0 attn rope k",
                                   "layer 1 attn scores",
                                   "layer 1 attn weights",
                                   "layer 1 router", "layer 1 moe",
                                   "final_norm"])
def test_moe_planted_ulp_is_named_at_its_stage(probe, moe, stage):
    _, run, _ = moe
    want, got = Stages(), probe.planted(stage)()
    run(want)
    run(got)
    p = parted_stage(got.rows, want.rows)
    assert (p["kind"], p["stage"]) == ("digest", stage), p
    assert got.rows[:p["index"]] == want.rows[:p["index"]]


# ------------------------------------------------------------ the record
def test_tap_is_set_only_inside_a_record():
    assert layers.TAP is None
    with Stages() as outer:
        assert layers.TAP == outer.tap
        with Stages() as inner:
            assert layers.TAP == inner.tap
        assert layers.TAP == outer.tap
    assert layers.TAP is None
    x = torch.ones(3)
    assert layers.tap("embed", x) is x


def test_stage_labels_carry_the_layer_in_progress():
    s = Stages()
    x = torch.arange(4.0)
    for name in ("embed", "attn", "mlp", "layer", "attn", "router", "moe",
                 "layer", "final_norm"):
        s.tap(name, x)
    assert [r[0] for r in s.rows] == [
        "embed", "layer 0 attn", "layer 0 mlp", "layer 0", "layer 1 attn",
        "layer 1 router", "layer 1 moe", "layer 1", "final_norm"]
    s.tap("attn", x)                # a second chunk of one layer
    assert s.rows[-1][0] == "layer 2 attn"
    s.tap("attn", x)
    assert s.rows[-1][0] == "layer 2 attn #2"


def test_a_stage_of_several_tensors_names_the_part_that_parts():
    a, b = Stages(), Stages()
    xs = [torch.zeros(5, dtype=torch.float64), torch.ones(3)]
    a("masters", xs)
    ys = [xs[0], torch.nextafter(xs[1], torch.tensor(2.0))]
    b("masters", ys)
    p = parted_stage(b.rows, a.rows)
    assert (p["kind"], p["stage"], p["part"]) == ("digest", "masters", 1)
    assert a.rows[0][1] == joined(a.rows[0][2])


def test_parted_stage_kinds():
    rows = [["a", "1" * 16, None], ["b", "2" * 16, None]]
    assert parted_stage(rows, rows) == {"index": None, "kind": "equal",
                                        "stages": 2}
    assert parted_stage(rows, {"a": "1" * 16, "c": "2" * 16})["kind"] == \
        "sequence"
    assert parted_stage(rows[:1], rows) == {"index": 1, "kind": "length",
                                            "stages": [1, 2]}
    assert parted_stage(rows, {"a": "1" * 16, "b": "3" * 16})["stage"] == "b"
