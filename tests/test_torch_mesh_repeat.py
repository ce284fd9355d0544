"""The sharded train step gives one result, run after run: the step of
``chip_smoke.py``'s mesh hold (``mesh_cpu_rank``: 4 CPU ranks, gloo, a
2 x 2 mesh, f64, one train step from seed-1 masters), here at a reduced
qwen2-0.5b, spawned twice by ``tools/mesh_f64_probe.py`` under its op
recorder (``repro_torch.launch.oplog.OpLog``: every local aten op and
collective below DTensor, with the op that wrote each input and a digest
of each output).  The two spawns differ in every
per-process choice the probe can set: each rank's ``PYTHONHASHSEED``,
and in the second every new tensor filled with NaN (PyTorch's
deterministic mode), so that an op reading memory no op has written
shows.  They must agree bit for bit, op by op, and no op may read or
write a buffer whose collective has not been waited on, run off the
rank's thread, or write NaN.

The f64 step stays in f64: no floating op of the step, recorded on the
4 ranks and without a mesh at reduced qwen2-0.5b and olmoe-1b-7b, gives
an output narrower than float64, but at the two places meant to, as the
reference has them: the init's f32 draw (``params._init_leaf``, and the
shards of it that ``sharding.distribute`` keeps before they are
widened) and AdamW's scalar schedule in f32 (``adamw._schedule``, and
the bias corrections of ``adamw_update``).  A view restates a tensor
whose op was already held.
"""
import dataclasses
import importlib
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
NARROW = ("float32", "bfloat16", "float16")
# (file, function) of the sites meant to give f32; AdamW's only for
# scalars (its schedule, as the reference's optim/adamw.py computes it)
INIT_DRAW = {("params.py", "_init_leaf"), ("sharding.py", "distribute")}
ADAMW_SCALARS = {("adamw.py", "_schedule"), ("adamw.py", "adamw_update")}


def narrow_outputs(rows) -> list:
    """Rows of ops (not views) with a floating output narrower than f64,
    outside the meant sites."""
    bad = []
    for r in rows:
        if "view" in r[7]:
            continue
        where = r[2].split(" [")[0]
        site = (where.split(":")[0], where.split(" ")[-1]) if where else None
        for out in r[4]:
            shape, dtype = out.rsplit("]", 1)
            if dtype not in NARROW or site in INIT_DRAW or (
                    site in ADAMW_SCALARS and shape == "["):
                continue
            bad.append(r[:5])
    return bad


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
def two_runs(probe, tmp_path_factory):
    C = probe.C
    from repro_torch.configs import reduced_config
    cfg = dataclasses.replace(reduced_config(C.get_arch(probe.ARCH)),
                              dtype="float64")
    case = (cfg, C.SyntheticTokenPipeline(cfg, C.ShapeConfig(
        "t", 32, 4, "train")))
    root = tmp_path_factory.mktemp("mesh_repeat")
    return [probe.ranks(tag, seeds, True, fill, case=case, root=root)
            for tag, seeds, fill in (("a", [11, 12, 13, 14], None),
                                     ("b", [21, 22, 23, 24], "nan"))]


def test_two_spawns_equal_bit_for_bit(two_runs):
    a, b = two_runs
    assert a["digest"] == b["digest"]
    assert a["loss"] == b["loss"]
    assert not a["nan"] and not b["nan"]
    assert a["replicas_differ"] == b["replicas_differ"] == []
    assert [x["hashseed"] for x in b["info"]] == ["21", "22", "23", "24"]


@pytest.mark.parametrize("rank", range(4))
def test_two_spawns_equal_op_by_op(probe, two_runs, rank):
    a, b = two_runs
    got = probe.first_parting(a["ops"][rank], b["ops"][rank])
    assert got["kind"] == "equal", got
    assert len(a["ops"][rank]) > 1000      # the step ran under the recorder


@pytest.mark.parametrize("run", (0, 1), ids=("plain", "nan_filled"))
def test_no_op_reads_a_pending_or_unwritten_buffer(probe, two_runs, run):
    for rank, rows in enumerate(two_runs[run]["ops"]):
        flags = probe.flag_summary(rows)
        assert flags["nan_ops"] == [], (rank, flags["nan_ops"])
        for bad in ("reads_pending", "writes_pending", "thread"):
            assert bad not in flags, (rank, bad, flags)
        assert any(r[1] == "_c10d_functional.wait_tensor" for r in rows)


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "olmoe-1b-7b"))
def test_f64_step_gives_no_narrower_float(probe, arch):
    """The step without a mesh, as ``mesh_cpu_rank`` runs it on a rank:
    seed-1 masters, ``loss_and_grads``, then ``adamw_update``."""
    C = probe.C
    from repro_torch.configs import reduced_config
    cfg = dataclasses.replace(reduced_config(C.get_arch(arch)),
                              dtype="float64")
    pipe = C.SyntheticTokenPipeline(cfg, C.ShapeConfig("t", 32, 4, "train"))
    with probe.OpLog() as log:
        params = C.mesh_cpu_masters(cfg)
        loss, grads = C.loss_and_grads(cfg, params, pipe.device_batch(
            0, "cpu"), remat=False)
        C.adamw_update(C.AdamWConfig(), params, grads,
                       C.init_opt_state(params))
    assert loss.dtype == torch.float64
    assert narrow_outputs(log.rows) == []
    sites = {r[2].split(" [")[0].split(" ")[-1] for r in log.rows
             if any(o.endswith("float32") for o in r[4])}
    assert sites == {"_init_leaf", "_schedule", "adamw_update"}, sites


@pytest.mark.parametrize("rank", range(4))
def test_f64_spawn_gives_no_narrower_float(two_runs, rank):
    rows = two_runs[0]["ops"][rank]
    assert narrow_outputs(rows) == []
    assert any(o.endswith("float64") for r in rows for o in r[4])
