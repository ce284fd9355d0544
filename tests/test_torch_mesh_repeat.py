"""The sharded train step gives one result, run after run: the step of
``chip_smoke.py``'s mesh hold (``mesh_cpu_rank``: 4 CPU ranks, gloo, a
2 x 2 mesh, f64, one train step from seed-1 masters), here at a reduced
qwen2-0.5b, spawned twice by ``tools/mesh_f64_probe.py`` under its op
recorder (every local aten op and collective below DTensor, with a
CRC-32 of what each reads and writes).  The two spawns differ in every
per-process choice the probe can set: each rank's ``PYTHONHASHSEED``,
and in the second every new tensor filled with NaN (PyTorch's
deterministic mode), so that an op reading memory no op has written
shows.  They must agree bit for bit, op by op, and no op may read or
write a buffer whose collective has not been waited on, run off the
rank's thread, or write NaN.
"""
import dataclasses
import importlib
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


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
