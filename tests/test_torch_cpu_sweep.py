"""``tools/cpu_sweep.py``, the sweep of the host's CPUs for the two f64
holds' CPU sides, on this CPU at reduced olmoe-1b-7b and qwen2-0.5b; and
the pinned thread count of olmoe's CPU side in ``chip_smoke.py``.

The sweep's children are fresh processes, each pinned to one CPU at one
thread: two on two CPUs give equal digests of both stand-ins, and a
one-bit flip planted through ``layers.TAP`` in one element of one stage
(in a third and fourth child) is reported at its stage, its element and
its bit.  The olmoe stand-in (the embedding and layer 0's attention)
digests the same stages as ``chip_smoke.moe_cpu_run``.  At a width where
the thread count splits the projections' sums (d_model 1024), two thread
counts give two stage digests, and ``chip_smoke.moe_cpu_side`` gives one
whatever the process's count, which it restores.
"""
import dataclasses
import importlib
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.oplog import (Stages, bit_parting, cpu_conditions,
                                      cpulist, parse_cpulist, parted_stage)
from repro_torch.models import layers

ROOT = Path(__file__).resolve().parents[1]
PLANTS = {"olmoe": {"what": "olmoe", "run": 1, "stage": "layer 0 attn q",
                    "element": 5, "bit": 20},
          "qwen2": {"what": "qwen2", "run": 1, "stage": "layer 1",
                    "element": 7, "bit": 3}}


@pytest.fixture(scope="module")
def sweep_mod():
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        yield importlib.import_module("cpu_sweep")
    finally:
        sys.path.remove(str(ROOT / "tools"))


@pytest.fixture(scope="module")
def swept(sweep_mod, tmp_path_factory):
    """Four children at reduced widths, one thread each: ``a`` and ``b``
    on two CPUs, then a planted flip of each stand-in on those CPUs."""
    S = sweep_mod
    root = tmp_path_factory.mktemp("cpu_sweep")
    sweep = S.Sweep(root / "work", root / "sweep.jsonl", reduced=True,
                    need_gb=0.5)
    S.prepare(sweep.work, reduced=True)
    mine = sorted(os.sched_getaffinity(0))
    cpus = [mine[0], mine[-1]]
    base = {"phase": "single", "olmoe_threads": 1, "qwen2_threads": 1,
            "olmoe_runs": 3, "whole": True, "qwen2_runs": 1}
    specs = [{**base, "name": "a", "cpus": [cpus[0]]},
             {**base, "name": "b", "cpus": [cpus[1]]}]
    specs += [{**base, "name": f"plant_{what}", "cpus": [cpus[k]],
               "whole": False, "qwen2_runs": 2, "plant": plant}
              for k, (what, plant) in enumerate(PLANTS.items())]
    children = {r["name"]: r for r in sweep.run(specs, at_once=4)}
    return S, sweep, children, cpus, S.analyse(sweep)


def test_two_children_on_two_cpus_give_equal_digests(swept):
    _, _, children, cpus, _ = swept
    a, b = children["a"], children["b"]
    assert "failed" not in a and "failed" not in b, (a, b)
    for rec, cpu in ((a, cpus[0]), (b, cpus[1])):
        for what in ("olmoe", "whole", "qwen2"):
            got = rec[what]
            assert got["conditions"]["affinity"] == str(cpu)
            assert got["conditions"]["threads"] == 1
            assert len(got["digests"]) == 1, got["digests"]
    for what in ("olmoe", "whole", "qwen2"):
        assert a[what]["digests"].keys() == b[what]["digests"].keys()
    (d, x), = a["olmoe"]["digests"].items()
    assert x["runs"] == 3
    # the whole forward's logits hash equal too
    assert [x["forward"] for x in a["whole"]["digests"].values()] == [
        x["forward"] for x in b["whole"]["digests"].values()]


@pytest.mark.parametrize("what", sorted(PLANTS))
def test_planted_flip_is_reported_at_its_stage_element_and_bit(swept, what):
    _, _, children, _, found = swept
    plant = PLANTS[what]
    rec = children[f"plant_{what}"]
    assert len(rec[what]["digests"]) == 2
    report, = [r for r in found["reports"] if r["what"] == what]
    assert report["child"] == f"plant_{what}"
    assert report["run"] == plant["run"]
    assert report["usual"] == next(iter(children["a"][what]["digests"]))
    assert (report["stage"]["kind"], report["stage"]["stage"]) == (
        "digest", plant["stage"]), report["stage"]
    e = report["element"]
    assert (e["part"], e["element"], e["bits"]) == (0, plant["element"],
                                                    [plant["bit"]])
    assert int(e["xor"], 16) == 1 << plant["bit"]
    assert (e["elements_differing"], e["most_bits"]) == (1, 1)
    assert report["signature"].startswith("one bit in one element")
    assert layers.TAP is None


def test_usual_digests_and_lines(swept):
    _, sweep, _, _, found = swept
    assert found["second_digests"] == len(PLANTS)
    lines = sweep.out.read_text().splitlines()
    kinds = [line.split('"', 4)[3] for line in lines]
    assert kinds.count("child") == 4 and kinds.count("parted") == 2
    assert "cpu" in kinds and "digest" in kinds


# ------------------------------------------------ the stand-in's stages
def _olmoe(C, d_model=None):
    from repro_torch.configs import reduced_config
    cfg = dataclasses.replace(reduced_config(C.get_arch("olmoe-1b-7b")),
                              n_layers=2)
    if d_model:
        cfg = dataclasses.replace(cfg, d_model=d_model,
                                  d_head=d_model // cfg.n_heads)
    host = C.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 16)))
    return cfg, host, toks


def test_standin_stages_equal_moe_cpu_run(sweep_mod):
    S = sweep_mod
    C = S._chip_smoke()
    cfg, host, toks = _olmoe(C)
    c = dataclasses.replace(cfg, dtype="float64")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want, got = Stages(), Stages()
        C.routed(lambda: C.moe_cpu_run(c, C.M._cast(host, torch.float64),
                                       toks, want))
        h = S.olmoe_standin(cfg, S.olmoe_leaves(cfg, host, toks), got)
    finally:
        torch.set_num_threads(threads)
    labels = [r[0] for r in got.rows]
    assert labels[:2] == ["leaves", "tokens"]
    assert labels[-1] == "layer 0 attn" and h.dtype == torch.float64
    n = len(got.rows) - 1
    assert got.rows[1:] == want.rows[1:1 + n]
    assert [r[0] for r in want.rows][1 + n] == "layer 0 router"


# ------------------------------------------------ olmoe's pinned threads
def test_olmoe_cpu_side_is_pinned_to_one_thread_count(sweep_mod):
    C = sweep_mod._chip_smoke()
    cfg, host, toks = _olmoe(C, d_model=1024)
    c = dataclasses.replace(cfg, dtype="float64")
    p = C.M._cast(host, torch.float64)
    threads = torch.get_num_threads()
    plain, pinned = {}, {}
    try:
        for n in (1, 2):
            torch.set_num_threads(n)
            s = Stages()
            C.routed(lambda: C.moe_cpu_run(c, p, toks, s))
            plain[n] = s.rows
            s = Stages()
            _, _, now = C.moe_cpu_side(c, p, toks, s)
            pinned[n] = s.rows
            assert now["threads"] == C.MOE_CPU_THREADS
            assert torch.get_num_threads() == n        # restored
    finally:
        torch.set_num_threads(threads)
    parted = parted_stage(plain[2], plain[1])
    assert (parted["kind"], parted["stage"]) == ("digest",
                                                 "layer 0 attn q"), parted
    assert pinned[1] == pinned[2]
    assert C.usual_key(C.MOE_CPU_THREADS) == (torch.__version__,
                                             C.MOE_CPU_THREADS)


# ------------------------------------------------ the helpers
def test_cpu_conditions_read_this_process(monkeypatch):
    monkeypatch.setenv("PYTHONHASHSEED", "7")
    got = cpu_conditions()
    mine = sorted(os.sched_getaffinity(0))
    assert parse_cpulist(got["affinity"]) == mine
    assert got["last_cpu"] in range(os.cpu_count())
    assert got["threads"] == torch.get_num_threads()
    assert got["hashseed"] == "7" and got["cpu_model"]


@pytest.mark.parametrize("cpus, text", [([0], "0"), ([0, 1, 2, 5], "0-2,5"),
                                        ([3, 7, 8, 9], "3,7-9")])
def test_cpulist_round_trip(cpus, text):
    assert cpulist(cpus) == text and parse_cpulist(text) == cpus


def test_core_groups_cover_the_cpus(sweep_mod):
    mine = frozenset(os.sched_getaffinity(0))
    groups = sweep_mod.core_groups(mine)
    assert groups
    assert set().union(*map(set, groups.values())) == mine
    assert all(set(g) <= mine for g in groups.values())


def test_bit_parting_counts_elements_and_bits():
    a = torch.linspace(-1, 1, 12, dtype=torch.float64).reshape(3, 4)
    assert bit_parting([a], [a.clone()]) is None
    b = a.clone()
    w = b.view(-1).view(torch.int64)
    w[6] ^= 1 << 40
    w[9] ^= 0b101
    got = bit_parting([a, a], [a.clone(), b])
    assert (got["part"], got["element"], got["at"]) == (1, 6, [1, 2])
    assert got["bits"] == [40] and got["xor"] == f"{1 << 40:016x}"
    assert (got["elements_differing"], got["most_bits"]) == (2, 2)
    assert got["bit_counts"] == {0: 1, 2: 1, 40: 1}
