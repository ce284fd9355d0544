"""The benchmark's files: BENCHMARK.json, every configuration, traffic
mix, limit file and per-layer reader it names, parse and agree."""
import importlib
import json
import re

import pytest

from bench import traffic as TR
from bench.harness import ROOT, load_cell

BJ = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BJ["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contract_keys():
    assert set(BJ) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BJ["paths"] == ["bench"] and BJ["command"][1] == "bench/run.py"
    assert 1 <= BJ["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BJ[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in BJ["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BJ["end_to_end"] + BJ["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BJ["per_layer"]:
        assert m["moves"] in e2e
        mod = importlib.import_module(f"bench.metrics.{m['name']}")
        assert callable(mod.read)
    assert len(json.dumps(BJ)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_files_parse(workload):
    c = load_cell(workload)
    w = {x["name"]: x for x in BJ["workloads"]}[workload]
    assert w["chips"] == 1
    assert c.config["name"] == w["config"]
    TR.load(ROOT / "bench" / "traffic" / f"{w['traffic']}.json")
    assert set(c.limits) >= {"plans_differing", "precise_differing",
                             "refinements_wrong"}
    assert all(isinstance(v, (int, float)) for v in c.limits.values())
    assert (ROOT / "bench" / "reference"
            / f"{c.config['reference']}.py").exists()


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (ROOT / "bench" / "configs").glob("*.json")))
def test_configuration_states_the_published_sizes(name):
    """The sizes the program runs are the published configuration's, key
    for key, and ``reduced`` names every key where they are not."""
    from bench.tiny import published_sizes
    c = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())
    listed = {x["name"]: x for x in BJ["configs"]}.get(name)
    reduced = set(c["reduced"]) | set(listed["reduced"] if listed else ())
    sizes = published_sizes(c["model"])
    differ = {k for k, v in sizes.items() if c["published"].get(k) != v}
    assert differ <= reduced, differ
    assert c["published"]["architectures"]
    if listed:
        assert listed["file"] == f"bench/configs/{name}.json"
        assert listed["reduced"] == c["reduced"]
