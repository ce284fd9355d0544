"""Nothing the harness runs loads JAX, its libraries or the JAX package
(top-level module names compared whole: ``repro_torch`` is not
``repro``), and the plain references load nothing of the program."""
import json
import subprocess
import sys

from bench.harness import ROOT

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from bench import harness as H
from bench.tiny import tiny_cell
for w in ("qwen3-8b.dsms-256x256", "mamba-2.8b.dsms-512"):
    run = H.Run(tiny_cell(w, dtype="bfloat16"), seed=1, seconds=0,
                trace=False, device="cpu", steps=3)
    run.setup(); run.window(); H.result(run, run.check())
print(json.dumps(H.forbidden_modules()))
"""

REFS = """
import json, sys
sys.path.insert(0, {root!r})
import bench.reference.transformer, bench.reference.mamba1, bench.reference.plan
print(json.dumps(sorted(n for n in sys.modules
                        if n.split(".")[0] in ("repro", "repro_torch",
                                               "jax", "jaxlib", "flax"))))
"""


def _loaded(script: str) -> list:
    out = subprocess.run([sys.executable, "-c",
                          script.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_module():
    assert _loaded(RUN) == []


def test_references_load_nothing_of_the_program():
    assert _loaded(REFS) == []


def test_the_forbidden_names_are_compared_whole():
    from bench import harness as H
    before = dict(sys.modules)
    try:
        sys.modules["repro_torch_probe"] = object()
        sys.modules["reprox"] = object()
        assert "repro_torch_probe" not in H.forbidden_modules()
        sys.modules["repro.core"] = object()
        assert "repro.core" in H.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]
