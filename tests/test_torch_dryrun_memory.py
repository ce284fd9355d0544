"""The port's dry run counts each rank's activation memory
(``repro_torch.launch.dryrun``), held against XLA's memory analysis of
the reference's dry run on the same cells, and lists each rank's
collectives.

Two reduced cells on the pod mesh (16 x 16), each package in a
subprocess of its own (the reference's 512 fake XLA devices and the
port's fake process group must not meet this process): qwen2-0.5b
``train_4k`` and qwen2-0.5b ``decode_32k``.  The port's
``memory.total_bytes`` (a rank's shards of the step's arguments) equals
XLA's ``argument_size_in_bytes`` exactly, and ``peak_bytes`` is the
arguments plus ``temp_bytes``.

``temp_bytes`` against XLA's ``temp_size_in_bytes`` is held within
``RATIO`` as it is, in both cells.  Measured:

* ``decode_32k``: 13,118,536 against 14,718,760 bytes, ratio 0.89;
* ``train_4k``: 5,038,325,448 against 4,438,683,176 bytes, ratio 1.14.
  Attention's backward (``layers._AttentionCore``) keeps one (Sq, Sk)
  f32 buffer of a rank's scores, as XLA's fusion does (4,294,967,296
  bytes here: 16 rows, 4 heads, 4096 x 4096); eager autograd of the
  plain softmax held three, and the ratio read 2.96.

Collectives: no all-reduce of the port's has the whole shape of the
embedding table or of a stacked attention leaf, on the reduced
qwen2-0.5b ``train_4k`` (pod) and dbrx-132b ``train_4k`` (multi-pod,
2 x 16 x 16) cells.  Each gradient is reduced on its own shard, as the
reference's partitioner reduces it (its compiled HLO of the dbrx cell
reduces ``wo``'s gradient in (64, 4) and (4, 4) pieces a layer); the
port summed the embedding table whole before splitting it, and reduced
``wo``'s over the pod axis before splitting it over data.  (At these
widths a rank's (B, S, D) f32 activations are all-reduced too and are
larger than any leaf, so the test holds shapes; ``chip_smoke.py``'s
mesh phase holds bytes at full size.)
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

import repro_torch.configs as pcfg
from repro_torch.models import params as PP
from repro_torch.models import sharding as PSH

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "decode_32k")]
# cells whose collectives are held (the port alone), with their mesh
COLLECTIVE_CELLS = [("qwen2-0.5b", "train_4k", "pod"),
                    ("dbrx-132b", "train_4k", "multipod")]
RATIO = (0.5, 2.0)
REF = """
import json, sys
import repro.launch.dryrun as D
from repro.configs import ARCHS, reduced_config
D.get_arch = lambda a: reduced_config(ARCHS[a])
for a, s in json.loads(sys.argv[1]):
    print(json.dumps(D.run_cell(a, s, "pod")["memory"]), flush=True)
"""
PORT = """
import json, sys
import repro_torch.launch.dryrun as D
from repro_torch.configs import ARCHS, reduced_config
D.get_arch = lambda a: reduced_config(ARCHS[a])
for a, s, m in json.loads(sys.argv[1]):
    r = D.run_cell(a, s, m)
    print(json.dumps({k: r[k] for k in ("memory", "collectives")}),
          flush=True)
"""


@pytest.fixture(scope="module")
def records():
    """Each package's records of ``CELLS`` (the reference's memory, the
    port's memory and collectives), and the port's of
    ``COLLECTIVE_CELLS``, the two subprocesses run side by side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)       # the reference's module sets its own
    cells = {"ref": CELLS, "port": [(a, s, "pod") for a, s in CELLS]
             + COLLECTIVE_CELLS}
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(cells[name])], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, code in (("ref", REF), ("port", PORT))}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        recs = list(map(json.loads, stdout.splitlines()))
        out[name] = dict(zip(CELLS, recs))
        if name == "port":
            out[name] = {c: r["memory"] for c, r in out[name].items()}
            out["collectives"] = {c: r["collectives"] for c, r in zip(
                cells["port"], recs)}
    return out


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_argument_bytes_equal_xla(cell, records):
    ref, port = records["ref"][cell], records["port"][cell]
    assert port["total_bytes"] == ref["argument_size_in_bytes"]
    assert port["peak_bytes"] == port["total_bytes"] + port["temp_bytes"]


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_temp_bytes_near_xla(cell, records):
    """Each cell's temp within ``RATIO`` of XLA's, as it is: the train
    cell's attention backward keeps one (Sq, Sk) f32 buffer, as XLA's
    fused step does."""
    ref, port = records["ref"][cell], records["port"][cell]
    ratio = port["temp_bytes"] / ref["temp_size_in_bytes"]
    assert RATIO[0] <= ratio <= RATIO[1], (cell, port, ref, ratio)


MESHES = {"pod": (("data", "model"), (16, 16)),
          "multipod": (("pod", "data", "model"), (2, 16, 16))}


def _split_leaves(arch, mesh):
    """The embedding table's and each stacked attention leaf's whole
    shape in ``arch``'s reduced config, as ``launch.dryrun`` writes a
    result shape, for each such leaf that the rules split on ``mesh``
    (``spec_for`` reads a mesh's axis names and sizes alone)."""
    specs = PP.param_specs(pcfg.reduced_config(pcfg.ARCHS[arch]))
    leaves = {k: specs[k] for k in ("embed", "lm_head") if k in specs}
    leaves.update({f"blocks.attn.{k}": v
                   for k, v in specs["blocks"]["attn"].items()})
    names, sizes = MESHES[mesh]
    stand_in = SimpleNamespace(mesh_dim_names=names, shape=sizes)
    with PSH.use_sharding(stand_in):
        return {name: "x".join(map(str, s.shape))
                for name, s in leaves.items()
                if any(PSH.spec_for(s.axes, s.shape))}


@pytest.mark.parametrize("cell", COLLECTIVE_CELLS, ids="/".join)
def test_no_all_reduce_of_a_whole_leaf(cell, records):
    """No gradient of a split leaf is all-reduced whole: every
    all-reduce result's shape is other than the embedding table's and
    every split stacked attention leaf's.  (A leaf the rules leave whole,
    a bias of 4 heads on a 16-way model axis, is reduced whole by the
    reference too.)"""
    reduce = records["collectives"][cell]["all_reduce"]
    leaves = _split_leaves(cell[0], cell[2])
    assert "embed" in leaves
    whole = {name: reduce["result_shapes"][s] for name, s in leaves.items()
             if s in reduce["result_shapes"]}
    assert not whole, (cell, whole, reduce["result_shapes"])
