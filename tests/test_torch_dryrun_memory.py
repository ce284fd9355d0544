"""The port's dry run counts each rank's activation memory
(``repro_torch.launch.dryrun``), held against XLA's memory analysis of
the reference's dry run on the same cells.

Two reduced cells on the pod mesh (16 x 16), each package in a
subprocess of its own (the reference's 512 fake XLA devices and the
port's fake process group must not meet this process): qwen2-0.5b
``train_4k`` and qwen2-0.5b ``decode_32k``.  The port's
``memory.total_bytes`` (a rank's shards of the step's arguments) equals
XLA's ``argument_size_in_bytes`` exactly, and ``peak_bytes`` is the
arguments plus ``temp_bytes``.

``temp_bytes`` against XLA's ``temp_size_in_bytes``, measured:

* ``decode_32k``: 13,118,536 against 14,718,760 bytes, ratio 0.89;
* ``train_4k``: 13,121,182,668 against 4,438,683,176 bytes, ratio 2.96.

XLA fuses the attention softmax's backward, and keeps one (Sq, Sk) f32
buffer of a rank's scores at its peak (4,294,967,296 bytes here: 16
rows, 4 heads, 4096 x 4096).  Eager autograd holds three at its peak:
the saved softmax output, its incoming gradient and the gradient it
produces (and, in the forward, the scores, the weights and two bf16
copies of them).  So the decode cell is held to 0.5-2x of XLA's temp
as it is, and the train cell after taking away the two (Sq, Sk) f32
buffers that eager mode materializes and XLA's fusion does not (ratio
1.02).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch.configs as pcfg

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("qwen2-0.5b", "train_4k"), ("qwen2-0.5b", "decode_32k")]
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
for a, s in json.loads(sys.argv[1]):
    print(json.dumps(D.run_cell(a, s, "pod")["memory"]), flush=True)
"""


@pytest.fixture(scope="module")
def records():
    """Each package's memory records of ``CELLS``, the two subprocesses
    run side by side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)       # the reference's module sets its own
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code, json.dumps(CELLS)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, code in (("ref", REF), ("port", PORT))}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        out[name] = dict(zip(CELLS, map(json.loads, stdout.splitlines())))
    return out


def _scores_bytes(arch, shape):
    """One rank's (B, K, G, Sq, Sk) f32 attention scores on the pod mesh:
    the batch split 16 ways over ``data``, the heads over ``model`` where
    they divide."""
    cfg = pcfg.reduced_config(pcfg.ARCHS[arch])
    sh = pcfg.SHAPES[shape]
    heads = cfg.n_heads // 16 if cfg.n_heads % 16 == 0 else cfg.n_heads
    return sh.global_batch // 16 * heads * sh.seq_len ** 2 * 4


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_argument_bytes_equal_xla(cell, records):
    ref, port = records["ref"][cell], records["port"][cell]
    assert port["total_bytes"] == ref["argument_size_in_bytes"]
    assert port["peak_bytes"] == port["total_bytes"] + port["temp_bytes"]


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_temp_bytes_near_xla(cell, records):
    """The decode cell's temp within ``RATIO`` of XLA's; the train cell's
    after the two (Sq, Sk) f32 buffers of the softmax backward that eager
    autograd holds beside the saved weights and XLA fuses away."""
    ref, port = records["ref"][cell], records["port"][cell]
    temp = port["temp_bytes"]
    if pcfg.SHAPES[cell[1]].kind == "train":
        unfused = 2 * _scores_bytes(*cell)
        assert temp > unfused + ref["temp_size_in_bytes"] // 2
        temp -= unfused
    ratio = temp / ref["temp_size_in_bytes"]
    assert RATIO[0] <= ratio <= RATIO[1], (cell, port, ref, ratio)
