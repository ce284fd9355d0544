"""The first call of the CPU's vector math in a process, made from several
threads at once.

torch computes an f32 or f64 ``cos``, ``sin``, ``exp``, ``log``, ``sqrt``
or ``tanh`` on the CPU with MKL's vector math, in chunks of 2048
elements, one a thread.  On the card machine's host a process's first
such call, made from several threads at once, now and then computes one
thread's chunk with a lower-accuracy kernel: olmoe's RoPE ``cos`` of
4096 angles on two threads, its first 2048 values about 7e-9 off
relative (``tools/vml_first_call.py``), where olmoe's f64 CPU side gave
its second result.  The port's import makes
each of those functions' first call on one thread
(``layers.first_calls_on_one_thread``).

Here the library does not misbehave on its own, so the condition is set:
in a fresh interpreter, before the port is imported, those torch
functions are replaced by ones that answer the process's first call
spanning more than one chunk on more than one thread with its first
chunk's mantissas cut to 26 bits, and every later call as torch does.
olmoe's CPU side (``chip_smoke.moe_cpu_side``, a reduced olmoe at d_model
1024, whose RoPE angles span 4 chunks) then gives the stages of a run
without the stand-in; with the stand-in's first call left to the model
(its state reset after the import, as if the port made no first calls),
it parts at ``layer 0 attn rope q``.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch.oplog import parted_stage

ROOT = Path(__file__).resolve().parents[1]

RACY = '''
import torch
STARTED = [False]


def racy(fn):
    def call(x, *args, **kwargs):
        out = fn(x, *args, **kwargs)
        first, STARTED[0] = not STARTED[0], True
        if (first and x.dtype in (torch.float32, torch.float64)
                and x.numel() > 2048 and torch.get_num_threads() > 1):
            word = torch.int64 if x.dtype == torch.float64 else torch.int32
            cut = 52 - 26 if x.dtype == torch.float64 else 23 - 12
            head = out.view(-1)[:2048].view(word)
            head &= ~((1 << cut) - 1)
        return out
    return call


for name in ("cos", "sin", "exp", "log", "sqrt", "tanh"):
    setattr(torch, name, racy(getattr(torch, name)))
'''

RUN = '''
import dataclasses, json, sys
import numpy as np
sys.path[:0] = [{root!r}, {src!r}]
import chip_smoke as C
from repro_torch.configs import reduced_config
from repro_torch.launch.oplog import Stages
if {reset}:
    STARTED[0] = False
cfg = reduced_config(C.get_arch("olmoe-1b-7b"))
cfg = dataclasses.replace(cfg, d_model=1024, d_head=1024 // cfg.n_heads,
                          dtype="float64")
host = C.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
toks = torch.from_numpy(np.random.default_rng(2).integers(
    0, cfg.vocab, (4, 16)))
stages = Stages()
C.moe_cpu_side(cfg, C.M._cast(host, torch.float64), toks, stages)
print(json.dumps(stages.rows))
'''


def _stages(racy: bool, reset: bool = False):
    code = (RACY if racy else "import torch\nSTARTED = [True]\n") + \
        RUN.format(root=str(ROOT), src=str(ROOT / "src"), reset=reset)
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def runs():
    procs = {"plain": _stages(False), "racy": _stages(True),
             "racy_first_call_threaded": _stages(True, reset=True)}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


def test_a_threaded_first_call_parts_olmoe_at_rope(runs):
    """The condition set: the stand-in's first call left to the model's
    threaded RoPE parts the run where the card host's second result
    parted."""
    got = parted_stage(runs["racy_first_call_threaded"], runs["plain"])
    assert (got["kind"], got["stage"]) == ("digest",
                                           "layer 0 attn rope q"), got


def test_the_port_makes_first_calls_on_one_thread(runs):
    """With the port's first calls on one thread the stand-in changes
    nothing: every stage as without it."""
    got = parted_stage(runs["racy"], runs["plain"])
    assert got["kind"] == "equal", got

