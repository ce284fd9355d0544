"""A run with its timed path broken underneath comes out not correct,
once for each fault a serving cell can have: a step that leaves its
state unchanged, half of the streams given the other half's results, a
token altered where it is produced, one stream given another's result
at one step, and a drift replan skipped.  (One
chip: no exchange between chips to leave out.)  On the CPU at a tiny
size in float64 against float64 limits; on the card at the cell's own
size against its limits."""
import pytest

from bench import harness as H
from bench.tiny import FAULTS, tiny_cell

WORKLOADS = ["qwen3-8b.dsms-256x256", "mamba-2.8b.dsms-512"]


def _result(cell, device, fault, steps):
    run = H.Run(cell, seed=2 ** 31 + 77, seconds=0, trace=False,
                device=device, steps=steps,
                hook=FAULTS[fault] if fault else None)
    run.setup()
    run.window()
    return H.result(run, run.check())


@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_makes_the_run_not_correct(workload, fault):
    res = _result(tiny_cell(workload), "cpu", fault, steps=12)
    assert res["correct"] == (fault is None), res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_makes_the_cell_not_correct_on_card(workload, fault, card):
    # past the first drift event (one in every 50 steps)
    res = _result(H.load_cell(workload), card, fault, steps=60)
    assert not res["correct"], res["checks"]
