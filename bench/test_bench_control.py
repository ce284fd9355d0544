"""The control comes out not correct at the cell's own size on the card:
the reference with every product in fp8 put in the program's place, and
the program's float32 scheduler in place of its float64 one; the
program itself is correct on the same tuples."""
import pytest

from bench import harness as H
from bench.readings import plan_control

WORKLOADS = ["qwen3-8b.dsms-256x256", "mamba-2.8b.dsms-512"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct_on_card(workload, card):
    cell = H.load_cell(workload)
    run = H.Run(cell, seed=2 ** 31 + 99, seconds=0, trace=False,
                device=card, steps=60)
    run.setup()
    run.window()
    assert H.result(run, run.check())["correct"]
    control = run.control()
    assert not H.result(run, control | {
        "plans_differing": 0, "precise_differing": 0,
        "refinements_wrong": 0})["correct"], control
    assert plan_control(run) > 0
