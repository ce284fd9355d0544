"""The plain references against the port's CPU path: the decode logits
of both cells' models in float64 at a tiny size, and the serving plan of
both cells at their own size, bit for bit, after drift events."""
import dataclasses
import sys

import numpy as np
import pytest

from bench import harness as H
from bench import yardstick as Y
from bench.reference import plan as PR
from bench.tiny import tiny_cell
from bench.trace import Trace

WORKLOADS = ["qwen3-8b.dsms-256x256", "mamba-2.8b.dsms-512"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_equals_the_port_in_float64(workload):
    run = H.Run(tiny_cell(workload), seed=2 ** 31 + 3, seconds=0,
                trace=False, device="cpu", steps=9)
    run.setup()
    run.window()
    assert len(run.segments) == 2            # a rollover at 6 positions
    nums = run.check()
    for k in ("token_gap", "top5_error", "conf_rel_error"):
        assert nums[k] < 1e-12, (k, nums)
    for k in ("plans_differing", "precise_differing", "refinements_wrong"):
        assert nums[k] == 0, (k, nums)
    assert H.result(run, nums)["correct"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_plan_reference_equals_the_ports_scalar_session(workload):
    sys.path.insert(0, str(H.ROOT / "src"))
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import HVLB_CC_IC, Scheduler
    from repro_torch.planner import gpu_slice_topology, serving_query_graph
    cell = H.load_cell(workload)
    m, spec = cell.config["model"], cell.traffic
    B, life, nq = spec["streams"], spec["lifetime"], spec["queries"]["count"]
    shape = dataclasses.replace(SHAPES["decode_32k"], global_batch=B,
                                seq_len=life)
    g = serving_query_graph(ModelConfig(**m), shape, n_queries=nq)
    ref = PR.serving_graph(m, B, life, nq)
    assert (g.n, g.edges, g.tpl, g.query_ops) == \
        (ref.n, ref.edges, ref.tpl, ref.query_ops)
    assert np.array_equal(g.weights, ref.weights)
    tg = gpu_slice_topology(n_slices=4, gpus_per_slice=2, nodes=1)
    s = Scheduler(tg, policy=HVLB_CC_IC(alpha_max=2.0, alpha_step=0.1),
                  backend="scalar")
    p = s.submit(g)
    sess = PR.Session(ref, PR.slice_topology())
    want = sess.current
    rng = np.random.default_rng(5)
    for k in range(4):
        got = (p.schedule.proc, p.schedule.start, p.schedule.finish, p.holes)
        assert H.same_plan(got, want), k
        ev = {int(t): float(f) for t, f in zip(
            rng.choice(g.n, 2, replace=False), rng.uniform(0.8, 1.25, 2))}
        p = s.update(task_rates=ev, graph=p.graph)
        want = sess.drift(ev)


def test_union_of_device_intervals():
    assert Y.busy_us([(0, 10), (5, 10), (30, 5), (31, 1)]) == 20
    assert Y.bound(3.35e9, 0) == (1.0, "bytes")
    assert Y.bound(0, 34e9)[1] == "operations"


def test_step_work_counts_only_the_experts_that_took_tokens():
    m = H.files_cell("olmoe-1b-7b", "dsms-256x1024").config["model"]
    all_b, flops, _ = Y.step_work(m, 256, 100)
    half_b, flops2, parts = Y.step_work(m, 256, 100, [32] * 16)
    assert flops == flops2 and all_b - half_b == 16 * 32 * 3 * 2048 * 1024 * 2
    later, _, _ = Y.step_work(m, 256, 101)
    assert later - all_b == 16 * 2 * 256 * 16 * 128 * 2


def test_trace_reading():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.step",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 10,
           "dur": 40},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 60, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 70,
           "dur": 40}]
    t = Trace(ev)
    assert t.steps == 1 and t.window_s == 1e-4
    assert t.busy_s == pytest.approx(5e-5)
    assert len(t.kernels()) == 2
    assert t.top_device_ops()[0] == ["copy", 4e-5]
    gaps = dict(t.idle_gaps())
    assert gaps["aten::mm"] == pytest.approx(5e-5)


def test_step_work_of_a_dense_model_with_its_cache():
    m = H.load_cell(WORKLOADS[0]).config["model"]
    b, flops, parts = Y.step_work(m, 256, 10)
    assert parts["mlp"] == 36 * 3 * 4096 * 12288 * 2
    later, _, _ = Y.step_work(m, 256, 11)
    assert later - b == 36 * 2 * 256 * 8 * 128 * 2
    assert flops > 2 * 256 * 36 * 3 * 4096 * 12288


def test_tied_head_reads_the_embedding_once():
    m = H.load_cell(WORKLOADS[1]).config["model"]
    _, _, parts = Y.step_work(m, 512, 0)
    assert parts["embed_rows"] == 0
    assert parts["lm_head"] == 50280 * 2560 * 2
