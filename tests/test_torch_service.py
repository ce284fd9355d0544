"""The port's scheduler service against the reference's.

The wire protocol is held byte for byte (requests, responses and graphs
encode to the same bytes, and each side decodes the other's), the shard
ring and the coalescer to the same outputs.  The request scripts of
``tests/test_service.py`` and the seeded chaos scripts of
``tests/test_service_chaos.py`` run through the reference
``SchedulerService(backend="scalar")`` and through the port's service,
on the kernels' plain versions (``backend="cuda", device="cpu"``) and on
the port's scalar backend; every response must be the reference's once
latency fields are dropped (and, on the cuda backend, the backend name
and the simulation count of a fresh grid, which the port's fused sweep
runs in full).  The pipelined TCP front-end answers as the in-process
reference does.

A kernel failure or a watchdog overrun is not demoted: the request gets
the structured ``device-error`` response, the failure is logged, and the
service goes on serving.  Without a card the service refuses to start
unless the CPU is asked for.
"""
import argparse
import asyncio
import dataclasses
import json
import logging
import threading

import numpy as np
import pytest
import torch

import repro.core as ref
import repro.service as rsvc
import repro_torch.core as port
import repro_torch.service as psvc
from repro.service.protocol import ProtocolError as RefProtocolError
from repro_torch import _nvcc
from repro_torch.core.backends import cuda as K
from repro_torch.service import __main__ as pmain
from test_service import _graphs, _tg
from test_service_chaos import _script, _topology
from test_torch_session import BACKENDS, _gp, _pol, _tp

_POLICY = ref.HVLB_CC_B(alpha_max=1.0, alpha_step=0.25)
_LATENCY = ("mean_replan_latency_s", "p99_replan_latency_s")


# ------------------------------------------------------------ protocol
def test_wire_format_is_byte_identical():
    tg = _tg()
    g = _graphs(tg, k=1, seed=5)[0]
    gp = _gp(g)
    gp.name = g.name
    assert psvc.spg_to_json(gp) == rsvc.spg_to_json(g)
    assert json.dumps(psvc.spg_to_json(gp)) == json.dumps(rsvc.spg_to_json(g))
    back = psvc.spg_from_json(rsvc.spg_to_json(g))
    assert np.array_equal(back.weights, g.weights) and back.tpl == g.tpl
    params = {"graph": "g0", "task_rates": {"3": 1.5},
              "link_speed": {"l1": 0.5}}
    for rid, op in enumerate(rsvc.protocol.OPS):
        rr = rsvc.Request(rid, op, "carA", dict(params))
        pr = psvc.Request(rid, op, "carA", dict(params))
        assert psvc.encode_request(pr) == rsvc.encode_request(rr)
        assert dataclasses.asdict(psvc.decode_request(
            rsvc.encode_request(rr))) == dataclasses.asdict(rr)
    for resp in ((1, True, {"makespan": 12.25, "proc": [0, 2]}, None),
                 (2, False, None, {"code": "infeasible",
                                   "message": "no placement"})):
        line = rsvc.encode_response(rsvc.Response(*resp))
        assert psvc.encode_response(psvc.Response(*resp)) == line
        assert dataclasses.asdict(psvc.decode_response(line)) == \
            dataclasses.asdict(rsvc.decode_response(line))
    assert psvc.ERROR_CODES == ("bad-request", "no-graphs", "infeasible",
                                "device-error", "internal")
    for bad in (b"not json\n", b'{"op": "plan"}\n',
                b'{"id": 1, "op": "nope", "tenant": "t"}\n'):
        with pytest.raises(RefProtocolError):
            rsvc.decode_request(bad)
        with pytest.raises(psvc.ProtocolError):
            psvc.decode_request(bad)
    with pytest.raises(psvc.ProtocolError):
        psvc.spg_from_json({"n": 2})


def test_sharding_and_coalescing_equal_reference():
    keys = [f"tenant{i}" for i in range(300)] + [""]
    assert [psvc.stable_hash(k) for k in keys] == \
        [rsvc.stable_hash(k) for k in keys]
    for n in (1, 4, 5):
        shards = [f"w{i}" for i in range(n)]
        pr, rr = psvc.HashRing(shards), rsvc.HashRing(shards)
        assert [pr.lookup(k) for k in keys] == [rr.lookup(k) for k in keys]
    assert psvc.shard_key("carA", "3p-3l") == rsvc.shard_key("carA", "3p-3l")
    rng = np.random.default_rng(3)
    kinds = ["register", "update", "plan", "mark_failed", "restore"]
    items = [(kinds[int(rng.integers(len(kinds)))], i) for i in range(80)]
    got = psvc.coalesce(items, lambda it: it[0])
    want = rsvc.coalesce(items, lambda it: it[0])
    assert [(b.kind, b.items) for b in got] == \
        [(b.kind, b.items) for b in want]
    assert psvc.COALESCIBLE == rsvc.COALESCIBLE


# ------------------------------------------------- running the requests
def _services(tg, backend, policy=_POLICY, **kw):
    return (rsvc.SchedulerService(tg, policy, backend="scalar", **kw),
            psvc.SchedulerService(_tp(tg), _pol(port, policy),
                                  backend=backend, device="cpu", **kw))


def _port_params(params):
    """A request's parameters for the port: graphs as the port's SPGs."""
    out = dict(params)
    if isinstance(out.get("graph"), ref.SPG):
        g = _gp(out["graph"])
        g.name = out["graph"].name
        out["graph"] = g
    return out


def _view(resp, backend):
    """A response as the reference would give it: its wire form without
    latency fields; on the cuda backend the backend name and the
    simulation count of a fresh grid (the fused sweep simulates every
    alpha) are checked and then set to the reference's."""
    body = json.loads(psvc.encode_response(resp))
    res = body.get("result") or {}
    for k in _LATENCY:
        res.pop(k, None)
    if backend == "cuda" and "backend" in res:
        assert res["backend"] == "cuda"
        res["backend"] = "scalar"
        rep = res.get("replay")
        if rep is not None and rep["suffix_start"] == 0:
            del rep["decisions_simulated"]
    return body


def _ref_view(resp, fresh_grid_counts=False):
    body = json.loads(rsvc.encode_response(resp))
    res = body.get("result") or {}
    for k in _LATENCY:
        res.pop(k, None)
    rep = res.get("replay")
    if fresh_grid_counts and rep is not None and rep["suffix_start"] == 0:
        del rep["decisions_simulated"]
    return body


async def _drive(svc, bursts, port_side):
    """Run the bursts (each a list of (tenant, op, params) sent together)
    and return every response in request order."""
    out = []
    for burst in bursts:
        futs = [asyncio.ensure_future(svc.request(
            tenant, op, rid=i, **(_port_params(p) if port_side else p)))
            for i, (tenant, op, p) in enumerate(burst)]
        out.extend(await asyncio.gather(*futs))
    return out


def _run_both(tg, backend, bursts, policy=_POLICY, **kw):
    rs, ps = _services(tg, backend, policy, **kw)
    try:
        rr = asyncio.run(_drive(rs, bursts, False))
        pr = asyncio.run(_drive(ps, bursts, True))
    finally:
        rs.close()
        ps.close()
    assert len(rr) == len(pr)
    for a, b in zip(rr, pr):
        assert _view(b, backend) == _ref_view(a, backend == "cuda")
        if not b.ok:
            assert b.error["code"] in psvc.ERROR_CODES
    return rs, ps, rr, pr


def _join():
    tg = ref.fully_switched_topology(2, rates=[1.0, 1.0],
                                     link_speeds=[1.0, 1.0])
    g = ref.SPG(n=3, edges=[(0, 2), (1, 2)], weights=[4.0, 4.0, 2.0],
                tpl={(0, 2): 2.0, (1, 2): 2.0}, name="join")
    return tg, g


def _reg(tenant, g, name=None):
    return (tenant, "register", {"graph": g, "name": name or g.name})


def _scenario(name):
    """(topology, service kwargs, policy, bursts) of the request scripts
    of tests/test_service.py."""
    tg = _tg()
    gs = _graphs(tg)
    A = "carA"
    plans = [[(A, "plan", {"graph": g.name}) for g in gs] + [(A, "plan", {})]]
    if name == "register_update_bursts":
        return tg, {}, _POLICY, [
            [_reg(A, g) for g in gs],
            [(A, "update", {"task_rates": {1: 1.5}, "graph": "g0"}),
             (A, "update", {"task_rates": {3: 0.8}, "graph": "g1"}),
             (A, "update", {"link_speed": {tg.all_links()[0]: 0.5}})],
            [(A, "update", {"task_rates": {2: 1.3}, "graph": "g2"})],
            [(A, "stats", {})]] + plans
    if name == "errors":
        return tg, {}, _POLICY, [
            [(A, "plan", {})], [(A, "update", {"task_rates": {0: 1.5}})],
            [_reg(A, gs[0], "g0")], [_reg(A, gs[1], "g0")],
            [(A, "update", {"task_rates": {0: 1.5}, "graph": "nope"})],
            [(A, "update", {"task_rates": {999: 1.5}, "graph": "g0"})],
            [(A, "mark_failed", {"proc": 99})], [(A, "frobnicate", {})],
            [(A, "plan", {"graph": "g0"}), (A, "plan", {"graph": "nope"}),
             (A, "plan", {})],
            [(A, "degrade", {"task": 999, "factor": 2.0, "graph": "g0"})],
            [(A, "stats", {})]]
    if name == "faults":
        return tg, {}, _POLICY, [
            [(A, "mark_failed", {"proc": 3})],
            [_reg(A, g) for g in gs],
            [(A, "update", {"task_rates": {1: 1.4}, "graph": "g1"})],
            [(A, "mark_failed", {"proc": 2})],
            [(A, "degrade", {"link": tg.all_links()[1], "factor": 2.0})],
            [(A, "degrade", {"task": 2, "factor": 1.6, "graph": "g0"})],
            [(A, "restore", {"proc": 3})], [(A, "restore", {"proc": 2})]
        ] + plans
    if name == "mixed_bursts":
        return tg, {}, _POLICY, [
            [_reg(A, gs[0], "a"), _reg(A, gs[1], "a"), _reg(A, gs[2], "b")],
            [(A, "update", {"task_rates": {1: 1.3}, "graph": "a"}),
             (A, "update", {"task_rates": {999: 1.5}, "graph": "a"}),
             (A, "update", {"task_rates": {2: 0.9}, "graph": "b"})],
            [(A, "plan", {"graph": "a"}), (A, "plan", {"graph": "b"})]]
    if name == "eviction":
        B = "carB"
        return tg, dict(workers=1, max_tenants_per_worker=1), _POLICY, [
            [_reg(A, gs[0], "g0")],
            [(A, "update", {"task_rates": {2: 1.3}, "graph": "g0"})],
            [(A, "plan", {"graph": "g0"})], [_reg(B, gs[1], "g1")],
            [(A, "plan", {"graph": "g0"})], [_reg(B, gs[2], "g2")],
            [(A, "degrade", {"task": 3, "factor": 1.4})],
            [(A, "plan", {"graph": "g0"}), (B, "plan", {})],
            [(A, "stats", {})]]
    # an infeasible partition, a spike on it, and the restore that heals
    tg, g = _join()
    return tg, {}, ref.HVLB_CC_B(alpha_max=1.0, alpha_step=1.0), [
        [_reg(A, g)], [(A, "mark_failed", {"link": "l1"})], [(A, "plan", {})],
        [(A, "degrade", {"task": 0, "factor": 2.0})],
        [(A, "restore", {"link": "l1"})], [(A, "plan", {})]]


@pytest.mark.parametrize("name", ["register_update_bursts", "errors",
                                  "faults", "mixed_bursts", "eviction",
                                  "infeasible"])
@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("backend", BACKENDS)
def test_request_scripts_equal_reference(name, coalesce, backend):
    tg, kw, policy, bursts = _scenario(name)
    rs, ps, rr, pr = _run_both(tg, backend, bursts, policy,
                               coalesce=coalesce, **kw)
    assert ps.stats.view().keys() == rs.stats.view().keys()
    for k in ("requests", "batches", "replans", "coalesced_events",
              "plan_cache_hits", "errors", "evictions"):
        assert getattr(ps.stats, k) == getattr(rs.stats, k), k
    if name == "infeasible":
        codes = [r.error["code"] if not r.ok else None for r in pr]
        if pr[0].ok and len(set(pr[0].result["proc"][:2])) == 2:
            assert codes[1:4] == ["infeasible"] * 3 and codes[4:] == [None] * 2


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("backend", BACKENDS)
def test_chaos_scripts_equal_reference(seed, backend):
    """The seeded multi-tenant chaos scripts: the same responses as the
    reference, and each tenant's final fleet the port's own fresh
    submit_many on the final state."""
    tg = _topology()
    rng = np.random.default_rng(7_000 + seed)
    scripts = {tenant: _script(rng, tg, tenant, n_ops=12)
               for tenant in ("carA", "carB")}
    bursts = []
    for b in range(max(len(s) for s in scripts.values())):
        bursts.append([(tenant, kind, params)
                       for tenant, s in scripts.items() if b < len(s)
                       for kind, params in s[b]])
    bursts.append([(tenant, "plan", {}) for tenant in scripts])
    policy = ref.HVLB_CC_B(alpha_max=1.0, alpha_step=0.5)
    rs, ps, rr, pr = _run_both(tg, backend, bursts, policy, workers=3)
    for tenant, resp in zip(scripts, pr[-len(scripts):]):
        t = ps._tenants[tenant]
        if not resp.ok:
            assert resp.error["code"] == "infeasible"
            continue
        fresh = port.Scheduler(t.topology, backend="scalar", policy=(
            dataclasses.replace(_pol(port, policy),
                                period=resp.result["period"])),
            faults=t.fault_records)
        fleet = fresh.submit_many(list(t.graphs.values()))
        assert float(fleet.makespan) == resp.result["makespan"]
        assert port.schedule_violations(fleet.schedule, fresh.faults) == []


def test_service_trace_coalescing_is_invisible():
    """A reduced exp10 trace (4 tenants, 4 graphs of 10 tasks, 3 bursts of
    3 drift updates) on the kernels' plain versions: the same final views
    with coalescing on and off, fewer replans with it on, and every
    response the reference's."""
    tg = ref.fully_switched_topology(8, [1.0, 1.2, 0.9, 1.1, 1.3, 0.95,
                                         1.05, 0.8],
                                     [1.0, 2.0, 1.5, 1.0, 3.0, 2.5, 1.0,
                                      2.0])
    bursts = [[], [], [], []]
    for t in range(4):
        rng = np.random.default_rng(10_000 + t)
        graphs = [ref.random_spg(10, rng, ccr=1.0, tg=tg,
                                 outdeg_constraint=True) for _ in range(4)]
        for k, g in enumerate(graphs):
            g.name = f"t{t}g{k}"
            bursts[0].append(_reg(f"tenant{t}", g))
        for b in range(3):
            for _ in range(3):
                gname = f"t{t}g{int(rng.integers(4))}"
                bursts[b + 1].append((f"tenant{t}", "update", {
                    "task_rates": {int(rng.integers(10)):
                                   float(rng.uniform(0.7, 1.4))},
                    "graph": gname}))
    finals = [[(f"tenant{t}", "plan", {"graph": f"t{t}g{k}"})
               for t in range(4) for k in range(4)]]
    views, replans = [], []
    for coalesce in (True, False):
        _, ps, _, pr = _run_both(tg, "cuda", bursts + finals,
                                 workers=4, coalesce=coalesce)
        assert all(r.ok for r in pr)
        views.append([r.result for r in pr[-16:]])
        replans.append(ps.stats.replans)
    assert views[0] == views[1]
    assert replans[1] > 2 * replans[0]


# ----------------------------------------------------------------- TCP
def test_tcp_front_end_answers_as_the_reference():
    tg = _tg()
    g = _graphs(tg, k=1, seed=7)[0]
    gp = _gp(g)
    gp.name = g.name
    lines = [psvc.encode_request(psvc.Request(*r)) for r in (
        (1, "register", "carA", {"name": "g0",
                                 "graph": psvc.spg_to_json(gp)}),
        (2, "update", "carA", {"graph": "g0", "task_rates": {"2": 1.4}}),
        (3, "plan", "carA", {"graph": "g0"}),
        (4, "mark_failed", "carA", {"proc": 99}),
        (5, "stats", "carA", {}))] + [
        b"this is not json\n",
        b'{"id": 6, "op": "plan", "tenant": "carA", "rid": 9}\n']

    async def main():
        svc = psvc.SchedulerService(_tp(tg), _pol(port, _POLICY), workers=2,
                                    device="cpu")
        try:
            server = await pmain.serve(svc, "127.0.0.1", 0)
        except OSError as e:
            svc.close()
            return ("skip", str(e))
        host, p = server.sockets[0].getsockname()[:2]
        reader, writer = await asyncio.open_connection(host, p)
        for line in lines:                     # a pipelined burst
            writer.write(line)
        await writer.drain()
        got = {}
        for _ in lines:
            resp = psvc.decode_response(
                await asyncio.wait_for(reader.readline(), timeout=60))
            got.setdefault(resp.id, resp)
        writer.close()
        await writer.wait_closed()
        server.close()
        await server.wait_closed()
        svc.close()
        return ("ok", got)

    status, got = asyncio.run(main())
    if status == "skip":
        pytest.skip(f"cannot bind a localhost socket: {got}")
    rs = rsvc.SchedulerService(tg, _POLICY, backend="scalar", workers=2)

    async def ref_side():
        out = {}
        for line in lines[:5]:
            req = rsvc.decode_request(line)
            params = dict(req.params)
            if req.op == "register":
                params["graph"] = rsvc.spg_from_json(params["graph"])
            out[req.id] = await rs.request(req.tenant, req.op, rid=req.id,
                                           **params)
        return out

    want = asyncio.run(ref_side())
    rs.close()
    for rid in range(1, 5):
        assert _view(got[rid], "cuda") == _ref_view(want[rid], True)
    # stats is answered inline, ahead of the pipelined requests
    assert got[5].ok and got[5].result.keys() == want[5].result.keys()
    assert got[0].error["code"] == "bad-request"
    assert got[6].error["code"] == "internal"


def _args(*argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--window", type=float, default=0.002)
    ap.add_argument("--no-coalesce", action="store_true")
    ap.add_argument("--topology", default="paper")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="cuda")
    return ap.parse_args(argv)


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmain.build_service(_args())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        psvc.SchedulerService(port.paper_topology())
    for argv in (("--device", "cpu"), ("--backend", "scalar"),
                 ("--device", "cpu", "--topology", "switched:4")):
        svc = pmain.build_service(_args(*argv))
        assert svc.device.type == ("cpu" if "cpu" in argv else "cuda")
        svc.close()
    with pytest.raises(SystemExit):
        pmain.main(["--backend", "vector"])


# ----------------------------------------------- failures of the card
def _drift_script():
    tg = _tg()
    gs = _graphs(tg)
    A = "carA"
    return tg, [[_reg(A, g) for g in gs],
                [(A, "update", {"task_rates": {1: 1.5}, "graph": "g0"}),
                 (A, "update", {"task_rates": {2: 0.7}, "graph": "g1"})],
                [(A, "mark_failed", {"proc": 1})],
                [(A, "plan", {"graph": "g0"})]]


def test_kernel_failure_answers_device_error(monkeypatch, caplog):
    """A kernel that fails (here the plain version the wrapper runs on CPU
    tensors) fails its requests with ``device-error`` and a log line;
    once the card works again the tenant is served from its last good
    state (its graphs undrifted, the processor fault that failed to
    replan still recorded), as the reference serves that state."""
    tg, bursts = _drift_script()
    good = bursts[:1] + bursts[2:]
    _, ps_good, _, want = _run_both(tg, "cuda", good)
    svc = psvc.SchedulerService(_tp(tg), _pol(port, _POLICY), device="cpu")
    real = K.plan_plain
    broken = {"on": False}

    def plan_plain(*args, **kwargs):
        if broken["on"]:
            raise _nvcc.KernelError("sched_plan_kernel launch failed with "
                                    "CUDA error 700")
        return real(*args, **kwargs)

    monkeypatch.setattr(K, "plan_plain", plan_plain)

    async def main():
        out = await _drive(svc, bursts[:1], True)
        broken["on"] = True
        out += await _drive(svc, bursts[1:3], True)
        broken["on"] = False
        out += await _drive(svc, bursts[3:], True)
        return out

    with caplog.at_level(logging.ERROR, logger="repro_torch.service"):
        resps = asyncio.run(main())
    svc.close()
    assert all(r.ok for r in resps[:3])
    assert [r.error["code"] for r in resps[3:6]] == ["device-error"] * 3
    assert "CUDA error 700" in resps[3].error["message"]
    assert sum("failed on the device" in rec.getMessage()
               for rec in caplog.records) >= 3
    assert resps[6].ok and resps[6].result == want[-1].result
    assert resps[6].result["faults"]["down_procs"] == [1]
    assert resps[6].result["fallback"] is None
    assert svc.stats.errors == 3


def test_watchdog_overrun_answers_device_error(monkeypatch):
    monkeypatch.setenv("REPRO_SCHED_WAVE_TIMEOUT", "1e-9")
    tg, bursts = _drift_script()
    svc = psvc.SchedulerService(_tp(tg), _pol(port, _POLICY), device="cpu")
    resps = asyncio.run(_drive(svc, bursts[:1], True))
    svc.close()
    assert {r.error["code"] for r in resps} == {"device-error"}
    assert "WaveTimeoutError" in resps[0].error["message"]
    # the host reference keeps no watchdog: the same service on it serves
    ssvc = psvc.SchedulerService(_tp(tg), _pol(port, _POLICY),
                                 backend="scalar")
    assert all(r.ok for r in asyncio.run(_drive(ssvc, bursts, True)))
    ssvc.close()


def test_library_cache_and_launch_counts_across_threads():
    """The locks the service's worker lanes rely on: one load for every
    thread that asks at once, and launch counts that add up."""
    loads = []
    barrier = threading.Barrier(8)

    def load():
        loads.append(1)
        return object()

    cache = _nvcc.LibraryCache(load)
    counts = {"a": 0, "b": 0}
    got = []

    def work():
        barrier.wait()
        got.append(cache.get())
        for _ in range(2000):
            _nvcc.count_launch((counts, "a"), (counts, "b"))

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(loads) == 1 and all(x is got[0] for x in got)
    assert counts == {"a": 16000, "b": 16000}
