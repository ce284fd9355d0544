"""Automotive-DSMS serving example: registered continuous queries over a
decoding LM stream, statically scheduled with HVLB_CC, with an
imprecise-computation query that refines only when its schedule hole
allows (Section 4.4 of the paper, end to end); then the scheduler
service.  The twin of the reference's ``examples/dsms_serve.py``.  On
the card::

    PYTHONPATH=src python -m repro_torch.examples.dsms_serve

and on the CPU::

    PYTHONPATH=src python -m repro_torch.examples.dsms_serve --device cpu

The model is qwen3-8b's reduced config with random weights drawn from a
``torch.Generator`` seeded 0 (not the reference's draws).
"""
from __future__ import annotations

import argparse
import asyncio
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs import get_arch, reduced_config
from ..core import fully_switched_topology, random_spg
from ..core.backends.cuda import check_device
from ..models.params import init_params
from ..serve import DSMSEngine, Query
from ..service import SchedulerService


def queries() -> List[Query]:
    """The example's three continuous queries."""
    return [
        # Query 1: collision-warning analogue — threshold detector on the
        # max logit.
        Query(name="alert",
              mandatory=lambda logits: torch.softmax(
                  logits[:, -1], dim=-1).max(dim=-1).values),
        # Query 2: navigation analogue — top-5 candidates, with an
        # *optional* refinement (full sort) that only runs in schedule
        # holes.
        Query(name="nav_topk",
              mandatory=lambda logits: torch.topk(logits[:, -1], 5),
              optional=lambda res: (res[0], res[1],
                                    torch.sort(res[0]).values.flip(-1)),
              optional_ratio=0.5),
        # Query 3: logging analogue.
        Query(name="log_mean",
              mandatory=lambda logits: logits[:, -1].mean(dim=-1)),
    ]


async def service_quickstart(device: torch.device) -> None:
    """Scheduler-as-a-service quickstart.  Many logical clients share one
    async service: bursts of registrations coalesce into ONE
    submit_many fleet replan, bursts of drift updates into ONE batched
    suffix-replay update; tenants are sharded across worker lanes by
    consistent hashing.  (``python -m repro_torch.service`` serves the
    same ops over newline-delimited JSON on TCP.)"""
    tg = fully_switched_topology(4, rates=[1.0, 1.1, 0.9, 1.2],
                                 link_speeds=[1.0, 1.5, 0.9, 1.2])
    svc = SchedulerService(tg, workers=2, device=device)
    try:
        car = svc.client("carA")
        rng = np.random.default_rng(0)
        graphs = [random_spg(10, rng, tg=tg) for _ in range(3)]

        # a burst of registrations -> ONE fleet replan
        resps = await asyncio.gather(*[
            asyncio.ensure_future(car.register(g, name=f"q{k}"))
            for k, g in enumerate(graphs)])
        print(f"service: registered {len(resps)} query graphs with "
              f"{svc.stats.replans} replan; fleet makespan="
              f"{resps[0].result['makespan']:.3f}")

        # a burst of drift reports -> ONE batched suffix replay
        resps = await asyncio.gather(
            asyncio.ensure_future(car.update(task_rates={2: 1.5},
                                             graph="q0")),
            asyncio.ensure_future(car.update(task_rates={4: 0.8},
                                             graph="q1")))
        print(f"service: 2 drift updates folded into "
              f"{resps[0].result['replay']['coalesced']}-event replay "
              f"({svc.stats.replans} replans total)")

        # faults surface as structured responses, not exceptions
        resp = await car.mark_failed(proc=3)
        print(f"service: proc 3 down -> ok={resp.ok}, "
              f"makespan={resp.result['makespan']:.3f}, "
              f"faults={resp.result['faults']}")
    finally:
        svc.close()


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the example; returns the serving engine and each step's
    result."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "dsms_serve")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model and the scheduler run")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    dev = check_device(args.device)

    cfg = reduced_config(get_arch("qwen3-8b"))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    engine = DSMSEngine(cfg, params, batch_size=args.batch,
                        max_seq=args.max_seq, device=dev)
    del params
    for q in queries():
        engine.register(q)

    # Registration is O(1): the schedule is computed once, lazily — three
    # registrations cost one re-plan, not three.
    assert engine.replans == 0
    engine.ensure_plan()
    print(f"engine: {len(engine.queries)} queries, {engine.replans} replan; "
          f"plan makespan={engine.plan.makespan * 1e3:.3f} ms on "
          f"{engine.topology.n_procs} slices")
    print(f"holes: { {k: round(v*1e3, 3) for k, v in engine.holes.items()} }"
          f" (ms)")

    toks = np.zeros(args.batch, np.int64)
    steps = []
    for t in range(args.steps):
        res = engine.step(toks)
        steps.append(res)
        toks = res.tokens
        prec = {k: ("precise" if v else "imprecise")
                for k, v in res.precise.items()}
        alert = res.query_outputs["alert"].double().cpu().numpy()
        print(f"step {t}: tokens={res.tokens.tolist()} "
              f"alert={alert.round(3).tolist()} {prec}")
    print("done.")

    asyncio.run(service_quickstart(dev))
    print("service quickstart done.")
    return {"engine": engine, "steps": steps}


if __name__ == "__main__":
    main()
