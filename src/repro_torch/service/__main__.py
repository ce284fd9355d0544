"""``python -m repro_torch.service`` — stdlib asyncio TCP front-end.

Twin of ``python -m repro.service``, with the same wire format.
Newline-delimited JSON requests in, responses out (see
:mod:`.protocol`); requests on one connection are
*pipelined* — the server dispatches each line as it arrives and writes
responses as they resolve (matched by ``id``), so a client that sends a
burst without waiting gets the full benefit of request coalescing.

Every tenant's scheduler runs on ``--device`` (default ``cuda``, the
card; a host without one refuses to start unless ``--device cpu`` or
``--backend scalar`` is given) with ``--backend`` (default ``cuda``) in
``--dtype`` (default ``float64``; ``float32`` is the near-tie mode).

Example::

    python -m repro_torch.service --port 8642 --topology switched:8 &
    printf '%s\n' \\
      '{"id":1,"op":"register","tenant":"carA","name":"g0","graph":{...}}' \\
      '{"id":2,"op":"plan","tenant":"carA","graph":"g0"}' | nc localhost 8642
"""
from __future__ import annotations

import argparse
import asyncio
from typing import Optional

import torch

from ..core import Topology, fully_switched_topology, paper_topology

from .protocol import (ProtocolError, Response, decode_request,
                       encode_response, spg_from_json)
from .service import SchedulerService

__all__ = ["build_service", "serve", "main"]


def _parse_topology(spec: str) -> Topology:
    if spec == "paper":
        return paper_topology()
    if spec.startswith("switched:"):
        p = int(spec.split(":", 1)[1])
        return fully_switched_topology(p, rates=[1.0] * p,
                                       link_speeds=[1.0] * p)
    raise SystemExit(f"unknown topology {spec!r} "
                     f"(expected 'paper' or 'switched:<P>')")


def build_service(args: argparse.Namespace) -> SchedulerService:
    # a namespace without ``dtype`` (built by hand) is float64's
    dtype = getattr(torch, getattr(args, "dtype", "float64"))
    return SchedulerService(_parse_topology(args.topology),
                            workers=args.workers, window=args.window,
                            coalesce=not args.no_coalesce,
                            backend=args.backend, device=args.device,
                            dtype=dtype)


async def _handle(service: SchedulerService,
                  reader: asyncio.StreamReader,
                  writer: asyncio.StreamWriter) -> None:
    wlock = asyncio.Lock()
    tasks = set()

    async def dispatch(line: bytes) -> None:
        rid = 0
        try:
            req = decode_request(line)
            rid = req.id
            params = dict(req.params)
            if req.op == "register" and isinstance(params.get("graph"),
                                                   dict):
                params["graph"] = spg_from_json(params["graph"])
            resp = await service.request(req.tenant, req.op, rid=rid,
                                         **params)
        except ProtocolError as e:
            resp = Response.failure(rid, "bad-request", str(e))
        except Exception as e:
            # e.g. a JSON key colliding with request()'s parameters:
            # every request line gets exactly one response, or a
            # pipelined client hangs on the missing id
            resp = Response.failure(rid, "internal",
                                    f"{type(e).__name__}: {e}")
        async with wlock:
            writer.write(encode_response(resp))
            await writer.drain()

    try:
        while True:
            line = await reader.readline()
            if not line:
                break
            if not line.strip():
                continue
            task = asyncio.ensure_future(dispatch(line))
            tasks.add(task)
            task.add_done_callback(tasks.discard)
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
    except ConnectionResetError:
        pass
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except ConnectionResetError:
            pass


async def serve(service: SchedulerService, host: str,
                port: int) -> asyncio.AbstractServer:
    """Start (and return) the TCP server; callers own its lifetime."""
    return await asyncio.start_server(
        lambda r, w: _handle(service, r, w), host, port)


async def _amain(args: argparse.Namespace) -> None:
    service = build_service(args)
    try:
        server = await serve(service, args.host, args.port)
        addr = server.sockets[0].getsockname()
        print(f"repro_torch.service listening on {addr[0]}:{addr[1]} "
              f"(workers={args.workers}, window={args.window}s, "
              f"coalesce={not args.no_coalesce}, backend={args.backend}, "
              f"device={args.device}, dtype={args.dtype})", flush=True)
        async with server:
            await server.serve_forever()
    finally:
        service.close()


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="Async scheduling service over the repro_torch.core "
                    "session API (newline-delimited JSON over TCP)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--workers", type=int, default=4,
                    help="worker lanes (consistent-hash shards)")
    ap.add_argument("--window", type=float, default=0.002,
                    help="coalescing debounce window, seconds")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="process every request as its own batch")
    ap.add_argument("--topology", default="paper",
                    help="'paper' or 'switched:<P>'")
    ap.add_argument("--device", default="cuda",
                    help="where the cuda backend runs: 'cuda' (the card) "
                         "or 'cpu' (the kernels' plain versions)")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "scalar"),
                    help="every tenant session's candidate-evaluation "
                         "backend")
    ap.add_argument("--dtype", default="float64",
                    choices=("float64", "float32"),
                    help="the cuda backend's real type: float64 (bit-"
                         "identical to scalar) or float32 (the near-tie "
                         "mode)")
    args = ap.parse_args(argv)
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
