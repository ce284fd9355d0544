"""Wire protocol of the scheduler service: newline-delimited JSON.

Twin of ``repro.service.protocol``, byte for byte on the wire: a client
of either service works with the other.  One request per line, one
response per line, matched by ``id``.  The codec is intentionally thin —
plain ``json`` over the stdlib, floats serialized with full ``repr``
round-trip fidelity so a schedule read back over TCP is bit-identical to
the in-process plan.

Request::

    {"id": 7, "op": "register", "tenant": "carA",
     "name": "g0", "graph": {<SPG>}}
    {"id": 8, "op": "update", "tenant": "carA",
     "graph": "g0", "task_rates": {"3": 1.5}, "link_speed": {"l1": 0.5}}
    {"id": 9, "op": "mark_failed", "tenant": "carA", "proc": 2}
    {"id": 10, "op": "plan", "tenant": "carA", "graph": "g0"}

Response::

    {"id": 7, "ok": true, "result": {<plan view>}}
    {"id": 9, "ok": false,
     "error": {"code": "infeasible", "message": "..."}}

Error codes (:data:`ERROR_CODES`): ``bad-request`` (malformed
arguments), ``no-graphs`` (plan/update before any register),
``infeasible`` (:class:`repro_torch.core.InfeasibleScheduleError` — no
feasible placement under the active faults; the fault stays recorded),
``device-error`` (a kernel that failed to build or launch, a CUDA error,
or a watchdog overrun; the port demotes to no other backend, so the
request fails and the tenant's last good plan is rebuilt on its next
request), ``internal``.  ``result.fallback`` is kept for parity with the
reference's responses and is always ``null``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

import numpy as np

from ..core.graph import SPG

__all__ = ["ERROR_CODES", "OPS", "Request", "Response", "spg_to_json",
           "spg_from_json", "encode_request", "decode_request",
           "encode_response", "decode_response", "ProtocolError"]

OPS = ("register", "update", "mark_failed", "degrade", "restore",
       "plan", "stats")

#: every ``error.code`` a response may carry
ERROR_CODES = ("bad-request", "no-graphs", "infeasible", "device-error",
               "internal")


class ProtocolError(ValueError):
    """Malformed request/response payload."""


@dataclasses.dataclass
class Request:
    """One decoded client request."""

    id: int
    op: str
    tenant: str
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Response:
    """One service response (``ok`` XOR ``error``)."""

    id: int
    ok: bool
    result: Optional[Dict[str, Any]] = None
    error: Optional[Dict[str, str]] = None

    @classmethod
    def success(cls, rid: int, result: Dict[str, Any]) -> "Response":
        return cls(id=rid, ok=True, result=result)

    @classmethod
    def failure(cls, rid: int, code: str, message: str) -> "Response":
        return cls(id=rid, ok=False,
                   error={"code": code, "message": message})


# ----------------------------------------------------------------- SPG
def spg_to_json(g: SPG) -> Dict[str, Any]:
    """JSON-safe view of an SPG (exact float round-trip)."""
    return {
        "n": g.n,
        "edges": [[int(i), int(j)] for (i, j) in g.edges],
        "weights": [float(w) for w in g.weights],
        "tpl": {f"{i},{j}": float(v) for (i, j), v in g.tpl.items()},
        "ccr": g.tpl_proportional_ccr,
        "comp_matrix": (None if g.comp_matrix is None
                        else np.asarray(g.comp_matrix).tolist()),
        "name": g.name,
    }


def spg_from_json(d: Dict[str, Any]) -> SPG:
    try:
        tpl = {}
        for key, v in (d.get("tpl") or {}).items():
            i, j = key.split(",")
            tpl[(int(i), int(j))] = float(v)
        cm = d.get("comp_matrix")
        return SPG(n=int(d["n"]),
                   edges=[(int(i), int(j)) for i, j in d["edges"]],
                   weights=np.asarray(d["weights"], dtype=float),
                   tpl=tpl,
                   tpl_proportional_ccr=d.get("ccr"),
                   comp_matrix=None if cm is None
                   else np.asarray(cm, dtype=float),
                   name=str(d.get("name", "spg")))
    except ProtocolError:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"malformed SPG payload: {e}") from e


# ------------------------------------------------------------- framing
def encode_request(req: Request) -> bytes:
    body = {"id": req.id, "op": req.op, "tenant": req.tenant, **req.params}
    return (json.dumps(body) + "\n").encode("utf-8")


def decode_request(line: bytes) -> Request:
    try:
        body = json.loads(line.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"not a JSON request line: {e}") from e
    if not isinstance(body, dict):
        raise ProtocolError("request must be a JSON object")
    try:
        rid = int(body.pop("id"))
        op = str(body.pop("op"))
        tenant = str(body.pop("tenant"))
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(
            f"request needs integer 'id', string 'op' and 'tenant': {e}"
        ) from e
    if op not in OPS:
        raise ProtocolError(f"unknown op {op!r} (expected one of {OPS})")
    return Request(id=rid, op=op, tenant=tenant, params=body)


def encode_response(resp: Response) -> bytes:
    body: Dict[str, Any] = {"id": resp.id, "ok": resp.ok}
    if resp.result is not None:
        body["result"] = resp.result
    if resp.error is not None:
        body["error"] = resp.error
    return (json.dumps(body) + "\n").encode("utf-8")


def decode_response(line: bytes) -> Response:
    try:
        body = json.loads(line.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"not a JSON response line: {e}") from e
    if not isinstance(body, dict) or "id" not in body or "ok" not in body:
        raise ProtocolError("response needs 'id' and 'ok'")
    return Response(id=int(body["id"]), ok=bool(body["ok"]),
                    result=body.get("result"), error=body.get("error"))
