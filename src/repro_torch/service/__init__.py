"""Scheduler-as-a-service: async serving front-end over the session API.

Twin of ``repro.service``: many logical clients (tenants) register
stream graphs, report drift and resource faults, and fetch plans
concurrently; the service coalesces request bursts into single fleet
replans / batched suffix replays and shards tenants across worker lanes
by consistent hashing.  Every tenant's scheduler runs its kernels
on the service's device, the card unless the caller asks for the CPU.
Run a TCP front-end with ``python -m repro_torch.service``; in-process
use::

    svc = SchedulerService(paper_topology())          # or device="cpu"
    client = svc.client("carA")
    resp = await client.register(graph, name="g0")
"""
from .coalescing import COALESCIBLE, Batch, coalesce
from .protocol import (ERROR_CODES, ProtocolError, Request, Response,
                       decode_request, decode_response, encode_request,
                       encode_response, spg_from_json, spg_to_json)
from .service import (DEVICE_ERRORS, SchedulerService, ServiceClient,
                      ServiceError, ServiceStats)
from .sharding import HashRing, shard_key, stable_hash

__all__ = [
    "SchedulerService", "ServiceClient", "ServiceError", "ServiceStats",
    "Batch", "coalesce", "COALESCIBLE",
    "HashRing", "shard_key", "stable_hash",
    "Request", "Response", "ProtocolError", "ERROR_CODES", "DEVICE_ERRORS",
    "encode_request", "decode_request",
    "encode_response", "decode_response",
    "spg_to_json", "spg_from_json",
]
