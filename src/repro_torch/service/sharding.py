"""Deterministic shard assignment for the serving layer.

Twin of ``repro.service.sharding`` (the same hashes, so a tenant lands
on the same lane in either service).  The service spreads tenants across
a pool of worker lanes, each owning the
:class:`repro_torch.core.Scheduler` sessions (and therefore the plan/trace
caches) of the tenants assigned to it.  Assignment uses consistent
hashing so that

  * the tenant -> worker mapping is a pure function of the tenant key
    and the worker-pool shape (no registration order dependence), and
  * resizing the pool moves only ~1/N of the tenants (the classic
    consistent-hashing property) — plan caches of unaffected tenants
    survive a pool resize.

All hashing is SHA-256 based: :func:`stable_hash` is independent of
``PYTHONHASHSEED`` and of the process, so shard placement is
reproducible across runs and machines.
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Sequence

__all__ = ["stable_hash", "shard_key", "HashRing"]


def stable_hash(key: str) -> int:
    """64-bit stable hash of ``key`` (first 8 bytes of SHA-256).

    Unlike the builtin ``hash``, the value does not depend on
    ``PYTHONHASHSEED`` — shard placement must be reproducible.
    """
    digest = hashlib.sha256(key.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big")


def shard_key(tenant: str, topology_tag: str = "") -> str:
    """The cache/shard key contract.

    A tenant's sessions are keyed by ``tenant@topology_tag``: two
    services over different topologies place the same tenant
    independently, while within one service the key — and therefore
    the owning worker, its Scheduler session, and its plan/trace
    caches — is stable for the tenant's whole lifetime.
    """
    return f"{tenant}@{topology_tag}" if topology_tag else tenant


class HashRing:
    """Consistent-hash ring over a fixed set of shard names.

    Each shard contributes ``replicas`` virtual nodes; :meth:`lookup`
    walks clockwise from the key's hash to the next virtual node
    (``bisect`` over the sorted ring, wrap-around at the end).
    """

    def __init__(self, shards: Sequence[str], replicas: int = 64) -> None:
        if not shards:
            raise ValueError("HashRing needs at least one shard")
        if len(set(shards)) != len(shards):
            raise ValueError("HashRing shard names must be unique")
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.shards: List[str] = list(shards)
        self.replicas = replicas
        points: Dict[int, str] = {}
        for name in self.shards:
            for r in range(replicas):
                points[stable_hash(f"{name}#{r}")] = name
        self._hashes: List[int] = sorted(points)
        self._owner: List[str] = [points[h] for h in self._hashes]

    def lookup(self, key: str) -> str:
        """Owning shard of ``key`` (deterministic, order-independent)."""
        h = stable_hash(key)
        i = bisect.bisect_right(self._hashes, h)
        if i == len(self._hashes):        # wrap around the ring
            i = 0
        return self._owner[i]
