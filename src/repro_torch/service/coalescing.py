"""Request coalescing: fold a burst of per-tenant requests into batches.

Twin of ``repro.service.coalescing``.  Window semantics: every tenant
request is appended to the tenant's pending queue and a flush is armed
``window`` seconds out (one flush per tenant at a time — requests
arriving while a flush is armed ride the same flush).  At flush time the
drained queue is split into *adjacent runs of the same coalescible
kind*:

  * a run of ``register`` requests  -> ONE ``submit_many`` of the
    tenant's whole graph set (one fleet replan instead of N),
  * a run of ``update`` requests    -> ONE batched suffix-replay
    ``Scheduler.update`` folding all the drift events
    (``ReplayStats.coalesced`` records the fold),
  * a run of ``plan`` requests      -> one cache lookup.

``mark_failed`` / ``degrade`` / ``restore`` are **barriers**: each is
its own singleton batch, executed in arrival order relative to its
neighbours.  Coalescing therefore never reorders requests — only
adjacent requests that commute by construction are folded — so the
response sequence is bit-identical to processing the queue one request
at a time (the chaos tests' oracle).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence

__all__ = ["COALESCIBLE", "Batch", "coalesce"]

#: Request kinds that may merge with an adjacent request of the same
#: kind.  Fault operations are deliberately absent: a fault replan is a
#: barrier (its suffix invalidation depends on the exact plan it is
#: applied to, so folding across one would change observable replays).
COALESCIBLE = frozenset({"register", "update", "plan"})


@dataclasses.dataclass
class Batch:
    """One unit of scheduler work produced by :func:`coalesce`."""

    kind: str
    items: List[Any]

    def __len__(self) -> int:
        return len(self.items)


def coalesce(items: Sequence[Any],
             kind_of: Callable[[Any], str]) -> List[Batch]:
    """Split ``items`` (arrival order) into adjacent-run batches.

    Consecutive items whose ``kind_of`` is the same *coalescible* kind
    share one :class:`Batch`; every other item becomes a singleton
    batch.  The concatenation of all batches' items is exactly
    ``items`` — nothing is reordered or dropped.
    """
    out: List[Batch] = []
    for item in items:
        kind = kind_of(item)
        if (out and out[-1].kind == kind and kind in COALESCIBLE):
            out[-1].items.append(item)
        else:
            out.append(Batch(kind, [item]))
    return out
