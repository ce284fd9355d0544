"""The continuous queries a cell registers: frozen copies of the serving
launcher's two kinds, so the program can change without moving them.

``argmax_conf``: the top token's softmax confidence.  ``topk``: the top
5 logits with their indices, and an optional refinement, the 5 values
sorted descending, which runs only inside the query's schedule hole.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


def _argmax_conf(lg: torch.Tensor) -> torch.Tensor:
    return torch.softmax(lg[:, -1], dim=-1).max(dim=-1).values


def _topk(lg: torch.Tensor):
    return torch.topk(lg[:, -1], 5)


def _topk_sorted(r):
    return (r[0], r[1], torch.sort(r[0]).values.flip(-1))


# kind -> (mandatory, optional or None)
KINDS: Dict[str, Tuple[Callable, Optional[Callable]]] = {
    "argmax_conf": (_argmax_conf, None),
    "topk": (_topk, _topk_sorted),
}


def make(query_cls, spec: dict) -> list:
    """The mix's ``count`` queries, its kinds in turn, each named
    ``<kind>.<index>`` (names must differ: results are keyed by them)."""
    kinds = spec["kinds"]
    out = []
    for i in range(spec["count"]):
        kind = kinds[i % len(kinds)]
        mand, opt = KINDS[kind]
        kw = {} if opt is None else dict(optional=opt,
                                         optional_ratio=spec["optional_ratio"])
        out.append(query_cls(f"{kind}.{i}", mandatory=mand, **kw))
    return out


def kind_of(name: str) -> str:
    return name.rsplit(".", 1)[0]
