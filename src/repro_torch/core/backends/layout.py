"""Route-table layout precompute for the device backend.

Twin of ``repro.core.backends.layout``.  The device backend evaluates
all P placement candidates of a decision at once, which needs the
topology's route tables in tensor form: per (source processor, route,
hop), a ``(P,)`` row over destination lanes.  Those tables are a pure
function of ``(topology, source processor)`` — a message *edge* only
contributes a scalar volume ``tpl(e_ij | src)`` that scales the per-hop
CTML row — so they are built **once per (instance, src)** here.

Where the reference's TPU kernels read one-hot ``(P, L)`` hop masks,
this layout stores the **link id** of each hop (``-1`` for padding): a
max over a one-hot row equals the gathered element, so the gather is an
exact replacement, and the table is ``L`` times smaller.

Padding conventions (shared by the kernels and their plain versions):

  * hop padding: link id ``-1`` (reads ``-inf``) and CTML ``-inf``, so
    both Eq. 13/14 running maxima are no-ops;
  * route padding (``valid = 0``): masked to ``+inf`` arrival so it
    never wins the (LFT, hops, index) route selection;
  * the ``src`` destination lane owns a fake zero-CTML route 0 with no
    links, whose final LFT is exactly ``aft_i`` — the scalar path's
    same-processor arrival contribution;
  * source plane ``P`` and edge row ``E`` are the **padding
    predecessor**: one valid zero-hop route per lane, no links, CTML
    ``-inf`` — with ``aft = -inf`` its arrival and commit drop out of
    the exact max algebra.

Bit-exactness: :func:`ensure_ct_table` performs the same IEEE-754
operations as the scalar ``CompiledInstance.msg_plans_for`` path — one
``tpl / speed`` division per hop plus the Eq. 15 quantization
(``np.rint`` is round-half-even like ``float(round(t))``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple, TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:                                   # pragma: no cover
    from ..engine import CompiledInstance

__all__ = ["SrcLayout", "ensure_ct_table", "padded_src_tensors",
           "src_layout", "stacked_edge_ct", "stacked_src_tensors"]

_NEG_INF = float("-inf")


class SrcLayout:
    """Padded route tables of one source processor against a topology.

    Hop tables are ``(P, R, H)`` — destination lane x route x hop —
    where ``R``/``H`` are the maximum route count / hop count over all
    destinations for this source.  ``route_meta[dst][r]`` is
    ``(link_ids, route_names)`` of route ``r``, for decoding a chosen
    route index back into a message placement.
    """

    __slots__ = ("src", "P", "L", "R", "H", "lid", "spd", "pad", "nhops",
                 "invalid", "route_meta", "spd_rows", "pad_flat",
                 "ct_table")

    def __init__(self, inst: "CompiledInstance", src: int) -> None:
        P = inst.P
        L = inst._n_links
        self.src, self.P, self.L = src, P, L
        routes = inst._routes
        R = H = 1
        route_meta: List[List[Tuple[Tuple[int, ...], Tuple[str, ...]]]] = []
        for dst in range(P):
            if dst == src:
                route_meta.append([])
                continue
            rr = routes[(src, dst)]
            meta = []
            for (lids, _spds, robj) in rr:
                meta.append((lids, robj))
                H = max(H, len(lids))
            R = max(R, len(rr))
            route_meta.append(meta)
        self.R, self.H = R, H
        self.route_meta = route_meta

        lid = np.full((P, R, H), -1, dtype=np.int32)
        spd = np.ones((P, R, H), dtype=np.float64)
        pad = np.ones((P, R, H), dtype=bool)
        nhops = np.zeros((P, R), dtype=np.int32)
        invalid = np.ones((P, R), dtype=bool)
        for dst in range(P):
            if dst == src:
                invalid[dst, 0] = False      # fake zero-CTML route
                continue
            for r, (lids, spds, _robj) in enumerate(routes[(src, dst)]):
                invalid[dst, r] = False
                nhops[dst, r] = len(lids)
                for h, l in enumerate(lids):
                    lid[dst, r, h] = l
                    spd[dst, r, h] = spds[h]
                    pad[dst, r, h] = False
        self.lid, self.spd, self.pad = lid, spd, pad
        self.nhops, self.invalid = nhops, invalid
        # per-edge CTML fill helpers: hop-major speeds for the
        # single-route shape, flat pad indices for either shape
        self.spd_rows: Optional[np.ndarray]
        if R == 1:
            self.spd_rows = np.ascontiguousarray(spd[:, 0, :].T)  # (H, P)
            self.pad_flat = np.flatnonzero(pad[:, 0, :].T.ravel())
        else:
            self.spd_rows = None
            self.pad_flat = np.flatnonzero(pad.ravel())
        self.ct_table: Optional[np.ndarray] = None


def src_layout(inst: "CompiledInstance", src: int) -> SrcLayout:
    """The (cached) :class:`SrcLayout` of ``src`` for one instance."""
    lay = inst._src_layouts.get(src)
    if lay is None:
        lay = SrcLayout(inst, src)
        inst._src_layouts[src] = lay
    return lay


def ensure_ct_table(inst: "CompiledInstance", lay: SrcLayout) -> np.ndarray:
    """Eq. 15 CTML tables of *every* edge from ``lay.src``, in one shot.

    Row shape is hop-major ``(H, P)`` for single-route layouts and the
    full ``(P, R, H)`` table otherwise; hop padding reads ``-inf`` and
    the ``src`` lane's fake route is all zeros.
    """
    t = inst._tpl_matrix[:, lay.src]                         # (E,)
    single = lay.R == 1
    if single:
        ct = t[:, None, None] / lay.spd_rows                 # (E, H, P)
    else:
        ct = t[:, None, None, None] / lay.spd                # (E, P, R, H)
    mode = inst._ctml_mode
    if mode == "round":
        np.rint(ct, out=ct)
    elif mode == "ceil":
        np.ceil(ct, out=ct)
    ct.reshape(len(t), -1)[:, lay.pad_flat] = _NEG_INF
    if single:
        ct[:, :, lay.src] = 0.0      # fake route: final LFT == aft_i
    else:
        ct[:, lay.src, 0, :] = 0.0
    lay.ct_table = ct
    return ct


def padded_src_tensors(inst: "CompiledInstance", src: int, R: int, H: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Route tables of ``src`` padded to instance-global ``(R, H)``:
    ``lid`` ``(R, H, P)`` int32 link ids (``-1`` = no link), ``valid``
    ``(R, P)`` int32 route validity, ``nhops`` ``(R, P)`` int32 hop
    counts."""
    lay = src_layout(inst, src)
    P = lay.P
    lid = np.full((R, H, P), -1, dtype=np.int32)
    lid[:lay.R, :lay.H, :] = lay.lid.transpose(1, 2, 0)
    valid = np.zeros((R, P), dtype=np.int32)
    valid[:lay.R] = (~lay.invalid).T
    nhops = np.zeros((R, P), dtype=np.int32)
    nhops[:lay.R] = lay.nhops.T
    return lid, valid, nhops


def stacked_src_tensors(inst: "CompiledInstance", R: int, H: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Route tables of **every** source processor on a leading src axis:
    ``(P + 1, R, H, P)`` / ``(P + 1, R, P)`` / ``(P + 1, R, P)``.  The
    kernels gather row ``proc_of[pred]``; row ``P`` is the padding
    predecessor plane (one valid zero-hop route per lane, no links)."""
    P = inst.P
    lid = np.full((P + 1, R, H, P), -1, dtype=np.int32)
    valid = np.zeros((P + 1, R, P), dtype=np.int32)
    nhops = np.zeros((P + 1, R, P), dtype=np.int32)
    for s in range(P):
        lid[s], valid[s], nhops[s] = padded_src_tensors(inst, s, R, H)
    valid[P, 0, :] = 1
    return lid, valid, nhops


def stacked_edge_ct(inst: "CompiledInstance", R: int, H: int) -> np.ndarray:
    """Eq. 15 CTML of **every** edge from **every** source, stacked to
    ``(E + 1, P + 1, R, H, P)`` for the kernels' gather
    ``ct[edge_index, proc_of[pred]]``.  Row ``E`` and source plane ``P``
    are the padding predecessor (``-inf`` everywhere)."""
    E = len(inst._edge_index)
    P = inst.P
    full = np.full((E + 1, P + 1, R, H, P), _NEG_INF)
    if E == 0:
        return full
    for s in range(P):
        lay = src_layout(inst, s)
        tab = lay.ct_table
        if tab is None:
            tab = ensure_ct_table(inst, lay)
        if lay.R == 1:
            full[:E, s, 0, :lay.H, :] = tab                  # (E, H, P)
        else:
            full[:E, s, :lay.R, :lay.H, :] = \
                tab.transpose(0, 2, 3, 1)                    # (E, P, R, H)
    return full
