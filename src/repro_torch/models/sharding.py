"""Logical-axis sharding on a ``torch.distributed`` DeviceMesh, the twin
of :mod:`repro.models.sharding`: parameters and activations carry
logical axis names, and a rules table maps them to physical mesh axes
(MaxText-style).

Physical mesh axes: ``pod`` (between pods), ``data`` (batch / FSDP),
``model`` (tensor parallel).  The default rules implement FSDP + TP:
weights are sharded over both the data and the model axis, activations
shard the batch over (pod, data) and attention heads / ff over model.

:func:`spec_for` gives, per tensor dimension, the mesh axes it is split
over (what a JAX ``PartitionSpec`` holds), by the reference's rules;
:func:`placements` turns that into DTensor placements.  Under
:func:`use_sharding` every parameter, optimizer leaf, cache leaf and
batch input is a DTensor laid out by those placements, and
:func:`shard` redistributes an activation to its logical layout where
the reference constrains one.  Without a mesh every function here
returns its input unchanged, so the model runs on plain tensors as
before.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard, distribute_tensor)

Axis = Union[str, None, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

# logical axis name -> physical mesh axis (or tuple of them, or None)
RuleTable = Dict[str, Axis]

# The reference's baseline layout, copied (the port imports nothing of
# the JAX package).
DEFAULT_RULES: RuleTable = {
    "batch": ("pod", "data"),       # data parallel over pods and data axis
    "seq": None,
    "embed": None,                  # activation d_model: replicated
    "heads": "model",               # attention heads: tensor parallel
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",                  # mlp hidden: tensor parallel
    "vocab": "model",               # logits vocab dim
    # parameter axes (FSDP: shard the non-TP dim over data)
    "p_vocab": "model",
    # embed/head tables: vocab is 'model'-sharded; the d_model dim stays
    # replicated — sharding it over 'data' makes GSPMD batch-gather the
    # (B,S,V) grad in the head backward (37 GiB/device in the reference)
    "p_embed": None,
    "p_in": "data",                 # fsdp dim of weight matrices
    "p_heads": "model",
    "p_kv_heads": "model",
    "p_head_dim": None,
    "p_ff": "model",
    "p_experts": "model",           # expert parallelism on the model axis
    "p_ssm_inner": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",           # mamba2 per-head decode state
    "p_state": None,
    "state": None,
    "layers": None,                 # stacked layer axis
    "conv": None,
    "expert": "model",              # dispatched expert activation dim
    "cache_seq": "model",           # KV-cache sequence dim (flash-decoding
    #                                 style split-K over the model axis)
}


@dataclasses.dataclass
class ShardingCtx:
    mesh: Optional[Any]             # a DeviceMesh, or None
    rules: RuleTable


_ctx = threading.local()


def _get() -> ShardingCtx:
    if not hasattr(_ctx, "cur"):
        _ctx.cur = ShardingCtx(None, dict(DEFAULT_RULES))
    return _ctx.cur


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[RuleTable] = None):
    """Activate a mesh and a rule table (the defaults, updated by
    ``rules``) in this thread until the block ends; nestable."""
    prev = getattr(_ctx, "cur", None)
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _ctx.cur = ShardingCtx(mesh, merged)
    try:
        yield
    finally:
        if prev is None:
            del _ctx.cur
        else:
            _ctx.cur = prev


def active_mesh():
    """The mesh of the innermost :func:`use_sharding`, or None."""
    return _get().mesh


def active() -> ShardingCtx:
    """The mesh and rules in force: a backward pass runs them again with
    ``use_sharding(ctx.mesh, ctx.rules)``, since autograd may run it on a
    thread of its own (a CUDA device's), where this thread's are not."""
    return _get()


def _require_mesh(what: str):
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError(f"{what} needs an active mesh (use_sharding)")
    return mesh


def spec_for(logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Spec:
    """Per dimension, the mesh axes of a tuple of logical axis names
    (None = replicated): a mesh axis name, a tuple of them, or None.

    Mesh axes that don't exist on the active mesh are dropped (so the same
    rules serve the single-pod (data, model) and multi-pod (pod, data,
    model) meshes), and so is an axis an earlier dimension already uses.
    When ``shape`` is given, axes whose sizes don't divide the dimension
    are dropped too (e.g. 8 KV heads on a 16-way model axis fall back to
    replication).  Reads the mesh's ``mesh_dim_names`` and ``shape``.
    """
    ctx = _get()
    mesh = ctx.mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape)) \
        if mesh is not None else {}
    out = []
    used = set()
    for i, name in enumerate(logical):
        if name is None:
            out.append(None)
            continue
        phys = ctx.rules.get(name, None)
        if phys is None:
            out.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        keep = []
        quo = shape[i] if shape is not None else None
        for a in phys:
            if a not in sizes or a in used:
                continue
            if quo is not None:
                if quo % sizes[a] != 0:
                    continue
                quo //= sizes[a]
            keep.append(a)
            used.add(a)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(tuple(keep))
    return tuple(out)


def placements(mesh, spec: Spec) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh
    dimension: ``Shard(d)`` where dimension d of the tensor is split over
    that mesh axis, else ``Replicate()``.  A dimension split over several
    axes (``("pod", "data")``) gets ``Shard(d)`` on each, and they must
    come in mesh order, the order DTensor splits in.  A mesh axis of
    size 1 splits nothing and is ``Replicate()`` whatever the spec."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dimension {d} is split over {axes}, not in "
                             f"the mesh's order {names}")
        for i in idx:
            # a split in one is no split: Replicate spares DTensor the
            # search over layouts of a dimension sharded on several axes
            out[i] = Shard(d) if mesh.shape[i] > 1 else Replicate()
    return tuple(out)


def param_sharding(logical: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None
                   ) -> Optional[Tuple[Placement, ...]]:
    """The placements of a leaf with these logical axes on the active
    mesh, or None without one."""
    mesh = active_mesh()
    if mesh is None:
        return None
    return placements(mesh, spec_for(logical, shape))


def shard(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``x`` redistributed to its logical layout under the active mesh
    (the reference's sharding constraint); ``x`` itself without one.
    Under a mesh ``x`` must be a DTensor: a plain tensor there would be
    some rank's data taken for the whole, so it raises."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"shard{logical}: a plain {tuple(x.shape)} tensor "
                        "under a mesh; every tensor of the model is a "
                        "DTensor there")
    want = placements(mesh, spec_for(logical, x.shape))
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


class _Pin(torch.autograd.Function):
    """Identity; the gradient is laid out as the input was."""

    @staticmethod
    def forward(ctx, x: DTensor) -> DTensor:
        ctx.layout = (x.device_mesh, tuple(x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: DTensor) -> DTensor:
        mesh, want = ctx.layout
        return g if tuple(g.placements) == want else g.redistribute(mesh,
                                                                    want)


def pin(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is redistributed to ``x``'s own placements:
    DTensor lays a product's gradient out as suits the product, which may
    split a flattened dimension unevenly for the view behind it."""
    return _Pin.apply(x) if isinstance(x, DTensor) else x


def view(x: torch.Tensor, shape: Sequence[int],
         *logical: Optional[str]) -> torch.Tensor:
    """``x.reshape(shape)``, laid out by ``logical`` (on ``shape``) under
    the active mesh.  A DTensor view keeps a split dimension split only
    where the shards divide it on both sides, so ``x`` is laid out by the
    same placements first (the dimensions they split must sit at the
    same index in ``x``, as a leading batch or head axis does); where
    ``x`` cannot take them evenly it is replicated on that dimension
    before the view and split after it."""
    mesh = active_mesh()
    if mesh is None:
        return x.reshape(shape)
    want = placements(mesh, spec_for(logical, shape))
    ways: Dict[int, int] = {}
    for size, p in zip(mesh.shape, want):
        if isinstance(p, Shard):
            ways[p.dim] = ways.get(p.dim, 1) * size
    first = tuple(Replicate() if isinstance(p, Shard)
                  and x.shape[p.dim] % ways[p.dim] else p for p in want)
    if tuple(x.placements) != first:
        x = x.redistribute(mesh, first)
    return shard(x.reshape(shape), *logical)


def local(fn: Callable[..., Any], out: Any,
          *args: Tuple[torch.Tensor, Sequence[Optional[str]]],
          partial: Optional[Tuple[str, int]] = None) -> Any:
    """``fn`` on plain tensors, run on each rank's shards under the
    active mesh: each argument, given as (tensor, logical axes), is laid
    out by its axes first and ``fn`` gets its local shard; the result,
    of the global shape and logical axes ``out`` (a list of them for a
    tuple of results), is wrapped back, as a pending sum over the mesh
    axes that split the logical axis ``partial`` (name, size) where
    ``fn`` sums over it.  For computations
    that are local in that layout (attention over whole sequences, the
    batch and the heads split; each rank's experts), where DTensor would
    otherwise search the layouts of every op inside.  An argument whole
    on a mesh axis that splits another argument gets its gradient as a
    pending sum over that axis (each rank's part).  Without a mesh,
    ``fn`` on the tensors as they are."""
    mesh = active_mesh()
    if mesh is None:
        return fn(*(x for x, _ in args))
    from torch.distributed.tensor.experimental import local_map
    rules = _get().rules

    def plain(*a):
        with use_sharding(None, rules):     # fn sees plain tensors only
            return fn(*a)

    ins = tuple(placements(mesh, spec_for(ax, x.shape)) for x, ax in args)
    split = {i for pl in ins for i, p in enumerate(pl) if isinstance(p, Shard)}
    grads = tuple(tuple(Partial() if i in split and isinstance(p, Replicate)
                        else p for i, p in enumerate(pl)) for pl in ins)
    outs = []
    for shape, ax in (out if isinstance(out, list) else [out]):
        res = list(placements(mesh, spec_for(ax, shape)))
        if partial is not None:
            entry = spec_for((partial[0],), (partial[1],))[0]
            for a in (() if entry is None else
                      (entry,) if isinstance(entry, str) else entry):
                i = mesh.mesh_dim_names.index(a)
                if mesh.shape[i] > 1:
                    res[i] = Partial()
        outs.append(tuple(res))
    return local_map(plain, out_placements=tuple(outs), in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*(x for x, _ in args))


def distribute(x: torch.Tensor,
               layout: Optional[Tuple[Placement, ...]]) -> torch.Tensor:
    """``x``, which every rank holds in full, as a DTensor with placements
    ``layout`` on the active mesh: each rank keeps its own shard, and
    nothing is communicated.  ``layout`` None (no mesh) returns ``x``."""
    if layout is None:
        return x
    mesh = _require_mesh("distribute")
    d = distribute_tensor(x, mesh, layout, src_data_rank=None)
    local = d.to_local()
    if local.numel() == x.numel():
        return d
    # the shard is a view into x: copy it, so that x can be freed
    return DTensor.from_local(local.clone(), mesh, layout, run_check=False,
                              shape=d.shape, stride=d.stride())


def replicate(x: torch.Tensor) -> torch.Tensor:
    """A constant every rank computes in full (positions, masks, an
    arange) as a replicated DTensor under the active mesh, so it can meet
    the model's DTensors; ``x`` itself without a mesh."""
    mesh = active_mesh()
    if mesh is None:
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def full(x: torch.Tensor) -> torch.Tensor:
    """``x``'s whole value as a plain tensor: a DTensor gathered (every
    rank must call), a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def local_shard(x: DTensor, dim: int) -> Tuple[torch.Tensor, int]:
    """This rank's shard of ``x`` (a view: writes go into ``x``) and the
    global index of its first entry along ``dim``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    _, offset = compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)
    return x.to_local(), offset[dim % x.ndim]


def index_copy_(dst: torch.Tensor, dim: int, index: torch.Tensor,
                src: torch.Tensor) -> torch.Tensor:
    """``dst.index_copy_(dim, index, src)`` for a one-position ``index``.

    Under a mesh ``dst`` (a KV cache, split over ``cache_seq``) may be
    sharded along ``dim``, which DTensor cannot write into: ``src`` is
    laid out like ``dst`` with ``dim`` replicated, and each rank writes
    the row into its own shard where it owns the position and rewrites
    the row it already has where it does not (no host sync)."""
    if not isinstance(dst, DTensor):
        return dst.index_copy_(dim, index, src)
    rows = [Replicate() if p == Shard(dim) else p for p in dst.placements]
    src = src.redistribute(dst.device_mesh, rows).to_local()
    local, offset = local_shard(dst, dim)
    at = full(index).reshape(()) - offset
    inside = (at >= 0) & (at < local.shape[dim])
    at = at.clamp(0, local.shape[dim] - 1).reshape(1)
    local.index_copy_(dim, at, torch.where(
        inside, src, local.index_select(dim, at)))
    return dst
