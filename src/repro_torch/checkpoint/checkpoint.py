"""Fault-tolerant checkpointing, the twin of
:mod:`repro.checkpoint.checkpoint`, in the reference's on-disk format.

Layout: ``<dir>/step_<n>/<key>.npy`` plus ``manifest.json``, where a
leaf's key joins its path with ``::``: a dict key as it is, a
NamedTuple field as ``.<name>`` (``OptState``'s ``.mu``, ``.nu``,
``.step``), a list index as its number, so ``{"p": params, "o": opt}``
gives ``p::embed`` and ``o::.mu::blocks::attn::bk``, the reference's
keys.  Leaves are saved in the order ``jax.tree`` flattens the same
tree.  Writes go to a temporary directory that is renamed into place,
so a crash mid-save never corrupts the latest checkpoint.  A bf16 leaf
is written as the reference writes one (its 16-bit patterns, numpy
``V2``) and read back through the int16 view; checkpoints move both
ways between the packages.

A sharded tree (DTensor leaves) is saved and restored shard by shard,
on the host, and no leaf is ever whole on a card: rank 0 creates each
leaf's ``.npy`` at its full size, each rank copies its own shard to the
host (``to_local().cpu()``) and writes it into its rows of the file
(one rank per replicated copy), and a barrier comes before the publish.
The files do not depend on the mesh, and are byte for byte a mesh-less
save's.  ``restore(..., placements=...)`` memory-maps each file, slices
out the rank's shard on the host, moves only that to the device and
wraps it as a DTensor laid out on the active mesh, whatever mesh saved
it (the reference's elastic reshard).  Neither issues a collective
beyond the barriers, so it runs the same under NCCL and gloo; the ranks
share the checkpoint's directory (one host, or a shared filesystem).
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from ..models.sharding import active_mesh

Tree = Any
SEP = "::"


def _paths(tree: Tree, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of every leaf, in ``jax.tree`` flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), prefix + (f".{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _rebuild(tree: Tree, leaves: Iterator[Any]) -> Tree:
    """``tree``'s structure with its leaves taken from ``leaves`` in
    :func:`_paths` order."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), leaves)
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


_BF16 = "bfloat16"


def _meta(leaf: Any) -> Tuple[List[int], str]:
    """A leaf's whole shape and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return list(leaf.shape), _BF16
        return list(leaf.shape), str(torch.empty(
            0, dtype=leaf.dtype).numpy().dtype)
    arr = np.asarray(leaf)
    return list(arr.shape), str(arr.dtype)


def _create(path: Path, shape: List[int], dtype: str) -> None:
    """An ``.npy`` of ``shape`` whose header is the one ``np.save`` would
    write (for bf16 the reference's ``<V2``) and whose data is zeros,
    for the shards to be written into."""
    if dtype != _BF16:
        if int(np.prod(shape)) == 0:            # nothing to map
            np.save(path, np.zeros(shape, dtype))
        else:
            m = np.lib.format.open_memmap(path, mode="w+", dtype=dtype,
                                          shape=tuple(shape))
            del m
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": tuple(shape)})
        n = 2 * int(np.prod(shape))
        if n:
            f.seek(f.tell() + n - 1)
            f.write(b"\0")


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values on the host, bf16 as its int16 bit patterns."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy()
    return t.numpy()


def _shard(leaf: DTensor) -> Tuple[Tuple[slice, ...], bool]:
    """The rows of ``leaf``'s whole value that this rank holds, and
    whether this rank writes them: the first rank along every mesh axis
    the leaf is replicated on."""
    mesh, pl = leaf.device_mesh, leaf.placements
    if any(p.is_partial() for p in pl):
        raise ValueError("a pending sum (Partial) cannot be saved; "
                         "redistribute the leaf first")
    shape, offset = compute_local_shape_and_global_offset(
        leaf.shape, mesh, pl)
    coord = mesh.get_coordinate()
    owner = coord is not None and all(
        c == 0 for c, p in zip(coord, pl) if not p.is_shard())
    return tuple(slice(o, o + n) for o, n in zip(offset, shape)), owner


def _put(path: Path, rows: Tuple[slice, ...], values: np.ndarray) -> None:
    """``values`` written into ``rows`` of the ``.npy`` at ``path``."""
    if values.size == 0:
        return
    m = np.load(path, mmap_mode="r+")
    if m.dtype.kind == "V":                     # bf16: the int16 view
        m = m.view(np.int16)
    m[rows] = values
    m.flush()
    del m


def save(ckpt_dir: Union[str, Path], step: int, tree: Tree) -> Path:
    """Writes ``tree`` as the checkpoint of ``step``.  In a process group
    every rank calls it: rank 0 creates the files, each rank writes its
    own shard of each DTensor leaf from the host (rank 0 a plain leaf
    whole), and no rank returns before the checkpoint is published."""
    d = Path(ckpt_dir)
    group = dist.is_initialized()
    writer = not group or dist.get_rank() == 0
    tmp = d / f".tmp_step_{step}"
    leaves = [(SEP.join(path), leaf) for path, leaf in _paths(tree)]
    manifest: Dict[str, Dict[str, Any]] = {}
    for key, leaf in leaves:
        shape, dtype = _meta(leaf)
        manifest[key] = {"file": key.replace("/", "_") + ".npy",
                         "shape": shape, "dtype": dtype}
    if writer:
        d.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        for key, _ in leaves:
            m = manifest[key]
            _create(tmp / m["file"], m["shape"], m["dtype"])
    if group:
        dist.barrier()                          # the files exist
    for key, leaf in leaves:
        path = tmp / manifest[key]["file"]
        if isinstance(leaf, DTensor):
            rows, owner = _shard(leaf)
            if owner:
                _put(path, rows, _host(leaf.to_local()))
        elif writer:
            _put(path, (), _host(leaf) if isinstance(leaf, torch.Tensor)
                 else np.asarray(leaf))
    if group:
        dist.barrier()                          # every shard is written
    final = d / f"step_{step}"
    if writer:
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "leaves": manifest}, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                  # atomic publish
    if group:
        dist.barrier()
    return final


def latest_step(ckpt_dir: Union[str, Path]) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _load(path: Path, dtype: str,
          rows: Optional[Tuple[slice, ...]] = None) -> torch.Tensor:
    """The leaf at ``path`` on the host, or only its ``rows``, read
    through a memory map."""
    arr = np.load(path, mmap_mode="r")
    if dtype == _BF16:
        arr = arr.view(np.int16)
    arr = np.array(arr if rows is None else arr[rows])
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if dtype == _BF16 else t


def _at(tree: Tree, path: Tuple[str, ...]) -> Any:
    """The node of ``tree`` at a :func:`_paths` path."""
    for k in path:
        if k.startswith("."):
            tree = getattr(tree, k[1:])
        elif isinstance(tree, dict):
            tree = tree[k]
        else:
            tree = tree[int(k)]
    return tree


def restore(ckpt_dir: Union[str, Path], step: int, like: Tree,
            device: Union[str, torch.device] = "cuda",
            placements: Optional[Tree] = None) -> Tree:
    """The checkpoint of ``step`` in the structure of ``like``, each leaf
    in its saved dtype on ``device`` (the card unless the caller asks for
    the CPU).  With ``placements``, a tree of the same structure whose
    leaves are DTensor placements (``param_shardings``,
    ``opt_shardings``), each leaf becomes a DTensor laid out by them on
    the active mesh: each rank reads only its own shard from the file
    and moves only that to the device, so any mesh restores whatever
    mesh saved it, and no collective is issued."""
    from ..core.backends.cuda import check_device
    dev = check_device(device)
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())["leaves"]
    mesh = active_mesh() if placements is not None else None
    out: List[torch.Tensor] = []
    for path, _ in _paths(like):
        m = manifest[SEP.join(path)]
        layout = None if placements is None else _at(placements, path)
        if layout is None:
            out.append(_load(d / m["file"], m["dtype"]).to(dev))
            continue
        if mesh is None:
            raise RuntimeError("restore with placements needs an active "
                               "mesh (use_sharding)")
        shape = torch.Size(m["shape"])
        local, offset = compute_local_shape_and_global_offset(
            shape, mesh, layout)
        rows = tuple(slice(o, o + n) for o, n in zip(offset, local))
        t = _load(d / m["file"], m["dtype"], rows).to(dev)
        out.append(DTensor.from_local(
            t, mesh, layout, run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride()))
    return _rebuild(like, iter(out))
