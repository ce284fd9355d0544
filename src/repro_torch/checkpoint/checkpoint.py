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

A sharded tree (DTensor leaves) is saved whole: every rank gathers each
leaf and rank 0 writes it, so the files do not depend on the mesh.
``restore(..., placements=...)`` lays the leaves out on the active
mesh, whatever mesh saved them (the reference's elastic reshard).
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

from ..models.sharding import distribute, full

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


def _write(path: Path, leaf: Any) -> Tuple[List[int], str]:
    """``leaf`` saved as ``.npy`` at ``path``; returns its shape and dtype
    name.  A bf16 tensor's 16-bit patterns go out under the header numpy
    writes for ``ml_dtypes.bfloat16`` (descr ``<V2``), the reference's
    bytes."""
    t = leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else None
    if t is None or t.dtype != torch.bfloat16:
        arr = np.asarray(leaf) if t is None else t.numpy()
        np.save(path, arr)
        return list(arr.shape), str(arr.dtype)
    bits = t.contiguous().view(torch.int16).numpy()
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": bits.shape})
        f.write(bits.tobytes())
    return list(bits.shape), "bfloat16"


def save(ckpt_dir: Union[str, Path], step: int, tree: Tree) -> Path:
    """Writes ``tree`` as the checkpoint of ``step``.  In a process group
    every rank calls it: each DTensor leaf is gathered whole, rank 0
    writes, and no rank returns before the checkpoint is published."""
    d = Path(ckpt_dir)
    writer = not dist.is_initialized() or dist.get_rank() == 0
    tmp = d / f".tmp_step_{step}"
    if writer:
        d.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
    manifest: Dict[str, Dict[str, Any]] = {}
    for path, leaf in _paths(tree):
        key = SEP.join(path)
        fname = key.replace("/", "_") + ".npy"
        leaf = full(leaf)
        if writer:
            shape, dtype = _write(tmp / fname, leaf)
            manifest[key] = {"file": fname, "shape": shape, "dtype": dtype}
    final = d / f"step_{step}"
    if writer:
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "leaves": manifest}, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                  # atomic publish
    if dist.is_initialized():
        dist.barrier()
    return final


def latest_step(ckpt_dir: Union[str, Path]) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _load(path: Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


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
    the active mesh, each rank keeping its own shard: any mesh, whatever
    mesh saved it."""
    from ..core.backends.cuda import check_device
    dev = check_device(device)
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())["leaves"]
    out: List[torch.Tensor] = []
    for path, _ in _paths(like):
        m = manifest[SEP.join(path)]
        t = _load(d / m["file"], m["dtype"]).to(dev)
        out.append(t if placements is None
                   else distribute(t, _at(placements, path)))
    return _rebuild(like, iter(out))
