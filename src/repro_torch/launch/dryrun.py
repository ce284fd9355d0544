"""Multi-pod dry run, the twin of :mod:`repro.launch.dryrun`: run one
step of every (arch x shape x mesh) cell on the production mesh and
record each rank's memory, FLOPs and collectives, which shows that the
distribution is coherent without the hardware.

The reference compiles for 512 fake XLA devices; here the mesh spans a
fake process group (``backend="fake"``: its collectives move nothing) of
256 or 512 ranks, this process being rank 0, and every parameter,
optimizer leaf, cache leaf and batch input is a DTensor over meta
tensors (shapes, no data).  The step runs op by op through DTensor,
whose redistributions issue the collectives the cell needs.  Nothing
touches a card.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k --mesh pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --out experiments/dryrun_torch

Each cell's JSON record: ``memory`` (bytes of each rank's shards of the
params, optimizer state, decode cache and batch, their sum
``total_bytes``, the counterpart of XLA's argument size; ``peak_bytes``,
the most bytes of local tensors a rank holds at once over the step, and
``temp_bytes`` = peak less the arguments, the counterpart of XLA's
``temp_size_in_bytes``), ``cost.flops`` (the
FLOPs of the rank's local ops, ``torch.utils.flop_counter``), and
``collectives`` (per op kind: count, operand bytes, result bytes, the
largest result with its shape and the op or the line that issued it,
and each result shape's count, from ``CommDebugMode``), and
``lower_s``, the wall time of the step.

The peak counts the step's allocations and frees as they happen, below
DTensor: every new storage a rank's local op (a collective's result
included) returns is live from then until its last tensor is freed, as
a card's allocator would hold it.  Eager mode materializes what XLA
fuses, so the temp is larger than XLA's on the same cell.
:func:`step_memory` gives the same accounting for any step on any mesh
(``chip_smoke.py`` holds it to the card's measured peak).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from ..configs import ARCHS, SHAPES, cell_supported, get_arch, input_specs
from ..configs.base import ShapeConfig
from ..models import model as M
from ..models.params import Tree, abstract_params, param_shardings, \
    tree_leaves, tree_map
from ..models.sharding import RuleTable, distribute, use_sharding
from ..optim.adamw import OptState, abstract_opt_state
from ..train.step import (batch_shardings, cache_shardings, make_serve_step,
                          make_train_step, opt_shardings)
from .mesh import make_production_mesh


class _Collectives(CommDebugMode):
    """``CommDebugMode`` that also adds up, per collective kind, the bytes
    of its tensor operands and of its result (the rank's own, as every
    count here is), and records the largest single result with its shape
    and the op that issued it, and each result shape's count."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes: Dict[str, Dict[str, Any]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(func, "namespace", None) == "aten" and \
                not any(issubclass(t, DTensor) for t in types):
            # a rank's local op, never a collective: nothing to count
            return func(*args, **(kwargs or {}))
        before = self.get_total_counts()
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is not NotImplemented and self.get_total_counts() > before:
            rec = self.bytes.setdefault(
                str(func.overloadpacket).split(".")[-1],
                {"count": 0, "bytes": 0, "result_bytes": 0,
                 "max_result_bytes": 0, "result_shapes": {}})
            outs = out if isinstance(out, (list, tuple)) else [out]
            size = _nbytes([a for a in args if isinstance(a, torch.Tensor)])
            res = _nbytes(outs)
            shape = "x".join(map(str, outs[0].shape))
            rec["count"] += 1
            rec["bytes"] += size
            rec["result_bytes"] += res
            rec["result_shapes"][shape] = rec["result_shapes"].get(
                shape, 0) + 1
            if res > rec["max_result_bytes"]:
                rec.update(max_result_bytes=res, max_result_shape=shape,
                           max_result_op=self._origin())
        return out

    @staticmethod
    def _origin() -> str:
        """What issued the collective running now: the DTensor op being
        dispatched (its ``op_call``), or an explicit ``redistribute``,
        with the innermost line of the port on the stack (none for an op
        of the backward pass)."""
        op, ours, f = None, "", sys._getframe()
        while f is not None:
            code = f.f_code
            if op is None and code.co_filename.endswith("_dispatch.py") \
                    and "op_call" in f.f_locals:
                op = str(f.f_locals["op_call"])
            if not ours and "repro_torch" in code.co_filename and \
                    not code.co_filename.endswith("dryrun.py"):
                ours = f"{Path(code.co_filename).name}:{f.f_lineno} " \
                    f"{code.co_name}"
            f = f.f_back
        return f"{op or 'redistribute'} at {ours or 'the backward pass'}"


class _RankFlopMode(flop_counter._FlopCounterMode):
    """Counts the local ops a rank runs: a DTensor op is left to DTensor
    (``NotImplemented``), which runs it on the rank's shards, and those
    are counted; so is the op on fake tensors of the global shape that
    DTensor runs to learn the output's shape, which is not counted."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class _RankFlops(flop_counter.FlopCounterMode):
    """``FlopCounterMode`` over one rank's local ops (the reference's
    ``cost_analysis`` is per device too)."""

    def __enter__(self):
        super().__enter__()
        self.mode.__exit__(None, None, None)
        self.mode = _RankFlopMode(self)
        self.mode.__enter__()
        return self


class _LiveBytes(TorchDispatchMode):
    """The bytes of local tensors a rank holds, over a step: ``held``
    (the step's arguments) from the start, then every new storage a local
    op returns, until its last tensor is freed; ``peak`` is the most at
    once.  DTensor ops are left to DTensor (``NotImplemented``), whose
    local ops come back here; ops on the fake tensors DTensor runs to
    learn a layout allocate nothing a rank holds."""

    def __init__(self, held: Sequence[torch.Tensor]) -> None:
        super().__init__()
        # id of each live storage -> a weak reference whose callback
        # frees its bytes when the storage dies
        self._refs: Dict[int, weakref.ref] = {}
        self.live = self.peak = 0
        for t in held:
            self._track(t)
        self.start = self.live

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:                    # a view, or in place
            return
        n = st.nbytes()
        self._refs[key] = weakref.ref(
            st, lambda _, key=key, n=n: self._free(key, n))
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def _free(self, key: int, n: int) -> None:
        del self._refs[key]
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not any(issubclass(t, FakeTensor) for t in types):
            for t in _pytree_leaves(out):
                if isinstance(t, torch.Tensor) and \
                        not isinstance(t, FakeTensor):
                    self._track(t)
        return out


def _nbytes(ts: Sequence[Any]) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _locals(*parts: Any) -> list:
    """This rank's shards of trees of DTensors (dicts, an ``OptState``)
    and single DTensors."""
    leaves = []
    for p in parts:
        if isinstance(p, OptState):
            leaves += tree_leaves(p.mu) + tree_leaves(p.nu) + [p.step]
        else:
            leaves += tree_leaves(p) if isinstance(p, dict) else [p]
    return [x.to_local() for x in leaves]


def _local_bytes(*parts: Any) -> int:
    """Bytes of this rank's shards of trees of DTensors."""
    return _nbytes(_locals(*parts))


def fake_group(world_size: int) -> None:
    """The default process group as a fake one of ``world_size`` ranks
    (this process rank 0).  A running fake group of another size is
    replaced; a real group is never touched."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs the fake process group; a "
                               f"{dist.get_backend()} group is running")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def build_cell(arch: str, shape_name: Union[str, ShapeConfig], mesh, *,
               rules: Optional[RuleTable] = None, remat: bool = True,
               microbatch: int = 1) -> Tuple[Callable, tuple]:
    """Returns (fn, args) for one cell under the mesh: ``fn(*args)`` runs
    the cell's step (train, prefill forward or decode) under the
    sharding context, ``args`` are DTensors over meta tensors.  The shape
    is a name of ``SHAPES`` or a ``ShapeConfig`` of its own."""
    cfg = get_arch(arch)
    shape = shape_name if isinstance(shape_name, ShapeConfig) \
        else SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"unsupported cell: {why}")

    def ctx(f):
        def wrapped(*a):
            with use_sharding(mesh, rules):
                return f(*a)
        return wrapped

    with use_sharding(mesh, rules):
        params = tree_map(distribute, abstract_params(cfg),
                          param_shardings(cfg))
        specs = input_specs(cfg, shape)
        b_sh = batch_shardings(cfg, shape)
        batch = {k: distribute(v, b_sh[k]) for k, v in specs.items()}
        if shape.kind == "train":
            ab, o_sh = abstract_opt_state(cfg), opt_shardings(cfg)
            opt = OptState(tree_map(distribute, ab.mu, o_sh.mu),
                           tree_map(distribute, ab.nu, o_sh.nu),
                           distribute(ab.step, o_sh.step))
            fn = ctx(make_train_step(cfg, remat=remat,
                                     microbatch=microbatch))
            args: tuple = (params, opt, batch)
        elif shape.kind == "prefill":
            def fwd(p, b):
                return M.forward(cfg, p, b, remat=False)
            fn = ctx(fwd)
            args = (params, batch)
        else:                                   # decode
            B, S = shape.global_batch, shape.seq_len
            cache = tree_map(distribute, M.abstract_cache(cfg, B, S),
                             cache_shardings(cfg, B, S))
            fn = ctx(make_serve_step(cfg))
            args = (params, cache, batch["tokens"], batch["positions"])
    return fn, args


def _memory(kind: str, args: tuple, peak: int) -> Dict[str, int]:
    state = _local_bytes(args[1]) if kind != "prefill" else 0
    memory = {"params_bytes": _local_bytes(args[0]),
              "opt_state_bytes": state if kind == "train" else 0,
              "cache_bytes": state if kind == "decode" else 0,
              "batch_bytes": _local_bytes(*(
                  args[1:] if kind == "prefill" else args[2:]))}
    memory["total_bytes"] = sum(memory.values())
    memory["peak_bytes"] = peak
    memory["temp_bytes"] = peak - memory["total_bytes"]
    return memory


def step_memory(arch: str, shape: Union[str, ShapeConfig], mesh, *,
                rules: Optional[RuleTable] = None, remat: bool = True,
                microbatch: int = 1) -> Dict[str, int]:
    """One rank's ``memory`` record (as :func:`run_cell`'s) for the step
    of ``arch`` at ``shape`` on ``mesh``, any mesh over the running
    (fake) process group, run over meta tensors."""
    fn, args = build_cell(arch, shape, mesh, rules=rules, remat=remat,
                          microbatch=microbatch)
    kind = shape.kind if isinstance(shape, ShapeConfig) \
        else SHAPES[shape].kind
    with _LiveBytes(_locals(*args)) as live:
        fn(*args)
    return _memory(kind, args, live.peak)


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             rules: Optional[RuleTable] = None, remat: bool = True,
             microbatch: int = 1) -> Dict[str, Any]:
    multi = mesh_kind == "multipod"
    fake_group(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    t0 = time.perf_counter()
    fn, args = build_cell(arch, shape_name, mesh, rules=rules, remat=remat,
                          microbatch=microbatch)
    with _Collectives() as comms, _RankFlops(display=False) as flops, \
            _LiveBytes(_locals(*args)) as live:
        fn(*args)
    lower_s = time.perf_counter() - t0
    return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "chips": int(np.prod(mesh.shape)), "lower_s": lower_s,
            "memory": _memory(SHAPES[shape_name].kind, args, live.peak),
            "cost": {"flops": flops.get_total_flops()},
            "collectives": comms.bytes}


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="")
    ap.add_argument("--shape", type=str, default="")
    ap.add_argument("--mesh", type=str, default="pod",
                    choices=["pod", "multipod"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="experiments/dryrun_torch")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    cells = []
    if args.all:
        for a in sorted(ARCHS):
            for s in SHAPES:
                ok, why = cell_supported(ARCHS[a], SHAPES[s])
                for mk in ("pod", "multipod"):
                    if ok:
                        cells.append((a, s, mk))
                    else:
                        (outdir / f"{a}__{s}__{mk}.json").write_text(
                            json.dumps({"arch": a, "shape": s, "mesh": mk,
                                        "skipped": why}, indent=1))
    else:
        cells = [(args.arch, args.shape, args.mesh)]

    for (a, s, mk) in cells:
        path = outdir / f"{a}__{s}__{mk}.json"
        if path.exists() and args.all:
            d = json.loads(path.read_text())
            if "cost" in d or "skipped" in d:
                print(f"skip (cached): {a} {s} {mk}")
                continue
        print(f"=== {a} x {s} x {mk} ===", flush=True)
        try:
            rec = run_cell(a, s, mk, remat=not args.no_remat,
                           microbatch=args.microbatch)
            print(json.dumps({k: rec[k] for k in
                              ("chips", "lower_s", "collectives")},
                             indent=1), flush=True)
            print("memory:", rec["memory"], flush=True)
            print(f"cost: flops={rec['cost']['flops']}", flush=True)
        except Exception as e:              # one failed cell, the rest run
            rec = {"arch": a, "shape": s, "mesh": mk,
                   "failed": f"{type(e).__name__}: {e}"}
            print("FAILED:", rec["failed"], flush=True)
        path.write_text(json.dumps(rec, indent=1))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
