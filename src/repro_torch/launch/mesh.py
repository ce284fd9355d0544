"""Production meshes, the twin of :mod:`repro.launch.mesh`, as
``torch.distributed`` DeviceMeshes.

Single pod: 16 x 16 = 256 ranks, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 ranks, axes (pod, data, model).

A mesh spans the default process group, which the caller starts first:
``torchrun`` (one rank per card), the launcher's own one-rank group, or
the dry run's fake group of 256 or 512 ranks over meta tensors
(``launch/dryrun.py``).  Defined as functions so that importing this
module touches no device and no group.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch.distributed as dist


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A mesh of ``shape`` named ``axes`` over the default process group,
    whose world size must be the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh
    n = int(np.prod(shape))
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != n:
        raise RuntimeError(
            f"mesh {tuple(shape)} needs a process group of {n} ranks, found "
            f"{world or 'none'} — launch under torchrun --nproc-per-node "
            f"{n}, or run the fake {n}-rank group of "
            f"python -m repro_torch.launch.dryrun (see launch/dryrun.py)")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))
