"""The input rule the attention and scan wrappers share."""
from __future__ import annotations

from typing import Sequence

import torch


def check_dtype(tensors: Sequence[torch.Tensor], what: str) -> torch.dtype:
    """The one dtype of ``tensors``, float32 or bfloat16; raises on any
    other, on a mix, or on a non-contiguous tensor."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= {torch.float32, torch.bfloat16}:
        raise ValueError(f"{what}: expected one dtype, float32 or bfloat16, "
                         f"got {sorted(map(str, dtypes))}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: inputs must be contiguous")
    return dtypes.pop()
