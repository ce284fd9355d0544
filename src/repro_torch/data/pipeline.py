"""Deterministic synthetic token pipeline, the twin of
:mod:`repro.data.pipeline`.

Step-indexed and host-shardable: ``batch_for_step(step)`` is a pure
function of (seed, step, host index), so any host can regenerate any
shard and a restart needs no data cursor beyond the step counter.  The
batches are numpy, drawn exactly as the reference draws them, so both
packages see the same bits; ``device_batch`` puts them on the device,
under a mesh each rank keeping its shard of the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.sharding import distribute


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # markov-chain-ish synthetic text: token t+1 depends on token t
    structure: float = 0.7          # fraction of deterministic transitions


class SyntheticTokenPipeline:
    """Generates (tokens, labels) batches with learnable structure
    (next token = an affine function of the current one, noise elsewhere)
    so a real training run shows a decreasing loss."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 data_cfg: DataConfig = DataConfig()):
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg

    def batch_for_step(self, step: int,
                       host_index: int = 0, host_count: int = 1
                       ) -> Dict[str, np.ndarray]:
        B = self.shape.global_batch // host_count
        S = self.shape.seq_len
        V = self.cfg.vocab
        rng = np.random.default_rng(
            (self.data_cfg.seed, step, host_index))
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, size=B)
        noise = rng.random((B, S))
        rand_next = rng.integers(0, V, size=(B, S))
        for t in range(S):
            det = (toks[:, t] * 31 + 7) % V
            toks[:, t + 1] = np.where(noise[:, t] < self.data_cfg.structure,
                                      det, rand_next[:, t])
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.embed_inputs:
            emb = rng.standard_normal((B, S, self.cfg.d_model),
                                      np.float32).astype(np.float32)
            out = {"embeds": emb, "labels": out["labels"]}
        if self.cfg.vision_prefix:
            out["vision_embeds"] = rng.standard_normal(
                (B, S // 4, self.cfg.d_model)).astype(np.float32) * 0.02
        return out

    def device_batch(self, step: int,
                     device: Union[str, torch.device] = "cuda",
                     placements: Optional[Dict] = None
                     ) -> Dict[str, torch.Tensor]:
        """``batch_for_step(step)`` as tensors on ``device`` (the card
        unless the caller asks for the CPU).  With ``placements``
        (``train.step.batch_shardings``) each input is a DTensor on the
        active mesh: every rank makes the global batch from the seed and
        keeps its own shard."""
        from ..core.backends.cuda import check_device
        dev = check_device(device)
        return {k: distribute(torch.from_numpy(np.ascontiguousarray(v)).to(
                    dev), placements[k] if placements else None)
                for k, v in self.batch_for_step(step).items()}
