"""Cells cut to a size the CPU tests can hold, and the faults the checks
must catch, planted in a serving engine."""
from __future__ import annotations

import copy
import math
from typing import Callable, Dict


from .harness import Cell, files_cell, load_cell

TINY_MODELS = {
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  d_head=16, d_ff=96, vocab=256),
    "moe": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=32,
                vocab=256, n_experts=8, top_k=2),
    "ssm": dict(n_layers=2, d_model=64, vocab=256, d_state=8),
}
# limits for a run in float64 against the reference in float64
F64_LIMITS = {"plans_differing": 0, "precise_differing": 0,
              "refinements_wrong": 0, "token_gap": 1e-9, "top5_error": 1e-9,
              "conf_rel_error": 1e-9}


def published_sizes(m: dict) -> dict:
    """The ``config.json`` keys of the sizes of the program's model
    ``m``."""
    out = {"num_hidden_layers": m["n_layers"], "hidden_size": m["d_model"],
           "vocab_size": m["vocab"],
           "tie_word_embeddings": bool(m.get("tie_embeddings"))}
    if m["family"] == "ssm":
        out.update(intermediate_size=m.get("expand", 2) * m["d_model"],
                   state_size=m["d_state"], conv_kernel=m["d_conv"],
                   expand=m.get("expand", 2),
                   time_step_rank=max(1, math.ceil(m["d_model"] / 16)),
                   layer_norm_epsilon=m["norm_eps"])
        return out
    out.update(num_attention_heads=m["n_heads"],
               num_key_value_heads=m["n_kv_heads"],
               intermediate_size=m["d_ff"], rms_norm_eps=m["norm_eps"],
               rope_theta=m.get("rope_theta", 10000.0))
    if m.get("d_head"):
        out["head_dim"] = m["d_head"]
    if m["family"] == "moe":
        out.update(num_experts=m["n_experts"],
                   num_experts_per_tok=m["top_k"])
    return out


def tiny_cell(workload: str, dtype: str = "float64", streams: int = 8,
              lifetime: int = 6) -> Cell:
    """``workload`` (a cell, or ``<config>.<traffic>`` of files) at a
    tiny width and depth, ``streams`` streams living ``lifetime``
    positions, every one compared, a drift event in every 4 steps, in
    ``dtype``, held to ``F64_LIMITS``."""
    try:
        c = load_cell(workload)
    except SystemExit:
        c = files_cell(*workload.split(".", 1))
    config = copy.deepcopy(c.config)
    m = config["model"]
    m.update(TINY_MODELS[m["family"]], dtype=dtype)
    config["published"].update(published_sizes(m))
    traffic = dict(c.traffic, streams=streams, lifetime=lifetime,
                   compare_streams=streams,
                   drift=dict(c.traffic["drift"], every=4))
    return Cell(c.name, c.chips, config, traffic, dict(F64_LIMITS),
                c.end_to_end, c.per_layer)


def _state_unchanged(eng, run) -> None:
    """The decode step leaves the state as it found it: the KV rows it
    writes, or the whole SSM state, are put back after it."""
    step = eng._step

    def faulty(p, cache, t, q):
        pos = int(q[0])
        kept = {k: (v[:, :, pos].clone() if k in ("k", "v") else v.clone())
                for k, v in cache.items()}
        logits, cache = step(p, cache, t, q)
        for k, v in kept.items():
            if k in ("k", "v"):
                cache[k][:, :, pos] = v
            else:
                cache[k].copy_(v)
        return logits, cache

    eng._step = faulty


def _half_batch(eng, run) -> None:
    """The second half of the streams gets the first half's logits."""
    step = eng._step

    def faulty(p, cache, t, q):
        logits, cache = step(p, cache, t, q)
        h = logits.shape[0] // 2
        logits = logits.clone()
        logits[h:2 * h] = logits[:h]
        return logits, cache

    eng._step = faulty


def _token_altered(eng, run) -> None:
    """At position 2 token 7's logit is raised by 50 for every stream, so
    it is served and reported."""
    step = eng._step

    def faulty(p, cache, t, q):
        logits, cache = step(p, cache, t, q)
        if int(q[0]) == 2:
            logits = logits.clone()
            logits[:, -1, 7] += 50.0
        return logits, cache

    eng._step = faulty


def _one_stream(eng, run) -> None:
    """At position 2 one stream gets its neighbour's logits: one slot's
    answer wrong, every other stream's right.  The stream is the run's
    first compared one: a slot outside a sampled comparison is caught
    only in the runs whose sample holds it."""
    step = eng._step
    s = int(run.rows[0])
    o = (s + 1) % run.B

    def faulty(p, cache, t, q):
        logits, cache = step(p, cache, t, q)
        if int(q[0]) == 2:
            logits = logits.clone()
            logits[s] = logits[o]
        return logits, cache

    eng._step = faulty


def _replan_skipped(eng, run) -> None:
    """A drift event leaves the plan as it was."""
    eng.retime = lambda task_rates: None


FAULTS: Dict[str, Callable] = {
    "state_unchanged": _state_unchanged,
    "half_batch": _half_batch,
    "token_altered": _token_altered,
    "one_stream": _one_stream,
    "replan_skipped": _replan_skipped,
}
