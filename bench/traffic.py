"""The general traffic generator: every traffic mix is a JSON file of
parameters under ``bench/traffic/`` that this module reads.

A mix is a closed loop of ``streams`` streams: each step feeds one tuple
(a token id, uniform over the vocabulary) to every stream.  Streams live
``lifetime`` positions; then the stream set rolls over.  Drift events
come one in every ``drift.every`` steps at a place in the block drawn
from the seed.  They come in cycles of ``drift.cycle`` events, each
rescaling ``drift.tasks`` (a range) tasks of the serving graph by
factors uniform in ``drift.factor`` (a range); a cycle's events are
drawn from ``drift.cycle_seed`` and the cycle's index, the same for
every run, and the run's seed orders all but the first, which leads
every cycle.  Every seed thus gives the same tuples' count and the same
events, in another order: a replan's cost depends on which task
drifted, and that set stays the same; and the first replan of a run,
the one its traced steps hold, is the same event in every run.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np


def load(path: Path) -> dict:
    spec = json.loads(Path(path).read_text())
    for key in ("streams", "lifetime", "queries", "drift", "compare_streams",
                "warmup_steps", "trace_steps"):
        if key not in spec:
            raise ValueError(f"{path}: no {key!r}")
    q = spec["queries"]
    if not q["count"] or not q["kinds"]:
        raise ValueError(f"{path}: no queries")
    d = spec["drift"]
    if not (d["every"] >= 1 and d["cycle"] >= 1
            and 1 <= d["tasks"][0] <= d["tasks"][1]
            and 0 < d["factor"][0] <= d["factor"][1]):
        raise ValueError(f"{path}: bad drift {d}")
    return spec


class Traffic:
    """The tuples and drift events of one run, drawn from ``seed``: the
    same seed gives the same ones, step for step."""

    def __init__(self, spec: dict, seed: int, vocab: int,
                 n_tasks: int) -> None:
        self.spec = spec
        self.streams = int(spec["streams"])
        self.vocab = vocab
        self.n_tasks = n_tasks
        self.seed = seed
        self._tok = np.random.default_rng([seed, 0])
        self._place = np.random.default_rng([seed, 1])
        self._tokens: list = []
        self._events: Dict[int, Dict[int, float]] = {}
        self._blocks = 0
        self._queue: list = []

    def tokens(self, step: int) -> np.ndarray:
        """Step ``step``'s tuples, one a stream (int64)."""
        while len(self._tokens) <= step:
            self._tokens.append(self._tok.integers(
                0, self.vocab, size=self.streams, dtype=np.int64))
        return self._tokens[step]

    def cycle(self, c: int) -> list:
        """Cycle ``c``'s events, in the order the seed gives them."""
        d = self.spec["drift"]
        rng = np.random.default_rng([int(d["cycle_seed"]), c])
        lo, hi = d["factor"]
        events = []
        for _ in range(int(d["cycle"])):
            n = int(rng.integers(d["tasks"][0], d["tasks"][1] + 1))
            tasks = rng.choice(self.n_tasks, size=n, replace=False)
            factors = rng.uniform(lo, hi, size=n)
            events.append({int(t): float(f) for t, f in zip(tasks, factors)})
        order = 1 + np.random.default_rng([self.seed, 4, c]).permutation(
            len(events) - 1)
        return [events[0]] + [events[i] for i in order]

    def drift(self, step: int) -> Optional[Dict[int, float]]:
        """The drift event due before step ``step``, or None."""
        every = int(self.spec["drift"]["every"])
        cycle = int(self.spec["drift"]["cycle"])
        while self._blocks <= step // every:
            if not self._queue:
                self._queue = self.cycle(self._blocks // cycle)
            at = self._blocks * every + int(self._place.integers(0, every))
            self._events[at] = self._queue.pop(0)
            self._blocks += 1
        return self._events.get(step)


def warmup_tokens(spec: dict, seed: int, vocab: int, n: int) -> list:
    """Tuples for the warm-up steps, from a stream of the seed the
    window does not use."""
    rng = np.random.default_rng([seed, 2])
    return [rng.integers(0, vocab, size=int(spec["streams"]),
                         dtype=np.int64) for _ in range(n)]


def sample_streams(spec: dict, seed: int) -> np.ndarray:
    """The streams whose results are compared: ``compare_streams`` of
    them drawn from the seed, sorted (all where that is every stream)."""
    B = int(spec["streams"])
    if spec["compare_streams"] >= B:
        return np.arange(B)
    rng = np.random.default_rng([seed, 3])
    return np.sort(rng.choice(B, size=int(spec["compare_streams"]),
                              replace=False))
