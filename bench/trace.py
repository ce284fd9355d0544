"""Reading the profiler's trace of the traced steps: device operations
(kernels, copies, sets) and host operations with their times, the busy
union, and the longest idle gaps named by what the host was doing.

The trace is written under the checkout's ``build/bench/`` and removed
once read.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .yardstick import busy_us

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
STEP_SPAN = "bench.step"
REPLAN_SPAN = "bench.retime"
# gaps shorter than this are counted together, unnamed
GAP_NAMED_US = 20.0


class Trace:
    """The events of one traced span (times in microseconds)."""

    def __init__(self, events: List[dict]) -> None:
        self.device = [e for e in events if e.get("ph") == "X"
                       and e.get("cat") in DEVICE_CATS]
        self.host = [e for e in events if e.get("ph") == "X"
                     and e.get("cat") in HOST_CATS]
        steps = [e for e in self.host if e["name"] == STEP_SPAN]
        self.steps = len(steps)
        self.t0 = min((e["ts"] for e in steps), default=0.0)
        self.t1 = max((e["ts"] + e["dur"] for e in steps), default=0.0)
        self.device = [e for e in self.device
                       if e["ts"] + e["dur"] > self.t0 and e["ts"] < self.t1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def clipped(self) -> List[Tuple[float, float]]:
        out = []
        for e in self.device:
            a, b = max(e["ts"], self.t0), min(e["ts"] + e["dur"], self.t1)
            if b > a:
                out.append((a, b - a))
        return out

    @property
    def busy_s(self) -> float:
        return busy_us(self.clipped()) / 1e6

    def kernels(self, name: Optional[str] = None) -> List[dict]:
        return [e for e in self.device if e["cat"] == "kernel"
                and (name is None or name in e["name"])]

    def top_device_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for e in self.device:
            by[e["name"][:120]] = by.get(e["name"][:120], 0.0) + e["dur"]
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e6] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Idle time between device operations, summed by the innermost
        host operation running at each gap's middle (gaps under
        ``GAP_NAMED_US`` as one entry)."""
        ivs = sorted(self.clipped())
        gaps, end = [], self.t0
        for ts, dur in ivs:
            if ts > end:
                gaps.append((end, ts))
            end = max(end, ts + dur)
        if self.t1 > end:
            gaps.append((end, self.t1))
        host = sorted(self.host, key=lambda e: e["ts"])
        starts = np.array([e["ts"] for e in host], dtype=float)
        ends = starts + np.array([e["dur"] for e in host], dtype=float)
        by: Dict[str, float] = {}
        for a, b in gaps:
            if b - a < GAP_NAMED_US:
                name = f"gaps under {GAP_NAMED_US:g} us"
            else:
                mid = (a + b) / 2
                cover = np.nonzero((starts <= mid) & (ends >= mid))[0]
                name = host[int(cover[-1])]["name"][:120] if cover.size \
                    else "host: no operation"
            by[name] = by.get(name, 0.0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e6] for k, v in top]


class Profiler:
    """torch.profiler (host and device) from :meth:`start` to
    :meth:`stop`, which returns the trace read."""

    def __init__(self, root: Path) -> None:
        import torch
        act = torch.profiler.ProfilerActivity
        self.path = root / "build" / "bench" / "trace.json"
        self.prof = torch.profiler.profile(activities=[act.CPU, act.CUDA])

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> Trace:
        import torch
        torch.cuda.synchronize()
        self.prof.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        try:
            events = json.loads(self.path.read_text())["traceEvents"]
        finally:
            self.path.unlink()
        return Trace(events)
