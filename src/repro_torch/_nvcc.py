"""Build a CUDA shared library with ``nvcc`` and load it with ``ctypes``,
and the checks every kernel wrapper makes around a launch.

Every kernel library of the port goes through :func:`build`: its
sources are compiled for ``sm_90a`` at first use into ``build/
repro_torch/`` of the checkout (listed in ``.gitignore``), under a name
keyed by a hash of the sources and the flags, so a changed source or
flag builds anew and an unchanged one is loaded as it is.  The output is
written under a temporary name and renamed into place, so a process
never loads a half-written library; nvcc's output (ptxas's registers and
spills) is kept beside it, so a library loaded as it is still reports
them.  A missing ``nvcc`` or a failed build raises :class:`KernelError`
(a ``RuntimeError``); nothing falls back.

Each library has a plain C interface; the caller sets each function's
``argtypes`` (``ctypes.c_void_p`` for pointers and the stream,
``ctypes.c_int`` for ints) on the returned handle.  A wrapper launches
only on CUDA tensors (:func:`on_cuda`), raises a :class:`KernelError`
when the launch function returns a CUDA error (:func:`raise_on`) and
counts the launch with :func:`count_launch`.

Threads: the scheduler service runs each worker lane on its own thread,
so several threads may build, load and launch at once.  :func:`build`
holds one lock per library name, so a library is compiled once while
other libraries build in parallel; each kernel module guards its loaded
handle with its own lock (:class:`LibraryCache`); :func:`count_launch`
increments the launch counters under one lock.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Generic, Optional, Sequence, Tuple, TypeVar

import torch

__all__ = ["BASE_FLAGS", "BUILD_DIR", "KernelError", "Library",
           "LibraryCache", "build", "count_launch", "on_cuda", "raise_on"]

# flags of every library; a library adds its own (e.g. ``--fmad=false``)
BASE_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# the checkout's root (src/repro_torch/_nvcc.py -> 2 up)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"


class KernelError(RuntimeError):
    """A kernel library that could not be built, or a launch that
    returned a CUDA error."""


@dataclasses.dataclass
class Library:
    name: str
    lib: ctypes.CDLL
    path: Path
    flags: Tuple[str, ...]
    build_seconds: float      # 0.0 when the hashed build already existed
    log: str                  # nvcc's output (ptxas: registers, spills),
                              # kept beside the library as lib*.log


# one lock per library name (made under _LOCKS_LOCK), so that two threads
# never write one library's temporary file at once
_BUILD_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()
# every kernel module's launch counters
_COUNT_LOCK = threading.Lock()


def build(name: str, sources: Sequence[Path],
          flags: Sequence[str]) -> Library:
    """Compile ``sources`` with ``flags`` into ``lib<name>_<hash>.so``
    (once per hash of the sources and flags) and load it."""
    with _LOCKS_LOCK:
        lock = _BUILD_LOCKS.setdefault(name, threading.Lock())
    with lock:
        return _build(name, sources, flags)


def _build(name: str, sources: Sequence[Path],
           flags: Sequence[str]) -> Library:
    from torch.utils.cpp_extension import CUDA_HOME
    flags = tuple(flags)
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    log_path = out.with_suffix(".log")
    seconds, log = 0.0, ""
    if out.exists():
        if log_path.exists():
            log = log_path.read_text()
    else:
        nvcc = None if CUDA_HOME is None else Path(CUDA_HOME) / "bin" / "nvcc"
        if nvcc is None or not nvcc.exists():
            raise KernelError(f"nvcc not found (CUDA_HOME is {CUDA_HOME!r}):"
                              f" cannot build {name}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        res = subprocess.run([str(nvcc), *flags, "-o", str(tmp),
                              *map(str, sources)], capture_output=True,
                             text=True)
        seconds = time.perf_counter() - t0
        log = res.stderr + res.stdout
        if res.returncode != 0:
            raise KernelError(f"nvcc failed on {name} ({res.returncode}):\n"
                              f"{log}")
        tmp_log = tmp.with_suffix(".log")
        tmp_log.write_text(log)
        os.replace(tmp_log, log_path)
        os.replace(tmp, out)
    return Library(name, ctypes.CDLL(str(out)), out, flags, seconds, log)


T = TypeVar("T")


class LibraryCache(Generic[T]):
    """A kernel module's loaded library: built by ``load`` on the first
    :meth:`get` of any thread, the same handle for every later one.  A
    failed build raises to its caller and leaves the cache empty."""

    def __init__(self, load: Callable[[], T]) -> None:
        self._load = load
        self._value: Optional[T] = None
        self._lock = threading.Lock()

    def get(self) -> T:
        value = self._value
        if value is None:
            with self._lock:
                if self._value is None:
                    self._value = self._load()
                value = self._value
        return value


def count_launch(*counters: Tuple[Dict[str, int], str]) -> None:
    """Add one to each ``(counts, key)`` under the counters' lock."""
    with _COUNT_LOCK:
        for counts, key in counters:
            counts[key] += 1


def on_cuda(tensors: Sequence[torch.Tensor]) -> bool:
    """True when every tensor is on one CUDA device (launch the kernel),
    False when every tensor is on the CPU (run the plain version); raises
    on anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise KernelError(f"{kernel} launch failed with CUDA error {rc}")
