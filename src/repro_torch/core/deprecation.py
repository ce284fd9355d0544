"""Once-per-process deprecation warnings for the legacy entry points.

Twin of ``repro.core.deprecation``: :func:`warn_once` emits one real
``DeprecationWarning`` per key per process, so a sweep loop over a
deprecated shim warns once instead of on every call; :func:`reset`
clears the emitted set so tests can assert the warning.
"""
from __future__ import annotations

import threading
import warnings
from typing import Set

_emitted: Set[str] = set()
# the service calls the session API from several worker threads
_lock = threading.Lock()


def warn_once(key: str, message: str, stacklevel: int = 3) -> None:
    """Emit ``DeprecationWarning`` for ``key`` only the first time."""
    with _lock:
        if key in _emitted:
            return
        _emitted.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel)


def reset() -> None:
    """Forget which warnings fired (test isolation helper)."""
    with _lock:
        _emitted.clear()
