"""Process-wide codec counters (observability); the port's own, a copy
of ``defl_tpu/metrics.py``.

The reference declares per-stream UNZ_STATS counters but never sets or
reads them anywhere (the reference's `src/common.h:181-187`).  This
module is the working equivalent: cheap process-global counters wired
into the real entry points (the batch device pipeline and the streaming
session), readable as one snapshot dict.

Usage::

    from defl_tpu_torch import metrics
    metrics.reset()
    ... do work ...
    print(metrics.snapshot())

Counters are guarded by a lock (the batch pipelines increment from
worker threads).  Overhead is a few ns per *batch*, not per byte.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counters: dict[str, int] = {}


def inc(name: str, value: int = 1) -> None:
    """Add ``value`` to counter ``name`` (created on first use)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(value)


def snapshot() -> dict[str, int]:
    """A consistent copy of every counter."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _counters.clear()
