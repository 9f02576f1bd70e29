"""Process-wide codec counters and spans (observability); the port's own,
a copy of ``defl_tpu/metrics.py`` with spans added.

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

Spans time the stages of the entries (pack, upload, decode, fetch,
resolve, ...), one per stage and batch, never per lane::

    with metrics.span("defl.pack") as sp:
        ...
    seconds = sp.s        # also sp.ns, the integer nanoseconds

A span that closes adds its elapsed ``time.perf_counter_ns()`` to counter
``<name>.ns`` and 1 to ``<name>.n``, in the same dict as the counters, so
``snapshot()`` and ``reset()`` cover them.  While a ``torch.profiler`` is
recording, the span is also a ``torch.profiler.record_function(name,
args)``: it lies on the profiler's clock, the one the card's events are
on, nested in the span around it.  ``args`` (a string: a batch index)
goes to the profiler alone, so the sums by name add up.  The profiler's
default configuration records only the thread that started it: a span on
a worker thread reaches the counters, not the trace.  Off the profiler a
span costs two clock reads, a check of the profiler's flag and the lock.
"""

from __future__ import annotations

import threading
import time

import torch
from torch._C._autograd import _profiler_enabled

_lock = threading.Lock()
_counters: dict[str, int] = {}
_record_function = torch.profiler.record_function


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


class span:
    """Context manager timing one stage into counters ``<name>.ns`` and
    ``<name>.n`` (module docstring); after it closes, ``ns`` and ``s``
    hold its length."""

    __slots__ = ("name", "args", "ns", "s", "_t0", "_rf")

    def __init__(self, name: str, args: str | None = None):
        self.name, self.args = name, args
        self.ns, self.s = 0, 0.0

    def __enter__(self) -> "span":
        self._rf = None
        if _profiler_enabled():
            self._rf = _record_function(self.name, self.args)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        ns = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.ns, self.s = ns, ns / 1e9
        n_key, ns_key = self.name + ".n", self.name + ".ns"
        with _lock:
            _counters[ns_key] = _counters.get(ns_key, 0) + ns
            _counters[n_key] = _counters.get(n_key, 0) + 1
