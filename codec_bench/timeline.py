"""Interval arithmetic over a profiler's events: the union of device
activity, the idle gaps and what the host was doing in them, the kernels'
summed time, and the bound by bytes.  Plain Python, so that it is tested on
synthetic events on the CPU.

Times are seconds on the trace's own clock.  An event is on the device
(a kernel, a copy or a set) or on the host (a span or an operator); a
device event whose name starts with ``Memcpy`` or ``Memset`` is a copy or a
set, every other one a kernel.  A host span also leaves its mirror on the
device's timeline (the profiler's GPU user annotation, under the span's
own name): that mirror is no device work, and ``summarize`` drops every
device event that bears the name of a host event.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: the host span that holds one call of the entry, and the one that holds
#: the whole window
CALL_SPAN = "codec_bench.call"
WINDOW_SPAN = "codec_bench.window"
BETWEEN_CALLS = "between calls"
#: a name in a summary is cut to this many characters (kernels' template
#: signatures run to hundreds)
NAME_CHARS = 160


@dataclass(frozen=True)
class Event:
    name: str
    start: float
    end: float
    device: bool


@dataclass
class Summary:
    """What a traced window reduces to."""
    window_s: float
    busy_s: float
    kernel_s: float
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The intervals clipped to [lo, hi] and merged, in order."""
    out: list[list[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in union(intervals, lo, hi):
        if a > at:
            out.append((at, a))
        at = b
    if hi > at:
        out.append((at, hi))
    return out


def kernel_s(events, lo: float, hi: float) -> float:
    """The summed time of every kernel in [lo, hi] (kernels that overlap
    each other count each)."""
    return sum(max(0.0, min(e.end, hi) - max(e.start, lo)) for e in events
               if e.device and is_kernel(e.name))


def top_ops(events, lo: float, hi: float, n: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time in
    [lo, hi], summed by name."""
    by: dict[str, float] = {}
    for e in events:
        if e.device:
            d = min(e.end, hi) - max(e.start, lo)
            if d > 0:
                by[e.name] = by.get(e.name, 0.0) + d
    return _top(by, n)


def _top(by: dict, n: int) -> list:
    return [[k[:NAME_CHARS], v]
            for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def name_gaps(idle, host, n: int = 10) -> list:
    """[[name, seconds]] of the idle time, summed by what the host was
    doing: the innermost host event (the shortest, other than the window's
    own span) that holds the middle of the gap, else ``BETWEEN_CALLS``."""
    hosts = sorted((e for e in host if e.name != WINDOW_SPAN),
                   key=lambda e: e.start)
    by: dict[str, float] = {}
    active: list[Event] = []
    j = 0
    for a, b in sorted(idle):
        mid = (a + b) / 2
        while j < len(hosts) and hosts[j].start <= mid:
            active.append(hosts[j])
            j += 1
        active = [e for e in active if e.end >= mid]
        name = (min(active, key=lambda e: e.end - e.start).name if active
                else BETWEEN_CALLS)
        by[name] = by.get(name, 0.0) + (b - a)
    return _top(by, n)


def summarize(events, lo: float, hi: float, n: int = 10) -> Summary:
    """The traced window [lo, hi] of ``events``."""
    host = [e for e in events if not e.device]
    names = {e.name for e in host}
    work = [e for e in events if e.device and e.name not in names]
    dev = [(e.start, e.end) for e in work]
    busy = sum(b - a for a, b in union(dev, lo, hi))
    return Summary(
        window_s=hi - lo, busy_s=busy, kernel_s=kernel_s(work, lo, hi),
        device_ops=top_ops(work, lo, hi, n),
        idle_gaps=name_gaps(gaps(dev, lo, hi), host, n))


def bytes_bound_s(nbytes: int, peak_bytes_per_s: float) -> float:
    """The least time in which the card moves ``nbytes``."""
    return nbytes / peak_bytes_per_s


def idle_pct(summary: Summary | None) -> float | None:
    """The share of the window with nothing on the device, in %; nothing
    when the window was not traced or the trace holds no device event."""
    if summary is None or summary.busy_s <= 0 or summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
