"""The traced window: ``torch.profiler`` over the calls (host operators and
spans, and on the card every kernel, copy and set), reduced by
``timeline`` once the window has closed.  Nothing is written to disk."""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from codec_bench import timeline


class Tracer:
    """``with Tracer(on_card) as t:`` around the window; ``t.span(name)``
    marks a host span; ``t.summary()`` after the ``with``."""

    def __init__(self, on_card: bool):
        self._prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else []))

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)

    @staticmethod
    def span(name: str):
        return record_function(name)

    def events(self) -> list[timeline.Event]:
        """Every event of the trace, read raw (the profiler's own event
        tree is far slower to build over a window of calls)."""
        cuda = torch.autograd.DeviceType.CUDA
        return [timeline.Event(e.name(), e.start_ns() / 1e9,
                               (e.start_ns() + e.duration_ns()) / 1e9,
                               e.device_type() == cuda)
                for e in self._prof.profiler.kineto_results.events()]

    def summary(self, n: int = 10) -> timeline.Summary | None:
        """The window span's summary; None when the trace lacks the span."""
        events = self.events()
        win = [e for e in events
               if not e.device and e.name == timeline.WINDOW_SPAN]
        if not win:
            return None
        return timeline.summarize(events, win[0].start, win[0].end, n)
