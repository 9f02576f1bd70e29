"""The program's spans as the readers in ``metrics/`` see them.

A span of the program (``defl_tpu_torch.metrics.span``) adds its length in
nanoseconds to counter ``<span>.ns``; the window's counters are read after
a ``reset()`` at its start.  A program without the span has no counter,
and the reader then reports nothing."""


def share_pct(w, span: str, kind: str = "inflate"):
    """Span ``span``'s summed length over the window, in %; None when the
    window is not of ``kind`` or the program has no such counter."""
    ns = w.counters.get(span + ".ns")
    if w.kind != kind or not ns or w.window_s <= 0:
        return None
    return 100.0 * ns / 1e9 / w.window_s
