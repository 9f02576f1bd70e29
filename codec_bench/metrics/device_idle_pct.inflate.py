"""The share of the traced window in which no kernel, copy or set ran on
the card (1 - the union of device activity over the window)."""

from codec_bench import timeline


def read(w):
    if w.kind != "inflate":
        return None
    return timeline.idle_pct(w.trace)
