"""The share of the window the pipeline's driving thread spent blocked on
the host resolver (the program's span ``defl.resolve_wait``, summed over
the window), in %."""

from codec_bench.spans import share_pct


def read(w):
    return share_pct(w, "defl.resolve_wait")
