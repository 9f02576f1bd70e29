"""The share of the window the host's C++ resolver spent turning tokens
into bytes (the program's span ``defl.resolve``, summed over the window),
in %."""

from codec_bench.spans import share_pct


def read(w):
    return share_pct(w, "defl.resolve")
