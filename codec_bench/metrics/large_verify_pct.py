"""The share of the window spent in the large route's adler32 check of the
whole output against the stream's trailer (the program's span
``defl.large.verify``), summed over the window, in %."""

from codec_bench.spans import share_pct


def read(w):
    return share_pct(w, "defl.large.verify")
