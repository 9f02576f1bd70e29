"""The share of the window the inflate entry spent making each lane's
result and bytes, the adler32 trailer check with them (the program's span
``defl.lane_bytes``, summed over the window), in %."""

from codec_bench.spans import share_pct


def read(w):
    return share_pct(w, "defl.lane_bytes")
