"""The share of the window the inflate entry spent packing its streams into
zero-padded words on the host (the program's span ``defl.pack``, summed
over the window), in %."""

from codec_bench.spans import share_pct


def read(w):
    return share_pct(w, "defl.pack")
