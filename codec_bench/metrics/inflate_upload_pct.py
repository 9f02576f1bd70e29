"""The share of the window the inflate entry spent copying the packed
inputs from the host to the card (the program's span ``defl.upload``,
summed over the window), in %."""

from codec_bench.spans import share_pct


def read(w):
    return share_pct(w, "defl.upload")
