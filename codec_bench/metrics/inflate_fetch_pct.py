"""The share of the window the inflate entry spent fetching the tokens and
each lane's totals from the card (the program's span ``defl.fetch``, summed
over the window), in %."""

from codec_bench.spans import share_pct


def read(w):
    return share_pct(w, "defl.fetch")
