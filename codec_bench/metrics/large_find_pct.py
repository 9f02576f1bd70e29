"""The share of the window spent in the host's finds of the large route's
lane starts (the program's span ``defl.large.find``: every find of a
call in one native call), summed over the window, in %."""

from codec_bench.spans import share_pct


def read(w):
    return share_pct(w, "defl.large.find")
