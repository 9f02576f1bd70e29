"""The share of the window spent in the large route's page-locked body (the
program's span ``defl.large.body``: its allocation, the copy of the
stream into it and the upload's start), summed over the window, in %."""

from codec_bench.spans import share_pct


def read(w):
    return share_pct(w, "defl.large.body")
