"""The share of the window spent in the large route's stitch on the host
(the program's span ``defl.large.stitch``: validated lanes resolved into
the caller's buffer, gaps decoded serially, one thread), summed over the
window, in %."""

from codec_bench.spans import share_pct


def read(w):
    return share_pct(w, "defl.large.stitch")
