"""The inflate kernels' share of their bound by bytes.

The bound is the bytes any inflater must move, read from the inputs and not
from the implementation (compressed bytes in plus raw bytes out of every
call in the traced window), over the card's peak memory bandwidth.  The
share is that bound over the summed device time of every kernel the trace
holds in the window.  Inflate is integer work on serial chains: no
operation term is counted.
"""

from codec_bench import timeline


def read(w):
    if w.kind != "inflate" or w.trace is None or not w.trace.kernel_s \
            or not w.peak_Bps:
        return None
    bound_s = timeline.bytes_bound_s(w.comp_bytes + w.raw_bytes, w.peak_Bps)
    return 100.0 * bound_s / w.trace.kernel_s
