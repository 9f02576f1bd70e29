"""The 90th percentile of the latency of every call in the window, in ms
(the highest percentile with ten calls beyond it at the window's length)."""

import statistics


def read(w):
    if len(w.latencies_s) < 2:
        return None
    return statistics.quantiles(w.latencies_s, n=10,
                                method="inclusive")[8] * 1e3
