"""Lanes the entry re-decoded on the host engine (the program's counters
``pipeline_host_retries`` and ``host_fallback_lanes``), as a share of the
lanes the window attempted."""


def read(w):
    if w.kind != "inflate" or not w.lanes:
        return None
    c = w.counters
    retried = c.get("pipeline_host_retries", 0) + c.get(
        "host_fallback_lanes", 0)
    return 100.0 * retried / w.lanes
