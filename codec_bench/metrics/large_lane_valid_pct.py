"""Lanes of the large route's split decode that validated (the program's
counters ``large_device_lanes_valid`` over ``large_device_lanes``), in %:
a lane that did not is decoded again by the stitch on the host."""


def read(w):
    lanes = w.counters.get("large_device_lanes")
    if w.kind != "inflate" or not lanes:
        return None
    return 100.0 * w.counters.get("large_device_lanes_valid", 0) / lanes
