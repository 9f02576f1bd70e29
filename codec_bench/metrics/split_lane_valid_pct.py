"""Lanes of the program's split decode of a batch's long streams that
validated (its counters ``batch_split_lanes_valid`` over
``batch_split_lanes``), in %: a lane that did not is decoded again on the
host."""


def read(w):
    lanes = w.counters.get("batch_split_lanes")
    if w.kind != "inflate" or not lanes:
        return None
    return 100.0 * w.counters.get("batch_split_lanes_valid", 0) / lanes
