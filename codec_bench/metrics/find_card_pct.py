"""Finds of the split decode's lane starts that ran on the card (the
program's counters ``lane_finds_card`` over ``lane_finds``: every find of
``large.find_lane_starts``, the kernel's and the host's), in %: a find not
on the card scans on the host while the card waits."""


def read(w):
    finds = w.counters.get("lane_finds")
    if w.kind != "inflate" or not finds:
        return None
    return 100.0 * w.counters.get("lane_finds_card", 0) / finds
