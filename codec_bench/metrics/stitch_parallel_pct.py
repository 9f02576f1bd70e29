"""Chains of the split decode that the stitch resolved on every host
thread (the program's counters ``stitch_chains_parallel`` over
``stitch_chains``: every chain of ``large.stitch_chains``, which both
split routes run), in %: a chain not resolved so walks its lanes on one
thread while the other threads and the card wait."""


def read(w):
    chains = w.counters.get("stitch_chains")
    if w.kind != "inflate" or not chains:
        return None
    return 100.0 * w.counters.get("stitch_chains_parallel", 0) / chains
