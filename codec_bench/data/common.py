"""What the generators share: the seeded random source, the batch record,
and zlib over every core."""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np


@dataclass
class Batch:
    """One batch of a pool.  ``raw``: the payloads (list of bytes).
    ``inputs``: what an inflate entry is handed, one item a lane (bytes, or
    a list of memoryviews of chunk payloads); None for an encode cell.
    ``streams``: each lane's compressed stream as contiguous bytes, which is
    what the reference inflates; None for an encode cell."""
    raw: list
    inputs: list | None
    streams: list | None


def rng(seed: int, *index: int) -> np.random.Generator:
    """The random source of one part of a pool (a batch, a chunk of a
    batch, an image): any whole ``seed`` (also past 64 bits, or negative)
    with the part's indices."""
    s = int(seed)
    words = [abs(s) >> (64 * i) & (2**64 - 1)
             for i in range(max(1, (abs(s).bit_length() + 63) // 64))]
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence(words + [int(s < 0)]
                               + [int(i) for i in index])))


def pmap(fn, items) -> list:
    """``[fn(x) for x in items]`` on a thread a core (zlib lets go of the
    interpreter lock while it works)."""
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        return list(ex.map(fn, items))


def zlib_all(raw, level: int) -> list[bytes]:
    """Each payload's zlib stream at ``level``."""
    return pmap(lambda b: zlib.compress(b, level), raw)
