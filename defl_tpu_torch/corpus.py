"""The bench corpus maker (the port's own copy of
``defl_tpu/bench.py``'s ``make_silesia_like``): the same bytes for the
same seed.
"""

from __future__ import annotations

import random


def make_silesia_like(total_bytes: int, block: int = 65536, seed: int = 42):
    """Mixed-characteristic corpus blocks (text / JSON-ish / binary-struct /
    high-redundancy / semi-random), ~2:1 zlib ratio like Silesia."""
    rng = random.Random(seed)
    words = ("the of and to in is was he for it with as his on be at by had "
             "not are but from or have an they which one you were her all "
             "she there would their we him been has when who will more no "
             "if out so said what up its about into than them can only "
             "other new some could time these two may then do first any my "
             "now such like our over man me even most made after also did "
             "many before must through years where much your way down "
             "should because each just those people how too little state "
             "good very make world still own see men work long get here "
             "between both life being under never day same another know "
             "while last might us great old year off come since against go "
             "came right used take three").split()

    # generate up to 64 unique blocks and cycle them: per-lane decode work
    # is identical either way (lanes are independent), and corpus
    # generation stays O(seconds) at multi-GB batch sizes
    n_unique = min(64, (total_bytes + block - 1) // block)
    blocks = []
    produced = 0
    kind = 0
    while produced < n_unique * block:
        k = kind % 5
        kind += 1
        if k == 0:      # english-ish text
            b = (" ".join(rng.choice(words)
                          for _ in range(block // 5))).encode()[:block]
        elif k == 1:    # structured records (xml/json-ish)
            rows = []
            while sum(len(r) for r in rows) < block:
                rows.append(
                    b'<row id="%d" name="item-%d" value="%.6f"/>'
                    % (rng.randrange(10**6), rng.randrange(10**4),
                       rng.random()))
            b = b"\n".join(rows)[:block]
        elif k == 2:    # binary structs: correlated little-endian ints
            vals = bytearray()
            x = 1 << 20
            while len(vals) < block:
                x = (x + rng.randrange(-1000, 1000)) & 0xFFFFFFFF
                vals += x.to_bytes(4, "little")
            b = bytes(vals[:block])
        elif k == 3:    # high redundancy
            unit = rng.randbytes(rng.choice([3, 17, 64, 256]))
            b = (unit * (block // len(unit) + 1))[:block]
        else:           # semi-random with embedded repeats
            b = bytearray(rng.randbytes(block))
            blob = rng.randbytes(600)
            for _ in range(20):
                p = rng.randrange(0, block - 600)
                b[p : p + 600] = blob
            b = bytes(b)
        blocks.append(b)
        produced += len(b)
    n_total = (total_bytes + block - 1) // block
    return [blocks[i % len(blocks)] for i in range(n_total)]
