"""The bench corpus maker (the port's own copy of
``defl_tpu/bench.py``'s ``make_silesia_like``): the same bytes for the
same seed; and the malformed streams the fuzz feeds the decoders
(``fuzz_cases``, drawn as tests/test_fuzz.py's ``_gen_cases`` draws them).
"""

from __future__ import annotations

import random
import zlib

#: the kinds of stream ``fuzz_cases`` draws: a valid zlib stream, one cut
#: short, one with 1-4 bit flips, random garbage, a valid zlib header
#: before a garbage body
VALID, TRUNCATED, BIT_FLIPS, GARBAGE, GARBAGE_BODY = range(5)


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


def fuzz_cases(seed: int, n: int, payloads) -> list[tuple[int, bytes]]:
    """``n`` (kind, stream) pairs from ``random.Random(seed)`` over
    ``payloads``: the streams of tests/test_fuzz.py's ``_gen_cases``, byte
    for byte, when given its payloads."""
    rng = random.Random(seed)
    cases = []
    for _ in range(n):
        kind = rng.randrange(5)
        if kind == VALID:
            data = zlib.compress(rng.choice(payloads), rng.randrange(10))
        elif kind == TRUNCATED:
            d = zlib.compress(rng.choice(payloads), 6)
            data = d[: rng.randrange(1, max(2, len(d)))]
        elif kind == BIT_FLIPS:
            d = bytearray(zlib.compress(rng.choice(payloads), 6))
            for _ in range(rng.randrange(1, 5)):
                if d:
                    p = rng.randrange(len(d))
                    d[p] ^= 1 << rng.randrange(8)
            data = bytes(d)
        elif kind == GARBAGE:
            data = rng.randbytes(rng.randrange(1, 200))
        else:
            data = b"\x78\x9c" + rng.randbytes(rng.randrange(1, 150))
        cases.append((kind, data))
    return cases


def fuzz_payloads(blocks) -> list[bytes]:
    """What ``fuzz_cases`` compresses, cut from ``make_silesia_like`` blocks
    the way tests/test_fuzz.py cuts its corpus: 400 bytes of text, 255 of
    semi-random bytes, 300 of a short period, nothing, one byte."""
    return [blocks[0][:400], blocks[4][:255], blocks[3][:300], b"", b"a"]


def mixed_batch(streams, blocks, seed: int, every: int = 8):
    """``streams`` with every ``every``-th lane swapped for a malformed
    stream (``fuzz_cases`` of every kind but VALID over
    ``fuzz_payloads(blocks)``).  Returns (the new list, the swapped lanes'
    indices)."""
    lanes = list(range(0, len(streams), every))
    bad = [d for k, d in fuzz_cases(seed, 4 * len(lanes) + 16,
                                    fuzz_payloads(blocks)) if k != VALID]
    if len(bad) < len(lanes):
        raise ValueError(f"seed {seed} drew {len(bad)} malformed streams "
                         f"for {len(lanes)} lanes")
    mixed = list(streams)
    for i, d in zip(lanes, bad):
        mixed[i] = d
    return mixed, lanes
