"""Silesia-like 64 KiB blocks from a seed, every block distinct.

The same five kinds of block as ``defl_tpu_torch.corpus.make_silesia_like``
and in the same mix (block ``i`` of a batch is of kind ``i % 5``): English-ish
text, XML-ish records, correlated little-endian ints, a short unit repeated,
and random bytes with a 600-byte blob pasted 20 times.  Written in NumPy
over chunks of ``CHUNK`` blocks, each chunk drawn from a random source of
its own, made from the seed, so that the chunks are made on every core:
no block repeats, within a batch or across the pool.

``make_pool`` returns batches as ``common.Batch`` objects; with ``encode``
each block is also compressed by the standard library's zlib at the
configured level, on every core.
"""

from __future__ import annotations

import zlib

import numpy as np

from codec_bench.data import common

WORDS = (
    "the of and to in is was he for it with as his on be at by had not are "
    "but from or have an they which one you were her all she there would "
    "their we him been has when who will more no if out so said what up its "
    "about into than them can only other new some could time these two may "
    "then do first any my now such like our over man me even most made "
    "after also did many before must through years where much your way "
    "down should because each just those people how too little state good "
    "very make world still own see men work long get here between both life "
    "being under never day same another know while last might us great old "
    "year off come since against go came right used take three").split()

UNIT_LENGTHS = (3, 17, 64, 256)
BLOB = 600
BLOBS_PER_BLOCK = 20
#: blocks drawn from one random source, the unit of the work on every core
CHUNK = 64
_ROW_PARTS = (b'<row id="', b'" name="item-', b'" value="0.', b'"/>\n')


def _text(rng, n, block):
    """``block // 5`` words drawn uniformly, joined by single spaces and cut
    at ``block`` (so a text block is a little short of it, as in the
    original)."""
    if n == 0:
        return []
    vocab = [w.encode() + b" " for w in WORDS]
    lens = np.array([len(w) for w in vocab], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    buf = np.frombuffer(b"".join(vocab), np.uint8)
    idx = rng.integers(0, len(vocab), n * (block // 5))
    ln = lens[idx]
    ends = np.cumsum(ln)
    flat = buf[np.repeat(offs[idx] - (ends - ln), ln) + np.arange(ends[-1])]
    per = ln.reshape(n, -1).sum(1)
    starts = np.concatenate([[0], np.cumsum(per)[:-1]])
    return [flat[s: s + min(t - 1, block)].tobytes()
            for s, t in zip(starts, per)]


def _digits(vals, width):
    """uint8 [R, width] decimal digits of ``vals`` and a mask that drops
    leading zeros (one digit always stays)."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    d = (vals[:, None] // p) % 10
    keep = (vals[:, None] >= p) | (p == 1)
    return (d + 48).astype(np.uint8), keep


def _records(rng, n, block):
    """``<row id=".." name="item-.." value="0.dddddd"/>`` rows, newline
    separated, cut at ``block``."""
    if n == 0:
        return []
    rows = block // 45 + 1                  # 45 B is the shortest row
    total = n * rows
    idv, idm = _digits(rng.integers(0, 10**6, total), 6)
    nmv, nmm = _digits(rng.integers(0, 10**4, total), 4)
    frv, _ = _digits(rng.integers(0, 10**6, total), 6)
    cols, masks = [], []
    fields = ((idv, idm), (nmv, nmm), (frv, np.ones_like(idm)), None)
    for piece, fld in zip(_ROW_PARTS, fields):
        piece = np.frombuffer(piece, np.uint8)
        cols.append(np.broadcast_to(piece, (total, len(piece))))
        masks.append(np.ones((total, len(piece)), bool))
        if fld is not None:
            cols.append(fld[0])
            masks.append(fld[1])
    mat, mask = np.concatenate(cols, 1), np.concatenate(masks, 1)
    flat = mat[mask]
    per = mask.reshape(n, -1).sum(1)
    starts = np.concatenate([[0], np.cumsum(per)[:-1]])
    return [flat[s: s + block].tobytes() for s in starts]


def _ints(rng, n, block):
    """A random walk of uint32 (steps in [-1000, 1000)) from 2**20."""
    steps = rng.integers(-1000, 1000, (n, block // 4))
    walk = ((1 << 20) + np.cumsum(steps, 1)) & 0xFFFFFFFF
    return [r.astype("<u4").tobytes() for r in walk]


def _repeated(rng, n, block, part):
    """A unit of 3, 17, 64 or 256 random bytes, repeated to ``block``.  The
    3-byte units are drawn without replacement from the residue class
    ``part[0]`` modulo ``part[1]`` (the batch's own), so no two blocks of a
    pool agree."""
    lens = rng.choice(UNIT_LENGTHS, n)
    short = np.flatnonzero(lens == 3)
    three = part[0] + part[1] * rng.choice((1 << 24) // part[1], len(short),
                                           replace=False)
    out = []
    for b in range(n):
        if lens[b] == 3:
            unit = int(three[np.searchsorted(short, b)]).to_bytes(3, "little")
        else:
            unit = rng.bytes(int(lens[b]))
        out.append((unit * (block // len(unit) + 1))[:block])
    return out


def _semirandom(rng, n, block):
    """Random bytes with one random 600-byte blob pasted at 20 places."""
    arr = rng.integers(0, 256, (n, block), np.uint8)
    blob = rng.integers(0, 256, (n, BLOB), np.uint8)
    pos = rng.integers(0, block - BLOB, (n, BLOBS_PER_BLOCK))
    cols = pos[:, :, None] + np.arange(BLOB)
    arr[np.arange(n)[:, None, None], cols] = blob[:, None, :]
    return [r.tobytes() for r in arr]


def _chunk(seed, batch_index, n_batches, n, block, c):
    """Blocks ``c * CHUNK`` up to ``(c + 1) * CHUNK`` of the batch, drawn
    from the chunk's own random source; block ``i`` is of kind ``i % 5``."""
    rng = common.rng(seed, batch_index, c)
    chunks = -(-n // CHUNK)
    idx = range(c * CHUNK, min(n, (c + 1) * CHUNK))
    m = [sum(1 for i in idx if i % 5 == k) for k in range(5)]
    part = (batch_index * chunks + c, n_batches * chunks)
    by_kind = [iter(b) for b in (
        _text(rng, m[0], block), _records(rng, m[1], block),
        _ints(rng, m[2], block), _repeated(rng, m[3], block, part),
        _semirandom(rng, m[4], block))]
    return [next(by_kind[i % 5]) for i in idx]


def make_blocks(seed: int, batch_index: int, n_batches: int, n: int,
                block: int):
    """``n`` distinct blocks of batch ``batch_index`` (of ``n_batches``) of
    the pool drawn from ``seed``; block ``i`` is of kind ``i % 5``."""
    return [b for c in range(-(-n // CHUNK))
            for b in _chunk(seed, batch_index, n_batches, n, block, c)]


def make_pool(fmt: dict, seed: int, n_batches: int, batch: int,
              encode: bool = True) -> list[common.Batch]:
    """``n_batches`` batches of ``batch`` blocks of ``fmt["block_bytes"]``;
    with ``encode``, each block's zlib stream at ``fmt["level"]`` too.
    The chunks of every batch are made, and compressed, on every core."""
    block, level = int(fmt["block_bytes"]), int(fmt["level"])
    jobs = [(j, c) for j in range(n_batches) for c in range(-(-batch // CHUNK))]

    def job(jc):
        raw = _chunk(seed, jc[0], n_batches, batch, block, jc[1])
        return raw, ([zlib.compress(b, level) for b in raw] if encode
                     else None)

    done = common.pmap(job, jobs)
    pool = []
    for j in range(n_batches):
        mine = [d for (jj, _), d in zip(jobs, done) if jj == j]
        raw = [b for r, _ in mine for b in r]
        streams = [s for _, z in mine for s in z] if encode else None
        pool.append(common.Batch(raw=raw, inputs=streams, streams=streams))
    return pool
