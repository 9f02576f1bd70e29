"""The Silesia corpus as one archive from a seed: its 12 files, at their
published sizes and in their order, joined as ``tarfile`` writes a ustar
archive, and compressed as one zlib stream.

The corpus is not in the repository, so each member's bytes are made: the
format names a kind for each, one of ``silesia_blocks``' own (``text``,
``records``, ``ints``, ``semirandom``: its functions ``_text``, ...), drawn
in pieces of ``piece_bytes`` from a random source of the member's own and
cut at the member's size.  The members are made on every core, and the
pool's archives are compressed side by side, each as one stream at the
configured level, window and memLevel with the default strategy.

An archive is each member's 512-byte ustar header (``tarfile``'s own, with
a fixed mtime, owner and mode), its bytes and zeros up to a multiple of
512, then two zero blocks and zeros up to a whole record of
``record_bytes``: ``layout`` gives its length from the format alone.
"""

from __future__ import annotations

import tarfile
import zlib

from codec_bench.data import common, silesia_blocks

BLOCK = tarfile.BLOCKSIZE
#: pieces drawn at a time from a member's random source
PIECES = 64


def _padded(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def layout(fmt: dict) -> tuple[list[int], int]:
    """(each member's byte offset in the archive, the archive's length),
    from ``fmt`` alone."""
    offs, at = [], 0
    for m in fmt["members"]:
        offs.append(at + BLOCK)
        at += BLOCK + _padded(int(m["bytes"]))
    rec = int(fmt["record_bytes"])
    return offs, -(-(at + 2 * BLOCK) // rec) * rec


def _header(name: str, size: int) -> bytes:
    info = tarfile.TarInfo(name)
    info.size, info.mtime, info.mode = size, 0, 0o644
    return info.tobuf(tarfile.USTAR_FORMAT, "utf-8", "surrogateescape")


def member(seed: int, item: int, index: int, kind: str, size: int,
           piece: int) -> bytes:
    """Member ``index`` of archive ``item``: pieces of kind ``kind`` drawn
    from the member's own random source until ``size`` bytes, cut there."""
    rng = common.rng(seed, item, index)
    draw = getattr(silesia_blocks, "_" + kind)
    parts, have = [], 0
    while have < size:
        for p in draw(rng, PIECES, piece):
            parts.append(p)
            have += len(p)
    return b"".join(parts)[:size]


def archive(fmt: dict, seed: int, item: int) -> bytes:
    """Archive ``item`` of the pool drawn from ``seed``; its members made
    on every core."""
    members = fmt["members"]
    offs, total = layout(fmt)
    piece = int(fmt["piece_bytes"])
    buf = bytearray(total)

    def job(k):
        m = members[k]
        n = int(m["bytes"])
        data = member(seed, item, k, m["kind"], n, piece)
        buf[offs[k] - BLOCK: offs[k]] = _header(m["name"], n)
        buf[offs[k]: offs[k] + n] = data

    common.pmap(job, range(len(members)))
    return bytes(buf)


def compress(raw: bytes, fmt: dict) -> bytes:
    """``raw`` as one zlib stream at the format's level, window and
    memLevel, default strategy."""
    z = zlib.compressobj(int(fmt["level"]), zlib.DEFLATED,
                         int(fmt["window_bits"]), int(fmt["mem_level"]),
                         zlib.Z_DEFAULT_STRATEGY)
    return z.compress(raw) + z.flush()


def make_pool(fmt: dict, seed: int, n_batches: int, batch: int,
              encode: bool = True) -> list[common.Batch]:
    """``n_batches`` batches of one archive each; with ``encode``, each
    archive's zlib stream too, the streams compressed side by side."""
    if batch != 1:
        raise ValueError(f"a batch of silesia_tar is one archive, not "
                         f"{batch}")
    raws = [archive(fmt, seed, j) for j in range(n_batches)]
    if not encode:
        return [common.Batch(raw=[r], inputs=None, streams=None)
                for r in raws]
    streams = common.pmap(lambda r: compress(r, fmt), raws)
    return [common.Batch(raw=[r], inputs=[s], streams=[s])
            for r, s in zip(raws, streams)]
