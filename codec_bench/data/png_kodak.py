"""PNG images of the Kodak suite's shape (768 x 512 RGB8) from a seed,
encoded as libpng encodes by default.

The Kodak files are not in the repository, so the pictures are made: a
smooth field (a few random values a channel, upsampled) plus a texture
(a finer grid, upsampled) plus per-pixel noise.  They are then filtered as
libpng filters by default, each row by whichever of its five filters gives
the least sum of absolute values (bytes read as signed), compressed with
zlib at level 6, strategy ``Z_FILTERED``, a 32 KiB window and memLevel 8,
and cut into IDAT chunks of 8,192 bytes (``PNG_ZBUF_SIZE``) with valid
CRCs.  An inflate entry is handed each image as the list of memoryviews of
its IDAT payloads inside the PNG file; the payloads are the image's
filtered scanlines (``height * (1 + 3 * width)`` bytes).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from codec_bench.data import common

SIGNATURE = b"\x89PNG\r\n\x1a\n"
BPP = 3  # RGB8
#: images drawn from one random source, the unit of the work on every core
GROUP = 4


def _upsample(grid, h, w):
    """Bilinear upsampling of ``grid`` [n, gh, gw, c] to [n, h, w, c]."""
    def weights(g, m):
        x = np.linspace(0, g - 1, m)
        lo = np.minimum(np.floor(x).astype(int), g - 2)
        f = x - lo
        a = np.zeros((m, g), np.float32)
        a[np.arange(m), lo] = 1 - f
        a[np.arange(m), lo + 1] = f
        return a
    return np.einsum("hi,nijc,wj->nhwc", weights(grid.shape[1], h), grid,
                     weights(grid.shape[2], w), optimize=True)


def make_images(rng, n, height, width, fmt) -> np.ndarray:
    """uint8 [n, height, width, 3]."""
    base = _upsample(rng.uniform(0, 255, (n, 6, 8, 3)).astype(np.float32),
                     height, width)
    fine = (n, max(2, height // 8), max(2, width // 8), 3)
    tex = _upsample(rng.standard_normal(fine, np.float32) * fmt["texture"],
                    height, width)
    noise = rng.standard_normal((n, height, width, 3), np.float32)
    pic = base + tex + noise * np.float32(fmt["noise"])
    return np.clip(pic, 0, 255).round().astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(img: np.ndarray) -> bytes:
    """The filtered scanlines of one image [h, w, 3]: each row led by its
    filter byte, the filter chosen per row by libpng's default heuristic
    (least sum of the filtered bytes read as signed)."""
    x = img.reshape(img.shape[0], -1).astype(np.int16)
    left = np.zeros_like(x)
    left[:, BPP:] = x[:, :-BPP]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, BPP:] = x[:-1, :-BPP]
    cand = np.stack([x, x - left, x - up, x - (left + up) // 2,
                     x - _paeth(left, up, upleft)]) & 0xFF
    cost = np.where(cand < 128, cand, 256 - cand).sum(2)
    best = cost.argmin(0)
    rows = cand[best, np.arange(x.shape[0])].astype(np.uint8)
    return np.concatenate([best.astype(np.uint8)[:, None], rows], 1).tobytes()


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def encode_png(scanlines: bytes, height: int, width: int, fmt):
    """(PNG file bytes, [memoryview of each IDAT payload in it])."""
    z = zlib.compressobj(int(fmt["level"]), zlib.DEFLATED,
                         int(fmt["window_bits"]), 8,
                         getattr(zlib, fmt["strategy"]))
    stream = z.compress(scanlines) + z.flush()
    size = int(fmt["idat_bytes"])
    head = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height,
                                                  8, 2, 0, 0, 0))
    parts, spans, at = [head], [], len(head)
    for o in range(0, len(stream), size):
        data = stream[o: o + size]
        spans.append((at + 8, len(data)))
        parts.append(_chunk(b"IDAT", data))
        at += 12 + len(data)
    parts.append(_chunk(b"IEND", b""))
    png = b"".join(parts)
    view = memoryview(png)
    return png, [view[a: a + n] for a, n in spans]


def idat_payloads(png: bytes) -> list[bytes]:
    """The IDAT payloads of a PNG file, each chunk's CRC checked."""
    if png[:8] != SIGNATURE:
        raise ValueError("not a PNG signature")
    out, at = [], 8
    while at < len(png):
        n, kind = struct.unpack(">I4s", png[at: at + 8])
        data = png[at + 8: at + 8 + n]
        if struct.unpack(">I", png[at + 8 + n: at + 12 + n])[0] != \
                zlib.crc32(kind + data):
            raise ValueError(f"bad CRC in a {kind!r} chunk")
        if kind == b"IDAT":
            out.append(data)
        at += 12 + n
    return out


def make_pool(fmt: dict, seed: int, n_batches: int, batch: int,
              encode: bool = True) -> list[common.Batch]:
    """``n_batches`` batches of ``batch`` images, made, filtered and
    encoded on every core in groups of ``GROUP``, each group drawn from a
    random source of its own.  ``raw`` holds each image's filtered
    scanlines; with ``encode``, ``inputs`` holds its IDAT memoryviews and
    ``streams`` their join."""
    h, w = int(fmt["height"]), int(fmt["width"])

    def job(jg):
        j, g = jg
        n = min(GROUP, batch - g * GROUP)
        raw = [filter_rows(img) for img in
               make_images(common.rng(seed, j, g), n, h, w, fmt)]
        return [(r, encode_png(r, h, w, fmt)[1] if encode else None)
                for r in raw]

    pool = []
    for j in range(n_batches):
        done = [x for part in common.pmap(
            job, [(j, g) for g in range(-(-batch // GROUP))]) for x in part]
        raw = [r for r, _ in done]
        if not encode:
            pool.append(common.Batch(raw=raw, inputs=None, streams=None))
            continue
        views = [v for _, v in done]
        pool.append(common.Batch(raw=raw, inputs=views,
                                 streams=[b"".join(v) for v in views]))
    return pool
