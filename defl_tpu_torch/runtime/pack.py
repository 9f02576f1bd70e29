"""Host-side stream staging: ragged chunk lists -> dense device arrays.

The port's own copy of ``defl_tpu/runtime/pack.py``.

Equivalent of the reference's chunk/pool manager
(the reference's `src/infl/mem.c:114-216`): where the C library coalesces
tiny PNG-IDAT chunks into pooled 32KB pages and borrows large chunks
zero-copy, this layer concatenates each stream's chunk list and packs the
batch into one `[N, W]` little-endian uint32 array (zero-padded) plus
per-stream length/flag/capacity vectors — the shape the lockstep decoder
consumes.  The chunk-coalescing logic *is* the batch-packing step
(SURVEY §2.3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: stored-run tokens carry a 22-bit input byte offset (ops/inflate_batch.py)
MAX_STREAM_BYTES = (1 << 22) - 8


@dataclass
class PackedBatch:
    words: np.ndarray        # uint32 [N, W+1], zero-padded
    nbits: np.ndarray        # int32 [N]  (8 * byte length)
    zflag: np.ndarray        # int32 [N]
    dst_cap: np.ndarray      # int32 [N]
    n: int

    @property
    def max_bytes(self) -> int:
        return int(self.nbits.max(initial=0)) // 8


def chunks(s) -> list:
    """A stream's chunks: ``bytes``, ``bytearray`` and ``memoryview`` are
    one stream of one chunk; anything else is a list of chunks (≙ repeated
    infl_include)."""
    return [s] if isinstance(s, (bytes, bytearray, memoryview)) else s


def stream_length(s) -> int:
    return sum(len(c) for c in chunks(s))


def stream_head(s, n: int) -> bytes:
    """The first ``n`` bytes of a stream."""
    out = b""
    for c in chunks(s):
        out += bytes(memoryview(c)[:n - len(out)])
        if len(out) >= n:
            break
    return out


def joined(s) -> bytes:
    """A stream's bytes in one piece (chunk coalescing)."""
    return b"".join(chunks(s))


def stream_caps(streams, dst_capacities) -> list[int]:
    """Each stream's output capacity: ``dst_capacities`` as declared (one
    int for every stream, or one a stream), else 64 times the stream's
    length, at most 64 MiB (64 for an empty stream)."""
    if dst_capacities is None:
        return [min(64 * stream_length(s), 1 << 26) or 64 for s in streams]
    if np.isscalar(dst_capacities):
        return [int(dst_capacities)] * len(streams)
    return [int(c) for c in dst_capacities]


def pack_streams(streams, zlib_flags, dst_caps) -> PackedBatch:
    """streams: list of streams (``chunks``).  zlib_flags/dst_caps: scalars
    or per-stream sequences."""
    bufs = []
    for s in streams:
        b = joined(s)
        if len(b) > MAX_STREAM_BYTES:
            raise ValueError(
                f"stream of {len(b)} bytes exceeds device limit "
                f"{MAX_STREAM_BYTES}; use the host engine for huge streams")
        bufs.append(b)

    n = len(bufs)
    max_len = max((len(b) for b in bufs), default=0)
    w = (max_len + 3) // 4 + 1  # +1 pad word so peek32's second gather is real
    words = np.zeros((n, w * 4), dtype=np.uint8)
    nbits = np.zeros(n, dtype=np.int32)
    for i, b in enumerate(bufs):
        words[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        nbits[i] = 8 * len(b)
    words = words.view("<u4")

    def vec(x, dtype):
        a = np.asarray(x, dtype=dtype)
        if a.ndim == 0:
            a = np.full(n, a, dtype=dtype)
        return a

    return PackedBatch(
        words=words,
        nbits=nbits,
        zflag=vec(zlib_flags, np.int32),
        dst_cap=vec(dst_caps, np.int32),
        n=n,
    )


def pack_dictionary(dictionary: bytes):
    """Shared preset dictionary -> (uint32 words, byte length)."""
    d = bytes(dictionary)
    pad = (-len(d)) % 4
    arr = np.frombuffer(d + b"\x00" * (pad + 4), dtype="<u4")
    return arr, len(d)
