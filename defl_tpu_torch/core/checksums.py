"""Host checksum: adler32 (RFC 1950).

New capability relative to the reference, which contains no checksum code
at all (SURVEY §2.1: "the zlib adler32 trailer is never verified").  These
are vectorised NumPy implementations used by the host engine and tests;
``defl_tpu_torch.ops.checksums`` provides the batched on-device version.
The port's own copy of ``defl_tpu/core/checksums.py``, adler32 only.
"""

from __future__ import annotations

import numpy as np

ADLER_MOD = 65521
# Largest n such that 255*n*(n+1)/2 + (n+1)*(MOD-1) fits in uint32 — the
# classic zlib NMAX bound for deferring the modulo.
_NMAX = 5552


def adler32(data, start: int = 1) -> int:
    """Vectorised adler32.

    a = 1 + sum(bytes) mod 65521;  b = sum of running a values mod 65521.
    For a block, b advances by n*a0 + sum((n-i)*d_i), computed as a
    weighted dot product per chunk with deferred modulo.
    """
    buf = np.frombuffer(bytes(data), dtype=np.uint8).astype(np.uint64)
    a = np.uint64(start & 0xFFFF)
    b = np.uint64((start >> 16) & 0xFFFF)
    n = buf.size
    for s in range(0, n, _NMAX):
        chunk = buf[s : s + _NMAX]
        m = chunk.size
        w = np.arange(m, 0, -1, dtype=np.uint64)
        b = (b + a * np.uint64(m) + np.dot(chunk, w)) % ADLER_MOD
        a = (a + chunk.sum()) % ADLER_MOD
    return int((b << np.uint64(16)) | a)
