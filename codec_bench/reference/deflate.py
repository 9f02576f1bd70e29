"""What an encode must return: zlib streams that inflate to their payloads,
with the payload's adler32 as the trailer, at about zlib level 6's size."""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor


def _pmap(fn, items):
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        return list(ex.map(fn, items))


def streams_wrong(outs, payloads) -> int:
    """Streams that do not inflate, whole, to their payload, or whose
    trailer is not the payload's adler32; a stream missing from, or added
    to, the batch is wrong."""
    def bad(pair):
        out, payload = pair
        try:
            d = zlib.decompressobj()
            got = d.decompress(bytes(out))
        except zlib.error:
            return True
        return (not d.eof or bool(d.unused_data) or got != payload
                or bytes(out[-4:]) != zlib.adler32(payload).to_bytes(4, "big"))
    n = min(len(outs), len(payloads))
    return abs(len(outs) - len(payloads)) + sum(
        _pmap(bad, list(zip(outs[:n], payloads[:n]))))


def zlib_sizes(payloads, level: int = 6) -> list[int]:
    """The size of each payload's zlib stream at ``level``."""
    return _pmap(lambda p: len(zlib.compress(p, level)), payloads)
