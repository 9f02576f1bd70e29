"""What an inflate must return, and how far the program's answers are from
it."""

from __future__ import annotations

import os
import zlib
from concurrent.futures import ThreadPoolExecutor


def inflate_all(streams) -> list[bytes]:
    """Each whole zlib stream inflated (header, body, adler32 trailer
    checked); raises ``zlib.error`` on an invalid or unfinished one."""
    def one(s):
        d = zlib.decompressobj()
        out = d.decompress(s)
        if not d.eof or d.unused_data:
            raise zlib.error("stream unfinished or followed by data")
        return out
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        return list(ex.map(one, streams))


def lanes_wrong(ok, outputs, expected) -> int:
    """Lanes of one batch whose status is not OK or whose bytes differ from
    ``expected``; a lane missing from, or added to, the batch is wrong."""
    wrong = abs(len(outputs) - len(expected)) + abs(len(ok) - len(expected))
    for k in range(min(len(ok), len(outputs), len(expected))):
        if not ok[k] or memoryview(outputs[k]).cast("B") != expected[k]:
            wrong += 1
    return wrong
