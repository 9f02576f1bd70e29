"""The controls: the reference put in the program's place with one stated
guarantee broken.  A codec states no precision, so each control breaks a
guarantee of the configuration instead; the comparison has to call its
answers wrong.

- inflate: a stream whose output fills ``dst_capacity`` exactly comes back
  whole with status OK.  The control inflates into one byte less (as a
  decoder that wants a spare byte would), so such lanes come back cut
  short, with a status other than OK.
- encode: the streams are zlib level 6's size.  The control compresses at
  level 1, the cheaper match search that would tempt a faster encoder.
"""

from __future__ import annotations

import zlib

from codec_bench.reference.deflate import _pmap


def inflate_capacity_short(streams, capacity: int):
    """(ok, outputs) of each stream inflated into ``capacity - 1`` bytes."""
    def one(s):
        d = zlib.decompressobj()
        out = d.decompress(bytes(s), capacity - 1)
        return d.eof and not d.unconsumed_tail, out
    pairs = _pmap(one, streams)
    return [p[0] for p in pairs], [p[1] for p in pairs]


def deflate_level1(payloads) -> list[bytes]:
    """Each payload's zlib stream at level 1."""
    return _pmap(lambda p: zlib.compress(p, 1), payloads)
