"""PNG IDAT decode with defl_tpu_torch: decompress a PNG's image data
straight from its non-contiguous IDAT chunks, without joining them.

Builds a PNG in memory (stdlib only), splits its zlib stream across many
IDAT chunks (PNG encoders routinely emit 8 KB or even 1-byte chunks), then
decodes it three ways and cross-checks them:
  1. the host ``InflateStream``, one ``include()`` per IDAT chunk;
  2. the batched decode on the card (``inflate_batch(backend="device")``)
     fed the chunk list itself, as one stream;
  3. CPython zlib on the joined stream (the oracle).

Run:  python examples/png_idat_torch.py [--device cuda|cpu]
(``cuda`` by default, which raises without a card; ``cpu`` runs the
decode kernel's plain version).
"""

import argparse
import os
import struct
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from defl_tpu_torch import InflateStream, Result, inflate_batch  # noqa: E402


def make_png(width=64, height=48, idat_chunk_size=913):
    """A minimal truecolor PNG with the zlib stream split across IDATs."""
    raw = bytearray()
    for y in range(height):
        raw.append(0)  # filter: None
        for x in range(width):
            raw += bytes(((x * 5 + y) & 0xFF, (x ^ y) & 0xFF, (x * y) & 0xFF))
    compressed = zlib.compress(bytes(raw), 6)

    def chunk(typ, data):
        c = struct.pack(">I", len(data)) + typ + data
        return c + struct.pack(">I", zlib.crc32(typ + data))

    png = b"\x89PNG\r\n\x1a\n"
    png += chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, 2,
                                      0, 0, 0))
    for i in range(0, len(compressed), idat_chunk_size):
        png += chunk(b"IDAT", compressed[i:i + idat_chunk_size])
    png += chunk(b"IEND", b"")
    return png, bytes(raw)


def iter_idat(png: bytes):
    pos = 8
    while pos < len(png):
        (ln,) = struct.unpack(">I", png[pos:pos + 4])
        if png[pos + 4:pos + 8] == b"IDAT":
            yield png[pos + 8:pos + 8 + ln]
        pos += 12 + ln


def main(argv=None):
    ap = argparse.ArgumentParser(description="PNG IDAT decode")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=48)
    a = ap.parse_args(argv)

    png, expected = make_png(a.width, a.height)
    idats = list(iter_idat(png))
    print(f"PNG: {len(png)} bytes, {len(idats)} IDAT chunks, "
          f"{len(expected)} bytes of scanline data")

    # 1. host stream, one include per chunk
    st = InflateStream(len(expected) + 64)
    for c in idats:
        assert st.include(c) is Result.OK
    assert st.run() is Result.OK
    assert st.output == expected
    print("host chunked decode: OK")

    # 2. the batched decode fed the chunk list as one stream
    res, outs = inflate_batch([idats], backend="device",
                              dst_capacities=len(expected) + 64,
                              device=a.device)
    assert res[0] is Result.OK and outs[0] == expected
    print(f"device chunked decode on {a.device}: OK")

    # 3. oracle cross-check
    assert zlib.decompress(b"".join(idats)) == expected
    print("zlib cross-check: OK")


if __name__ == "__main__":
    main()
