"""The split decode of one stream under malformed input: the port's device
route (its plain version on the CPU) against the host-parallel engines of
both packages.

A stream of about 256 KiB of the bench corpus in small blocks (zlib
``memLevel`` 4: a block every 1023 symbols) gets 1 to 4 bit flips past its
header and, for every other seed, a cut tail.  It goes through the port's
``inflate_large(use_device=True, device="cpu")``, whose lanes start at the
block starts the finder sees in the mutated body and run on the decode
kernel's plain version, with the segment size set small (as
tests/test_torch_large.py does) so that a lane takes hundreds of steps;
then through ``inflate_large(use_device=False)`` of the port and of
``defl_tpu``.  All three must give the same class, and the same bytes
when the class is OK.  With ``FLAG_VERIFY_ADLER32`` a flip that still
decodes must come back ERR from the trailer check.  Exact comparisons.
"""

import random
import zlib

import pytest

import defl_tpu.runtime.large as jlarge
from defl_tpu.runtime import native as jnative
from defl_tpu_torch.corpus import make_silesia_like
from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result
from defl_tpu_torch.runtime import large as tlarge

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="the JAX package's native library is "
                                "unavailable")

SEG = 1024
RAW_BYTES = 1 << 18


@pytest.fixture(scope="module")
def stream():
    raw = b"".join(make_silesia_like(RAW_BYTES, 65536))[:RAW_BYTES]
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 4)
    return raw, co.compress(raw) + co.flush()


def _mutated(comp, seed):
    rng = random.Random(seed)
    d = bytearray(comp)
    for _ in range(rng.randrange(1, 5)):
        d[rng.randrange(2, len(d))] ^= 1 << rng.randrange(8)
    if seed % 2:
        d = d[: rng.randrange(len(d) // 2, len(d))]
    return bytes(d)


@pytest.mark.parametrize("seed, flags", [
    (0, FLAG_ZLIB), (1, FLAG_ZLIB), (2, FLAG_ZLIB | FLAG_VERIFY_ADLER32),
    (3, FLAG_ZLIB | FLAG_VERIFY_ADLER32),
    (4, FLAG_ZLIB | FLAG_VERIFY_ADLER32)])
def test_split_decode_of_a_mutated_stream_matches_the_host_engines(
        stream, monkeypatch, seed, flags):
    raw, comp = stream
    monkeypatch.setattr(tlarge, "SEGMENT_BYTES", SEG)
    data = _mutated(comp, seed)
    st = {}
    r, out = tlarge.inflate_large(data, flags, use_device=True,
                                  device="cpu", stats_out=st)
    assert st["route"] == "device" and st["lanes"] > 10
    for r_host, out_host in (tlarge.inflate_large(data, flags,
                                                  use_device=False),
                             jlarge.inflate_large(data, flags,
                                                  use_device=False)):
        assert int(r) == int(r_host)
        if r is Result.OK:
            assert out == out_host
    if seed % 2:
        assert r is not Result.OK
    if flags & FLAG_VERIFY_ADLER32:
        assert r is not Result.OK or out == raw

