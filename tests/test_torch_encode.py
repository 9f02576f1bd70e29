"""The port's encode side on the CPU against ``defl_tpu``'s.

- ``ops/huffman_pack.py``: ``pack_fields`` and ``pack_fields_scan`` against
  the JAX functions on the same seeded fields (words, slots, ``final_lo``,
  ``total_bits``), the closed form against the reservoir loop, and both
  u32 conventions (int64 on the CPU, int32 as on the card).
- ``device_deflate(device="cpu")`` byte-identical to ``defl_tpu``'s and to
  ``native_deflate_batch``, both packs, zlib and raw framing, field
  overflow, and calls from several threads at once.
- the host encoder (``lz77_tokens``, ``deflate_oracle``, ``DeflateStream``)
  and the huffman encoder half against ``defl_tpu``'s: byte-equal, except
  where ``limited_code_lengths`` differs on purpose (below).

Inputs come from numpy seeds; every comparison is exact.
"""

import random
import threading
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from defl_tpu.core import deflate_ref as jref
from defl_tpu.core import huffman as jhuff
from defl_tpu.core.checksums import crc32 as jcrc32
from defl_tpu.ops import huffman_pack as jpack
from defl_tpu.runtime import native as jnative
from defl_tpu.runtime import session as jsess
from defl_tpu_torch import deflate_batch, device_deflate, metrics
from defl_tpu_torch.core import deflate_ref as tref
from defl_tpu_torch.core import huffman as thuff
from defl_tpu_torch.core.checksums import crc32 as tcrc32
from defl_tpu_torch.errors import FLAG_ZLIB, Result
from defl_tpu_torch.ops import huffman_pack as tpack
from defl_tpu_torch.runtime import native as tnative
from tests.gendata import make_corpus

needs_native = pytest.mark.skipif(not jnative.available(),
                                  reason="native library unavailable")
CORPUS = make_corpus()


# ---------------------------------------------------------------------------
# the bit-pack
# ---------------------------------------------------------------------------

def _fields(seed, N, F, full=False):
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, 17, (N, F))
    if full:
        nb[:] = 16
    val = rng.integers(0, 1 << 16, (N, F)) & ((1 << nb) - 1)
    n_fields = rng.integers(0, F + 1, N).astype(np.int32)
    n_fields[:3] = [F, 0, 1][: min(3, N)]
    return ((nb << 16) | val).astype(np.uint32), n_fields


@pytest.fixture(params=["int64", "int32"])
def work_dtype(request, monkeypatch):
    """The CPU convention, and the card's (int32 patterns) run on the CPU."""
    if request.param == "int32":
        monkeypatch.setattr(tpack, "_work_dtype", lambda d: torch.int32)
    return request.param


@pytest.mark.parametrize("seed,N,F,full", [(0, 5, 300, False),
                                           (1, 9, 64, True),
                                           (2, 1, 1, False),
                                           (3, 33, 513, False)])
def test_pack_fields_scan_matches_jax_and_the_reservoir_loop(seed, N, F, full,
                                                             work_dtype):
    fields, nf = _fields(seed, N, F, full)
    js, jlo, jtb = jpack.pack_fields_scan(jnp.asarray(fields),
                                          jnp.asarray(nf))
    got = tpack.pack_fields_scan(fields, nf)
    ref = tpack.pack_fields_scan_ref(fields, nf)
    for slots, lo, tb in (got, ref):
        np.testing.assert_array_equal(tpack.to_u32(slots), np.asarray(js))
        np.testing.assert_array_equal(tpack.to_u32(lo), np.asarray(jlo))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jtb))
    want = torch.int64 if work_dtype == "int64" else torch.int32
    assert got[0].dtype == want and ref[0].dtype == want


@pytest.mark.parametrize("seed,N,F,n_words", [(0, 5, 300, 256), (4, 7, 200, 16),
                                              (5, 3, 40, 1), (6, 2, 90, 1024)])
def test_pack_fields_matches_jax(seed, N, F, n_words, work_dtype):
    """n_words 16 and 1 are too few: what lies past them is dropped, as
    JAX's ``mode="drop"`` drops it."""
    fields, nf = _fields(seed, N, F)
    jw, jtb = jpack.pack_fields(jnp.asarray(fields), jnp.asarray(nf),
                                n_words=n_words)
    tw, ttb = tpack.pack_fields(fields, nf, n_words)
    np.testing.assert_array_equal(tpack.to_u32(tw), np.asarray(jw))
    np.testing.assert_array_equal(ttb.numpy(), np.asarray(jtb))


def test_pack_slabs_do_not_change_the_result(monkeypatch):
    fields, nf = _fields(7, 20, 100)
    whole = tpack.pack_fields_scan(fields, nf)
    words = tpack.pack_fields(fields, nf, 64)
    monkeypatch.setattr(tpack, "SLAB_ELEMS", 300)       # 3 lanes a slab
    assert len(tpack._slabs(20, 100)) == 7
    for a, b in zip(whole + words, tpack.pack_fields_scan(fields, nf)
                    + tpack.pack_fields(fields, nf, 64)):
        assert torch.equal(a, b)


def test_packed_words_are_the_bitstream():
    """The packed row read as little-endian bytes is the fields' bits in
    order, and the scan's used slots are that row's whole words."""
    fields, nf = _fields(8, 4, 120)
    words, tb = tpack.pack_fields(fields, nf, 64)
    slots, lo, _ = tpack.pack_fields_scan(fields, nf)
    w, s = tpack.to_u32(words), tpack.to_u32(slots)
    for i in range(4):
        bits = []
        for f in fields[i, : nf[i]]:
            bits += [(int(f) >> k) & 1 for k in range(int(f) >> 16)]
        assert len(bits) == int(tb[i])
        got = np.unpackbits(w[i].view(np.uint8), bitorder="little")
        assert got[: len(bits)].tolist() == bits and not got[len(bits):].any()
        nb = (fields[i] >> 16) * (np.arange(120) < nf[i])
        ends = np.cumsum(nb)
        used = (ends >> 5) > ((ends - nb) >> 5)
        assert s[i][used].tolist() == w[i][: len(bits) // 32].tolist()
        assert not s[i][~used].any()
        assert int(tpack.to_u32(lo)[i]) == int(w[i][len(bits) // 32])


# ---------------------------------------------------------------------------
# device_deflate
# ---------------------------------------------------------------------------

def _payloads():
    rng = random.Random(5)
    return (list(CORPUS.values())[:12]
            + [b"", b"x", rng.randbytes(70000), b"\0" * 50000,
               rng.randbytes(64) * 500])


@needs_native
@pytest.mark.parametrize("pack", ["scan", "scatter"])
def test_device_deflate_is_byte_identical(pack):
    payloads = _payloads()
    st = {}
    m0 = metrics.snapshot()
    outs = device_deflate(payloads, level=6, stats_out=st, pack=pack,
                          device="cpu")
    m1 = metrics.snapshot()
    _, host = tnative.native_deflate_batch(payloads, level=6)
    _, jhost = jnative.native_deflate_batch(payloads, level=6)
    jouts = jsess.device_deflate(payloads, level=6, pack=pack)
    assert outs == host == jhost == jouts
    assert st["device_fallbacks"] == []
    for key in ("fields_s", "upload_s", "pack_s", "fetch_s", "assemble_s"):
        assert st[key] >= 0
    for o, p in zip(outs, payloads):
        assert zlib.decompress(o) == p
    assert m1["device_deflate_lanes"] - m0.get("device_deflate_lanes", 0) \
        == len(payloads)
    assert m1["deflate_bytes_in"] - m0.get("deflate_bytes_in", 0) \
        == sum(len(p) for p in payloads)


@needs_native
@pytest.mark.parametrize("level", [1, 9])
def test_device_deflate_raw_framing_and_levels(level):
    payloads = _payloads()
    for flags, wbits in ((FLAG_ZLIB, 15), (0, -15)):
        outs = device_deflate(payloads, level=level, flags=flags,
                              device="cpu")
        assert outs == jsess.device_deflate(payloads, level=level,
                                            flags=flags)
        _, host = tnative.native_deflate_batch(payloads, level=level,
                                               flags=flags)
        assert outs == host
        for o, p in zip(outs, payloads):
            assert zlib.decompress(o, wbits) == p


@needs_native
def test_field_overflow_lanes_take_the_serial_encoder(monkeypatch):
    """A field budget too small for the noise lane: that lane comes back
    EFULL from the field pass, goes through the serial encoder, and is
    reported."""
    rng = random.Random(9)
    payloads = [b"aaaa" * 1000, rng.randbytes(5000), b"tail"]
    real = tnative.native_deflate_fields
    monkeypatch.setattr(
        tnative, "native_deflate_fields",
        lambda p, level=6, **kw: real(p, level=level, F=1024, **kw))
    st = {}
    m0 = metrics.snapshot().get("device_deflate_fallback_lanes", 0)
    outs = device_deflate(payloads, stats_out=st, device="cpu")
    assert st["device_fallbacks"] == [1]
    assert metrics.snapshot()["device_deflate_fallback_lanes"] - m0 == 1
    _, host = tnative.native_deflate_batch(payloads)
    assert outs == host
    f = real(payloads, F=1024)
    assert [r is Result.OK for r in f[4]] == [True, False, True]


@needs_native
def test_native_deflate_fields_buffers_are_the_calls_own():
    """Two results stay apart: the JAX bindings return one process-wide
    buffer, which a second call overwrites."""
    a = tnative.native_deflate_fields([b"first payload " * 20])
    b = tnative.native_deflate_fields([b"second, other payload " * 20])
    assert a[0].shape == b[0].shape
    assert not np.shares_memory(a[0], b[0])
    n = int(a[1][0])
    again = tnative.native_deflate_fields([b"first payload " * 20])
    np.testing.assert_array_equal(a[0][0, :n], again[0][0, :n])
    assert tnative.fields_width([b"x" * 65536]) == 73728
    assert tnative.fields_width([b""]) == 8192


@needs_native
def test_concurrent_device_deflate_calls_do_not_share_fields():
    sets = [[bytes([65 + t]) * 3000 + random.Random(t).randbytes(4000)
             for _ in range(6)] for t in range(4)]
    want = [tnative.native_deflate_batch(s)[1] for s in sets]
    got = [None] * 4
    errs = []

    def run(t):
        try:
            for _ in range(3):
                got[t] = device_deflate(sets[t], device="cpu")
        except Exception as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs and got == want


@needs_native
def test_batch_deflate_backends():
    payloads = _payloads()
    host = deflate_batch(payloads, backend="host")
    assert deflate_batch(payloads, backend="auto") == host
    assert deflate_batch(payloads, backend="device", device="cpu") == host
    assert host == jsess.batch_deflate(payloads, backend="host")
    assert deflate_batch([]) == [] and device_deflate([], device="cpu") == []
    with pytest.raises(ValueError):
        deflate_batch(payloads, backend="tpu")
    with pytest.raises(ValueError):
        device_deflate(payloads, pack="loop", device="cpu")


def test_device_deflate_needs_a_card_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        device_deflate([b"abc"])
    with pytest.raises(RuntimeError, match="CUDA"):
        deflate_batch([b"abc"], backend="device")
    assert zlib.decompress(deflate_batch([b"abc"])[0]) == b"abc"   # host


@needs_native
def test_native_encode_compact_refuses_mismatched_shapes():
    fields, nf, tb, _, _ = tnative.native_deflate_fields([b"abc" * 50])
    slots, lo, _ = tpack.pack_fields_scan(fields, nf)
    with pytest.raises(ValueError):
        tnative.native_encode_compact(fields, tpack.to_u32(slots)[:, :-1],
                                      nf, tpack.to_u32(lo), tb)


# ---------------------------------------------------------------------------
# the host encoder and the huffman encoder half
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CORPUS)[:10])
def test_host_encoder_matches_jax(name):
    raw = CORPUS[name][:6000]
    assert tref.lz77_tokens(raw, 6) == jref.lz77_tokens(raw, 6)
    for level, flags in ((6, FLAG_ZLIB), (1, 0), (0, FLAG_ZLIB)):
        got = tref.deflate_oracle(raw, level=level, flags=flags)
        assert got == jref.deflate_oracle(raw, level=level, flags=flags)
        assert zlib.decompress(got, 15 if flags else -15) == raw


def test_host_encoder_dictionary_and_stream_match_jax():
    d = b"shared words appear early " * 40
    payload = b"shared words appear early in this payload too" * 30
    got = tref.deflate_oracle(payload, dictionary=d)
    assert got == jref.deflate_oracle(payload, dictionary=d)
    assert zlib.decompressobj(zdict=d).decompress(got) == payload
    outs = []
    for mod in (tref, jref):
        st = mod.DeflateStream(level=6, dictionary=d)
        out = bytearray()
        for i in range(0, len(payload), 300):
            out += st.compress(payload[i: i + 300])
        out += st.flush()
        with pytest.raises(ValueError):
            st.compress(b"x")
        outs.append(bytes(out))
    assert outs[0] == outs[1]
    assert zlib.decompressobj(zdict=d).decompress(outs[0]) == payload
    st = tref.DeflateStream()
    assert zlib.decompress(st.compress(b"") + st.flush()) == b""


def test_assign_codes_and_reverse_bits_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        lens = rng.integers(0, 16, int(rng.integers(1, 288)))
        np.testing.assert_array_equal(thuff.assign_codes(lens),
                                      jhuff.assign_codes(lens))
    for v, n in ((0b1, 1), (0b1011, 4), (0x1234, 15), (0, 0)):
        assert thuff.reverse_bits(v, n) == jhuff.reverse_bits(v, n)


def _kraft(lens, max_len):
    return sum(1 << (max_len - int(l)) for l in lens if l)


def test_limited_code_lengths_keeps_the_kraft_sum_exact():
    """Where no code is over-long both packages build the same tree.  Where
    the depth limit bites they may differ, on purpose: the JAX package
    counts clamped leaves (``overflow -= 2``), which can leave the code
    oversubscribed or give up more code space than it must; the port
    removes exactly the oversubscription, as the C++ engine does.  There
    the port's lengths must be a valid, complete prefix code within the
    limit, and an encode with them must round-trip."""
    rng = np.random.default_rng(0)
    same = differ = jax_invalid = 0
    for t in range(200):
        n = int(rng.integers(2, 288))
        if t % 2:
            f = rng.integers(0, 1000, n)
        else:    # heavy tails force the depth limit
            f = (rng.pareto(0.5, n) * 10).astype(np.int64) \
                * (rng.random(n) < .8)
        max_len = 7 if n <= 19 else 15
        got = thuff.limited_code_lengths(f, max_len)
        ref = jhuff.limited_code_lengths(f, max_len)
        used = int((f > 0).sum())
        assert ((got > 0) == (f > 0)).all() or used == 1
        assert got.max(initial=0) <= max_len
        if used >= 2:
            assert _kraft(got, max_len) == 1 << max_len   # complete
        if (got == ref).all():
            same += 1
        else:
            differ += 1
            assert ref.max() >= max_len   # only where the limit bit
            jax_invalid += _kraft(ref, max_len) > 1 << max_len
    assert same >= 100 and differ > 0
    with pytest.raises(ValueError):
        thuff.limited_code_lengths(np.ones(200), 7)
    # an encode whose trees hit the 7-bit limit of the code-length code
    # and the 15-bit limit of the literal code still round-trips
    skew = bytes(rng.choice(256, 60000, p=np.exp(-0.09 * np.arange(256))
                            / np.exp(-0.09 * np.arange(256)).sum())
                 .astype(np.uint8))
    assert zlib.decompress(tref.deflate_oracle(skew)) == skew


def test_crc32_matches_jax_and_zlib():
    rng = np.random.default_rng(4)
    for n in (0, 1, 7, 8, 9, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tcrc32(data) == jcrc32(data) == zlib.crc32(data)
        assert tnative.native_crc32(data) == zlib.crc32(data)
    assert tcrc32(b"tail", tcrc32(b"head ")) == zlib.crc32(b"head tail")
    assert tnative.native_crc32(np.arange(10, dtype=np.uint8)) \
        == zlib.crc32(bytes(range(10)))
