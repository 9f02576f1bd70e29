"""The port's single-stream split decode (runtime/large.py) on the CPU
against ``defl_tpu``'s, and the decoder's shared-input mode against the
JAX decoder's.

Both packages get the same bytes, made from numpy seeds; every comparison
is exact (a codec has no tolerance): the same ``Result``, the same output,
the same candidates.  The port's device route runs here with
``device="cpu"``, which is the decode kernel's plain version, so streams
have small blocks (a low zlib ``memLevel``) and both packages' segment
size is set small inside the test: a lane then takes hundreds of steps of
the eager twin, not 20,000.  The JAX decoder compiles once per shape, so
the tests that run it share one stream.
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import defl_tpu.runtime.large as jlarge
import defl_tpu.runtime.session as jsess
from defl_tpu.ops import inflate_batch as jib
from defl_tpu.runtime import native as jnative
from defl_tpu_torch import metrics
from defl_tpu_torch.corpus import make_silesia_like
from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.runtime import large as tlarge
from defl_tpu_torch.runtime import native as tnative
from defl_tpu_torch.runtime import session as tsess

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="native library unavailable")

SEG = 1024


def _payload(n_bytes: int) -> bytes:
    return b"".join(make_silesia_like(max(n_bytes, 65536), 65536))[:n_bytes]


def _small_blocks(raw: bytes, wbits: int = 15, zdict=None) -> bytes:
    """One stream of many small dynamic blocks (memLevel 4 ends a block
    every 1023 symbols)."""
    kw = {} if zdict is None else {"zdict": zdict}
    co = zlib.compressobj(6, zlib.DEFLATED, wbits, 4, **kw)
    return co.compress(raw) + co.flush()


@pytest.fixture(scope="module")
def shared_stream():
    raw = _payload(100_000)
    return raw, _small_blocks(raw)


@pytest.fixture
def small_segments(monkeypatch):
    monkeypatch.setattr(jlarge, "SEGMENT_BYTES", SEG)
    monkeypatch.setattr(tlarge, "SEGMENT_BYTES", SEG)


def _same(j, t):
    (jr, jo), (tr, to) = j, t
    assert int(tr) == int(jr)
    assert to == jo
    return tr, to


# ---------------------------------------------------------------------------
# the finder, the span decoder, the host engines
# ---------------------------------------------------------------------------

def test_block_finder_candidates_match_and_lie_on_the_chain():
    raw = _payload(2 << 20)
    body = np.frombuffer(zlib.compress(raw, 6), np.uint8)[2:]
    n_seg = body.size // tlarge.SEGMENT_BYTES
    cands = tlarge._find_candidates(body, 0, n_seg, 8 * tlarge.SEGMENT_BYTES)
    assert cands == jlarge._find_candidates(body, 0, n_seg,
                                            8 * jlarge.SEGMENT_BYTES)
    assert len(cands) > 10
    lib = tnative.load()
    out = np.zeros(len(raw) + 64, np.uint8)
    cur, pos = 0, 0
    for c in cands[1:8]:
        r, pos, end = tnative.inflate_span(lib, body, cur, c, out, pos)
        assert r is Result.OK and end == c
        cur = end
    assert out[:pos].tobytes() == raw[:pos]


def test_constants_match():
    for name in ("SEGMENT_BYTES", "HOST_SEGMENT_BYTES", "SEGMENT_CAP",
                 "WINDOW"):
        assert getattr(tlarge, name) == getattr(jlarge, name), name


def test_serial_stitch_matches():
    raw = _payload(4 << 20)
    comp = zlib.compress(raw, 6)
    st = {}
    r, out = _same(jlarge.inflate_large(comp, use_device=False),
                   tlarge.inflate_large(comp, use_device=False, stats_out=st))
    assert r is Result.OK and out == raw
    assert st["route"] == "host_parallel" and "parallel_s" in st


def test_caller_buffer_matches():
    raw = _payload(2 << 20)
    comp = zlib.compress(raw, 6)
    bufs = [np.zeros(len(raw) + 64, np.uint8) for _ in range(2)]
    for flags in (FLAG_ZLIB, FLAG_ZLIB | FLAG_VERIFY_ADLER32):
        jr, jn = jlarge.inflate_large(comp, flags, out=bufs[0],
                                      use_device=False)
        tr, tn = tlarge.inflate_large(comp, flags, out=bufs[1],
                                      use_device=False)
        assert (int(tr), tn) == (int(jr), jn) == (0, len(raw))
        assert bufs[1][:tn].tobytes() == raw
    small = [np.zeros(1000, np.uint8) for _ in range(2)]
    jr, jn = jlarge.inflate_large(comp, out=small[0], use_device=False)
    tr, tn = tlarge.inflate_large(comp, out=small[1], use_device=False)
    assert tr is Result.EFULL and int(jr) == int(tr) and tn == jn <= 1000
    assert small[1][:tn].tobytes() == raw[:tn]
    r, n = tnative.native_inflate(comp, len(raw), out=bufs[1])
    assert r is Result.OK and bufs[1][:n].tobytes() == raw
    for bad in (np.zeros(8, np.int32), np.zeros((2, 8), np.uint8),
                np.zeros(16, np.uint8)[::2], b"bytes"):
        with pytest.raises(ValueError):
            tlarge.inflate_large(comp, out=bad, use_device=False)
        with pytest.raises(ValueError):
            tnative.native_inflate(comp, 8, out=bad)


@pytest.mark.parametrize("use_device", [False, True])
def test_caller_buffer_is_filled_to_the_declared_capacity_only(
        use_device, small_segments):
    """``out`` with a smaller ``dst_capacity``: the port stops at the
    capacity and returns EFULL.  The JAX module hands its stitch the whole
    buffer on the device route and so writes past the capacity the caller
    declared (and ends OK); its host route holds the capacity.  The port
    holds it on both."""
    raw = _payload(60_000)
    comp = _small_blocks(raw)
    buf = np.full(len(raw) + 64, 0xAA, np.uint8)
    r, n = tlarge.inflate_large(comp, dst_capacity=5000, out=buf,
                                use_device=use_device, device="cpu")
    assert r is Result.EFULL and n <= 5000
    assert buf[:n].tobytes() == raw[:n]
    assert (buf[5000:] == 0xAA).all()
    if not use_device:
        jbuf = np.zeros(len(raw) + 64, np.uint8)
        jr, jn = jlarge.inflate_large(comp, dst_capacity=5000, out=jbuf,
                                      use_device=False)
        assert (int(jr), jn) == (int(r), n)


def test_adler_verify_matches():
    raw = _payload(1 << 20)
    comp = bytearray(zlib.compress(raw, 6))
    fl = FLAG_ZLIB | FLAG_VERIFY_ADLER32
    r, out = _same(jlarge.inflate_large(bytes(comp), fl, use_device=False),
                   tlarge.inflate_large(bytes(comp), fl, use_device=False))
    assert r is Result.OK and out == raw
    comp[-1] ^= 0xFF
    r, _ = _same(jlarge.inflate_large(bytes(comp), fl, use_device=False),
                 tlarge.inflate_large(bytes(comp), fl, use_device=False))
    assert r is Result.ERR
    r, _ = _same(jlarge.inflate_large(bytes(comp[:-3]), fl, use_device=False),
                 tlarge.inflate_large(bytes(comp[:-3]), fl, use_device=False))
    assert r is Result.UNFINISHED


@pytest.mark.parametrize("data", [b"", b"\x78", b"\x79\x9c\x03\x00",
                                  b"\x78\xbb\x03\x00"])
def test_bad_zlib_headers_match(data):
    r, out = _same(jlarge.inflate_large(data, use_device=False),
                   tlarge.inflate_large(data, use_device=False))
    assert r in (Result.UNFINISHED, Result.ERR) and out == b""


def test_efull_matches():
    raw = _payload(1 << 20)
    comp = zlib.compress(raw, 6)
    r, out = _same(
        jlarge.inflate_large(comp, dst_capacity=1000, use_device=False),
        tlarge.inflate_large(comp, dst_capacity=1000, use_device=False))
    assert r is Result.EFULL
    assert raw.startswith(out) and len(out) <= 1000


def test_grows_without_declared_capacity():
    raw = b"\x00" * (20 << 20)           # ~1000:1 under zlib level 6
    comp = zlib.compress(raw, 6)
    assert max(len(comp) * 16, 1 << 20) < len(raw)   # EFULL without a retry
    r, out = tlarge.inflate_large(comp, use_device=False)
    assert r is Result.OK and out == raw
    r, out = tlarge.inflate_large(comp, use_device=True, device="cpu")
    assert r is Result.OK and out == raw             # one segment: serial


@pytest.mark.parametrize("seg_bytes", [16384, 131072])
@pytest.mark.parametrize("n_threads", [1, 4])
def test_host_parallel_engine_byte_exact(seg_bytes, n_threads):
    raw = _payload(4 << 20)
    comp = zlib.compress(raw, 6)
    kw = dict(use_device=False, seg_bytes=seg_bytes, n_threads=n_threads)
    r, out = _same(jlarge.inflate_large(comp, **kw),
                   tlarge.inflate_large(comp, **kw))
    assert r is Result.OK and out == raw


def test_host_parallel_mixed_block_types():
    rng = np.random.default_rng(3)
    noise = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    text = _payload(1 << 20)
    co = zlib.compressobj(6)
    parts, raws = [], []
    for i in range(64):
        blk = noise[i * 2048:(i + 1) * 2048] if i % 2 else b"pattern " * 300
        raws.append(blk)
        parts.append(co.compress(blk))
        parts.append(co.flush(zlib.Z_FULL_FLUSH if i % 3 else
                              zlib.Z_SYNC_FLUSH))
    parts.append(co.flush())
    for comp, raw in ((zlib.compress(noise, 0), noise),
                      (zlib.compress(text, 1), text),
                      (b"".join(parts), b"".join(raws))):
        r, out = _same(jlarge.inflate_large(comp, use_device=False),
                       tlarge.inflate_large(comp, use_device=False))
        assert r is Result.OK and out == raw


def test_host_parallel_efull_retry_reuses_tokens():
    raw = b"\x00" * (8 << 20)
    body = np.frombuffer(zlib.compress(raw, 6), np.uint8)[2:]
    lib = tnative.load()
    small = np.zeros(1 << 20, np.uint8)
    r, total, _, state = tnative.inflate_large_parallel(lib, body, small)
    assert r is Result.EFULL and total <= small.size
    big = np.zeros(len(raw), np.uint8)
    r, total, _, state = tnative.inflate_large_parallel(lib, body, big,
                                                        state=state)
    tnative.large_free(lib, state)
    assert r is Result.OK and total == len(raw) and big.tobytes() == raw


def test_device_route_allowed_boundary():
    bound = ((1 << 31) - (1 << 22)) // 8
    for n in (0, 1, bound - 1, bound, bound + 1, 300 << 20):
        assert tlarge.device_route_allowed(n) \
            == jlarge.device_route_allowed(n), n
    assert tlarge.device_route_allowed(bound - 1)
    assert not tlarge.device_route_allowed(bound)


# ---------------------------------------------------------------------------
# the device route (device="cpu": the kernel's plain version)
# ---------------------------------------------------------------------------

def test_device_route_matches_jax(shared_stream, small_segments):
    raw, comp = shared_stream
    js, ts = {}, {}
    m0 = metrics.snapshot()
    r, out = _same(
        jlarge.inflate_large(comp, use_device=True, stats_out=js),
        tlarge.inflate_large(comp, use_device=True, stats_out=ts,
                             device="cpu"))
    m1 = metrics.snapshot()
    assert r is Result.OK and out == raw
    assert ts["route"] == "device"
    assert ts["lanes"] == js["lanes"] > 10
    assert ts["lanes_valid"] == js["lanes_valid"] >= 0.8 * ts["lanes"]
    for key in ("find_s", "upload_s", "decode_s", "fetch_s", "stitch_s",
                "tok_rows"):
        assert key in ts
    assert "parallel_s" not in ts
    count = lambda k: m1.get(k, 0) - m0.get(k, 0)
    assert count("large_device_lanes") == ts["lanes"]
    assert count("large_device_lanes_valid") == ts["lanes_valid"]
    assert count("large_streams") == 1


def test_device_route_is_the_default_when_the_body_allows(shared_stream,
                                                          small_segments):
    raw, comp = shared_stream
    st = {}
    r, out = tlarge.inflate_large(comp, stats_out=st, device="cpu",
                                  flags=FLAG_ZLIB | FLAG_VERIFY_ADLER32)
    assert r is Result.OK and out == raw and st["route"] == "device"
    # one or two segments: the host-parallel engine
    st = {}
    r, out = tlarge.inflate_large(comp[:2 * SEG + 100], stats_out=st,
                                  device="cpu")
    assert st["route"] == "host_parallel"
    assert raw.startswith(out) and r is Result.UNFINISHED


def test_too_few_segments_leave_the_serial_stitch(shared_stream):
    raw, comp = shared_stream            # under two real-size segments
    st = {}
    before = metrics.snapshot().get("large_device_rerouted", 0)
    r, out = _same(jlarge.inflate_large(comp, use_device=True),
                   tlarge.inflate_large(comp, use_device=True, stats_out=st,
                                        device="cpu"))
    assert r is Result.OK and out == raw
    assert st["route"] == "serial" and "lanes" not in st
    # no lane ran on the device although the caller named it: counted
    assert metrics.snapshot()["large_device_rerouted"] == before + 1


def test_head_lane_distance_too_far_is_err_on_both_engines(small_segments):
    """A preset-dictionary compress replayed WITHOUT the dictionary reaches
    before the stream's start: the head lane's reach is 0, so it must ERR
    instead of resolving to garbage."""
    raw = _payload(80_000)
    zdict = raw[:16384][::-1]
    # the stream's first bytes repeat the dictionary's end, so its first
    # match reaches back into the dictionary
    comp = _small_blocks(zdict[-600:] + raw, wbits=-15, zdict=zdict)
    st = {}
    r_host, _ = _same(
        jlarge.inflate_large(comp, flags=0, use_device=False),
        tlarge.inflate_large(comp, flags=0, use_device=False))
    assert r_host is Result.ERR
    r_dev, _ = _same(
        jlarge.inflate_large(comp, flags=0, use_device=True),
        tlarge.inflate_large(comp, flags=0, use_device=True, stats_out=st,
                             device="cpu"))
    assert r_dev is Result.ERR
    assert st["route"] == "device" and st["lanes_valid"] < st["lanes"]


def test_oversize_body_reroutes_to_the_host_engine(shared_stream,
                                                   small_segments,
                                                   monkeypatch):
    """A body past the int32 bit cursors: the host-parallel engine when the
    choice was the module's (and counted), an error when the caller named
    the device.  (The JAX module reroutes quietly in both cases.)"""
    raw, comp = shared_stream
    monkeypatch.setattr(tlarge, "device_route_allowed", lambda n: False)
    before = metrics.snapshot().get("large_device_rerouted", 0)
    st = {}
    r, out = tlarge.inflate_large(comp, stats_out=st, device="cpu")
    assert r is Result.OK and out == raw
    assert st["route"] == "host_parallel" and "parallel_s" in st
    assert "lanes" not in st
    assert metrics.snapshot()["large_device_rerouted"] == before + 1
    with pytest.raises(ValueError, match="bit cursors"):
        tlarge.inflate_large(comp, use_device=True, device="cpu")
    monkeypatch.setattr(tsess, "MAX_STREAM_BYTES", 20_000)
    with pytest.raises(ValueError, match="bit cursors"):
        tsess.batch_inflate([comp], backend="device", device="cpu")
    # the host engine by name is no reroute
    r, out = tlarge.inflate_large(comp, use_device=False)
    assert r is Result.OK and out == raw
    assert metrics.snapshot()["large_device_rerouted"] == before + 1


def test_cuda_without_a_card_raises_unless_the_host_engine_is_named(
        shared_stream):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    raw, comp = shared_stream
    for use_device in (None, True):
        with pytest.raises(RuntimeError, match="CUDA"):
            tlarge.inflate_large(comp, use_device=use_device)
    r, out = tlarge.inflate_large(comp, use_device=False)
    assert r is Result.OK and out == raw
    with pytest.raises(RuntimeError, match="CUDA"):
        tsess.batch_inflate([comp], backend="device")


# ---------------------------------------------------------------------------
# batch_inflate's routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["auto", "device"])
def test_batch_inflate_routes_big_streams(backend, shared_stream,
                                          small_segments, monkeypatch):
    raw, comp = shared_stream
    monkeypatch.setattr(tsess, "MAX_STREAM_BYTES", 20_000)
    monkeypatch.setattr(jsess, "MAX_STREAM_BYTES", 20_000)
    small_raw = b"small payload " * 100
    streams = [zlib.compress(small_raw, 6), comp, zlib.compress(small_raw, 6)]
    assert len(comp) > 20_000 > len(streams[0])
    seen = []
    real = tlarge.inflate_large

    def spy(data, *a, **kw):
        st = kw.setdefault("stats_out", {})
        out = real(data, *a, **kw)
        seen.append((kw.get("use_device"), st["route"]))
        return out

    monkeypatch.setattr(tlarge, "inflate_large", spy)
    caps = [2048, len(raw), 2048]
    for dst in (None, caps):
        seen.clear()
        jr, jo = jsess.batch_inflate(streams, backend="auto",
                                     dst_capacities=dst)
        tr, to = tsess.batch_inflate(streams, backend=backend,
                                     dst_capacities=dst, device="cpu")
        assert [int(r) for r in tr] == [int(r) for r in jr] == [0, 0, 0]
        assert to == jo == [small_raw, raw, small_raw]
        # the big stream went through the split decode on the device
        assert seen == [(True if backend == "device" else None, "device")]
    # with a dictionary, or on the host backend, nothing is rerouted
    seen.clear()
    tr, to = tsess.batch_inflate(streams, backend="host")
    assert to == [small_raw, raw, small_raw] and not seen


# ---------------------------------------------------------------------------
# the decoder's shared-input mode against the JAX decoder's
# ---------------------------------------------------------------------------

def _lane_tokens(tok, rows=None):
    t = tok[:rows].numpy() if torch.is_tensor(tok) else np.asarray(tok)[:rows]
    t = np.ascontiguousarray(t.T).view(np.uint32)
    return [lane[lane != 0].tolist() for lane in t]


def test_shared_input_decode_matches_jax(shared_stream):
    raw, comp = shared_stream
    body = np.frombuffer(comp, np.uint8)[2:]
    cands = tlarge._find_candidates(body, 0, body.size // SEG, 8 * SEG)
    assert len(cands) > 10 and cands[0] == 0
    kw = tlarge.lane_args(body.size, cands)
    nbits, zflag, cap = kw.pop("nbits"), kw.pop("zflag"), kw.pop("cap")
    T = kw.pop("T")
    words = decode_cu.pad_body(body).view(np.uint32)

    jt, jc = jib.decode_tokens(
        jnp.asarray(words), jnp.asarray(nbits), jnp.asarray(zflag),
        jnp.asarray(cap), T=T, K=128, dict_len=tlarge.WINDOW,
        shared_input=True, **{k: jnp.asarray(v) for k, v in kw.items()})
    for layout in (words, words[None, :],
                   torch.from_numpy(words.view(np.int32))):
        tt, tc = decode_cu.decode_tokens(
            layout, nbits, zflag, cap, T=T, K=128, dict_len=tlarge.WINDOW,
            shared_input=True, device="cpu", **kw)
        for key in ("status", "dst_pos", "bitpos", "final"):
            np.testing.assert_array_equal(tc[key].numpy(),
                                          np.asarray(jc[key]), key)
        assert _lane_tokens(tt, tc["tok_rows"]) == _lane_tokens(jt)
    status = tc["status"].numpy()
    assert (status == 0).all()
    # every lane ended on the next one's start, the last in the final block
    end = tc["bitpos"].numpy()
    assert end[:-1].tolist() == cands[1:]
    assert tc["final"].numpy()[-1] == 1
    # stored-run offsets are relative to the lane's segment: a level-0
    # stream of the same bytes, split by hand at its block starts
    stored = zlib.compress(raw[:70_000], 0)[2:]
    sb = np.frombuffer(stored, np.uint8)
    first = int.from_bytes(stored[1:3], "little")   # the first block's LEN
    assert 0 < first < 70_000
    starts = [0, 8 * (5 + first)]        # a 5-byte header before each block
    skw = tlarge.lane_args(sb.size, starts)
    snb, szf, scap = skw.pop("nbits"), skw.pop("zflag"), skw.pop("cap")
    sT = skw.pop("T")
    st, sc = decode_cu.decode_tokens(sb.copy(), snb, szf, scap, T=sT, K=128,
                                     dict_len=tlarge.WINDOW,
                                     shared_input=True, device="cpu", **skw)
    sw = decode_cu.pad_body(sb).view(np.uint32)
    jst, jsc = jib.decode_tokens(
        jnp.asarray(sw), jnp.asarray(snb), jnp.asarray(szf),
        jnp.asarray(scap), T=sT, K=128, dict_len=tlarge.WINDOW,
        shared_input=True, **{k: jnp.asarray(v) for k, v in skw.items()})
    assert _lane_tokens(st, sc["tok_rows"]) == _lane_tokens(jst)
    assert sc["status"].tolist() == [0, 0]
    assert sc["dst_pos"].tolist() == [first, 70_000 - first]
    second = _lane_tokens(st, sc["tok_rows"])[1]
    assert second[0] >> 30 == 3 and second[0] & 0x3FFFFF == 5
