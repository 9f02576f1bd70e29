"""``defl_tpu_torch.api`` against ``defl_tpu.api`` on the cases of
tests/test_api_corpus.py: contiguous one-shot, chunked include, streaming
feeds, bytewise streaming, lifecycle (NOOP, EBADF after destroy, reset,
positions), raw deflate, the native fast path and what stays resumable
beside it, EFULL then ``resize_output``, the one-shot buffers and the
counters.  Every step's ``Result``, output and positions must be the
reference's (exact).
"""

import zlib

import pytest

import defl_tpu
import defl_tpu.api as japi
import defl_tpu_torch
import defl_tpu_torch.api as tapi
from defl_tpu.runtime import native as jnative
from defl_tpu_torch import metrics
from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, DeflError, \
    Result
from tests.gendata import make_corpus

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="native library unavailable")

CORPUS = make_corpus()
NAMES = sorted(CORPUS)


def _cap(payload: bytes) -> int:
    return max(len(payload), 1)


class Both:
    """One stream object of each package, driven in step."""

    def __init__(self, *a, **kw):
        self.j = japi.InflateStream(*a, **kw)
        self.t = tapi.InflateStream(*a, **kw)

    def call(self, name, *a):
        jr = getattr(self.j, name)(*a)
        tr = getattr(self.t, name)(*a)
        assert (tr is None and jr is None) or int(tr) == int(jr), \
            (name, tr, jr)
        self.same()
        return tr

    def same(self):
        assert self.t.output == self.j.output
        assert self.t.output_pos == self.j.output_pos
        assert self.t.input_pos == self.j.input_pos
        assert self.t.native_path_used == self.j.native_path_used


def test_public_names():
    for name in ("InflateStream", "inflate_buffer", "DeflateStream",
                 "deflate_buffer", "inflate_batch", "deflate_batch"):
        assert callable(getattr(tapi, name)) and hasattr(japi, name)
    mine = {n for n in vars(tapi) if not n.startswith("_")}
    theirs = {n for n in vars(japi) if not n.startswith("_")}
    assert {n for n in theirs if callable(getattr(japi, n))} <= mine
    for name in defl_tpu.__all__:
        if name != "__version__":
            assert name in defl_tpu_torch.__all__, name
    for name in ("inflate_large", "device_deflate", "device_inflate"):
        assert name in defl_tpu_torch.__all__


@pytest.mark.parametrize("name", NAMES)
def test_contiguous_one_shot(name):
    payload = CORPUS[name]
    b = Both(_cap(payload))
    assert b.call("include", zlib.compress(payload, 6)) is Result.OK
    assert b.call("run") is Result.OK
    assert b.t.output == payload and b.t.output_pos == len(payload)


@pytest.mark.parametrize("chunk", [1, 8])
@pytest.mark.parametrize("name", NAMES)
def test_chunked_include(name, chunk):
    payload = CORPUS[name]
    comp = zlib.compress(payload, 6)
    b = Both(_cap(payload))
    for i in range(0, len(comp), chunk):
        assert b.t.include(comp[i: i + chunk]) is Result.OK
        b.j.include(comp[i: i + chunk])
    assert b.call("run") is Result.OK
    assert b.t.output == payload


@pytest.mark.parametrize("feed", [64, 1024])
@pytest.mark.parametrize("name", NAMES)
def test_streaming_feeds(name, feed):
    payload = CORPUS[name]
    comp = zlib.compress(payload, 6)
    b = Both(_cap(payload))
    r = Result.UNFINISHED
    for i in range(0, len(comp), feed):
        r = b.call("stream", comp[i: i + feed])
        assert r in (Result.OK, Result.UNFINISHED)
    assert r is Result.OK
    assert b.call("stream", b"") in (Result.OK, Result.NOOP)
    assert b.t.output == payload


def test_streaming_bytewise():
    payload = CORPUS["png_simulation"][:3000]
    comp = zlib.compress(payload, 6)
    b = Both(len(payload) or 1)
    for i in range(len(comp)):
        r = b.call("stream", comp[i: i + 1])
    assert r is Result.OK and b.t.output == payload


def test_lifecycle_noop_ebadf_reset_positions():
    payload = CORPUS["text"][:500]
    comp = zlib.compress(payload, 6)
    b = Both(len(payload))
    assert b.call("stream", b"") is Result.NOOP
    assert b.call("stream", comp) is Result.OK
    assert b.t.output == payload and b.t.output_pos == len(payload)
    assert b.t.input_pos == len(comp) - 4     # the trailer is never consumed
    assert b.call("include", b"late") is Result.EPERM
    other = CORPUS["json"][:400]
    assert b.call("reset", len(other)) is Result.OK
    assert b.call("reset_pool") is Result.OK
    assert b.call("stream", zlib.compress(other, 6)) is Result.OK
    assert b.t.output == other
    b.call("destroy")
    for name, arg in (("stream", b"x"), ("include", b"x"), ("run", None),
                      ("reset", None), ("reset_pool", None),
                      ("resize_output", 10)):
        assert b.call(name, *(() if arg is None else (arg,))) is Result.EBADF
    assert b.t.output_pos == 0 and b.t.input_pos == 0 and b.t.output == b""


def test_raw_deflate_and_verify_flags():
    payload = CORPUS["period_13"]
    comp = zlib.compress(payload, 6, -15)
    b = Both(len(payload), flags=0)
    for i in range(0, len(comp), 4):
        b.call("include", comp[i: i + 4])
    assert b.call("run") is Result.OK and b.t.output == payload
    z = bytearray(zlib.compress(payload, 6))
    z[-1] ^= 0x55
    b = Both(len(payload), flags=FLAG_ZLIB | FLAG_VERIFY_ADLER32)
    b.call("include", bytes(z))
    assert b.call("run") is Result.ERR


def test_one_shot_takes_native_fast_path():
    from defl_tpu_torch.core.oracle import InflateEngine

    for name in ("text", "json", "period_13"):
        payload = CORPUS[name]
        comp = zlib.compress(payload, 6)
        b = Both(_cap(payload))
        b.call("include", comp)
        assert b.call("run") is Result.OK
        assert b.t.native_path_used
        eng = InflateEngine(_cap(payload))
        eng.include(comp)
        assert eng.step() is Result.OK
        assert b.t.output == bytes(eng.out) == payload
        assert b.t.input_pos == eng.input_pos
        with pytest.raises(RuntimeError):
            eng.adopt_native_result(b"x", 1)


def test_native_fast_path_preserves_resumable_semantics():
    payload = CORPUS["text"]
    comp = zlib.compress(payload, 6)
    b = Both(_cap(payload))
    b.call("include", comp[:100])
    assert b.call("run") is Result.UNFINISHED
    assert not b.t.native_path_used
    b.call("include", comp[100:])
    assert b.call("run") is Result.OK and b.t.output == payload

    b = Both(16)
    b.call("include", comp)
    assert b.call("run") is Result.EFULL
    assert b.call("resize_output", 8) is Result.EPERM
    assert b.call("resize_output", _cap(payload)) is Result.OK
    assert b.call("run") is Result.OK and b.t.output == payload


def test_dictionary_streams_stay_on_the_oracle():
    d = b"a shared preset dictionary: hello world, the quick brown fox " * 4
    payload = b"hello world, the quick brown fox jumps " * 30
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_DEFAULT_STRATEGY,
                          zdict=d)
    comp = co.compress(payload) + co.flush()
    b = Both(len(payload), dictionary=d)
    b.call("include", comp)
    assert b.call("run") is Result.OK and not b.t.native_path_used
    assert b.t.output == payload
    assert tapi.inflate_buffer(comp, dictionary=d) \
        == japi.inflate_buffer(comp, dictionary=d) == payload
    b = Both(len(payload))               # FDICT without the dictionary
    b.call("include", comp)
    assert b.call("run") is Result.ERR


@pytest.mark.parametrize("name", NAMES[:8])
def test_buffers_match(name):
    payload = CORPUS[name]
    comp = zlib.compress(payload, 6)
    assert tapi.inflate_buffer(comp) == japi.inflate_buffer(comp) == payload
    assert tapi.inflate_buffer(comp, len(payload)) == payload
    for level in (0, 1, 6):
        got = tapi.deflate_buffer(payload, level=level)
        assert got == japi.deflate_buffer(payload, level=level)
        assert zlib.decompress(got) == payload
    raw = tapi.deflate_buffer(payload, flags=0)
    assert raw == japi.deflate_buffer(payload, flags=0)
    assert tapi.inflate_buffer(raw, flags=0) == payload


def test_inflate_buffer_failures_raise_the_same():
    payload = CORPUS["text"]
    comp = zlib.compress(payload, 6)
    for data, cap in ((comp[:50], None), (b"\x78\x9c\x07\xff", None),
                      (comp, 10)):
        with pytest.raises(japi.DeflError) as je:
            japi.inflate_buffer(data, cap)
        with pytest.raises(DeflError) as te:
            tapi.inflate_buffer(data, cap)
        assert int(te.value.result) == int(je.value.result)
    big = b"\0" * (1 << 20)              # grows past 64x without a capacity
    assert tapi.inflate_buffer(zlib.compress(big, 9)) == big


def test_deflate_stream_and_batches_match():
    d = b"shared words appear early " * 40
    payload = CORPUS["text"] * 3
    outs = []
    for api in (tapi, japi):
        st = api.DeflateStream(level=6, dictionary=d)
        outs.append(st.compress(payload[:5000]) + st.compress(payload[5000:])
                    + st.flush())
    assert outs[0] == outs[1]
    assert zlib.decompressobj(zdict=d).decompress(outs[0]) == payload
    pays = [CORPUS[n] for n in NAMES[:6]]
    comp = tapi.deflate_batch(pays)
    assert comp == japi.deflate_batch(pays)
    assert tapi.deflate_batch(pays, backend="device", device="cpu") == comp
    tr, to = tapi.inflate_batch(comp, backend="device", device="cpu",
                                dst_capacities=[_cap(p) for p in pays])
    jr, jo = japi.inflate_batch(comp, backend="host")
    assert [int(r) for r in tr] == [int(r) for r in jr] and to == jo == pays
    tr, to = tapi.inflate_batch(comp[:3], backend="auto")   # small: the host
    assert to == pays[:3]


def test_metrics_counters_wired():
    metrics.reset()
    payload = CORPUS["text"]
    assert tapi.inflate_buffer(zlib.compress(payload, 6)) == payload
    snap = metrics.snapshot()
    assert snap.get("inflate_buffer_calls", 0) == 1
    assert snap.get("inflate_bytes_out", 0) == len(payload)
    st = tapi.InflateStream(len(payload))
    st.include(zlib.compress(payload, 6))
    st.run()
    assert metrics.snapshot().get("oneshot_native_fast_path", 0) == 1
    metrics.reset()
    assert metrics.snapshot() == {}


def test_cli_entry_point_exists():
    from defl_tpu_torch import cli

    assert callable(cli.breakdown_main)
