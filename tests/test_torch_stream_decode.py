"""The whole-call decode of the port: its comparator, its plain version (the
chunk loop) against the JAX package, and the stream kernel's per-lane code
run on the CPU.

- ``compare_decodes`` must call the chunk loop equal to itself at two chunk
  lengths (other token slots, same lanes) and must see a flipped token, a
  shifted ``bitpos`` and a wrong table in a resumable lane.
- The chunk loop's status, ``dst_pos``, ``bitpos``, compacted tokens and
  bytes are held against ``defl_tpu`` on the payload matrix of
  tests/test_torch_decode.py and on three streams whose tables are bad
  (all ERR in both packages).
- ``csrc/decode_stream.cu`` keeps its per-lane code free of CUDA-only
  constructs, so g++ can build it with a few intrinsics defined: one
  thread after the other, each lane runs the very step and build code the
  card runs.  That host build is held against the chunk loop by the
  comparator, and its builds against ``ops/tables.build_canonical``.  It is
  a test of the source's arithmetic only; what nvcc makes of it is held on
  the card by tests/test_torch_cuda.py and chip_smoke.py.

Inputs come from numpy seeds; every comparison is exact (a codec has no
tolerance).
"""

import ctypes
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from defl_tpu.ops import inflate_batch as jib
from defl_tpu.runtime.native import available, native_resolve_tokens
from defl_tpu.runtime.pack import pack_dictionary, pack_streams
from defl_tpu_torch.ops import inflate_batch as tib
from defl_tpu_torch.ops import tables as ttables
from defl_tpu_torch.ops.bitio import i32_to_u32, u32_to_i32
from defl_tpu_torch.ops.cuda import decode_cu
from tests.decode_host import _host_split_decode, _host_stream, _ptr, build
from tests.gendata import BitWriter

N, W, T = 16, 2304, 4096
OK, ERR, UNF, EFULL = 0, -1, 2, -105


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def _payloads():
    rng = np.random.default_rng(7)
    return [b"hello hello hello world" * 40, bytes(range(256)) * 16,
            b"\0" * 5000,
            rng.integers(0, 256, 700, dtype=np.uint8).tobytes(),
            b"ab" * 4000, b"x"]


def _dynamic_header(hlit, hdist, cl_lens):
    """BFINAL=1, BTYPE=2 and the code-length code's own lengths."""
    order = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
    w = BitWriter()
    w.bits(1, 1).bits(2, 2)
    w.bits(hlit - 257, 5).bits(hdist - 1, 5).bits(19 - 4, 4)
    for sym in order:
        w.bits(cl_lens.get(sym, 0), 3)
    return w


def _bad_table_streams():
    """Raw streams that end in ERR at a table build: an oversubscribed
    code-length code; an oversubscribed literal code (three codes of length
    1); a literal code with no end-of-block symbol."""
    over_cl = _dynamic_header(257, 1, {0: 1, 1: 1, 2: 1})
    # code-length code {1: '0', 2: '1'}, both of length 1
    over_lit = _dynamic_header(257, 1, {1: 1, 2: 1})
    for _ in range(3):
        over_lit.code(0, 1)              # three literals of length 1
    for _ in range(255):
        over_lit.code(1, 1)              # length 2 for all the rest
    no_eob = _dynamic_header(257, 1, {0: 1, 1: 1})
    no_eob.code(1, 1).code(1, 1)         # two literals of length 1
    for _ in range(256):
        no_eob.code(0, 1)                # length 0 up to and with EOB, dist
    return [w.getvalue() + b"\0" * 8 for w in (over_cl, over_lit, no_eob)]


def _many_blocks_payload():
    rng = np.random.default_rng(5)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(60)]
    return b" ".join(words[i] for i in rng.integers(0, 60, 900))


def _many_blocks():
    """One lane with dozens of dynamic and fixed blocks (memLevel 1 ends a
    block every 127 symbols) and two empty stored ones (sync flushes)."""
    pay = _many_blocks_payload()
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 1)
    return (co.compress(pay[:2000]) + co.flush(zlib.Z_SYNC_FLUSH)
            + co.compress(pay[2000:3500]) + co.flush(zlib.Z_SYNC_FLUSH)
            + co.compress(pay[3500:]) + co.flush())


def _matrix():
    """(streams, zflag, caps): every block type, RLE, dist=2 chains,
    BTYPE=3, truncation, EFULL lanes, bad tables, a lane of many blocks."""
    pays = _payloads()
    raw = zlib.compressobj(6, zlib.DEFLATED, -15)
    fixed = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FIXED)
    streams = [zlib.compress(p, 6) for p in pays] + [
        zlib.compress(pays[0], 0), raw.compress(pays[1]) + raw.flush(),
        fixed.compress(pays[4]) + fixed.flush(),
        b"\x78\x9c\x07\xff\xff\xff", zlib.compress(pays[0], 6)[:-8],
        zlib.compress(pays[1], 9)] + _bad_table_streams() + [_many_blocks()]
    zflag = [1] * 7 + [0, 1, 1, 1, 1, 0, 0, 0, 1]
    caps = [8192] * len(streams)
    caps[2], caps[11] = 1000, 777        # EFULL mid-run and mid-block
    return streams, zflag, caps


def _pack(streams, zflag, caps, n=N, w=W):
    p = pack_streams(streams, zflag, caps)
    words = np.zeros((n, w), np.uint32)
    words[: len(streams), : p.words.shape[1]] = p.words
    pad = lambda a: np.pad(a, (0, n - len(streams)))
    return words, pad(p.nbits), pad(p.zflag), pad(p.dst_cap)


def _until_done(decode, packed, new_cap=None, max_calls=12, **kw):
    """Call ``decode`` (decode_tokens' signature) until no lane is RUNNING;
    with ``new_cap``, EFULL lanes are then revived once with that capacity
    and run on.  Returns (parts, carry)."""
    words, nbits, zflag, cap = packed
    parts, carry = [], None
    for _ in range(max_calls):
        tok, carry = decode(words, nbits, zflag, cap, carry=carry, **kw)
        parts.append((tok, carry["tok_rows"]))
        if not (carry["status"] == tib.STATUS_RUNNING).any():
            if new_cap is None:
                return parts, carry
            cap = np.full_like(cap, new_cap)
            carry = tib.revive_carry(carry, new_cap=torch.from_numpy(cap))
            new_cap = None
    raise AssertionError("lanes still RUNNING")


def _loop(K):
    return lambda *a, **kw: decode_cu.decode_tokens(*a, T=T, K=K,
                                                    device="cpu", **kw)


# ---------------------------------------------------------------------------
# the comparator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def loop_runs():
    packed = _pack(*_matrix())
    return {K: _until_done(_loop(K), packed) for K in (16, 128)}


def test_comparator_equal_across_chunk_lengths(loop_runs):
    a, b = loop_runs[16], loop_runs[128]
    assert decode_cu.compare_decodes(a, b) == 0
    # other slot layouts: the buffers themselves differ
    assert not torch.equal(a[0][0][0], b[0][0][0])
    st = a[1]["status"].numpy()
    assert set(st[:15]) == {OK, ERR, UNF, EFULL}
    assert (st[12:15] == ERR).all()


@pytest.fixture(scope="module")
def loop_resumed():
    """The chunk loop to the end, EFULL lanes revived once at 8192."""
    return _until_done(_loop(128), _pack(*_matrix()), new_cap=8192)


def test_comparator_equal_after_efull_resume(loop_resumed):
    packed = _pack(*_matrix())
    a = _until_done(_loop(16), packed, new_cap=8192)
    b = loop_resumed
    assert decode_cu.compare_decodes(a, b) == 0
    assert len(a[0]) >= 2 and len(b[0]) >= 2
    assert (a[1]["status"].numpy()[[2, 11]] == OK).all()


def _mutated(run, fn):
    parts, carry = run
    parts = [(t.clone(), rows) for t, rows in parts]
    carry = {k: v.clone() if torch.is_tensor(v) else v
             for k, v in carry.items()}
    fn(parts, carry)
    return parts, carry


def _flip_token(parts, carry):
    tok, rows = parts[0]
    r = int((tok[:rows, 0] != 0).nonzero()[3])
    tok[r, 0] ^= 1


def _swap_tokens(parts, carry):
    tok, rows = parts[0]
    r = (tok[:rows, 1] != 0).nonzero()[:, 0]
    a, b = int(r[2]), int(r[3])
    assert tok[a, 1] != tok[b, 1]
    tok[[a, b], 1] = tok[[b, a], 1]


def _drop_token(parts, carry):
    tok, rows = parts[0]
    tok[int((tok[:rows, 4] != 0).nonzero()[-1]), 4] = 0


def _shift_bitpos(parts, carry):
    carry["bitpos"][5] += 1


def _wrong_table(parts, carry):
    assert carry["status"][2] == EFULL   # resumable, mid-block
    carry["syms"][2, 40] ^= 1 << 10


def _wrong_lens(parts, carry):
    carry["lens_pk"][3, 11] ^= 2         # lane 11: EFULL too


def _wrong_state(parts, carry):
    carry["state"][0] = tib.S_ERR


@pytest.mark.parametrize("fault", [_flip_token, _swap_tokens, _drop_token,
                                   _shift_bitpos, _wrong_table, _wrong_lens,
                                   _wrong_state])
def test_comparator_sees(loop_runs, fault):
    good = loop_runs[128]
    assert decode_cu.compare_decodes(good, _mutated(good, fault)) > 0
    assert decode_cu.compare_decodes(_mutated(good, fault), good) > 0


def test_comparator_ignores_tables_of_finished_lanes(loop_runs):
    """A lane that is DONE or ERR never reads its tables again."""
    good = loop_runs[128]

    def fn(parts, carry):
        assert carry["status"][0] == OK and carry["status"][9] == ERR
        carry["syms"][0, 40] ^= 1
        carry["count"][9, 1, 3] += 1
    assert decode_cu.compare_decodes(good, _mutated(good, fn)) == 0


def test_comparator_takes_a_lane_subset_and_a_single_call(loop_runs):
    good = loop_runs[128]
    bad = _mutated(good, _shift_bitpos)
    assert decode_cu.compare_decodes(good, bad, lanes=[0, 1, 7]) == 0
    assert decode_cu.compare_decodes(good, bad, lanes=[5]) > 0
    packed = _pack([zlib.compress(b"one call " * 9)], 1, 256, n=2, w=16)
    tok, c = _loop(128)(*packed)
    assert decode_cu.compare_decodes((tok, c), ([(tok, c["tok_rows"])], c)) == 0


def test_compact_tokens_keeps_order_and_counts():
    tok = torch.tensor([[5, 0], [0, 0], [-7, 9], [0, 1], [3, 0]],
                       dtype=torch.int32)
    got, n = decode_cu.compact_tokens([(tok[:3], 3), (tok[3:], 2)])
    assert n.tolist() == [3, 2]
    assert got.tolist() == [[5, (1 << 32) - 7, 3], [9, 1, 0]]


# ---------------------------------------------------------------------------
# the chunk loop against defl_tpu
# ---------------------------------------------------------------------------

needs_native = pytest.mark.skipif(not available(),
                                  reason="native resolver unavailable")


def _jax_run(packed, K=32, **kw):
    jt, jc = jib.decode_tokens(*(jnp.asarray(a) for a in packed), T=T, K=K,
                               **kw)
    return np.asarray(jt), {k: np.asarray(v) for k, v in jc.items()}


def _lane_tokens(tok, rows=None):
    """[rows, N] token buffer -> per-lane lists of non-NOP u32 tokens."""
    t = (tok[:rows].numpy() if torch.is_tensor(tok) else tok[:rows])
    t = np.ascontiguousarray(t.T).view(np.uint32)
    return [lane[lane != 0].tolist() for lane in t]


def _resolve(tok, rows, words, dst, dictionary=None):
    t = tok[:rows].numpy() if torch.is_tensor(tok) else tok[:rows]
    lane_major = np.ascontiguousarray(t.T).view(np.uint32)
    return native_resolve_tokens(lane_major, words, np.asarray(dst), 8192,
                                 dictionary)


def _check_against_jax(packed, n, payloads, dictionary=None, **kw):
    jt, jc = _jax_run(packed, **kw)
    tt, tc = decode_cu.decode_tokens(*packed, T=T, K=32, device="cpu", **kw)
    ts, js = tc["status"].numpy(), jc["status"]
    np.testing.assert_array_equal(ts[:n], js[:n])
    assert (ts[:n] != tib.STATUS_RUNNING).all()
    for key in ("dst_pos", "bitpos"):
        np.testing.assert_array_equal(tc[key].numpy()[:n], jc[key][:n], key)
    # both packages run the same step from the same state: a lane's tokens
    # are the same tokens, whatever slots they sit in
    assert _lane_tokens(tt, tc["tok_rows"])[:n] == _lane_tokens(jt)[:n]
    for tok, rows, dst in ((tt, tc["tok_rows"], tc["dst_pos"].numpy()),
                           (jt, None, jc["dst_pos"])):
        out = _resolve(tok, rows, packed[0], dst, dictionary)
        for i, p in enumerate(payloads):
            if p is not None and ts[i] == OK:
                assert out[i, : dst[i]].tobytes() == p, i
    return ts


@needs_native
@pytest.mark.parametrize("level", [6, 9, 1])
def test_chunk_loop_matrix_matches_jax(level):
    pays = _payloads()
    streams = [zlib.compress(p, level) for p in pays]
    ts = _check_against_jax(_pack(streams, 1, 8192), len(pays), pays)
    assert (ts[: len(pays)] == OK).all()


@needs_native
def test_chunk_loop_block_types_match_jax():
    streams, zflag, caps = _matrix()
    pays = _payloads()
    want = pays + [pays[0], pays[1], pays[4], None, None, None] + [None] * 3 \
        + [_many_blocks_payload()]
    ts = _check_against_jax(_pack(streams, zflag, caps), len(streams), want)
    assert ts.tolist() == [OK, OK, EFULL, OK, OK, OK, OK, OK, OK, ERR,
                           UNF, EFULL, ERR, ERR, ERR, OK]


@needs_native
def test_chunk_loop_bad_tables_are_err_in_both_packages():
    streams = _bad_table_streams()
    packed = _pack(streams, 0, 8192)
    ts = _check_against_jax(packed, 3, [None] * 3)
    assert ts[:3].tolist() == [ERR] * 3
    tt, tc = decode_cu.decode_tokens(*packed, T=T, K=32, device="cpu")
    # each stops where its build fails: after the code-length code's own
    # lengths, and after the literal and distance lengths
    assert tc["state"].numpy()[:3].tolist() == [tib.S_ERR] * 3
    assert tc["bitpos"].numpy()[0] == 3 + 14 + 19 * 3
    assert (tc["dst_pos"].numpy()[:3] == 0).all()


@needs_native
def test_chunk_loop_dictionary_matches_jax():
    d = b"a shared preset dictionary: hello world, the quick brown fox " * 4
    pays = [b"hello world, the quick brown fox jumps " * 30,
            b"the quick brown fox" + bytes(range(200))]
    streams = []
    for p in pays:
        co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_DEFAULT_STRATEGY,
                              zdict=d)
        streams.append(co.compress(p) + co.flush())
    ts = _check_against_jax(_pack(streams, 1, 8192), 2, pays, dictionary=d,
                            has_dict=True, dict_len=pack_dictionary(d)[1])
    assert ts[:2].tolist() == [OK, OK]


def test_numpy_words_default_to_the_card():
    """Like every other entry point, the decode runs on CUDA unless the
    caller names the CPU: here, without a card, that raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    packed = _pack([zlib.compress(b"abc")], 1, 64, n=1, w=16)
    with pytest.raises((RuntimeError, AssertionError)):
        decode_cu.decode_tokens(*packed, T=T)
    tok, c = decode_cu.decode_tokens(*packed, T=T, device="cpu")
    assert c["status"].tolist() == [OK]


def test_words_rows_are_padded_to_16_bytes():
    for w in (13, 14, 15, 16):
        seen = []

        def chunk(st_pk, lens, words, *a, **k):
            seen.append(words.shape[1])
            return decode_cu.decode_chunk_ref(st_pk, lens, words, *a, **k)
        packed = _pack([zlib.compress(b"abc")], 1, 64, n=1, w=w)
        decode_cu.decode_tokens(*packed, T=64, device="cpu", _chunk=chunk)
        assert seen[0] % 4 == 0 and seen[0] >= w + decode_cu.PAD_WORDS


# ---------------------------------------------------------------------------
# the kernel source's per-lane code, built for the host
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    return ctypes.CDLL(build(tmp_path_factory.mktemp("decode_stream_host")))


def test_host_build_of_the_kernel_equals_the_chunk_loop(host_kernels,
                                                        monkeypatch,
                                                        loop_runs):
    packed = _pack(*_matrix())
    got = _until_done(_host_stream(host_kernels, monkeypatch), packed)
    assert decode_cu.compare_decodes(got, loop_runs[128]) == 0
    assert len(got[0]) == 1              # one call: no lane ever waited
    st = got[1]["stream_stats"]
    assert st["tok_rows"] == got[0][0][1] > 0 and st["builds"] >= 30
    assert st["tokens"] == int((got[0][0][0][: st["tok_rows"]] != 0).sum())


@pytest.mark.parametrize("threads", [1, 3, 32])
def test_host_build_efull_resume_equals_the_chunk_loop(host_kernels,
                                                       monkeypatch, threads,
                                                       loop_resumed):
    packed = _pack(*_matrix())
    got = _until_done(_host_stream(host_kernels, monkeypatch, threads),
                      packed, new_cap=8192)
    assert decode_cu.compare_decodes(got, loop_resumed) == 0
    assert (got[1]["status"].numpy()[[2, 11]] == OK).all()


@pytest.mark.parametrize("budget", [16, 40, 90])
def test_host_build_budget_cuts_resume_to_the_same_end(host_kernels,
                                                       monkeypatch, budget):
    """A lane cut by its step budget anywhere (in a header, waiting for a
    build, mid-block) keeps status 127 and resumes from its carry."""
    packed = _pack(*_matrix())
    decode = _host_stream(host_kernels, monkeypatch)
    one = _until_done(decode, packed)
    cut = _until_done(lambda *a, **k: decode(*a, T=budget, K=budget // 2, **k),
                      packed, max_calls=200)
    assert len(cut[0]) > 2
    assert decode_cu.compare_decodes(cut, one) == 0


def test_host_build_resumes_a_chunk_loop_carry_and_back(host_kernels,
                                                        monkeypatch,
                                                        loop_runs):
    """The two routes hand each other a carry mid-stream: lanes parked in
    S_WAIT by the chunk loop build in the kernel, and lanes the kernel
    left mid-block finish in the chunk loop."""
    packed = _pack(*_matrix())
    decode = _host_stream(host_kernels, monkeypatch)
    want = loop_runs[128]

    t1, c1 = decode_cu.decode_tokens(*packed, T=64, K=32, device="cpu")
    assert ((c1["state"] == tib.S_WAIT) & (c1["need_build"] > 0)).any()
    rest = _until_done(lambda *a, carry=None, **k: decode(
        *a, carry=c1 if carry is None else carry, **k), packed)
    got = ([(t1, c1["tok_rows"])] + rest[0], rest[1])
    assert decode_cu.compare_decodes(got, want) == 0

    t1, c1 = decode(*packed, T=60, K=30)
    assert (c1["status"] == tib.STATUS_RUNNING).any()
    rest = _until_done(lambda *a, carry=None, **k: _loop(128)(
        *a, carry=c1 if carry is None else carry, **k), packed)
    got = ([(t1, c1["tok_rows"])] + rest[0], rest[1])
    assert decode_cu.compare_decodes(got, want) == 0


def test_host_build_feeds_resume_like_the_chunk_loop(host_kernels,
                                                     monkeypatch):
    """Input arriving in pieces: UNFINISHED lanes revive and go on."""
    streams, zflag, caps = _matrix()
    decode = _host_stream(host_kernels, monkeypatch)
    runs = []
    for fn in (decode, _loop(128)):
        parts, carry = [], None
        for frac in (0.3, 0.6, 1.0):
            cut = [s[: max(1, int(len(s) * frac))] for s in streams]
            packed = _pack(cut, zflag, caps)
            if carry is not None:
                carry = tib.revive_carry(carry)
            for _ in range(12):
                tok, carry = fn(*packed, carry=carry)
                parts.append((tok, carry["tok_rows"]))
                if not (carry["status"] == tib.STATUS_RUNNING).any():
                    break
        runs.append((parts, carry))
    assert decode_cu.compare_decodes(*runs) == 0
    assert runs[0][1]["status"].numpy()[:9].tolist() == [
        OK, OK, EFULL, OK, OK, OK, OK, OK, OK]


def test_host_build_dictionary_and_odd_row_lengths(host_kernels, monkeypatch):
    d = b"a shared preset dictionary: hello world, the quick brown fox " * 4
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_DEFAULT_STRATEGY,
                          zdict=d)
    zs = [co.compress(b"hello world, the quick brown fox jumps " * 30)
          + co.flush()] + [zlib.compress(p) for p in _payloads()[:2]]
    kw = dict(has_dict=True, dict_len=pack_dictionary(d)[1])
    decode = _host_stream(host_kernels, monkeypatch)
    for n, w in ((3, 300), (1, 301), (3, 302), (2, 303)):
        packed = _pack(zs[:n], 1, 8192, n=n, w=w)
        got = _until_done(decode, packed, **kw)
        want = _until_done(_loop(128), packed, **kw)
        assert decode_cu.compare_decodes(got, want) == 0
        assert (got[1]["status"] == OK).all()


def test_host_build_codes_longer_than_the_lookup_tables(host_kernels,
                                                        monkeypatch):
    """Skewed symbol frequencies give literal codes of up to 15 bits and
    distance codes past 8: the lookup tables miss and the boundary-sum
    decode over the carry's rows answers."""
    rng = np.random.default_rng(17)
    pays = []
    for spread in (0.06, 0.12):
        p = np.exp(-spread * np.arange(256))
        lits = rng.choice(256, 6000, p=p / p.sum()).astype(np.uint8)
        far = rng.integers(0, 256, 9000, dtype=np.uint8)
        pays.append(lits.tobytes() + far.tobytes() + far[::-1].tobytes()[:500]
                    + lits.tobytes()[:900])
    packed = _pack([zlib.compress(p, 9) for p in pays], 1, 32768, n=2,
                   w=5000)
    decode = _host_stream(host_kernels, monkeypatch)
    big = dict(T=40000)
    got = _until_done(lambda *a, **k: decode(*a, **big, **k), packed)
    want = _until_done(lambda *a, **k: decode_cu.decode_tokens(
        *a, T=40000, K=512, device="cpu", **k), packed)
    assert decode_cu.compare_decodes(got, want) == 0
    assert (got[1]["status"] == OK).all()
    assert (got[1]["maxlen"][:, 1] > 10).all()
    assert got[1]["dst_pos"].tolist() == [len(p) for p in pays]


@pytest.mark.parametrize("trim", [0, 1, 2])
def test_host_build_of_the_chunk_kernel_is_the_twin_bit_for_bit(host_kernels,
                                                                trim):
    """decode_chunk's lane code against decode_chunk_ref: every token slot,
    state row and lens word of every chunk of a decode; with ``trim`` the
    rows are no multiple of 16 bytes and are read word by word."""
    packed = _pack(*_matrix())
    calls = []

    def chunk(st_pk, lens, words, bound, adjoff, maxlen, syms, tok, *, K,
              has_dict):
        words = words[:, : words.shape[1] - trim].contiguous()
        ref = [t.clone() for t in (st_pk, lens)]
        rtok = torch.empty_like(tok)
        decode_cu.decode_chunk_ref(ref[0], ref[1], words, bound, adjoff,
                                   maxlen, syms, rtok, K=K, has_dict=has_dict)
        out = torch.empty(tok.shape, dtype=torch.int32)
        host_kernels.decode_chunk_host(
            _ptr(st_pk), _ptr(lens), _ptr(words), ctypes.c_int(words.shape[1]),
            ctypes.c_int(int(words.shape[0] != st_pk.shape[1])), _ptr(bound), _ptr(adjoff), _ptr(maxlen), _ptr(syms), _ptr(out),
            ctypes.c_int(st_pk.shape[1]), ctypes.c_int(K),
            ctypes.c_int(int(has_dict)))
        tok.copy_(out)
        calls.append(all(torch.equal(x, y) for x, y in
                         ((out, rtok), (st_pk, ref[0]), (lens, ref[1]))))

    decode_cu.decode_tokens(*packed, T=T, K=48, device="cpu", _chunk=chunk)
    assert len(calls) >= 5 and all(calls)


def _lane_build(lib, kind, lengths, hlit=None, hdist=None):
    """One stream-kernel launch of one step for lanes parked in S_WAIT:
    returns the carry after their builds."""
    n = lengths.shape[0]
    st = tib._init_scan_state(n, "cpu")
    ck = tib._init_chunk_state(n, "cpu")
    st["state"].fill_(tib.S_WAIT)
    if kind == 0:
        st["need_build"].fill_(1)
        v = torch.from_numpy(lengths.astype(np.int64))
        st["cl_lo"] = sum(v[:, j] << (3 * j) for j in range(10))
        st["cl_hi"] = sum(v[:, j] << (3 * (j - 10)) for j in range(10, 19))
    else:
        st["need_build"].fill_(2)
        st["hlit"] = torch.from_numpy(hlit.astype(np.int32))
        st["hdist"] = torch.from_numpy(hdist.astype(np.int32))
        v = torch.from_numpy(lengths.astype(np.int64))       # [n, 320]
        st["lens_pk"] = sum(v[:, j::8] << (4 * j) for j in range(8)).T
    full = lambda x: torch.full((n,), x, dtype=torch.int32)
    st_pk, lens = decode_cu._pack_state(st, full(0), full(64), full(1 << 30),
                                        full(0), full(0))
    own = lambda t: t.to(torch.int32).clone()
    count, first, offs, maxlen = (own(ck[k]) for k in
                                  ("count", "first", "offs", "maxlen"))
    syms = u32_to_i32(ck["syms"]).contiguous()
    tok = torch.zeros((2, n), dtype=torch.int32)
    meta = torch.zeros(decode_cu.META_WORDS, dtype=torch.int64)
    words = torch.zeros((n, 16), dtype=torch.int32)
    order = torch.arange(n - 1, -1, -1, dtype=torch.int32)
    lib.decode_stream_host(
        _ptr(st_pk), _ptr(lens), _ptr(count), _ptr(first), _ptr(offs),
        _ptr(maxlen), _ptr(syms), _ptr(words), ctypes.c_int(16),
        ctypes.c_int(0), _ptr(tok),
        _ptr(meta, torch.int64), _ptr(order), ctypes.c_int(n), ctypes.c_int(1),
        ctypes.c_int(0),
        ctypes.c_int(8))
    out = decode_cu._state_from_rows(st_pk, lens)
    out.update(count=count, first=first, offs=offs, maxlen=maxlen,
               syms=i32_to_u32(syms))
    return out, st, ck


@pytest.mark.parametrize("kind", [0, 1])
def test_host_build_tables_match_build_canonical(host_kernels, kind):
    """The kernel's per-lane build against the batched plain builds (which
    stand on ops/tables.build_canonical), on random, complete, empty,
    oversubscribed and EOB-less length sets."""
    rng = np.random.default_rng(11 + kind)
    n = 40
    if kind == 0:
        lengths = rng.integers(0, 8, (n, 19))
        lengths[n // 2:] *= rng.random((n - n // 2, 19)) < 0.3
        lengths[0] = 0
        lengths[1] = 1                   # oversubscribed
        lengths[2] = [3] * 8 + [0] * 11  # complete
        got, st, ck = _lane_build(host_kernels, 0, lengths)
        wck, wst = tib._build_cl(ck, st)
    else:
        hlit = rng.integers(257, 287, n)
        hdist = rng.integers(1, 31, n)
        hdist[3] = 5
        lengths = np.zeros((n, 320), np.int64)
        for i in range(n):
            k = hlit[i] + hdist[i]
            if i < n // 2:               # long codes: never oversubscribed
                lengths[i, :k] = rng.integers(9, 16, k) * (rng.random(k) < .9)
                lengths[i, 256] = 10
            else:                        # anything, mostly oversubscribed
                top = int(rng.integers(2, 16))
                lengths[i, :k] = rng.integers(0, top, k) * (rng.random(k) < .7)
        lengths[0, : hlit[0]] = 9        # under-full: fine
        lengths[1, :4] = 1               # oversubscribed literals
        lengths[2, 256] = 0              # no end-of-block code
        lengths[3, hlit[3]: hlit[3] + 3] = 1   # oversubscribed distances
        lengths[4, hlit[4] + hdist[4]:] = 5    # stale lengths past the end
        got, st, ck = _lane_build(host_kernels, 1, lengths, hlit, hdist)
        wck, wst = tib._build_litdist(ck, st)
    wst = dict(wst, need_build=torch.zeros_like(wst["need_build"]))
    for key in ("state", "status", "idx", "prev", "need_build", "lens_pk"):
        assert torch.equal(got[key].long(), wst[key].long()), key
    for key in tib.CHUNK_KEYS:
        assert torch.equal(got[key].long(), wck[key].long()), key
    states = set(got["state"].tolist())
    assert tib.S_ERR in states and len(states) == 2
    # and the sorted-symbol bank is build_canonical's own order
    if kind == 0:
        _, _, _, order, _ = ttables.build_canonical(
            torch.from_numpy(lengths))
        packed = ttables.pack_syms(order, 24)
        assert torch.equal(got["syms"][:, :8], packed)


def test_host_build_fixed_tables_match_the_plain_build(host_kernels,
                                                       monkeypatch):
    n = 3
    st = tib._init_scan_state(n, "cpu")
    st["need_build"].fill_(3)
    wck, _ = tib._build_fixed(tib._init_chunk_state(n, "cpu"), st)
    w = BitWriter()
    w.bits(1, 1).bits(1, 2)              # BFINAL, BTYPE=1
    packed = _pack([w.getvalue() + b"\0" * 4] * n, 0, 64, n=n, w=16)
    # two steps: the block header, then the build
    _, c = _host_stream(host_kernels, monkeypatch)(*packed, T=4, K=2)
    assert c["state"].tolist() == [tib.S_SYM] * n
    assert c["bitpos"].tolist() == [3] * n
    assert c["status"].tolist() == [tib.STATUS_RUNNING] * n
    for key in ("count", "first", "offs", "maxlen"):
        assert torch.equal(c[key][:, 1:].long(), wck[key][:, 1:].long()), key
    assert torch.equal(c["syms"][:, 8:], wck["syms"][:, 8:])


# ---------------------------------------------------------------------------
# the host build in shared-input mode (runtime/large.py's split decode)
# ---------------------------------------------------------------------------

def _split(raw, seg, mem_level=None, wbits=15, zdict=None):
    """(body, candidates, decode_tokens arguments) of one stream split at
    the block starts the finder sees near every ``seg`` bytes."""
    from defl_tpu_torch.runtime import large

    if mem_level is None:
        comp = zlib.compress(raw, 6)
    else:
        kw = {} if zdict is None else {"zdict": zdict}
        co = zlib.compressobj(6, zlib.DEFLATED, wbits, mem_level, **kw)
        comp = co.compress(raw) + co.flush()
    body = np.frombuffer(comp, np.uint8)[2 if wbits > 0 else 0:]
    cands = large._find_candidates(body, 0, max(1, body.size // seg), 8 * seg)
    return body, cands, large.lane_args(body.size, cands)


def _corpus_bytes(n):
    from defl_tpu_torch.corpus import make_silesia_like

    return b"".join(make_silesia_like(max(n, 65536), 65536))[:n]


def test_host_build_shared_input_equals_the_chunk_loop(host_kernels,
                                                       monkeypatch):
    from defl_tpu_torch.runtime import large

    raw = _corpus_bytes(150_000)
    body, cands, kw = _split(raw, 1024, mem_level=4)
    assert len(cands) > 20
    got = _host_split_decode(host_kernels, monkeypatch, body, kw)
    T = kw.pop("T")
    args = (kw.pop("nbits"), kw.pop("zflag"), kw.pop("cap"))
    want = decode_cu.decode_tokens(body.copy(), *args, T=T, K=128,
                                   dict_len=large.WINDOW, shared_input=True,
                                   device="cpu", **kw)
    assert decode_cu.compare_decodes(got, want) == 0
    assert (got[1]["status"] == OK).all()
    assert got[1]["bitpos"][:-1].tolist() == cands[1:]


def test_host_build_shared_input_at_the_real_segment_size(host_kernels,
                                                          monkeypatch):
    """Lanes of ~24 KiB of zlib level 6 input, as the card gets them: most
    lanes must end on the next one's start (a candidate may be a false
    block start, which costs a serial decode of its segment and no more),
    and the chain must stitch to the stream's bytes."""
    from defl_tpu_torch.runtime import large
    from defl_tpu_torch.runtime import native as tnative

    raw = _corpus_bytes(3 << 20)
    body, cands, kw = _split(raw, large.SEGMENT_BYTES)
    assert len(cands) > 30
    tok, c = _host_split_decode(host_kernels, monkeypatch, body, kw)
    on_seam = c["bitpos"][:-1].numpy() == np.asarray(cands[1:])
    valid = int(((c["status"][:-1] == OK).numpy() & on_seam).sum())
    assert valid >= 0.8 * (len(cands) - 1)
    assert c["status"][-1] == OK and c["final"][-1] == 1
    toks = np.ascontiguousarray(tok[: c["tok_rows"]].numpy().T).view(np.uint32)
    lib = tnative.load()
    out = np.zeros(len(raw) + 64, np.uint8)
    r, total, end_bit = tnative.stitch(
        lib, body, cands,
        (toks, c["dst_pos"].numpy(), c["status"].numpy(), c["final"].numpy(),
         c["bitpos"].numpy().astype(np.int64)), out)
    assert r is tib.Result.OK and out[:total].tobytes() == raw
    # the same chain with no lanes is all serial spans and the same bytes
    out2 = np.zeros(len(raw) + 64, np.uint8)
    r2, total2, end2 = tnative.stitch(lib, body, cands, None, out2)
    assert (r2, total2, end2) == (r, total, end_bit)
    assert out2[:total2].tobytes() == raw


def test_host_build_shared_input_head_lane_and_stored_runs(host_kernels,
                                                           monkeypatch):
    from defl_tpu_torch.runtime import large

    # a match reaching before the stream's start: ERR in the head lane
    raw = _corpus_bytes(40_000)
    zdict = raw[:16384][::-1]
    body, cands, kw = _split(zdict[-600:] + raw, 1024, mem_level=4, wbits=-15,
                             zdict=zdict)
    got = _host_split_decode(host_kernels, monkeypatch, body, kw)
    T = kw.pop("T")
    args = (kw.pop("nbits"), kw.pop("zflag"), kw.pop("cap"))
    want = decode_cu.decode_tokens(body.copy(), *args, T=T, K=128,
                                   dict_len=large.WINDOW, shared_input=True,
                                   device="cpu", **kw)
    assert decode_cu.compare_decodes(got, want) == 0
    assert got[1]["status"][0] == ERR and (got[1]["status"][1:] == OK).all()
    # stored runs: offsets are taken from the lane's own segment start
    raw = _corpus_bytes(70_000)
    stored = np.frombuffer(zlib.compress(raw, 0), np.uint8)[2:]
    first = int.from_bytes(stored[1:3].tobytes(), "little")
    assert 0 < first < len(raw)
    skw = large.lane_args(stored.size, [0, 8 * (5 + first)])
    tok, c = _host_split_decode(host_kernels, monkeypatch, stored, skw)
    assert c["status"].tolist() == [OK, OK]
    assert c["dst_pos"].tolist() == [first, len(raw) - first]
    lane1 = tok[: c["tok_rows"], 1]
    t0 = int(lane1[lane1 != 0][0]) & 0xFFFFFFFF
    assert t0 >> 30 == 3 and t0 & 0x3FFFFF == 5
