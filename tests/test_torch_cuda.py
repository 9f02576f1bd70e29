"""The CUDA kernels against their plain PyTorch versions, on the card: the
decode kernel, the adler32 kernel, and the paths that run them
(``device_inflate`` with either resolver, the streaming session).

Marked ``needs_cuda``: each test skips when ``torch.cuda.is_available()``
is False (decided inside a fixture, never at import).  On a machine with
a card, run ``python -m pytest tests/test_torch_cuda.py -q`` (add
``--noconftest`` where jax is not installed: tests/conftest.py imports
it, and this file needs nothing from it).  Every comparison is exact.
The stream kernel (one launch per ``decode_tokens`` call) is held against
its plain version, the chunk loop, by ``decode_cu.compare_decodes``: the
same end state and tokens per lane, the same tables for a resumable lane.
The chunk kernel and its twin read bits straight from the packed input and
agree slot for slot: tokens, state rows and lens.  A checksum is exact by
nature.
"""

import zlib

import numpy as np
import pytest
import torch

from defl_tpu_torch import DeviceInflateSession, metrics
from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB
from defl_tpu_torch.ops import checksums as ck
from defl_tpu_torch.ops import inflate_batch as ib
from defl_tpu_torch.ops.cuda import checksums_cu, decode_cu
from defl_tpu_torch.ops import resolve as tres
from defl_tpu_torch.ops.resolve import resolve_tokens
from defl_tpu_torch.runtime.pack import pack_dictionary, pack_streams
from defl_tpu_torch.runtime.session import device_inflate, fetch_tokens

pytestmark = pytest.mark.needs_cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


def _matrix():
    rng = np.random.default_rng(7)
    pays = [b"hello hello hello world" * 40, bytes(range(256)) * 16,
            b"\0" * 5000, rng.integers(0, 256, 700, dtype=np.uint8).tobytes(),
            b"ab" * 4000, b"x"]
    raw = zlib.compressobj(6, zlib.DEFLATED, -15)
    streams = [zlib.compress(p, 6) for p in pays] + [
        zlib.compress(pays[0], 0), raw.compress(pays[1]) + raw.flush(),
        b"\x78\x9c\x07\xff\xff\xff", zlib.compress(pays[0])[:-8]]
    zflag = [1] * 7 + [0, 1, 1]
    return streams, zflag


def _assert_same(a, b):
    (ta, ca), (tb, cb) = a, b
    assert ca["tok_rows"] == cb["tok_rows"]
    rows = ca["tok_rows"]
    assert torch.equal(ta[:rows], tb[:rows])
    for k in ca:
        if k != "tok_rows":
            assert torch.equal(ca[k], cb[k]), k


def _until_done(packed, new_cap=None, carry=None, max_calls=40, **kw):
    """decode_tokens until no lane is RUNNING; with ``new_cap``, EFULL
    lanes are then revived once with that capacity and run on.  Returns
    (parts, carry) as compare_decodes takes them."""
    words, nbits, zflag, cap = packed
    cap = torch.as_tensor(cap, dtype=torch.int32, device="cuda")
    kw = {"T": 4096, "device": "cuda", **kw}
    parts = []
    for _ in range(max_calls):
        tok, carry = decode_cu.decode_tokens(words, nbits, zflag, cap,
                                             carry=carry, **kw)
        parts.append((tok, carry["tok_rows"]))
        if not (carry["status"] == ib.STATUS_RUNNING).any():
            if new_cap is None:
                return parts, carry
            cap = torch.full_like(cap, new_cap)
            carry = ib.revive_carry(carry, new_cap=cap)
            new_cap = None
    raise AssertionError("lanes still RUNNING")


def _plain(**kw):
    return dict(_chunk=decode_cu.decode_chunk_ref, K=128, **kw)


def _packed(streams, zflag, caps):
    p = pack_streams(streams, zflag, caps)
    return p.words, p.nbits, p.zflag, p.dst_cap


@pytest.mark.parametrize("K", [8, 32, 512])
def test_kernel_matches_twin_full_decode(K):
    """The chunk kernel in the chunk loop against the twin in the same
    loop, slot for slot."""
    streams, zflag = _matrix()
    p = pack_streams(streams, zflag, 8192)
    args = (p.words, p.nbits, p.zflag, p.dst_cap)
    launches = decode_cu.chunk_launches
    a = decode_cu.decode_tokens(*args, T=4096, K=K, device="cuda",
                                _chunk=decode_cu.decode_chunk)
    b = decode_cu.decode_tokens(*args, T=4096, K=K, device="cuda",
                                _chunk=decode_cu.decode_chunk_ref)
    torch.cuda.synchronize()
    assert decode_cu.chunk_launches > launches
    _assert_same(a, b)
    assert (a[1]["status"][:7] == 0).all()


def test_kernel_matches_twin_efull_resume_and_dictionary():
    streams, zflag = _matrix()
    p = pack_streams(streams[:6], 1, [100, 3000, 17, 699, 7999, 1])
    args = (p.words, p.nbits, p.zflag, p.dst_cap)
    runs = []
    for chunk in (decode_cu.decode_chunk, decode_cu.decode_chunk_ref):
        t1, c1 = decode_cu.decode_tokens(*args, T=4096, K=32, device="cuda",
                                         _chunk=chunk)
        cap = torch.full((6,), 8192, dtype=torch.int32, device="cuda")
        t2, c2 = decode_cu.decode_tokens(
            p.words, p.nbits, p.zflag, cap, T=4096, K=32, device="cuda",
            carry=ib.revive_carry(c1, new_cap=cap), _chunk=chunk)
        runs.append(((t1, c1), (t2, c2)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        _assert_same(a, b)
    assert (runs[0][1][1]["status"] == 0).all()

    d, zs = _dict_stream()
    pd = pack_streams(zs, 1, 4096)
    kw = dict(T=4096, K=32, device="cuda", has_dict=True,
              dict_len=pack_dictionary(d)[1])
    dargs = (pd.words, pd.nbits, pd.zflag, pd.dst_cap)
    a = decode_cu.decode_tokens(*dargs, **kw, _chunk=decode_cu.decode_chunk)
    b = decode_cu.decode_tokens(*dargs, **kw,
                                _chunk=decode_cu.decode_chunk_ref)
    _assert_same(a, b)
    assert a[1]["status"][0] == 0


def _dict_stream():
    d = b"a shared preset dictionary: hello world " * 4
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_DEFAULT_STRATEGY,
                          zdict=d)
    return d, [co.compress(b"hello world " * 50) + co.flush()]


# ---- the stream kernel against the chunk loop --------------------------------

def _full_matrix():
    """_matrix plus a fixed block, a lane of many small blocks, bad tables
    left to the CPU tests' hand-made streams, and EFULL capacities."""
    streams, zflag = _matrix()
    rng = np.random.default_rng(5)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(60)]
    text = b" ".join(words[i] for i in rng.integers(0, 60, 900))
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 1)   # a block per 127 symbols
    many = (co.compress(text[:2000]) + co.flush(zlib.Z_SYNC_FLUSH)
            + co.compress(text[2000:]) + co.flush())
    fixed = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FIXED)
    streams = streams + [many, fixed.compress(b"ab" * 4000) + fixed.flush(),
                         zlib.compress(bytes(range(256)) * 16, 9)]
    zflag = zflag + [1, 1, 1]
    caps = [8192] * len(streams)
    caps[2], caps[12] = 1000, 777        # EFULL mid-run and mid-block
    return streams, zflag, caps, text


def test_stream_kernel_equals_the_chunk_loop():
    streams, zflag, caps, text = _full_matrix()
    packed = _packed(streams, zflag, caps)
    launches, chunks = decode_cu.launches, decode_cu.chunk_launches
    got = _until_done(packed)
    assert decode_cu.launches == launches + 1    # one call, one launch
    assert decode_cu.chunk_launches == chunks
    want = _until_done(packed, **_plain())
    assert decode_cu.compare_decodes(got, want) == 0
    st = got[1]["status"].tolist()
    assert st == [0, 0, -105, 0, 0, 0, 0, 0, -1, 2, 0, 0, -105]
    assert got[1]["dst_pos"][10] == len(text)
    stats = got[1]["stream_stats"]
    assert got[0][0][1] == stats["tok_rows"] > 0
    toks = got[0][0][0][: stats["tok_rows"]]
    assert stats["tokens"] == int((toks != 0).sum())


def test_stream_kernel_efull_revive_resume():
    streams, zflag, caps, _ = _full_matrix()
    packed = _packed(streams, zflag, caps)
    got = _until_done(packed, new_cap=8192)
    want = _until_done(packed, new_cap=8192, **_plain())
    assert decode_cu.compare_decodes(got, want) == 0
    assert len(got[0]) == 2
    assert (got[1]["status"][[2, 12]] == 0).all()
    # the same bytes as a decode that never ran full
    once = _until_done(_packed(streams, zflag, 8192))
    for a in (got, once):
        toks = torch.cat([t[:r] for t, r in a[0]])
        a[1]["out"] = resolve_tokens(
            toks, torch.from_numpy(packed[0].view(np.int32)).cuda(),
            a[1]["dst_pos"], C=8192)
    assert torch.equal(got[1]["out"], once[1]["out"])


@pytest.mark.parametrize("budget", [16, 40, 90])
def test_stream_kernel_budget_cut_resumes_to_the_same_end(budget):
    """A lane cut by its step budget anywhere (in a header, before a
    build, mid-block) keeps status 127 and resumes from its carry."""
    streams, zflag, caps, _ = _full_matrix()
    packed = _packed(streams, zflag, caps)
    one = _until_done(packed)
    launches = decode_cu.launches
    cut = _until_done(packed, T=budget, K=budget // 2, max_calls=400)
    assert len(cut[0]) > 2
    assert decode_cu.launches == launches + len(cut[0])
    assert (cut[0][0][1] <= budget)
    assert decode_cu.compare_decodes(cut, one) == 0
    assert decode_cu.compare_decodes(cut, _until_done(packed, **_plain())) == 0


def test_stream_kernel_and_chunk_loop_hand_each_other_a_carry():
    streams, zflag, caps, _ = _full_matrix()
    packed = _packed(streams, zflag, caps)
    want = _until_done(packed)
    t1, c1 = decode_cu.decode_tokens(*packed, T=64, K=32, device="cuda",
                                     _chunk=decode_cu.decode_chunk_ref)
    assert ((c1["state"] == ib.S_WAIT) & (c1["need_build"] > 0)).any()
    rest = _until_done(packed, carry=c1)
    got = ([(t1, c1["tok_rows"])] + rest[0], rest[1])
    assert decode_cu.compare_decodes(got, want) == 0
    t1, c1 = decode_cu.decode_tokens(*packed, T=60, K=30, device="cuda")
    assert (c1["status"] == ib.STATUS_RUNNING).any()
    rest = _until_done(packed, carry=c1, **_plain())
    got = ([(t1, c1["tok_rows"])] + rest[0], rest[1])
    assert decode_cu.compare_decodes(got, want) == 0


def test_stream_kernel_dictionary():
    d, zs = _dict_stream()
    kw = dict(has_dict=True, dict_len=pack_dictionary(d)[1])
    packed = _packed(zs, 1, 4096)
    got = _until_done(packed, **kw)
    assert decode_cu.compare_decodes(got, _until_done(packed, **_plain(**kw))) \
        == 0
    assert got[1]["status"].tolist() == [0]
    # FDICT without a dictionary is an error, as in the reference
    assert _until_done(packed)[1]["status"].tolist() == [-1]


@pytest.mark.parametrize("n,w", [(1, 460), (31, 461), (33, 462), (64, 463)])
def test_stream_kernel_lane_counts_and_row_lengths(n, w):
    """Blocks that are not full, and rows whose length plus the padding is
    no multiple of four words before decode_tokens rounds it up."""
    streams, zflag, caps, _ = _full_matrix()
    pick = [i % len(streams) for i in range(3, 3 + n)]
    p = pack_streams([streams[i] for i in pick], [zflag[i] for i in pick],
                     [caps[i] for i in pick])
    words = np.zeros((n, w), np.uint32)
    words[:, : p.words.shape[1]] = p.words
    assert (w + decode_cu.PAD_WORDS) % 4 != 0 or w == 460
    packed = (words, p.nbits, p.zflag, p.dst_cap)
    got = _until_done(packed)
    assert decode_cu.compare_decodes(got, _until_done(packed, **_plain())) == 0


@pytest.mark.parametrize("threads,lanes_per_warp",
                         [(32, 32), (32, 1), (64, 16), (256, 4)])
def test_stream_kernel_launch_shapes_agree(threads, lanes_per_warp,
                                           monkeypatch):
    """Any block size and share of each warp's threads that own a lane
    gives the same decode; above 48 KB a block's shared memory is dynamic
    and opted into (the default shape, 32 lanes a block, is)."""
    streams, zflag, caps, _ = _full_matrix()
    packed = _packed(streams * 11, zflag * 11, caps * 11)
    want = _until_done(packed)
    monkeypatch.setattr(decode_cu, "STREAM_THREADS", threads)
    monkeypatch.setattr(decode_cu, "STREAM_LANES_PER_WARP", lanes_per_warp)
    assert decode_cu.compare_decodes(_until_done(packed), want) == 0


def test_stream_kernel_refused_launch_raises(monkeypatch):
    """1024 threads a block (256 lanes) would need over 900 KB of shared
    memory: the card refuses, and the wrapper raises instead of taking
    another route."""
    streams, zflag, caps, _ = _full_matrix()
    launches = decode_cu.launches
    with monkeypatch.context() as m:
        m.setattr(decode_cu, "STREAM_THREADS", 1024)
        with pytest.raises(RuntimeError, match="launch failed"):
            decode_cu.decode_tokens(*_packed(streams, zflag, caps), T=4096,
                                    device="cuda")
    assert decode_cu.launches == launches
    torch.cuda.synchronize()
    assert _until_done(_packed(streams, zflag, caps))[1]["status"][0] == 0


def test_cuda_decode_is_one_launch_one_sync_and_no_plain_code(monkeypatch):
    """On CUDA tensors decode_tokens never reaches the chunk loop's parts
    nor the twin, launches once and reads the card once."""
    def boom(name):
        def f(*a, **k):
            raise AssertionError(f"{name} ran for CUDA tensors")
        return f

    for mod, name in ((ib, "_chunk_gate"), (ib, "_apply_builds"),
                      (decode_cu, "_kernel_inputs"),
                      (decode_cu, "_unpack_state"),
                      (decode_cu, "decode_chunk_ref"),
                      (decode_cu, "decode_chunk"),
                      (ib, "_build_cl"), (ib, "_build_litdist"),
                      (ib, "_build_fixed")):
        monkeypatch.setattr(mod, name, boom(name))
    streams, zflag, caps, _ = _full_matrix()
    p = pack_streams(streams, zflag, caps)
    args = [torch.from_numpy(a).cuda() for a in
            (p.words.view(np.int32), p.nbits, p.zflag, p.dst_cap)]
    decode_cu.decode_tokens(*args, T=4096)   # warm: build, fixed tables
    reads = []
    real = decode_cu._read_meta

    def read(meta):
        torch.cuda.set_sync_debug_mode("default")
        try:
            reads.append(1)
            return real(meta)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(decode_cu, "_read_meta", read)
    launches = decode_cu.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")   # any other sync raises
    try:
        tok, c = decode_cu.decode_tokens(*args, T=4096)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert decode_cu.launches == launches + 1
    assert reads == [1]
    assert c["status"].tolist()[:2] == [0, 0]


def _chunk_inputs(device="cuda", n=300, w=64):
    rng = np.random.default_rng(1)
    st = torch.zeros((decode_cu.NROWS, n), dtype=torch.int32)
    st[decode_cu.R_STATUS] = ib.STATUS_RUNNING
    st[decode_cu.R_STATE] = ib.S_BHDR
    st[decode_cu.R_NBITS] = 32 * (w - 8)
    st[decode_cu.R_CAP] = 4096
    st[decode_cu.R_LIMIT] = 1 << 30
    words = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (n, w),
                                          dtype=np.int64).astype(np.int32))
    z = lambda r: torch.zeros((r, n), dtype=torch.int32)
    return [t.to(device) for t in (st, z(40), words, z(48), z(48), z(3) + 15,
                                   z(116))]


def test_cuda_call_never_reaches_the_twin(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the twin ran for CUDA tensors")

    monkeypatch.setattr(decode_cu, "decode_chunk_ref", boom)
    a = _chunk_inputs()
    launches = decode_cu.chunk_launches
    tok, st, _ = decode_cu.decode_chunk(*a, K=16)
    torch.cuda.synchronize()
    assert decode_cu.chunk_launches == launches + 1
    assert tok.is_cuda and tok.shape == (32, 300)


@pytest.mark.parametrize("fault", ["cpu_mix", "dtype", "noncontig"])
def test_wrapper_refuses(fault):
    a = _chunk_inputs()
    if fault == "cpu_mix":
        a[3] = a[3].cpu()
    elif fault == "dtype":
        a[2] = a[2].to(torch.int64)
    else:
        a[2] = torch.zeros((64, 300), dtype=torch.int32, device="cuda").T
    launches = decode_cu.chunk_launches
    with pytest.raises((TypeError, ValueError)):
        decode_cu.decode_chunk(*a, K=16)
    assert decode_cu.chunk_launches == launches


def test_fetches_do_not_share_a_host_buffer():
    """A later fetch never overwrites the tokens an earlier one returned
    (the resolver reads them after the call)."""
    a = torch.arange(64 * 300, dtype=torch.int32, device="cuda")
    first = fetch_tokens([(a.view(64, 300), 40)])
    keep = first.copy()
    second = fetch_tokens([((-a).view(64, 300), 40)])
    assert np.array_equal(first, keep)
    assert first.shape == second.shape == (300, 40)
    assert np.array_equal(first.view(np.int32), a.view(64, 300)[:40].T.cpu())


def test_concurrent_device_inflate_on_the_card():
    """Threads decoding different batches at once each get their own
    bytes, byte for byte, with every lane OK."""
    from concurrent.futures import ThreadPoolExecutor

    from defl_tpu_torch import Result

    rng = np.random.default_rng(11)
    pays = [[rng.integers(0, 4, 2000 + 90 * i, np.uint8).tobytes()
             for i in range(64)] for _ in range(4)]   # all within the cap
    batches = [[zlib.compress(p, 6) for p in ps] for ps in pays]
    with ThreadPoolExecutor(max_workers=len(batches)) as ex:
        futs = [ex.submit(device_inflate, b, dst_capacities=8192)
                for b in batches]
        got = [f.result()[:2] for f in futs]
    assert [r for r, _ in got] == [[Result.OK] * 64] * len(batches)
    assert [o for _, o in got] == pays


# ---- the adler32 kernel ------------------------------------------------------

def _adler_matrix(C):
    g = torch.Generator().manual_seed(C)
    lens = [0, 1, 2, 15, 16, 17, 3071, 3072, 3073, C - 1, C, C + 9, C, C // 2]
    data = torch.randint(0, 256, (len(lens), C), dtype=torch.uint8,
                         generator=g)
    data[-2:] = 0xFF
    return data, torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("C", [6144, 6001, 5, 70001])
@pytest.mark.parametrize("sliced", [False, True])
def test_adler32_kernel_matches_plain_version_and_zlib(C, sliced):
    data, lens = _adler_matrix(C)
    dev = data.cuda()
    if sliced:      # rows inside a wider buffer: unaligned, strided
        wide = torch.zeros((data.shape[0], C + 67), dtype=torch.uint8,
                           device="cuda")
        wide[:, 3:3 + C] = dev
        dev = wide[:, 3:3 + C]
    launches = checksums_cu.launches
    got = ck.adler32_batch(dev, lens.cuda())
    assert checksums_cu.launches == launches + 1
    ref = ck.adler32_batch_ref(dev, lens.cuda())
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and torch.equal(got, ref)
    host = data.numpy()
    want = [zlib.adler32(host[i, : min(max(int(n), 0), C)].tobytes())
            for i, n in enumerate(lens)]
    assert got.cpu().tolist() == want


def test_adler32_cuda_call_never_reaches_the_plain_version(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version ran for CUDA tensors")

    monkeypatch.setattr(ck, "adler32_batch_ref", boom)
    data, lens = _adler_matrix(6144)
    got = ck.adler32_batch(data.cuda(), lens.cuda())
    assert int(got[0]) == 1


@pytest.mark.parametrize("fault", ["dtype", "lengths_dtype", "lengths_shape",
                                   "column_stride"])
def test_adler32_wrapper_refuses(fault):
    data = torch.zeros((4, 64), dtype=torch.uint8, device="cuda")
    lens = torch.zeros(4, dtype=torch.int32, device="cuda")
    if fault == "dtype":
        data = data.to(torch.int8)
    elif fault == "lengths_dtype":
        lens = lens.long()
    elif fault == "lengths_shape":
        lens = lens[:3]
    else:
        data = torch.zeros((4, 128), dtype=torch.uint8,
                           device="cuda")[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        checksums_cu.adler32_batch_cuda(data, lens)


def test_adler32_launches_on_the_current_stream():
    """No sync inside and no default-stream launch: on a side stream the
    result is still right after that stream is waited for."""
    data, lens = _adler_matrix(70001)
    want = ck.adler32_batch_ref(data, lens)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        d, n = data.cuda(), lens.cuda()
        got = ck.adler32_batch(d, n)
    side.synchronize()
    assert got.cpu().tolist() == want.tolist()


# ---- the device-resident inflate and the session ---------------------------

def _payload_batch(n=48):
    rng = np.random.default_rng(21)
    pays = []
    for i in range(n):
        unit = rng.integers(0, 256, 1 + (i * 7) % 300, dtype=np.uint8)
        noise = rng.integers(0, 256, 200 + 13 * i, dtype=np.uint8)
        pays.append((unit.tobytes() * 20 + noise.tobytes())[:6000])
    return pays, [zlib.compress(p, 6 if i % 5 else 0)
                  for i, p in enumerate(pays)]


def test_resolve_tokens_on_the_card_matches_the_cpu(monkeypatch):
    pays, zs = _payload_batch()
    p = pack_streams(zs, 1, 8192)
    tok, c = decode_cu.decode_tokens(p.words, p.nbits, p.zflag, p.dst_cap,
                                     T=8192, device="cuda")
    toks = tok[: c["tok_rows"]]
    words = torch.from_numpy(p.words.view(np.int32)).cuda()
    monkeypatch.setattr(tres, "SLAB_ELEMS", 5 * 8193)   # ten slabs
    got = resolve_tokens(toks, words, c["dst_pos"], C=8192)
    monkeypatch.undo()
    want = resolve_tokens(toks.cpu(), words.cpu(), c["dst_pos"].cpu(), C=8192)
    assert torch.equal(got.cpu(), want)
    dst = c["dst_pos"].cpu().numpy()
    assert [want[i, : dst[i]].numpy().tobytes()
            for i in range(len(pays))] == pays


def test_device_inflate_device_resolve_on_the_card():
    pays, zs = _payload_batch()
    flags = FLAG_ZLIB | FLAG_VERIFY_ADLER32
    zs[3] = zs[3][:-1] + bytes([zs[3][-1] ^ 1])     # corrupted trailer
    zs[9] = zs[9][:-3]                              # cut trailer
    metrics.reset()
    res, outs, st = device_inflate(zs, flags, dst_capacities=8192,
                                   resolve="device")
    want = [0] * len(pays)
    want[3], want[9] = -1, 2
    assert [int(r) for r in res] == want
    assert outs == pays
    assert st["decode_chunk_launches"] > 0
    assert st["adler32_batch_launches"] == 1
    assert "token_fetch_bytes" not in metrics.snapshot()
    cpu = device_inflate(zs, flags, dst_capacities=8192, resolve="device",
                         device="cpu")
    host = device_inflate(zs, flags, dst_capacities=8192)
    for other in (cpu, host):
        assert (other[0], other[1]) == (res, outs)
        np.testing.assert_array_equal(other[2]["bitpos"], st["bitpos"])


@pytest.mark.parametrize("resolve", ["host", "device"])
def test_session_on_the_card(resolve):
    pays, zs = _payload_batch(16)
    sess = DeviceInflateSession(16, 2048, resolve=resolve)
    twin = DeviceInflateSession(16, 2048, resolve=resolve, device="cpu")
    top = max(len(z) for z in zs)
    for lo in range(0, top, 301):
        chunk = [z[lo: lo + 301] for z in zs]
        res = sess.feed(chunk)
        assert res == twin.feed(chunk)
    assert -105 in res and set(res) <= {-105, 0}
    for s in (sess, twin):
        s.resize_output(8192)
    res = sess.feed([b""] * 16)
    assert res == twin.feed([b""] * 16) and set(res) == {0}
    assert sess.outputs()[1] == pays == twin.outputs()[1]
    assert [sess.input_pos(i) for i in range(16)] == \
        [len(z) - 4 for z in zs]


def test_bench_batch_longest_lanes_equal_the_chunk_loop():
    """The bench corpus's lanes that take the most steps (literal-heavy:
    about 19,000 steps and 38,000 token rows), out of one launch over 256
    lanes of the corpus, against the chunk loop.  The smoke run holds the
    shorter half of the batch's lanes; the plain version lasts as long as
    its longest lane, so the longest are held here."""
    from defl_tpu_torch.breakdown import lane_rows
    from defl_tpu_torch.corpus import make_silesia_like

    n, block = 256, 65536
    pays = make_silesia_like(n * block, block)[:n]
    cache = {}
    zs = [cache.setdefault(id(p), zlib.compress(p, 6)) for p in pays]
    p = pack_streams(zs, 1, block)
    up = lambda a: torch.from_numpy(a).cuda()
    args = (up(p.words.view(np.int32)), up(p.nbits), up(p.zflag),
            up(p.dst_cap))
    T = ib.step_budget(block)
    tok, carry = decode_cu.decode_tokens(*args, T=T)
    assert (carry["status"] == 0).all()
    used = lane_rows(tok, carry["tok_rows"])
    pick = torch.argsort(used)[-3:]
    assert int(used[pick[-1]]) > 35_000
    sub = [a[pick] for a in args]
    parts, pc = [], None
    for _ in range(4):
        ptok, pc = decode_cu.decode_tokens(*sub, T=T, carry=pc, **_plain())
        parts.append((ptok, pc["tok_rows"]))
        if not (pc["status"] == ib.STATUS_RUNNING).any():
            break
    got = decode_cu.select_lanes((tok, carry), pick)
    assert decode_cu.compare_decodes(got, (parts, pc)) == 0


# ---- the split decode of one huge stream (shared-input mode) ---------------

def _split_stream(n_bytes=600_000, seg=2048, level_mem=4):
    """A stream of small blocks, its body, the candidate block starts at a
    small segment size, and decode_tokens' arguments for them."""
    from defl_tpu_torch.corpus import make_silesia_like
    from defl_tpu_torch.runtime import large

    raw = b"".join(make_silesia_like(max(n_bytes, 65536), 65536))[:n_bytes]
    co = zlib.compressobj(6, zlib.DEFLATED, 15, level_mem)
    comp = co.compress(raw) + co.flush()
    body = np.frombuffer(comp, np.uint8)[2:]
    cands = large._find_candidates(body, 0, body.size // seg, 8 * seg)
    kw = large.lane_args(body.size, cands)
    args = (kw.pop("nbits"), kw.pop("zflag"), kw.pop("cap"))
    kw.update(dict_len=large.WINDOW, shared_input=True)
    words = torch.from_numpy(decode_cu.pad_body(body)).view(torch.int32)
    return raw, comp, body, cands, words.cuda(), args, kw


def test_shared_input_stream_kernel_equals_the_chunk_loop():
    raw, comp, body, cands, words, args, kw = _split_stream()
    assert len(cands) > 50
    launches = decode_cu.launches
    got = decode_cu.decode_tokens(words, *args, **kw)
    torch.cuda.synchronize()
    assert decode_cu.launches == launches + 1
    want = decode_cu.decode_tokens(words, *args, **kw, **_plain())
    assert decode_cu.compare_decodes(got, want) == 0
    st = got[1]
    assert (st["status"] == 0).all()
    assert st["bitpos"][:-1].tolist() == cands[1:]
    # the tokens stitch to the stream's bytes with every lane valid
    from defl_tpu_torch.runtime import native

    toks = fetch_tokens([(got[0], st["tok_rows"])])
    out = np.zeros(len(raw) + 64, np.uint8)
    meta = [st[k].cpu().numpy() for k in ("dst_pos", "status", "final")]
    r, total, _ = native.stitch(native.load(), body, cands,
                                (toks, *meta,
                                 st["bitpos"].cpu().numpy().astype(np.int64)),
                                out)
    assert int(r) == 0 and out[:total].tobytes() == raw


def test_shared_input_chunk_kernel_matches_twin_slot_for_slot():
    raw, comp, body, cands, words, args, kw = _split_stream(200_000)
    a = decode_cu.decode_tokens(words, *args, K=64, **kw,
                                _chunk=decode_cu.decode_chunk)
    b = decode_cu.decode_tokens(words, *args, K=64, **kw,
                                _chunk=decode_cu.decode_chunk_ref)
    torch.cuda.synchronize()
    _assert_same(a, b)
    assert (a[1]["status"] == 0).all()


def test_shared_input_head_lane_has_no_window():
    """Lane 0 starts at the stream's head with a reach of 0: a distance
    before byte 0 is ERR there, in kernel and plain version alike."""
    from defl_tpu_torch.runtime import large

    raw = bytes(range(256)) * 300
    zdict = raw[:16384][::-1]
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 4, zdict=zdict)
    comp = co.compress(zdict[-600:] + raw) + co.flush()
    body = np.frombuffer(comp, np.uint8)
    cands = [0]
    kw = large.lane_args(body.size, cands)
    args = (kw.pop("nbits"), kw.pop("zflag"), kw.pop("cap"))
    kw.update(dict_len=large.WINDOW, shared_input=True)
    words = torch.from_numpy(decode_cu.pad_body(body)).view(torch.int32).cuda()
    got = decode_cu.decode_tokens(words, *args, **kw)
    want = decode_cu.decode_tokens(words, *args, **kw, **_plain())
    assert decode_cu.compare_decodes(got, want) == 0
    assert got[1]["status"].tolist() == [-1]


def test_inflate_large_on_the_card():
    from defl_tpu_torch import Result, inflate_batch, inflate_large
    from defl_tpu_torch.corpus import make_silesia_like

    raw = b"".join(make_silesia_like(8 << 20, 65536))
    comp = zlib.compress(raw, 6)
    st = {}
    launches = decode_cu.launches
    r, out = inflate_large(comp, FLAG_ZLIB | FLAG_VERIFY_ADLER32,
                           use_device=True, stats_out=st)
    assert r is Result.OK and out == raw
    assert st["route"] == "device" and decode_cu.launches == launches + 1
    assert st["lanes"] > 50 and st["lanes_valid"] >= 0.8 * st["lanes"]
    buf = np.zeros(len(raw), np.uint8)
    r, n = inflate_large(comp, out=buf)              # the default route
    assert r is Result.OK and buf[:n].tobytes() == raw
    bad = bytearray(comp)
    bad[-1] ^= 1
    r, _ = inflate_large(bytes(bad), FLAG_ZLIB | FLAG_VERIFY_ADLER32)
    assert r is Result.ERR
    small = zlib.compress(b"small " * 100)
    res, outs = inflate_batch([small, comp], backend="device",
                              dst_capacities=[1024, len(raw)])
    assert res == [Result.OK] * 2 and outs == [b"small " * 100, raw]


# ---- the hybrid encode -------------------------------------------------------

def _encode_payloads(n=96, seed=3):
    from defl_tpu_torch.corpus import make_silesia_like

    rng = np.random.default_rng(seed)
    pays = make_silesia_like(n * 16384, 16384)[:n]
    return pays + [b"", b"x", rng.integers(0, 256, 70000, np.uint8).tobytes(),
                   b"\0" * 50000]


@pytest.mark.parametrize("pack", ["scan", "scatter"])
def test_device_deflate_on_the_card_is_byte_identical(pack):
    from defl_tpu_torch import device_deflate
    from defl_tpu_torch.runtime import native

    pays = _encode_payloads()
    st = {}
    outs = device_deflate(pays, stats_out=st, pack=pack)
    assert outs == native.native_deflate_batch(pays)[1]
    assert st["device_fallbacks"] == []
    assert all(zlib.decompress(o) == p for o, p in zip(outs, pays))
    raw = device_deflate(pays, flags=0, pack=pack)
    assert all(zlib.decompress(o, -15) == p for o, p in zip(raw, pays))


def test_pack_closed_form_equals_the_reservoir_loop_on_the_card():
    from defl_tpu_torch.ops import huffman_pack as hp
    from defl_tpu_torch.runtime import native

    pays = _encode_payloads(8)[:8]
    pays = [p[:1500] for p in pays]
    fields, nf, tb, _, _ = native.native_deflate_fields(pays, F=2048)
    fd = torch.from_numpy(fields.view(np.int32)).cuda()
    nd = torch.from_numpy(nf.astype(np.int32)).cuda()
    got = hp.pack_fields_scan(fd, nd)
    ref = hp.pack_fields_scan_ref(fd, nd)
    cpu = hp.pack_fields_scan(fields, nf)
    for a, b, c in zip(got, ref, cpu):
        assert a.dtype == torch.int32 and a.is_cuda
        assert np.array_equal(hp.to_u32(a), hp.to_u32(b))
        assert np.array_equal(hp.to_u32(a), hp.to_u32(c))
    assert got[2].cpu().tolist() == tb.tolist()


def test_concurrent_device_deflate_on_the_card():
    """Two threads encoding at once: each call has its own field buffer,
    so neither overwrites the other's fields before they are uploaded."""
    from concurrent.futures import ThreadPoolExecutor

    from defl_tpu_torch import device_deflate
    from defl_tpu_torch.runtime import native

    sets = [_encode_payloads(64, seed=1), _encode_payloads(64, seed=2)[::-1]]
    want = [native.native_deflate_batch(s)[1] for s in sets]
    for _ in range(3):
        with ThreadPoolExecutor(max_workers=2) as ex:
            got = list(ex.map(device_deflate, sets))
        assert got == want


# ---- the sharded decode ------------------------------------------------------

def _sharded(devices, **kw):
    from defl_tpu_torch.parallel.mesh import make_stream_mesh
    from defl_tpu_torch.parallel.shard import DistributedCodec

    return DistributedCodec(make_stream_mesh(devices), **kw)


@pytest.mark.parametrize("resolve", ["host", "device"])
def test_sharded_codec_on_one_card_equals_device_inflate(resolve):
    """DistributedCodec over cuda:0 alone: one launch, and what
    device_inflate gives for the same streams, lane for lane."""
    pays, zs = _payload_batch()
    flags = FLAG_ZLIB | FLAG_VERIFY_ADLER32
    codec = _sharded(["cuda:0"], resolve=resolve)
    decode_cu.launches = 0
    res, outs, st = codec.inflate(zs, flags, dst_capacities=8192)
    assert decode_cu.launches == st["decode_launches"] == 1
    r1, o1, s1 = device_inflate(zs, flags, dst_capacities=8192,
                                resolve=resolve)
    assert res == r1 and outs == o1 == pays
    np.testing.assert_array_equal(st["bitpos"], s1["bitpos"])
    assert st["ok_lanes"] == len(pays)
    assert st["total_bytes"] == sum(map(len, pays))
    assert st["host_fallbacks"] == [] and st["reduced_on"] is None
    assert st["shards"] == 1


def test_two_shards_on_one_card_equal_one_shard():
    """["cuda:0", "cuda:0"]: two host threads on one card, one launch
    each; the same lanes as one shard, and the calling thread's current
    device is left as it was."""
    pays, zs = _payload_batch()
    one = _sharded(["cuda:0"]).inflate(zs, dst_capacities=8192)
    current = torch.cuda.current_device()
    decode_cu.launches = 0
    two = _sharded(["cuda:0", "cuda:0"]).inflate(zs, dst_capacities=8192)
    assert decode_cu.launches == two[2]["decode_launches"] == 2
    assert torch.cuda.current_device() == current
    assert two[0] == one[0] and two[1] == one[1] == pays
    for k in ("total_bytes", "ok_lanes"):
        assert two[2][k] == one[2][k], k
    assert two[2]["shards"] == 2
    np.testing.assert_array_equal(two[2]["bitpos"], one[2]["bitpos"])


def test_world_of_one_nccl_group_with_a_dictionary(tmp_path):
    """An NCCL group of one rank: the dictionary goes through the
    broadcast and the stats through the all-reduce, both on the card."""
    import torch.distributed as dist

    from defl_tpu_torch import dryrun
    from defl_tpu_torch.parallel import multihost

    multihost.initialize(f"file://{tmp_path / 'store'}", 1, 0,
                         device="cuda:0", timeout_s=120)
    try:
        assert dist.get_backend() == "nccl"
        codec = _sharded(["cuda:0"], dictionary=dryrun.DICTIONARY)
        assert codec.mesh.grouped
        pays, zs = dryrun.dict_streams(32)
        decode_cu.launches = 0
        res, outs, st = codec.inflate(zs, dst_capacities=512)
        assert [int(r) for r in res] == [0] * 32 and outs == pays
        assert decode_cu.launches == 1
        assert st["reduced_on"] == "cuda:0" and st["ok_lanes"] == 32
        assert st["total_bytes"] == sum(map(len, pays))
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip_on_the_card():
    """dryrun_multichip(1): one spawned NCCL process on cuda:0."""
    from defl_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(1, device="cuda", timeout_s=300)
    assert out["backend"] == "nccl" and out["ok_lanes"] == 2
    assert out["ranks"][0]["launches"] == 1
    assert out["ranks"][0]["reduced_on"] == "cuda:0"


# ---- the bench -------------------------------------------------------------

def test_bench_on_the_card(monkeypatch, capsys):
    """defl_tpu_torch.bench on the card at 64 x 64 KiB, without the
    scaling subprocesses: one line, no error, every ``*_ok`` true, the
    card's name, the decode kernel launched."""
    import json

    from defl_tpu_torch import bench

    for k, v in {"DEFL_BENCH_STREAMS": "64", "DEFL_BENCH_BLOCK": "65536",
                 "DEFL_BENCH_SCALING": "0"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("DEFL_PROFILE_DIR", raising=False)
    assert bench.main([]) == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    assert "error" not in line, line
    for key in ("pipeline_fetch_ok", "large64_ok", "large64_device_ok",
                "encode_ok"):
        assert line[key] is True, key
    assert line["large64_device_route"] == "device"
    assert line["device"] == torch.cuda.get_device_name(0)
    assert line["value"] == line["pipeline_fetch_wall_GBps"] > 0
    assert decode_cu.launches > 0
