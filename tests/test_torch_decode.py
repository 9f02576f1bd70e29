"""The port's chunk loop on the CPU (the kernel's twin) against the JAX
package's lockstep decoder and the host oracle.

The JAX side is ``defl_tpu.ops.inflate_batch.decode_tokens``, the XLA
path: the Pallas kernel cannot execute on the CPU in test time
(tests/test_decode_pl.py:199-212).  Per lane the port must give the same
status and, for every lane that stopped, the same ``dst_pos`` and
``bitpos``; OK lanes must resolve to the payload.  Token slot layouts may
differ (stall timing), so tokens are compared through the resolver.
Every comparison is exact.  Batches are padded to one shape so that the
JAX decoder compiles once per variant.
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from defl_tpu.core.oracle import inflate_oracle
from defl_tpu.errors import Result
from defl_tpu.ops import inflate_batch as jib
from defl_tpu.runtime.native import available, native_resolve_tokens
from defl_tpu.runtime.pack import pack_dictionary, pack_streams
from defl_tpu_torch.ops import inflate_batch as tib
from defl_tpu_torch.ops.cuda import decode_cu

pytestmark = pytest.mark.skipif(not available(),
                                reason="native resolver unavailable")

N, W, T, K = 16, 2304, 4096, 32


def _payloads():
    rng = np.random.default_rng(7)
    return [
        b"hello hello hello world" * 40,
        bytes(range(256)) * 16,
        b"\0" * 5000,                       # RLE: overlapping dist=1
        rng.integers(0, 256, 700, dtype=np.uint8).tobytes(),  # incompressible
        b"ab" * 4000,                        # dist=2 chains
        b"x",                                # one byte
    ]


def _pack(streams, zflag, caps):
    p = pack_streams(streams, zflag, caps)
    n = len(streams)
    words = np.zeros((N, W), np.uint32)
    words[:n, : p.words.shape[1]] = p.words
    pad = lambda a: np.pad(a, (0, N - n))
    return words, pad(p.nbits), pad(p.zflag), pad(p.dst_cap)


def _run_both(words, nbits, zflag, cap, jcarry=None, tcarry=None, **kw):
    jt, jc = jib.decode_tokens(jnp.asarray(words), jnp.asarray(nbits),
                               jnp.asarray(zflag), jnp.asarray(cap), T=T, K=K,
                               carry=jcarry, **kw)
    tt, tc = decode_cu.decode_tokens(words, nbits, zflag, cap, T=T, K=K,
                                     carry=tcarry, device="cpu", **kw)
    return (np.asarray(jt), jc), (tt, tc)


def _host(tokens, rows=None):
    """Token buffer -> lane-major uint32 for the resolver."""
    if torch.is_tensor(tokens):
        return tokens[:rows].T.contiguous().numpy().view(np.uint32)
    return np.ascontiguousarray(tokens.T)


def _check_same_lanes(jc, tc, n):
    js, ts = np.asarray(jc["status"]), tc["status"].numpy()
    np.testing.assert_array_equal(ts[:n], js[:n])
    done = js[:n] != jib.STATUS_RUNNING
    for k in ("dst_pos", "bitpos"):
        np.testing.assert_array_equal(tc[k].numpy()[:n][done],
                                      np.asarray(jc[k])[:n][done], err_msg=k)


def _decode_and_check(streams, payloads, zflag=1, caps=8192, dictionary=None):
    kw = {}
    if dictionary is not None:
        kw = dict(has_dict=True, dict_len=pack_dictionary(dictionary)[1])
    packed = _pack(streams, zflag, caps)
    (jt, jc), (tt, tc) = _run_both(*packed, **kw)
    n = len(streams)
    _check_same_lanes(jc, tc, n)
    outs = [native_resolve_tokens(tok, packed[0], dst, 8192, dictionary)
            for tok, dst in ((_host(tt, tc["tok_rows"]),
                              tc["dst_pos"].numpy()),
                             (_host(jt), np.asarray(jc["dst_pos"])))]
    status = tc["status"].numpy()
    for i, p in enumerate(payloads):
        if p is None:
            continue
        zf = int(zflag) if np.isscalar(zflag) else int(zflag[i])
        r, want = inflate_oracle(bytes(streams[i]), zf,
                                 caps if np.isscalar(caps) else caps[i],
                                 dictionary)
        assert status[i] == int(r), (i, status[i], r)
        if r is Result.OK:
            assert want == p
            for out in outs:
                assert out[i, : tc["dst_pos"][i]].tobytes() == p, i
    return tc


@pytest.mark.parametrize("level", [6, 9, 1])
def test_payload_matrix_matches_jax_and_oracle(level):
    pays = _payloads()
    tc = _decode_and_check([zlib.compress(p, level) for p in pays], pays)
    assert (tc["status"].numpy()[: len(pays)] == 0).all()


def test_stored_and_raw_blocks():
    pays = [b"stored block payload " * 30, b"\xff" * 2000,
            np.random.default_rng(3).integers(0, 256, 3000,
                                              dtype=np.uint8).tobytes()]
    raw = zlib.compressobj(6, zlib.DEFLATED, -15)
    streams = [zlib.compress(pays[0], 0), raw.compress(pays[1]) + raw.flush(),
               zlib.compress(pays[2], 6)]
    _decode_and_check(streams, pays, zflag=np.array([1, 0, 1]))


def test_btype3_and_truncation():
    good = b"fine payload " * 50
    streams = [zlib.compress(good, 6), b"\x78\x9c" + b"\x07\xff\xff\xff",
               zlib.compress(good, 6)[:-8], zlib.compress(good, 0)[:40],
               b"\x78\x9c", b"\x78\x9d\x00"]
    tc = _decode_and_check(streams, [good, b"", b"", b"", b"", b""])
    st = tc["status"].numpy()
    assert st[1] == int(Result.ERR) and st[5] == int(Result.ERR)
    assert st[2] == st[3] == st[4] == int(Result.UNFINISHED)


def test_efull_then_revive_resumes():
    # 64-symbol noise is one dynamic block of literals, ~3 per step (a
    # pair and a second token): caps 694..699 put every phase of that
    # cadence at the capacity edge
    lits = np.random.default_rng(9).integers(64, 128, 800, dtype=np.uint8)
    pays = _payloads()[:5] + [lits.tobytes()] * 6
    streams = [zlib.compress(p, 6) for p in pays]
    caps = [100, 3000, 17, 699, 7999] + list(range(694, 700))
    packed = _pack(streams, 1, caps)
    (jt1, jc1), (tt1, tc1) = _run_both(*packed)
    _check_same_lanes(jc1, tc1, len(pays))
    assert (tc1["status"].numpy()[: len(pays)] == int(Result.EFULL)).all()
    np.testing.assert_array_equal(tc1["dst_pos"].numpy()[5: len(pays)],
                                  caps[5:])
    big = np.full(N, 8192, np.int32)
    jrev = jib.revive_carry(jc1, new_cap=jnp.asarray(big))
    trev = tib.revive_carry(tc1, new_cap=torch.from_numpy(big))
    words, nbits, zflag, _ = packed
    (jt2, jc2), (tt2, tc2) = _run_both(words, nbits, zflag, big,
                                       jcarry=jrev, tcarry=trev)
    _check_same_lanes(jc2, tc2, len(pays))
    toks = np.concatenate([_host(tt1, tc1["tok_rows"]),
                           _host(tt2, tc2["tok_rows"])], axis=1)
    out = native_resolve_tokens(toks, words, tc2["dst_pos"].numpy(), 8192)
    for i, p in enumerate(pays):
        assert tc2["status"][i] == 0
        assert out[i, : tc2["dst_pos"][i]].tobytes() == p, i


def test_dictionary_stream():
    d = b"a shared preset dictionary: hello world, the quick brown fox " * 4
    pays = [b"hello world, the quick brown fox jumps " * 30,
            b"the quick brown fox" + bytes(range(200))]
    streams = []
    for p in pays:
        co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_DEFAULT_STRATEGY,
                              zdict=d)
        streams.append(co.compress(p) + co.flush())
    _decode_and_check(streams, pays, dictionary=d)


def test_distance_too_far_is_an_error():
    # a fixed block whose first symbol is a match reaching before byte 0
    from tests.gendata import BitWriter, _fixed_lit_code

    w = BitWriter()
    w.bits(1, 1).bits(1, 2)
    w.code(*_fixed_lit_code(ord("a")))
    w.code(*_fixed_lit_code(257))          # length 3
    w.code(4, 5)                           # distance code 4: 5..6 (+1 bit)
    w.bits(0, 1)
    w.code(*_fixed_lit_code(256))
    tc = _decode_and_check([w.getvalue()], [b""], zflag=0)
    assert tc["status"][0] == int(Result.ERR)


def test_shared_input_is_not_ported():
    """The name is from when the mode raised.  It is ported now: two lanes
    read one raw body, the second from the first's start again, and both
    end like a lane of the ordinary mode."""
    pay = b"shared body " * 50
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    raw = co.compress(pay) + co.flush()
    body = np.frombuffer(raw + b"\0" * (-len(raw) % 4), np.uint8).view(
        np.uint32)
    two = lambda v: np.full(2, v, np.int32)
    tok, c = decode_cu.decode_tokens(
        body, two(8 * len(raw)), two(0), two(4096), T=2048,
        shared_input=True, start_bit=two(0), limit=two(8 * len(raw)),
        in_base=two(0), device="cpu")
    want, wc = decode_cu.decode_tokens(
        body[None, :], np.array([8 * len(raw)]), np.zeros(1), np.array([4096]),
        T=2048, device="cpu")
    assert c["status"].tolist() == [int(Result.OK)] * 2
    assert c["dst_pos"].tolist() == [len(pay)] * 2
    for lane in (0, 1):
        assert torch.equal(tok[: c["tok_rows"], lane],
                           want[: wc["tok_rows"], 0])


# ---------------------------------------------------------------------------
# the wrapper on the CPU: dispatch to the twin, in-place contract, refusals
# ---------------------------------------------------------------------------

def _chunk_inputs(n=4, w=16):
    rng = np.random.default_rng(0)
    st = torch.zeros((decode_cu.NROWS, n), dtype=torch.int32)
    st[decode_cu.R_STATUS] = tib.STATUS_RUNNING
    st[decode_cu.R_STATE] = tib.S_BHDR
    st[decode_cu.R_NBITS] = 32 * (w - 8)
    st[decode_cu.R_CAP] = 1024
    st[decode_cu.R_LIMIT] = 1 << 30
    words = torch.from_numpy(rng.integers(0, 1 << 31, (n, w),
                                          dtype=np.int64).astype(np.int32))
    z = lambda r: torch.zeros((r, n), dtype=torch.int32)
    return [st, z(40), words, z(48), z(48), z(3) + 15, z(116)]


def test_decode_chunk_on_cpu_runs_the_twin_in_place():
    a = _chunk_inputs()
    b = [x.clone() for x in a]
    launches = decode_cu.launches
    tok_a, st_a, lens_a = decode_cu.decode_chunk(*a, K=8)
    tok_b, st_b, lens_b = decode_cu.decode_chunk_ref(*b, K=8)
    assert decode_cu.launches == launches   # the twin is not a launch
    assert st_a is a[0] and lens_a is a[1]  # updated in place
    assert torch.equal(tok_a, tok_b) and torch.equal(st_a, st_b)
    assert tok_a.shape == (16, 4)
    out = torch.full((16, 4), 7, dtype=torch.int32)
    tok_c, *_ = decode_cu.decode_chunk(*[x.clone() for x in b], out, K=8)
    assert tok_c is out


@pytest.mark.parametrize("fault", ["dtype", "shape", "noncontig", "K",
                                   "tok_shape"])
def test_decode_chunk_refuses_bad_inputs(fault):
    a = _chunk_inputs()
    kw = {"K": 8}
    if fault == "dtype":
        a[3] = a[3].to(torch.int64)
    elif fault == "shape":
        a[6] = a[6][:100]
    elif fault == "noncontig":
        a[2] = torch.zeros((16, 4), dtype=torch.int32).T
    elif fault == "K":
        kw["K"] = 0
    else:
        a.append(torch.zeros((15, 4), dtype=torch.int32))
    with pytest.raises((TypeError, ValueError)):
        decode_cu.decode_chunk(*a, **kw)
