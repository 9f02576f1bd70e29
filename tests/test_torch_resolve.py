"""The port's device resolver on the CPU against the JAX package's.

``resolve_tokens`` is a pure function of the token array, so both
packages get the *same* tokens (made once by the port's decoder on the
CPU) and must give the same bytes, byte for byte, zero past ``dst_len``:
with no prefix, with a shared preset dictionary, and with a per-lane
``prefix``.  Tolerance 0.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defl_tpu.ops.resolve import resolve_tokens as j_resolve
from defl_tpu_torch.ops.bitio import i32_to_u32
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.ops.inflate_batch import (TOK_LIT, TOK_LIT_PAIR_BIT,
                                              TOK_MATCH, TOK_STORED)
from defl_tpu_torch.ops import resolve as tres
from defl_tpu_torch.ops.resolve import resolve_tokens as t_resolve
from defl_tpu_torch.runtime.pack import pack_dictionary, pack_streams
from tests.gendata import make_corpus

CORPUS = make_corpus()
C = 4096
DICT = b"a shared preset dictionary: hello world, the quick brown fox " * 3


def _decode(streams, dictionary=None):
    p = pack_streams(streams, 1, C)
    tok, c = decode_cu.decode_tokens(
        p.words, p.nbits, p.zflag, p.dst_cap, T=8192, K=128,
        dict_len=len(dictionary) if dictionary else 0,
        has_dict=dictionary is not None, device="cpu")
    assert c["status"].tolist() == [0] * len(streams)
    return tok[: c["tok_rows"]], p.words, c["dst_pos"]


def _plain_batch():
    """One lane per shape of token stream: literal pairs (random bytes),
    dist=1 runs, overlapping matches (dist 3 < len), long-distance
    matches, stored runs, text, an empty stream."""
    pays = [CORPUS["rand_255"], CORPUS["period_1"][:3000],
            CORPUS["period_3"][:3000], CORPUS["far_match_4k"][:C],
            CORPUS["text"][:2500], CORPUS["zeros_65536"][:C],
            CORPUS["json"][:2000], b""]
    streams = [zlib.compress(p, 6) for p in pays]
    streams[4] = zlib.compress(pays[4], 0)          # stored blocks
    return pays, streams


@pytest.fixture(scope="module")
def plain():
    pays, streams = _plain_batch()
    return (pays, *_decode(streams))


@pytest.fixture(scope="module")
def with_dict():
    pays = [b"hello world, the quick brown fox jumps " * 20,
            b"quick brown fox " * 50, DICT[::-1] + DICT, b"x"]
    zs = []
    for p in pays:
        co = zlib.compressobj(6, zlib.DEFLATED, 15, 9,
                              zlib.Z_DEFAULT_STRATEGY, zdict=DICT)
        zs.append(co.compress(p) + co.flush())
    return (pays, *_decode(zs, DICT))


def _jax(tokens, words, dst, **kw):
    toks = tokens.numpy().view(np.uint32)
    return np.asarray(j_resolve(jnp.asarray(toks), jnp.asarray(words),
                                jnp.asarray(dst.numpy()), C=C, **kw))


def _check_bytes(out, pays, dst):
    for i, p in enumerate(pays):
        assert int(dst[i]) == len(p)
        assert out[i, : len(p)].tobytes() == p, i
        assert not out[i, len(p):].any()            # zero past dst_len


def test_token_shapes_are_all_there(plain):
    """The batch really holds what the resolver has to get right."""
    _, tokens, _, _ = plain
    t = i32_to_u32(tokens)
    kind = t >> 30
    assert ((kind == TOK_LIT) & ((t & TOK_LIT_PAIR_BIT) != 0)).any()
    assert (kind == TOK_STORED).any()
    m = kind == TOK_MATCH
    dist = (t & 0x7FFF) + 1
    length = ((t >> 21) & 0x1FF) + 3
    assert (m & (dist == 1)).any()                  # dist=1 runs
    assert (m & (dist < length) & (dist > 1)).any()  # overlapping matches
    assert (m & (dist > 3000)).any()                # long distance


def test_no_prefix_matches_jax(plain):
    pays, tokens, words, dst = plain
    got = t_resolve(tokens, words, dst, C=C)
    assert got.dtype == torch.uint8 and got.shape == (len(pays), C)
    np.testing.assert_array_equal(got.numpy(), _jax(tokens, words, dst))
    _check_bytes(got.numpy(), pays, dst)


def test_short_dst_len_zeroes_the_rest_like_jax(plain):
    pays, tokens, words, dst = plain
    short = (dst // 2).to(torch.int32)
    got = t_resolve(tokens, words, short, C=C).numpy()
    np.testing.assert_array_equal(got, _jax(tokens, words, short))
    for i, p in enumerate(pays):
        assert got[i, : int(short[i])].tobytes() == p[: int(short[i])]
        assert not got[i, int(short[i]):].any()


@pytest.mark.parametrize("slab_elems", [1, 3 * (C + 1), 1 << 25])
def test_lane_slabs_give_the_same_bytes(plain, slab_elems, monkeypatch):
    """Lanes are independent: one lane per slab, three, or all at once."""
    pays, tokens, words, dst = plain
    monkeypatch.setattr(tres, "SLAB_ELEMS", slab_elems)
    got = t_resolve(tokens, words, dst, C=C)
    _check_bytes(got.numpy(), pays, dst)


def test_input_forms(plain):
    """Words as the packer's uint32 ndarray or as an int32 tensor of the
    same bits; tokens and words in any other type are refused."""
    pays, tokens, words, dst = plain
    want = t_resolve(tokens, words, dst, C=C)
    w32 = torch.from_numpy(words.view(np.int32))
    assert torch.equal(t_resolve(tokens, w32, dst.tolist(), C=C), want)
    with pytest.raises(TypeError, match="tokens"):
        t_resolve(i32_to_u32(tokens), words, dst, C=C)
    with pytest.raises(TypeError, match="words"):
        t_resolve(tokens, i32_to_u32(w32), dst, C=C)


def test_shared_dictionary_matches_jax(with_dict):
    pays, tokens, words, dst = with_dict
    dw, dl = pack_dictionary(DICT)
    got = t_resolve(tokens, words, dst, C=C, dict_len=dl, dict_words=dw)
    want = _jax(tokens, words, dst, dict_len=dl, dict_words=jnp.asarray(dw))
    np.testing.assert_array_equal(got.numpy(), want)
    _check_bytes(got.numpy(), pays, dst)
    # without the dictionary the back-references find zeros: not the payload
    bare = t_resolve(tokens, words, dst, C=C)
    assert bare[0, : len(pays[0])].numpy().tobytes() != pays[0]


@pytest.mark.parametrize("pad", [0, 100])
def test_per_lane_prefix_matches_jax(with_dict, pad):
    """The dictionary as each lane's own right-aligned prefix (what the
    streaming session passes), with zero bytes before it when the prefix
    is wider than the history."""
    pays, tokens, words, dst = with_dict
    n = len(pays)
    prefix = np.zeros((n, pad + len(DICT)), np.uint8)
    prefix[:, pad:] = np.frombuffer(DICT, np.uint8)
    got = t_resolve(tokens, words, dst, C=C, prefix=torch.from_numpy(prefix))
    want = _jax(tokens, words, dst, prefix=jnp.asarray(prefix))
    np.testing.assert_array_equal(got.numpy(), want)
    _check_bytes(got.numpy(), pays, dst)


def test_prefixes_differ_by_lane(with_dict):
    """Each lane reads its own prefix: lane 1's is corrupted, and only
    lane 1's bytes change, the same way in both packages."""
    pays, tokens, words, dst = with_dict
    prefix = np.tile(np.frombuffer(DICT, np.uint8), (len(pays), 1))
    prefix[1] ^= 0x20
    got = t_resolve(tokens, words, dst, C=C,
                    prefix=torch.from_numpy(prefix)).numpy()
    np.testing.assert_array_equal(
        got, _jax(tokens, words, dst, prefix=jnp.asarray(prefix)))
    assert got[0, : len(pays[0])].tobytes() == pays[0]
    assert got[1, : len(pays[1])].tobytes() != pays[1]


def test_prefix_and_dictionary_are_exclusive(with_dict):
    _, tokens, words, dst = with_dict
    dw, dl = pack_dictionary(DICT)
    with pytest.raises(ValueError, match="exclusive"):
        t_resolve(tokens, words, dst, C=C, dict_len=dl, dict_words=dw,
                  prefix=torch.zeros((4, 8), dtype=torch.uint8))
