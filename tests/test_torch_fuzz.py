"""The port's whole-stream engines under malformed input, against
``defl_tpu``'s oracle.

Counterpart of the first half of tests/test_fuzz.py.  The streams are that
file's own (``_gen_cases``: valid, truncated, bit-flipped, garbage, a
valid zlib header before a garbage body, from ``random.Random`` seeds), so
both packages see byte-identical input.  Every engine of the port must give
``defl_tpu.core.oracle.inflate_oracle``'s result class for every lane, and
its bytes for every OK lane:

- ``device_inflate(device="cpu")`` (the decode kernel's plain version),
  with the host resolver and with the device resolver and the adler32
  check, at the fuzz file's capacity and at one small enough for EFULL;
- ``batch_inflate(backend="device", device="cpu")``;
- the port's own oracle, and the port's C++ engine (``native_inflate``);
- raw DEFLATE (``flags=0``), and preset-dictionary streams, mutated, with
  and without their dictionary.

A codec is exact: there is no tolerance.  The streaming entry points and
the JAX decoder itself are held in tests/test_torch_fuzz_stream.py, the
C++ tier's bit-offset entry points in tests/test_torch_fuzz_native.py.
"""

import random
import zlib

import pytest

from defl_tpu.core.oracle import inflate_oracle as jax_oracle
from defl_tpu.runtime import native as jnative
from defl_tpu_torch import corpus
from defl_tpu_torch.core.oracle import inflate_oracle as port_oracle
from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result
from defl_tpu_torch.runtime import native as tnative
from defl_tpu_torch.runtime import session as tsess
from tests.test_fuzz import CAP, CORPUS, _gen_cases

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="the JAX package's native library is "
                                "unavailable")

#: every seed is a test of its own; 7 is tests/test_fuzz.py's engine seed
SEEDS = [1, 2, 3, 7, 100, 101]
#: a capacity under the longest payload (400 bytes of text): EFULL lanes
SMALL_CAP = 200


def _want(cases, flags, cap, dictionary=None):
    """The reference's (class, bytes) per case, its class as the port's
    ``Result`` (the two packages' enums are different types)."""
    return [(Result(int(r)), o) for r, o in
            (jax_oracle(d, flags, cap, dictionary) for d in cases)]


def _same(results, outputs, want, what):
    """Each lane's class, and an OK lane's bytes, as the reference's."""
    assert len(results) == len(outputs) == len(want)
    for i, (r, o, (wr, wo)) in enumerate(zip(results, outputs, want)):
        assert int(r) == int(wr), (what, i, int(r), int(wr))
        if wr is Result.OK:
            assert o == wo, (what, i)
    assert any(wr is Result.OK for wr, _ in want)


def _raw_cases(seed, n=24):
    """Raw DEFLATE input: tests/test_fuzz.py's garbage (seed 11 there), and
    the zlib cases of ``seed`` with their two header bytes cut off."""
    rng = random.Random(seed)
    garbage = [rng.randbytes(rng.randrange(1, 120)) for _ in range(n)]
    return garbage + [d[2:] for d in _gen_cases(seed, n)]


@pytest.mark.parametrize("seed", SEEDS)
def test_port_oracle_and_native_engine_match(seed):
    cases = _gen_cases(seed, 60)
    for cap in (CAP, SMALL_CAP):
        want = _want(cases, FLAG_ZLIB, cap)
        got = [port_oracle(d, FLAG_ZLIB, cap) for d in cases]
        _same([r for r, _ in got], [o for _, o in got], want, "oracle")
        # an engine that stops early keeps the same prefix
        assert [o for _, o in got] == [o for _, o in want]
        nat = [tnative.native_inflate(d, cap, FLAG_ZLIB) for d in cases]
        if cap == CAP:
            _same([r for r, _ in nat], [o for _, o in nat], want, "native")
        # the port's binding of the C++ engine is the JAX package's, at
        # either capacity.  (Under the small one the reference's own C++
        # engine and oracle part ways on a stored block cut short whose
        # LEN is past the capacity: the engine says EFULL before it copies,
        # the oracle copies what came and says UNFINISHED.  The device
        # decoders of both packages follow the oracle.)
        assert nat == [jnative.native_inflate(d, cap, FLAG_ZLIB)
                       for d in cases]


@pytest.mark.parametrize("resolve", ["host", "device"])
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_device_inflate_matches_the_oracle(seed, resolve):
    """The device resolver runs with the trailer check on the card's
    adler32 (its plain version here); the oracle gets the same flag."""
    cases = _gen_cases(seed, 60)
    flags = FLAG_ZLIB | (FLAG_VERIFY_ADLER32 if resolve == "device" else 0)
    res, outs, st = tsess.device_inflate(cases, flags, dst_capacities=CAP,
                                         resolve=resolve, device="cpu")
    _same(res, outs, _want(cases, flags, CAP), f"device_inflate {resolve}")
    assert not st["host_fallbacks"]


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_device_inflate_small_capacity_matches_the_oracle(seed):
    cases = _gen_cases(seed, 60)
    want = _want(cases, FLAG_ZLIB, SMALL_CAP)
    assert any(r is Result.EFULL for r, _ in want)
    res, outs, _ = tsess.device_inflate(cases, dst_capacities=SMALL_CAP,
                                        device="cpu")
    _same(res, outs, want, "device_inflate, small capacity")


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_batch_inflate_device_matches_the_oracle(seed):
    cases = _gen_cases(seed, 60)
    res, outs = tsess.batch_inflate(cases, backend="device",
                                    dst_capacities=CAP, device="cpu")
    _same(res, outs, _want(cases, FLAG_ZLIB, CAP), "batch_inflate")


@pytest.mark.parametrize("seed", [11, 12])
def test_raw_mode_matches_the_oracle(seed):
    cases = _raw_cases(seed)
    want = _want(cases, 0, CAP)
    res, outs, _ = tsess.device_inflate(cases, flags=0, dst_capacities=CAP,
                                        device="cpu")
    _same(res, outs, want, "device_inflate raw")
    for r, o in zip(res, outs):
        assert int(r) in (0, -1, 2, -105) and len(o) <= CAP
    got = [port_oracle(d, 0, CAP) for d in cases]
    _same([r for r, _ in got], [o for _, o in got], want, "oracle raw")
    nat = [tnative.native_inflate(d, CAP, 0) for d in cases]
    _same([r for r, _ in nat], [o for _, o in nat], want, "native raw")


DICT = b"a shared preset dictionary: the quick brown fox, lorem ipsum " * 3


def _dict_cases(seed, n=24):
    """Preset-dictionary streams of tests/test_fuzz.py's payloads, then
    truncated or bit-flipped like its cases."""
    rng = random.Random(seed)
    pays = [b"the quick brown fox jumps over " * 9, DICT[::-1][:150],
            bytes(range(200)), b"lorem ipsum " * 30, b""]
    cases = []
    for _ in range(n):
        co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_DEFAULT_STRATEGY,
                              zdict=DICT)
        d = bytearray(co.compress(rng.choice(pays)) + co.flush())
        kind = rng.randrange(3)
        if kind == 1:
            d = d[: rng.randrange(1, len(d))]
        elif kind == 2:
            for _ in range(rng.randrange(1, 5)):
                d[rng.randrange(len(d))] ^= 1 << rng.randrange(8)
        cases.append(bytes(d))
    return cases


@pytest.mark.parametrize("seed", [21, 22])
def test_dictionary_streams_match_the_oracle(seed):
    """With the dictionary every lane has the oracle's class and bytes;
    without it an FDICT stream is ERR in both packages."""
    cases = _dict_cases(seed)
    want = _want(cases, FLAG_ZLIB, CAP, DICT)
    assert any(r is Result.OK for r, _ in want)
    res, outs, _ = tsess.device_inflate(cases, dictionary=DICT,
                                        dst_capacities=CAP, device="cpu")
    _same(res, outs, want, "device_inflate, dictionary")
    got = [port_oracle(d, FLAG_ZLIB, CAP, DICT) for d in cases]
    _same([r for r, _ in got], [o for _, o in got], want, "oracle, dictionary")
    bare = [int(r) for r, _ in _want(cases, FLAG_ZLIB, CAP)]
    res, _, _ = tsess.device_inflate(cases, dst_capacities=CAP, device="cpu")
    assert [int(r) for r in res] == bare
    assert set(bare) <= {int(Result.ERR), int(Result.UNFINISHED)}


#: raw DEFLATE streams the fuzz found where the decoder stalled for the
#: extra bits of a code that the oracle rejects before reading them; each
#: must be ERR, as in the oracle
BAD_CODE_CUT_SHORT = [
    "4b043e",       # fixed block: 'a', length 3, distance code 30, cut (C4)
    "4b047e",       # the same with distance code 31 (C4)
    "4b043e00",     # 8 bits more, still under the 13 extra bits (C4)
    "0560240980",   # dynamic block: code-length repeat 16 first, cut (C5)
]


@pytest.mark.parametrize("hexdata", BAD_CODE_CUT_SHORT)
def test_a_bad_code_cut_short_is_an_error_as_in_the_oracle(hexdata):
    data = bytes.fromhex(hexdata)
    assert jax_oracle(data, 0, CAP)[0] == Result.ERR
    assert port_oracle(data, 0, CAP)[0] is Result.ERR
    for resolve in ("host", "device"):
        res, _, st = tsess.device_inflate([data], 0, dst_capacities=CAP,
                                          resolve=resolve, device="cpu")
        assert [int(r) for r in res] == [int(Result.ERR)]
        assert int(st["status"][0]) == int(Result.ERR)
    # the C++ engines of both packages: ERR on a distance code of 30 or 31,
    # as zlib ("invalid distance code"); a repeat with nothing before it
    # waits for its two extra bits first, as zlib's inflate does, so a
    # stream cut there is UNFINISHED in both (the reference's oracle and
    # its C++ engine part ways; the port's decoder follows the oracle)
    want = Result.UNFINISHED if hexdata == "0560240980" else Result.ERR
    assert tnative.native_inflate(data, CAP, 0)[0] is want
    assert int(jnative.native_inflate(data, CAP, 0)[0]) == int(want)


@pytest.mark.needs_jax
@pytest.mark.parametrize("hexdata", BAD_CODE_CUT_SHORT)
def test_the_jax_decoder_stalls_where_the_oracle_errs(hexdata):
    """A fault of the reference the port does not copy: defl_tpu's step
    asks for a distance code's extra bits, and a repeat's, before it
    rejects the code (``d_stall`` and ``lens_stall`` ahead of ``d_err``
    and ``bad16``: defl_tpu/ops/inflate_batch.py:837-845, 886-890, and
    ops/pallas/decode_pl.py:457-466, 496-500), so these cut streams come
    back UNFINISHED from its decoder where its oracle says ERR."""
    from defl_tpu.runtime.session import device_inflate as jax_device_inflate

    data = bytes.fromhex(hexdata)
    res, _, _ = jax_device_inflate([data], 0, dst_capacities=CAP)
    assert int(res[0]) == int(Result.UNFINISHED)
    res, _, _ = tsess.device_inflate([data], 0, dst_capacities=CAP,
                                     device="cpu")
    assert int(res[0]) == int(Result.ERR) == int(jax_oracle(data, 0, CAP)[0])


@pytest.mark.parametrize("seed", SEEDS)
def test_the_ports_fuzz_cases_are_the_reference_fuzz_streams(seed):
    """``corpus.fuzz_cases`` (what the card's fuzz and the soak draw) gives
    tests/test_fuzz.py's streams byte for byte from its payloads."""
    base = [CORPUS["text"][:400], CORPUS["rand_255"], CORPUS["period_3"][:300],
            b"", b"a"]
    cases = corpus.fuzz_cases(seed, 60, base)
    assert [d for _, d in cases] == _gen_cases(seed, 60)
    assert {k for k, _ in cases} == set(range(5))


def test_mixed_batch_swaps_every_eighth_lane_for_a_malformed_stream():
    blocks = corpus.make_silesia_like(8 * 65536)
    streams = [zlib.compress(b, 6) for b in blocks] * 4
    mixed, lanes = corpus.mixed_batch(streams, blocks, seed=11)
    assert lanes == list(range(0, 32, 8))
    assert all(mixed[i] == streams[i] for i in range(32) if i not in lanes)
    drawn = corpus.fuzz_cases(11, 32, corpus.fuzz_payloads(blocks))
    assert [mixed[i] for i in lanes] == [
        d for k, d in drawn if k != corpus.VALID][:4]
    assert mixed == corpus.mixed_batch(streams, blocks, seed=11)[0]
