"""The port under malformed input against the JAX decoder itself, and its
streaming entry points fed the same streams in pieces.

- One seed of tests/test_fuzz.py's cases (seed 7, 48 cases, as
  ``test_cross_engine_agreement_device`` runs them there) through
  ``defl_tpu.runtime.session.device_inflate`` on the CPU and through the
  port's ``device_inflate(device="cpu")``: the same class for every lane,
  the same bytes for every OK lane, and the same device end state (each
  lane's ``dst_pos`` and ``bitpos`` before any host retry).
- The fuzz cases cut at random points (``random.Random`` seeds) and fed to
  the port's ``DeviceInflateSession(device="cpu")``, with either resolver,
  and to its ``InflateStream``: the final class and an OK lane's bytes
  must be the one-shot decode's, which tests/test_torch_fuzz.py holds
  against the reference's oracle.

Exact comparisons throughout: a codec has no tolerance.
"""

import random

import numpy as np
import pytest

from defl_tpu.core.oracle import inflate_oracle as jax_oracle
from defl_tpu.runtime import native as jnative
from defl_tpu_torch.api import InflateStream
from defl_tpu_torch.errors import FLAG_ZLIB, Result
from defl_tpu_torch.runtime import session as tsess
from defl_tpu_torch.runtime.stream_device import DeviceInflateSession
from tests.test_fuzz import CAP, _gen_cases

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="the JAX package's native library is "
                                "unavailable")


def _one_shot(cases):
    """The reference oracle's (class, bytes), the class as an int."""
    return [(int(r), o) for r, o in (jax_oracle(d, FLAG_ZLIB, CAP)
                                     for d in cases)]


@pytest.mark.needs_jax
def test_port_matches_the_jax_decoder():
    from defl_tpu.runtime.session import device_inflate as jax_device_inflate

    cases = _gen_cases(7, 48)
    jr, jo, js = jax_device_inflate(cases, dst_capacities=CAP)
    tr, to, ts = tsess.device_inflate(cases, dst_capacities=CAP,
                                      device="cpu")
    assert [int(r) for r in tr] == [int(r) for r in jr]
    for i, r in enumerate(jr):
        if int(r) == 0:
            assert to[i] == jo[i], i
    for key in ("dst_pos", "bitpos"):
        np.testing.assert_array_equal(np.asarray(ts[key])[:len(cases)],
                                      np.asarray(js[key])[:len(cases)], key)
    assert {int(r) for r in tr} >= {0, -1, 2}


def _pieces(cases, seed, most=4):
    """Each case cut at up to ``most - 1`` random points (empty pieces
    allowed), from ``random.Random(seed)``."""
    rng = random.Random(seed)
    out = []
    for d in cases:
        k = rng.randrange(1, most + 1)
        cuts = sorted(rng.randrange(0, len(d) + 1) for _ in range(k - 1))
        bounds = [0, *cuts, len(d)]
        out.append([d[a:b] for a, b in zip(bounds, bounds[1:])])
    return out


@pytest.mark.parametrize("seed, resolve", [(1, "host"), (2, "device"),
                                           (3, "host")])
def test_device_session_in_pieces_matches_one_shot(seed, resolve):
    cases = _gen_cases(seed, 60)
    want = _one_shot(cases)
    pieces = _pieces(cases, seed + 1000)
    sess = DeviceInflateSession(len(cases), CAP, resolve=resolve,
                                device="cpu")
    for k in range(max(len(p) for p in pieces)):
        sess.feed([p[k] if k < len(p) else b"" for p in pieces])
    # empty feeds until no lane moves: a lane cut by the per-feed step
    # budget goes on
    for _ in range(8):
        before = sess.input_pos
        pos = [before(i) for i in range(len(cases))]
        sess.feed([b""] * len(cases))
        if [sess.input_pos(i) for i in range(len(cases))] == pos:
            break
    res, outs = sess.outputs()
    for i, (r, o, (wr, wo)) in enumerate(zip(res, outs, want)):
        assert int(r) == wr, (i, int(r), wr)
        if wr == 0:
            assert o == wo, i
    assert {wr for wr, _ in want} >= {0, -1, 2}


@pytest.mark.parametrize("seed", [1, 2, 3, 7, 100])
def test_inflate_stream_in_pieces_matches_one_shot(seed):
    """``stream()`` per piece; a lane whose last piece is empty gets one
    more empty ``stream()`` (NOOP or the class it already had)."""
    cases = _gen_cases(seed, 60)
    want = _one_shot(cases)
    for i, (d, pieces) in enumerate(zip(cases, _pieces(cases, seed + 2000))):
        st = InflateStream(CAP)
        r = None
        for p in pieces:
            if p or r is None:
                r = st.stream(p)
        if int(r) == int(Result.NOOP):
            r = st.run()
        assert int(r) == want[i][0], (i, int(r), want[i][0])
        if want[i][0] == 0:
            assert st.output == want[i][1], i
