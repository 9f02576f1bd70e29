"""The port's streaming session on the CPU against the JAX package's.

Mirrors ``tests/test_stream_device.py``: each scenario runs through
``defl_tpu.runtime.stream_device.DeviceInflateSession`` and through the
port's class with ``device="cpu"`` and both resolvers, on the same
feeds; statuses, output positions and ``input_pos`` must agree after
every feed, and the outputs at the end.  One stream is begun in one
package and finished in the other through ``defl_tpu_torch.convert``.
Every session here has 4 lanes, so the JAX decoder compiles one shape.
"""

import zlib

import numpy as np
import pytest

from defl_tpu.errors import Result
from defl_tpu.runtime import native as jnative
from defl_tpu.runtime.stream_device import DeviceInflateSession as JSession
from defl_tpu_torch import DeviceInflateSession as TSession
from defl_tpu_torch.convert import session_from_jax, session_into_jax
from tests.gendata import make_corpus

pytestmark = pytest.mark.skipif(not jnative.available(),
                                reason="native resolver unavailable")

CORPUS = make_corpus()
N = 4
RESOLVERS = ["host", "device"]


def _feed_both(js, ts, chunks):
    jr, tr = js.feed(chunks), ts.feed(chunks)
    assert [int(r) for r in tr] == [int(r) for r in jr]
    np.testing.assert_array_equal(ts.dst_pos, js.dst_pos)
    assert [ts.input_pos(i) for i in range(N)] == \
        [js.input_pos(i) for i in range(N)]
    assert [bytes(b) for b in ts.bufs] == [bytes(b) for b in js.bufs]
    return tr


def _same_outputs(js, ts):
    (jr, jo), (tr, to) = js.outputs(), ts.outputs()
    assert [int(r) for r in tr] == [int(r) for r in jr]
    assert to == jo
    return tr, to


@pytest.mark.parametrize("resolve", RESOLVERS)
def test_incremental_feeds_resume(resolve):
    payloads = [CORPUS["text"][:700], CORPUS["period_7"][:600],
                CORPUS["rand_255"], CORPUS["json"][:500]]
    streams = [zlib.compress(p, 6) for p in payloads]
    js = JSession(N, 1024)
    ts = TSession(N, 1024, resolve=resolve, device="cpu")

    feed = 48
    pos = [0] * N
    done = False
    rounds = 0
    while not done and rounds < 60:
        chunk = []
        for i, s in enumerate(streams):
            chunk.append(s[pos[i]: pos[i] + feed])
            pos[i] += feed
        res = _feed_both(js, ts, chunk)
        done = all(r != Result.UNFINISHED for r in res)
        rounds += 1

    res, outs = _same_outputs(js, ts)
    assert all(r == Result.OK for r in res), res
    assert outs == payloads
    assert rounds > 1  # genuinely incremental


@pytest.mark.parametrize("resolve", RESOLVERS)
def test_single_byte_feeds(resolve):
    p = CORPUS["rand_7"] * 3
    s = zlib.compress(p, 6)
    js = JSession(N, 256)
    ts = TSession(N, 256, resolve=resolve, device="cpu")
    for i in range(len(s)):
        res = _feed_both(js, ts, [s[i: i + 1]] * N)
    assert all(r == Result.OK for r in res)
    _, outs = _same_outputs(js, ts)
    assert outs == [p] * N


@pytest.mark.parametrize("resolve", RESOLVERS)
def test_efull_resize_resume_device(resolve):
    pays = [b"w" * 800, CORPUS["text"][:400], b"ab" * 300, b"tiny"]
    streams = [zlib.compress(p, 6) for p in pays]
    js = JSession(N, 100)
    ts = TSession(N, 100, resolve=resolve, device="cpu")
    res = _feed_both(js, ts, streams)
    assert [int(r) for r in res] == [int(Result.EFULL)] * 3 + [0]
    js.resize_output(1024)
    ts.resize_output(1024)
    res = _feed_both(js, ts, [b""] * N)
    assert all(r == Result.OK for r in res)
    _, outs = _same_outputs(js, ts)
    assert outs == pays
    # per-lane budgets
    js2, ts2 = JSession(N, 100), TSession(N, 100, resolve=resolve,
                                          device="cpu")
    _feed_both(js2, ts2, streams)
    caps = [800, 100, 1024, 100]
    js2.resize_output(caps)
    ts2.resize_output(caps)
    res = _feed_both(js2, ts2, [b""] * N)
    assert [int(r) for r in res] == [0, int(Result.EFULL), 0, 0]
    _same_outputs(js2, ts2)


@pytest.mark.parametrize("resolve", RESOLVERS)
def test_feed_cost_independent_of_history(resolve):
    """Rebasing keeps the unconsumed backlog bounded by the feed size,
    however much has streamed through: ~12 KB through the session in
    256-byte feeds (the JAX test streams 400 KB; the plain twin pays for
    every step on the CPU, so this one is cut in scale, not in shape)."""
    rng = np.random.default_rng(3)
    parts = []
    for _ in range(8):
        unit = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
        parts.append(unit * 22 + rng.integers(0, 256, 96,
                                              dtype=np.uint8).tobytes())
    payload = b"".join(parts)[:12_000]
    s = zlib.compress(payload, 6)
    js = JSession(N, 1 << 14)
    ts = TSession(N, 1 << 14, resolve=resolve, device="cpu")

    feed = 256
    max_backlog = 0
    for off in range(0, len(s), feed):
        _feed_both(js, ts, [s[off: off + feed]] + [b""] * (N - 1))
        max_backlog = max(max_backlog, len(ts.bufs[0]))
    res, outs = _same_outputs(js, ts)
    assert res[0] == Result.OK
    assert outs[0] == payload
    assert len(s) > 4 * feed and max_backlog <= 4 * feed, max_backlog
    # the 4-byte adler trailer is never consumed: decode stops at the
    # final block's end-of-block symbol
    assert ts.input_pos(0) == len(s) - 4


@pytest.mark.parametrize("resolve", RESOLVERS)
def test_dictionary_session(resolve):
    """Back-references reach through the resolved output into the preset
    dictionary; the device resolver gets both as its per-lane prefix."""
    d = b"a shared preset dictionary: hello world, the quick brown fox " * 3
    pays = [b"hello world, the quick brown fox jumps " * 12,
            b"quick brown fox " * 30, d[::-1] + d, b"x"]
    zs = []
    for p in pays:
        co = zlib.compressobj(6, zlib.DEFLATED, 15, 9,
                              zlib.Z_DEFAULT_STRATEGY, zdict=d)
        zs.append(co.compress(p) + co.flush())
    js = JSession(N, 1024, dictionary=d)
    ts = TSession(N, 1024, dictionary=d, resolve=resolve, device="cpu")
    for lo in range(0, max(len(z) for z in zs), 40):
        res = _feed_both(js, ts, [z[lo: lo + 40] for z in zs])
    assert all(r == Result.OK for r in res)
    _, outs = _same_outputs(js, ts)
    assert outs == pays


@pytest.mark.parametrize("resolve", RESOLVERS)
def test_stream_begun_in_jax_finishes_in_the_port_and_back(resolve):
    """JAX feeds the first third, the port the second, JAX the rest; the
    session state crosses through ``convert`` both ways."""
    payloads = [CORPUS["text"][:900], CORPUS["period_13"][:700],
                CORPUS["rand_255"], CORPUS["json"][:800]]
    streams = [zlib.compress(p, 6) for p in payloads]
    cut = lambda s, k: s[len(s) * k // 3: len(s) * (k + 1) // 3]

    whole = JSession(N, 1024)
    for k in range(3):
        whole.feed([cut(s, k) for s in streams])

    js = JSession(N, 1024)
    js.feed([cut(s, 0) for s in streams])
    ts = session_from_jax(js, resolve=resolve, device="cpu")
    assert ts.outputs()[1] == js.outputs()[1]
    ts.feed([cut(s, 1) for s in streams])
    back = JSession(N, 1024)
    session_into_jax(ts, back)
    res = back.feed([cut(s, 2) for s in streams])
    assert all(r is Result.OK for r in res)
    assert back.outputs()[1] == payloads == whole.outputs()[1]
    assert [back.input_pos(i) for i in range(N)] == \
        [whole.input_pos(i) for i in range(N)]

    # and the port alone finishes what JAX began
    res = ts.feed([cut(s, 2) for s in streams])
    assert all(r == Result.OK for r in res)
    assert ts.outputs()[1] == payloads


def test_unknown_resolver_and_oversized_backlog_raise():
    with pytest.raises(ValueError, match="resolve"):
        TSession(N, 256, resolve="xla", device="cpu")
    ts = TSession(1, 256, device="cpu")
    with pytest.raises(ValueError, match="backlog"):
        ts.feed([bytes((1 << 22))])
