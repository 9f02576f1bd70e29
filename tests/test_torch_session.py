"""The port's batch session and pipeline on the CPU against the JAX ones.

``defl_tpu_torch.device_inflate(device="cpu")`` runs the main path with
the kernel's plain twin; it must give the results, outputs and
``bitpos``/``dst_pos`` stats of ``defl_tpu.runtime.session.device_inflate
(resolve="host")``, and ``pipeline_inflate`` those of the JAX pipeline.
Shapes stay inside one capacity bucket so that the JAX decoder compiles
few times per test session.
"""

import zlib

import numpy as np
import pytest
import torch

from defl_tpu.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result
from defl_tpu.runtime import native
from defl_tpu.runtime import pipeline as jpipe
from defl_tpu.runtime import session as jsess
from defl_tpu_torch import (device_inflate, inflate_batch, metrics,
                            pipeline_inflate)
from defl_tpu_torch.runtime import native as tnative
from defl_tpu_torch.runtime import session as tsess
from tests.gendata import BitWriter, _fixed_lit_code, make_corpus

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native resolver unavailable")

CORPUS = make_corpus()
SMALL = {k: v for k, v in CORPUS.items() if 0 < len(v) <= 900}
CAP = 1024


def _both(streams, **kw):
    kw.setdefault("dst_capacities", CAP)
    jr, jo, js = jsess.device_inflate(streams, resolve="host", **kw)
    tr, to, ts = device_inflate(streams, device="cpu", **kw)
    assert tr == jr
    assert to == jo
    n = len(streams)
    for k in ("bitpos", "dst_pos"):
        np.testing.assert_array_equal(ts[k][:n], np.asarray(js[k])[:n],
                                      err_msg=k)
    assert ts["C"] == js["C"] and ts["T"] == js["T"]
    assert ts["host_fallbacks"] == js["host_fallbacks"]
    return tr, to, ts


def test_corpus_batch_matches_jax():
    names = sorted(SMALL)[:16]
    pays = [CORPUS[n] for n in names]
    res, outs, _ = _both([zlib.compress(p, 6) for p in pays])
    assert res == [Result.OK] * len(pays) and outs == pays


def test_error_lanes_match_jax():
    good = b"fine payload " * 50
    _both([zlib.compress(good), b"\x78\x9c\x07\xff\xff\xff",
           zlib.compress(good)[:-8], b"\x78\x9d\x00",
           zlib.compress(good * 3)], dst_capacities=[CAP, CAP, CAP, CAP, 700])


def test_verify_adler32_matches_jax():
    p = CORPUS["text"][:600]
    good = zlib.compress(p, 6)
    corrupt = bytearray(good)
    corrupt[-1] ^= 0xFF
    res, outs, _ = _both([good, bytes(corrupt), good[:-2]],
                         flags=FLAG_ZLIB | FLAG_VERIFY_ADLER32)
    assert res == [Result.OK, Result.ERR, Result.UNFINISHED]
    assert outs[0] == p


def test_undeclared_capacity_efull_resume_matches_jax():
    pays = [b"\0" * 6000, b"ab" * 3000, b"text " * 300]
    res, outs, st = _both([zlib.compress(p, 9) for p in pays],
                          dst_capacities=None)
    assert res == [Result.OK] * 3 and outs == pays
    assert st["C"] >= 4096   # the grown bucket


def test_dictionary_matches_jax():
    d = b"shared dictionary words: alpha beta gamma delta " * 3
    pays = [b"alpha beta gamma delta " * 20, b"gamma" * 30]
    zs = []
    for p in pays:
        co = zlib.compressobj(6, zlib.DEFLATED, 15, 9,
                              zlib.Z_DEFAULT_STRATEGY, zdict=d)
        zs.append(co.compress(p) + co.flush())
    res, outs, _ = _both(zs, dictionary=d)
    assert outs == pays


def _both_device(streams, **kw):
    """``resolve="device"`` in both packages: pass 2 and the trailer
    checksums run in ops/resolve.py and ops/checksums.py of each."""
    kw.setdefault("dst_capacities", CAP)
    metrics.reset()
    jr, jo, js = jsess.device_inflate(streams, resolve="device", **kw)
    tr, to, ts = device_inflate(streams, resolve="device", device="cpu", **kw)
    assert tr == jr
    assert to == jo
    n = len(streams)
    for k in ("bitpos", "dst_pos"):
        np.testing.assert_array_equal(ts[k][:n], np.asarray(js[k])[:n],
                                      err_msg=k)
    assert ts["C"] == js["C"] and ts["T"] == js["T"]
    assert ts["host_fallbacks"] == js["host_fallbacks"]
    # the tokens stay where they were decoded
    assert "token_fetch_bytes" not in metrics.snapshot()
    return tr, to, ts


def test_device_resolve_corpus_batch_matches_jax():
    names = sorted(SMALL)[:16]
    pays = [CORPUS[n] for n in names]
    res, outs, _ = _both_device([zlib.compress(p, 6) for p in pays])
    assert res == [Result.OK] * len(pays) and outs == pays
    # and the host route gives the same bytes
    assert device_inflate([zlib.compress(p, 6) for p in pays],
                          dst_capacities=CAP, device="cpu")[1] == pays


def test_device_resolve_error_lanes_match_jax():
    good = b"fine payload " * 50
    res, _, _ = _both_device(
        [zlib.compress(good), b"\x78\x9c\x07\xff\xff\xff",
         zlib.compress(good)[:-8], b"\x78\x9d\x00",
         zlib.compress(good * 3), zlib.compress(good, 0)],
        dst_capacities=[CAP, CAP, CAP, CAP, 700, CAP])
    assert res == [Result.OK, Result.ERR, Result.UNFINISHED, Result.ERR,
                   Result.EFULL, Result.OK]


def test_device_resolve_verify_adler32_matches_jax():
    """The trailer check against checksums taken on the device: a
    corrupted trailer is ERR, a cut one UNFINISHED; without the flag the
    corrupted trailer goes unnoticed, as in the JAX package."""
    p = CORPUS["text"][:600]
    good = zlib.compress(p, 6)
    corrupt = bytearray(good)
    corrupt[-1] ^= 0xFF
    batch = [good, bytes(corrupt), good[:-2], zlib.compress(b"", 6)]
    res, outs, st = _both_device(batch, flags=FLAG_ZLIB | FLAG_VERIFY_ADLER32)
    assert res == [Result.OK, Result.ERR, Result.UNFINISHED, Result.OK]
    assert outs[:3] == [p] * 3 and outs[3] == b""
    assert st["adler32_batch_launches"] == 0    # the CPU runs the plain one
    res, _, _ = _both_device(batch, flags=FLAG_ZLIB)
    assert res == [Result.OK] * 4


def test_device_resolve_undeclared_capacity_matches_jax():
    pays = [b"\0" * 6000, b"ab" * 3000, b"text " * 300]
    res, outs, st = _both_device([zlib.compress(p, 9) for p in pays],
                                 dst_capacities=None)
    assert res == [Result.OK] * 3 and outs == pays
    assert st["C"] >= 4096   # the grown bucket: two token parts resolved


def test_device_resolve_dictionary_matches_jax():
    d = b"shared dictionary words: alpha beta gamma delta " * 3
    pays = [b"alpha beta gamma delta " * 20, b"gamma" * 30]
    zs = []
    for p in pays:
        co = zlib.compressobj(6, zlib.DEFLATED, 15, 9,
                              zlib.Z_DEFAULT_STRATEGY, zdict=d)
        zs.append(co.compress(p) + co.flush())
    res, outs, _ = _both_device(zs, dictionary=d,
                                flags=FLAG_ZLIB | FLAG_VERIFY_ADLER32)
    assert res == [Result.OK] * 2 and outs == pays


def test_device_resolve_step_budget_exhaustion_falls_back_to_host():
    good = zlib.compress(b"fine " * 50, 6)[2:-4]
    res, outs, st = _both_device([_evil(), good], flags=0)
    assert res == [Result.OK, Result.OK]
    assert outs == [b"Z", b"fine " * 50]
    assert st["host_fallbacks"] == [0]


def test_device_resolve_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    zs = [zlib.compress(b"x" * 100)]
    with pytest.raises(RuntimeError, match="CUDA"):
        device_inflate(zs, dst_capacities=CAP, resolve="device")


def _evil():
    """Thousands of empty static blocks: exhausts the step budget."""
    w = BitWriter()
    for _ in range(3000):
        w.bits(0, 1).bits(1, 2)
        w.code(*_fixed_lit_code(256))
    w.bits(1, 1).bits(1, 2)
    w.code(*_fixed_lit_code(ord("Z")))
    w.code(*_fixed_lit_code(256))
    return w.getvalue()


def test_step_budget_exhaustion_falls_back_to_host():
    good = zlib.compress(b"fine " * 50, 6)[2:-4]
    res, outs, st = _both([_evil(), good], flags=0)
    assert res == [Result.OK, Result.OK]
    assert outs == [b"Z", b"fine " * 50]
    assert st["host_fallbacks"] == [0]


def test_inflate_batch_device_matches_jax():
    pays = [b"batch %d " % i * 40 for i in range(9)]
    zs = [zlib.compress(p) for p in pays]
    jr, jo = jsess.batch_inflate(zs, backend="device", dst_capacities=CAP)
    tr, to = inflate_batch(zs, backend="device", dst_capacities=CAP,
                           device="cpu")
    assert (tr, to) == (jr, jo) and to == pays


def test_auto_backend_without_card_stays_on_host(monkeypatch):
    """``auto`` decides by the batch alone, as the JAX session does, and
    never hides a missing card: a batch of 8 or more goes to the device
    and raises without one.  What stays on the host without a card is a
    small batch, ``backend="host"``, and ``device="cpu"`` (the twin)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pays = [b"auto %d " % i * 30 for i in range(10)]
    zs = [zlib.compress(p) for p in pays]
    with pytest.raises(RuntimeError, match="CUDA"):
        inflate_batch(zs)
    jr, jo = jsess.batch_inflate(zs, backend="auto", dst_capacities=CAP)
    res, outs = inflate_batch(zs, dst_capacities=CAP, device="cpu")
    assert (res, outs) == (jr, jo) and outs == pays

    called = []
    monkeypatch.setattr(tsess, "device_inflate",
                        lambda *a, **k: called.append(1))
    assert inflate_batch(zs, backend="host") == ([Result.OK] * 10, pays)
    assert inflate_batch(zs[:7]) == ([Result.OK] * 7, pays[:7])
    assert not called


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    zs = [zlib.compress(b"x" * 100)]
    with pytest.raises(RuntimeError, match="CUDA"):
        device_inflate(zs, dst_capacities=CAP)
    with pytest.raises(RuntimeError, match="CUDA"):
        inflate_batch(zs, backend="device", dst_capacities=CAP)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline_inflate([zs], CAP)


def test_unported_and_missing_resolvers_raise(monkeypatch):
    zs = [zlib.compress(b"x" * 100)]
    with pytest.raises(ValueError, match="resolve"):
        device_inflate(zs, dst_capacities=CAP, resolve="xla", device="cpu")

    def no_compiler():
        raise RuntimeError("g++ failed (1): no compiler here")

    # a host engine that does not build raises; no other resolver steps in
    monkeypatch.setattr(tnative, "load", no_compiler)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        device_inflate(zs, dst_capacities=CAP, device="cpu")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        pipeline_inflate([zs], CAP, device="cpu")
    # the device resolver needs no host engine for lanes that finish
    res, outs, _ = device_inflate(zs, dst_capacities=CAP, resolve="device",
                                  device="cpu")
    assert res == [Result.OK] and outs == [b"x" * 100]


def test_metrics_count_the_batch():
    metrics.reset()
    pays = [b"m" * 300, b"n" * 200]
    device_inflate([zlib.compress(p) for p in pays], dst_capacities=CAP,
                   device="cpu")
    snap = metrics.snapshot()
    assert snap["device_inflate_batches"] == 1
    assert snap["device_inflate_lanes"] == 2
    assert snap["device_inflate_bytes_out"] == 500
    assert snap["host_fallback_lanes"] == 0
    assert snap["decode_chunk_launches"] == 0   # the CPU runs the twin
    assert snap["adler32_batch_launches"] == 0


def test_concurrent_device_inflate_calls_keep_their_own_bytes():
    """Two threads decode different batches at once; each gets its own
    bytes, as a serial run does (no buffer is shared between calls)."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(11)
    batches = [[zlib.compress(rng.integers(0, 4, 200 + 40 * i, np.uint8)
                              .tobytes() * 2, 6) for i in range(6)]
               for _ in range(2)]
    serial = [device_inflate(b, dst_capacities=CAP, device="cpu")[:2]
              for b in batches]
    with ThreadPoolExecutor(max_workers=2) as ex:
        futs = [ex.submit(device_inflate, b, dst_capacities=CAP,
                          device="cpu") for b in batches]
        threaded = [f.result()[:2] for f in futs]
    assert threaded == serial
    assert all(r == [Result.OK] * 6 for r, _ in serial)


def test_pipeline_matches_jax():
    pays = [b"data %d " % i * 50 for i in range(16)]
    batch = [zlib.compress(p, 6) for p in pays]
    batches = [batch, batch[3:] + batch[:3]]
    jpb, _ = jpipe.pipeline_inflate(batches, 4096, as_bytes=True)
    tpb, wall = pipeline_inflate(batches, 4096, as_bytes=True, device="cpu")
    assert wall > 0
    assert tpb == jpb
    assert tpb[1][1] == pays[3:] + pays[:3]


def test_pipeline_sink_and_host_retry():
    pays = [b"ok stream " * 30 for _ in range(7)]
    batch = [zlib.compress(p, 6)[2:-4] for p in pays] + [_evil()]
    seen = []

    def sink(i, status, out, dst_pos):
        seen.append(i)
        return ([int(s) for s in status],
                [out[k, : dst_pos[k]].tobytes() for k in range(len(status))])

    per_batch, _ = pipeline_inflate([batch, batch], 2048, flags=0, sink=sink,
                                    device="cpu")
    assert sorted(seen) == [0, 1]
    for status, outs in per_batch:
        assert status == [0] * 8
        assert outs == pays + [b"Z"]


@pytest.mark.parametrize("backend", ["device", "host", "auto"])
def test_a_memoryview_is_one_stream_on_every_backend(backend):
    """A ``memoryview`` is one stream, as ``bytes`` is, on every backend
    (``defl_tpu`` reads it as a list of chunks and raises)."""
    pays = [b"hello world %d " % i * 10 for i in range(8)]
    zs = [memoryview(zlib.compress(p)) for p in pays]
    res, outs = inflate_batch(zs, backend=backend, device="cpu")
    assert res == [Result.OK] * 8
    assert outs == [zlib.decompress(z) for z in zs] == pays
