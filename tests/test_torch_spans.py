"""``metrics.span`` and the spans of the port's entries, on the CPU.

- The primitive: ``<name>.ns`` and ``<name>.n`` from several threads at
  once, ``reset()``, the length it yields; ``record_function`` entered only
  while a profiler records, and then the span in the profiler's events
  under its own name, nested in its parent.
- The entries: ``device_inflate`` closes pack, upload, decode, fetch,
  resolve and lane_bytes once per decode; ``pipeline_inflate`` over B
  batches closes resolve and resolve_wait B times and decode B + 1 times
  (its warm-up decode); ``device_deflate``'s and ``inflate_large``'s
  ``stats_out`` seconds are their spans' lengths, to the nanosecond.
"""

import threading
import time
import zlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from defl_tpu_torch import device_deflate, device_inflate, metrics
from defl_tpu_torch.corpus import make_silesia_like
from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result
from defl_tpu_torch.runtime import large as tlarge
from defl_tpu_torch.runtime import native as tnative
from defl_tpu_torch.runtime.pipeline import pipeline_inflate

needs_native = pytest.mark.skipif(not tnative.available(),
                                  reason="native library unavailable")

INFLATE_SPANS = ("defl.pack", "defl.upload", "defl.decode", "defl.fetch",
                 "defl.resolve", "defl.lane_bytes")
DEFLATE_STAGES = ("fields", "upload", "pack", "fetch", "assemble")


def _streams(n, seed=0, size=700):
    rng = np.random.default_rng(seed)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"\x00\xff"]
    raws = [b"".join(words[k] for k in rng.integers(0, 5, size // 5))[:size]
            for _ in range(n)]
    return raws, [zlib.compress(r, 6) for r in raws]


def _delta(m0, m1, key):
    return m1.get(key, 0) - m0.get(key, 0)


def _kineto(prof, names):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name() in names]


# ---------------------------------------------------------------------------
# the primitive
# ---------------------------------------------------------------------------

def test_span_sums_ns_and_n_from_several_threads_and_reset_clears():
    metrics.reset()
    per_thread = [[] for _ in range(8)]
    go = threading.Barrier(8)

    def work(k):
        go.wait()
        for j in range(300):
            with metrics.span("test.span.a" if j % 3 else "test.span.b") \
                    as sp:
                pass
            per_thread[k].append((j % 3 != 0, sp.ns))

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = metrics.snapshot()
    a = [ns for rows in per_thread for is_a, ns in rows if is_a]
    b = [ns for rows in per_thread for is_a, ns in rows if not is_a]
    assert snap["test.span.a.n"] == len(a) == 8 * 200
    assert snap["test.span.b.n"] == len(b) == 8 * 100
    assert snap["test.span.a.ns"] == sum(a)
    assert snap["test.span.b.ns"] == sum(b)
    metrics.reset()
    assert "test.span.a.ns" not in metrics.snapshot()
    assert metrics.snapshot() == {}


def test_span_yields_its_own_length():
    m0 = metrics.snapshot()
    with metrics.span("test.span.sleep") as sp:
        time.sleep(0.02)
    m1 = metrics.snapshot()
    assert 0.02 <= sp.s < 5
    assert sp.s == sp.ns / 1e9
    assert _delta(m0, m1, "test.span.sleep.ns") == sp.ns
    assert _delta(m0, m1, "test.span.sleep.n") == 1


def test_a_span_counts_also_when_its_body_raises():
    m0 = metrics.snapshot()
    with pytest.raises(KeyError):
        with metrics.span("test.span.raises"):
            raise KeyError("x")
    assert _delta(m0, metrics.snapshot(), "test.span.raises.n") == 1


def test_record_function_only_while_a_profiler_records(monkeypatch):
    entered = []
    real = metrics._record_function

    def spy(name, args=None):
        entered.append((name, args))
        return real(name, args)

    monkeypatch.setattr(metrics, "_record_function", spy)
    with metrics.span("test.span.off", "7"):
        pass
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with metrics.span("test.span.on", "7"):
            pass
    assert entered == [("test.span.on", "7")]
    with metrics.span("test.span.off"):
        pass
    assert entered == [("test.span.on", "7")]


def test_span_lies_in_the_profilers_events_nested_in_its_parent():
    m0 = metrics.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.span("test.span.parent", "0"):
            with metrics.span("test.span.child", "0"):
                torch.zeros(64).add_(1)
            with metrics.span("test.span.child", "1"):
                torch.zeros(64).add_(1)
    ev = _kineto(prof, {"test.span.parent", "test.span.child"})
    parent = [e for e in ev if e.name() == "test.span.parent"]
    children = [e for e in ev if e.name() == "test.span.child"]
    assert len(parent) == 1 and len(children) == 2
    p = parent[0]
    for c in children:
        assert p.start_ns() <= c.start_ns()
        assert c.start_ns() + c.duration_ns() <= p.start_ns() + \
            p.duration_ns()
    # the counters sum by name whatever the args
    assert _delta(m0, metrics.snapshot(), "test.span.child.n") == 2


def test_a_worker_threads_span_reaches_the_counters_not_the_default_trace():
    """The profiler's default configuration records the thread that
    started it alone: a span on a worker thread is counted, not traced."""
    m0 = metrics.snapshot()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t = threading.Thread(
            target=lambda: metrics.span("test.span.worker").__enter__()
            .__exit__(None, None, None))
        t.start()
        t.join()
    assert _delta(m0, metrics.snapshot(), "test.span.worker.n") == 1
    assert _kineto(prof, {"test.span.worker"}) == []


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------

@needs_native
@pytest.mark.parametrize("resolve", ["host", "device"])
def test_device_inflate_closes_each_stage_once_per_decode(resolve):
    raws, zs = _streams(6, seed=1)
    m0 = metrics.snapshot()
    res, outs, _ = device_inflate(zs, FLAG_ZLIB | FLAG_VERIFY_ADLER32,
                                  dst_capacities=1024, resolve=resolve,
                                  device="cpu")
    m1 = metrics.snapshot()
    assert outs == raws and all(r is Result.OK for r in res)
    for name in INFLATE_SPANS:
        assert _delta(m0, m1, name + ".n") == 1, name
        assert _delta(m0, m1, name + ".ns") > 0, name
    assert _delta(m0, m1, "defl.resolve_wait.n") == 0


@needs_native
def test_device_inflate_spans_on_the_profilers_clock():
    _, zs = _streams(4, seed=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        device_inflate(zs, dst_capacities=1024, device="cpu")
    got = {e.name() for e in _kineto(prof, set(INFLATE_SPANS))}
    assert got == set(INFLATE_SPANS)


@needs_native
@pytest.mark.parametrize("B", [1, 3])
def test_pipeline_closes_resolve_and_wait_per_batch_and_one_more_decode(B):
    batches, raws = [], []
    for k in range(B):
        r, z = _streams(5, seed=10 + k)
        raws.append(r)
        batches.append(z)
    m0 = metrics.snapshot()
    per_batch, _ = pipeline_inflate(batches, 1024, n_threads=2,
                                    as_bytes=True, device="cpu")
    m1 = metrics.snapshot()
    assert [o for _, o in per_batch] == raws
    count = lambda name: _delta(m0, m1, name + ".n")   # noqa: E731
    assert count("defl.resolve") == B
    assert count("defl.resolve_wait") == B
    assert count("defl.decode") == B + 1        # the warm-up decode(0)
    assert count("defl.pack") == count("defl.upload") == B
    assert count("defl.fetch") == B
    assert count("defl.lane_bytes") == 0


@needs_native
@pytest.mark.parametrize("pack", ["scatter", "scan"])
def test_device_deflate_stats_are_its_spans(pack):
    payloads = [bytes(p) for p in make_silesia_like(6 * 4096, 4096)]
    st = {}
    m0 = metrics.snapshot()
    outs = device_deflate(payloads, level=6, stats_out=st, pack=pack,
                          device="cpu")
    m1 = metrics.snapshot()
    assert [zlib.decompress(o) for o in outs] == payloads
    for stage in DEFLATE_STAGES:
        key = "defl.deflate." + stage
        assert _delta(m0, m1, key + ".n") == 1, stage
        assert round(st[stage + "_s"] * 1e9) == _delta(m0, m1, key + ".ns"), \
            stage


@needs_native
def test_inflate_large_host_route_stats_are_its_span():
    raw = b"".join(make_silesia_like(1 << 18, 65536))
    st = {}
    m0 = metrics.snapshot()
    r, out = tlarge.inflate_large(zlib.compress(raw, 6), stats_out=st)
    m1 = metrics.snapshot()
    assert r is Result.OK and out == raw and st["route"] == "host_parallel"
    assert round(st["parallel_s"] * 1e9) == \
        _delta(m0, m1, "defl.large.parallel.ns")
    assert _delta(m0, m1, "defl.large.parallel.n") == 1
    assert _delta(m0, m1, "defl.large.find.n") == 0


@needs_native
def test_inflate_large_device_route_stats_are_its_spans(monkeypatch):
    monkeypatch.setattr(tlarge, "SEGMENT_BYTES", 1024)
    raw = b"".join(make_silesia_like(65536, 65536))[:24_000]
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 4)   # small blocks
    comp = co.compress(raw) + co.flush()
    st = {}
    m0 = metrics.snapshot()
    r, out = tlarge.inflate_large(comp, use_device=True, stats_out=st,
                                  device="cpu")
    m1 = metrics.snapshot()
    assert r is Result.OK and out == raw and st["route"] == "device"
    for stage in ("body", "find", "upload", "decode", "fetch", "stitch"):
        # the launch and its fetch are the chain path's, which the batch
        # split shares
        key = ("defl." if stage in ("decode", "fetch") else "defl.large.") \
            + stage
        assert _delta(m0, m1, key + ".n") == 1, stage
        assert round(st[stage + "_s"] * 1e9) == _delta(m0, m1, key + ".ns"), \
            stage
    assert "parallel_s" not in st
    assert _delta(m0, m1, "defl.large.parallel.n") == 0


@needs_native
@pytest.mark.parametrize("verify", [False, True])
def test_inflate_large_device_route_body_and_verify_spans(monkeypatch,
                                                          verify):
    """The card's route closes ``defl.large.body`` once a call, and
    ``defl.large.verify`` (the trailer's adler32 over the output) once a
    call under FLAG_VERIFY_ADLER32 alone."""
    monkeypatch.setattr(tlarge, "SEGMENT_BYTES", 1024)
    raw = b"".join(make_silesia_like(65536, 65536))[:24_000]
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 4)
    comp = co.compress(raw) + co.flush()
    flags = FLAG_ZLIB | (FLAG_VERIFY_ADLER32 if verify else 0)
    for calls in (1, 2):
        m0 = metrics.snapshot()
        for _ in range(calls):
            buf = np.zeros(len(raw), np.uint8)
            r, n = tlarge.inflate_large(comp, flags=flags,
                                        dst_capacity=len(raw),
                                        use_device=True, out=buf,
                                        device="cpu")
            assert r is Result.OK and buf.tobytes() == raw
        m1 = metrics.snapshot()
        assert _delta(m0, m1, "defl.large.body.n") == calls
        assert _delta(m0, m1, "defl.large.body.ns") > 0
        assert _delta(m0, m1, "defl.large.verify.n") == calls * verify
        assert (_delta(m0, m1, "defl.large.verify.ns") > 0) == verify
