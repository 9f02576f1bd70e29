"""Overlapped batch pipeline: device decode ‖ host LZ77 resolve.

Counterpart of ``defl_tpu/runtime/pipeline.py``: the card runs pass 1
(bitstream -> tokens) for batch i+1 while the host's multithreaded C++
resolver runs pass 2 for batch i-1, a depth-2 double buffer.  The loop
keeps the JAX package's order per iteration:

    fetch(i) -> decode(i+1) -> wait resolve(i-1) -> submit resolve(i)

In JAX the decode call returned at once (async dispatch).  Here the
decode is synchronous — one kernel launch, then one read of its totals
by the host — so decode(i+1) runs on the calling thread while resolve(i-1)
runs in the executor; the resolver is a ctypes call, which releases the
GIL, so the two overlap all the same.  The token fetch copies exactly
the occupied rows into a pinned host buffer of each batch's own, which
lives until that batch's resolve has finished.

Every stage is a ``metrics.span``, the batch index in the profiler's
``args``: ``defl.pack`` and ``defl.upload`` (each distinct batch once;
on the card one more upload span for the sync that ends them),
``defl.decode`` (the warm-up's too), ``defl.fetch``, ``defl.resolve`` (on
the resolver's thread) and ``defl.resolve_wait`` (the driving thread
blocked on that resolve).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from defl_tpu_torch import metrics
from defl_tpu_torch.errors import FLAG_ZLIB, Result
from defl_tpu_torch.ops import inflate_batch as ib
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.runtime import native
from defl_tpu_torch.runtime.pack import joined, pack_streams
from defl_tpu_torch.runtime.session import _pick_decoder, fetch_tokens


def pipeline_inflate(stream_batches, dst_capacity: int, flags=FLAG_ZLIB,
                     chunk_steps: int | None = None,
                     n_threads: int | None = None,
                     as_bytes: bool = False, sink=None, _fetch=None,
                     device="cuda"):
    """Decode a sequence of stream batches, overlapped.

    stream_batches: list of lists of compressed streams (each inner list
    is one device batch).  dst_capacity: per-stream output capacity.
    as_bytes: materialise per-stream ``bytes`` objects (the zero-copy
    default returns the resolved ``[N, C]`` array directly).
    sink: optional ``f(i, status, out, dst_pos) -> value`` consuming each
    batch as it resolves (per_batch then holds the sink's return values).
    Sinks normally run in batch order on one thread; a batch that needs a
    host retry has its sink called from the retry worker instead, so
    sinks must not assume ordering across batches.
    _fetch: test/bench hook — ``f(tokens, st) -> (toks_nt, dst_pos,
    status, bitpos)`` replacing the device->host fetch.
    device: CUDA by default (raises without a card); "cpu" runs the twin.

    Returns (per_batch, wall_seconds); per_batch entries are
    (results, outputs) with ``outputs = list[bytes]`` under ``as_bytes``,
    else (status int32 [N], out uint8 [N, C], dst_pos int32 [N]).
    """
    dev = _pick_decoder(device)
    native.load()
    zf = flags & FLAG_ZLIB
    C = int(dst_capacity)
    T = ib.step_budget(C)

    def default_fetch(tokens, st):
        # exactly the occupied rows (tok_rows: the last row any lane
        # wrote) into a pinned buffer of the batch's own; the per-lane
        # metadata crosses in one transfer
        toks_nt = fetch_tokens([(tokens, st["tok_rows"])])
        meta = torch.stack([st["dst_pos"], st["status"], st["bitpos"]]).cpu()
        return (toks_nt, *(m.numpy() for m in meta))

    fetch = _fetch or default_fetch

    if n_threads is None:
        # leave one core for the thread that drives the device
        n_threads = max(1, (os.cpu_count() or 2) - 1)

    # pack and upload each distinct batch once (repeated list objects
    # share one packing and one upload)
    packed_cache = {}
    packed = []
    dev_in = []
    up = lambda a: torch.from_numpy(a).to(dev)
    for i, b in enumerate(stream_batches):
        key = id(b)
        if key not in packed_cache:
            with metrics.span("defl.pack", str(i)):
                p = pack_streams(b, zf, C)
            with metrics.span("defl.upload", str(i)):
                packed_cache[key] = (p, (up(p.words.view(np.int32)),
                                         up(p.nbits), up(p.zflag),
                                         up(p.dst_cap)))
        p, d = packed_cache[key]
        packed.append(p)
        dev_in.append(d)
    if dev.type == "cuda":
        # uploads finish before the timed loop (one more upload span)
        with metrics.span("defl.upload"):
            torch.cuda.synchronize(dev)

    # One resolve runs at a time and sink / as_bytes modes consume the
    # array before returning, so one pre-faulted output buffer serves
    # every batch.
    reuse_out = sink is not None or as_bytes
    out_buf = None
    if reuse_out:
        out_buf = np.empty((max(p.n for p in packed), C), np.uint8)
        out_buf[:] = 0  # pre-fault outside the timed loop

    _RETRY = object()  # per_batch marker: (_RETRY, future)

    def finish_one(i, n, status, dst_pos, out):
        if sink is not None:
            return sink(i, status[:n], out[:n], dst_pos[:n])
        if as_bytes:
            return ([Result(int(s)) for s in status[:n]],
                    [out[k, : int(dst_pos[k])].tobytes() for k in range(n)])
        return status[:n], out[:n], dst_pos[:n]

    def resolve_one(i, toks_nt, dst_pos, status):
        # on the resolver's worker thread: the span reaches the counters,
        # and the trace only under a profiler that records every thread
        with metrics.span("defl.resolve", str(i)):
            out = native.native_resolve_tokens(
                toks_nt, packed[i].words, dst_pos, C, n_threads=n_threads,
                out=None if out_buf is None else out_buf[: toks_nt.shape[0]])
        n = len(stream_batches[i])
        # step-budget-exhausted lanes (status 127) retry on the host
        # engine (counted as ``pipeline_host_retries``), on their own
        # worker so that the pipeline does not stall behind them; with a
        # shared output buffer the batch's rows are copied first (the next
        # resolve reuses the buffer at once)
        rerun = [k for k in range(n) if int(status[k]) == ib.STATUS_RUNNING]
        if not rerun:
            return finish_one(i, n, status, dst_pos, out)
        metrics.inc("pipeline_host_retries", len(rerun))
        out_r = np.array(out[:n], copy=True) if reuse_out else out
        status = np.array(status, copy=True)
        dst_pos = np.array(dst_pos, copy=True)

        def retry():
            # single-threaded: runs beside the next batches' resolves
            rs, os_ = native.native_inflate_batch(
                [joined(stream_batches[i][k]) for k in rerun], C, flags,
                n_threads=1)
            for j, k in enumerate(rerun):
                status[k] = int(rs[j])
                dst_pos[k] = len(os_[j])
                out_r[k, : len(os_[j])] = np.frombuffer(os_[j], np.uint8)
            return finish_one(i, n, status, dst_pos, out_r)

        return _RETRY, retry_ex.submit(retry)

    def decode(i):
        w, nb, zfl, cp = dev_in[i]
        with metrics.span("defl.decode", str(i)):
            return decode_cu.decode_tokens(w, nb, zfl, cp, T=T,
                                           K=chunk_steps)

    # Warm up outside the timed region: the first decode builds the
    # kernel library (nvcc) and loads it.
    decode(0)

    per_batch = [None] * len(stream_batches)
    retry_ex = ThreadPoolExecutor(max_workers=1)
    t0 = time.perf_counter()
    B = len(dev_in)
    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = None  # (index, resolve future)
        tokens, st = decode(0)
        for i in range(B):
            with metrics.span("defl.fetch", str(i)):
                toks_nt, dst_pos, status, _ = fetch(tokens, st)
            if i + 1 < B:
                tokens, st = decode(i + 1)
            if pending is not None:
                j, fut = pending
                with metrics.span("defl.resolve_wait", str(j)):
                    per_batch[j] = fut.result()
            pending = (i, ex.submit(resolve_one, i, toks_nt, dst_pos, status))
        j, fut = pending
        with metrics.span("defl.resolve_wait", str(j)):
            per_batch[j] = fut.result()
    # join deferred retries (rare; confined to their batch slots)
    for j, v in enumerate(per_batch):
        if isinstance(v, tuple) and len(v) == 2 and v[0] is _RETRY:
            per_batch[j] = v[1].result()
    retry_ex.shutdown()
    wall = time.perf_counter() - t0
    return per_batch, wall
