"""Scaling evidence for the sharded decode (counterpart of
``defl_tpu/bench_scaling.py``, with its modes and JSON keys).

  - ``scaling`` (``measure``): wall of the SAME batch decoded by
    ``DistributedCodec`` over one device and over every local device:
    ``shard1_s``, ``shard<n>_s``, ``shard<n>_speedup``;
  - ``pinned1`` (``measure_pinned1``): one shard on the CPU with the
    process pinned to one core and one torch thread, set before any work:
    the single-core baseline for a cores-matched efficiency;
  - ``overhead`` (``measure_overhead``): ``DistributedCodec`` on one
    device against raw ``device_inflate`` on the same batch, in
    interleaved rounds: ``dist_overhead_pct``, the cost of the sharding
    machinery itself (splitting, threads, collectives, gather).

Run standalone (each prints one JSON line, which names the device)::

  python -m defl_tpu_torch.bench_scaling [scaling|pinned1|overhead]
  python -m defl_tpu_torch.bench_scaling scaling --device cpu --shards 8

On the card the devices are every visible CUDA device; ``--device cpu``
runs the plain versions over ``--shards`` CPU shards.  A time taken on the
CPU is the CPU's, never a card's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib


def _batch(n_streams: int, block: int):
    from defl_tpu_torch.corpus import make_silesia_like

    payloads = make_silesia_like(n_streams * block, block)[:n_streams]
    return payloads, [zlib.compress(p, 6) for p in payloads]


def _device_name(dev) -> str:
    import torch

    dev = torch.device(dev)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _check(res, outs, payloads):
    if any(int(r) != 0 for r in res) or outs != payloads:
        raise AssertionError("sharded decode: a lane is not OK or its bytes "
                             "differ")


def measure(n_streams: int = 256, block: int = 32768, reps: int = 5,
            devices=None):
    """Shard1 against shardN over ``devices`` (default: every visible
    card), best of ``reps`` after one warm-up each."""
    from defl_tpu_torch.parallel.mesh import make_stream_mesh
    from defl_tpu_torch.parallel.shard import DistributedCodec

    devs = list(make_stream_mesh(devices).devices)
    payloads, streams = _batch(n_streams, block)
    raw_bytes = sum(len(p) for p in payloads)

    def time_codec(codec):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            res, outs, _ = codec.inflate(streams, dst_capacities=block)
            best = min(best, time.perf_counter() - t0)
            _check(res, outs, payloads)
        return best

    codec1 = DistributedCodec(make_stream_mesh(devs[:1]))
    codec_n = DistributedCodec(make_stream_mesh(devs))
    codec1.inflate(streams, dst_capacities=block)   # warm-up
    codec_n.inflate(streams, dst_capacities=block)
    shard1_s = time_codec(codec1)
    shardn_s = time_codec(codec_n)
    n = len(devs)
    return {
        "scaling_n_devices": n,
        "scaling_raw_mb": round(raw_bytes / 1e6, 1),
        "shard1_s": shard1_s,
        f"shard{n}_s": shardn_s,
        f"shard{n}_speedup": shard1_s / shardn_s,
        "device": _device_name(devs[0]),
    }


def measure_pinned1(n_streams: int = 256, block: int = 32768,
                    reps: int = 5):
    """One CPU shard with this process pinned to its first allowed core
    and torch held to one thread, both set before any work and given back
    after: the honest single-core baseline (an unpinned run lets torch's
    intra-op threads use every core)."""
    import torch

    from defl_tpu_torch.parallel.mesh import make_stream_mesh
    from defl_tpu_torch.parallel.shard import DistributedCodec

    cores, threads = os.sched_getaffinity(0), torch.get_num_threads()
    os.sched_setaffinity(0, {min(cores)})
    torch.set_num_threads(1)
    try:
        payloads, streams = _batch(n_streams, block)
        codec = DistributedCodec(make_stream_mesh(["cpu"]))
        codec.inflate(streams, dst_capacities=block)   # warm-up
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            res, outs, _ = codec.inflate(streams, dst_capacities=block)
            best = min(best, time.perf_counter() - t0)
            _check(res, outs, payloads)
    finally:
        torch.set_num_threads(threads)
        os.sched_setaffinity(0, cores)
    return {"shard1core_s": best, "device": "cpu"}


def measure_overhead(n_streams: int = 256, block: int = 32768,
                     reps: int = 3, device="cuda", batch=None):
    """DistributedCodec on one device against raw ``device_inflate``, both
    with the host resolver, on the same batch: one warm-up each, then
    ``reps`` interleaved rounds, best of each (background drift otherwise
    swings the comparison).  ``batch`` = (payloads, streams) takes a batch
    the caller already has, at capacity ``block``."""
    from defl_tpu_torch.parallel.mesh import make_stream_mesh
    from defl_tpu_torch.parallel.shard import DistributedCodec
    from defl_tpu_torch.runtime.session import device_inflate

    payloads, streams = batch if batch is not None else _batch(n_streams,
                                                               block)
    codec = DistributedCodec(make_stream_mesh([device]))

    def t_codec():
        t0 = time.perf_counter()
        res, outs, _ = codec.inflate(streams, dst_capacities=block)
        dt = time.perf_counter() - t0
        _check(res, outs, payloads)
        return dt

    def t_raw():
        t0 = time.perf_counter()
        res, outs, _ = device_inflate(streams, dst_capacities=block,
                                      device=device)
        dt = time.perf_counter() - t0
        _check(res, outs, payloads)
        return dt

    t_codec()
    t_raw()
    codec_times, raw_times = [], []
    for _ in range(reps):
        codec_times.append(t_codec())
        raw_times.append(t_raw())
    codec_s, raw_s = min(codec_times), min(raw_times)
    return {
        "dist_overhead_pct": 100.0 * (codec_s - raw_s) / raw_s,
        "codec1_s": codec_s,
        "raw_device_inflate_s": raw_s,
        "codec1_rounds_s": codec_times,
        "raw_rounds_s": raw_times,
        "device": _device_name(device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m defl_tpu_torch.bench_scaling")
    ap.add_argument("mode", nargs="?", default="scaling",
                    choices=("scaling", "pinned1", "overhead"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shards", type=int, default=8,
                    help="CPU shards of the scaling mode with --device cpu")
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--block", type=int, default=32768)
    args = ap.parse_args(argv)
    size = dict(n_streams=args.streams, block=args.block)
    if args.mode == "pinned1":
        res = measure_pinned1(**size)
    elif args.mode == "overhead":
        res = measure_overhead(**size, device=args.device)
    else:
        res = measure(**size, devices=(["cpu"] * args.shards
                                       if args.device == "cpu" else None))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
