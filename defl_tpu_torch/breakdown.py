"""Where one batch's time goes on the card: the stage and chunk-loop split.

    python -m defl_tpu_torch.breakdown [--streams 8192] [--block 65536]
                                       [--reps 3] [--json PATH]

On bench.py's corpus (``make_silesia_like``, zlib level 6) it measures,
with a device sync after each part:

- the stages of one ``device_inflate`` batch, ``reps`` times: pack,
  upload, decode, token fetch, host resolve, per-lane ``bytes``; and
  beside them the device-resident route's pass 2 on the same tokens:
  device resolve, the adler32 kernel, and the output's copy to the host;
- inside one decode, the chunk loop's parts summed over its chunks: the
  gate sync, the table builds, the kernel-input repack, the kernel and
  the state unpack.  The loop is ``decode_cu.decode_tokens`` itself, with
  those functions wrapped in timers for the run;
- one decode under ``torch.profiler``: the union of device activity
  against the wall, i.e. the device's idle share, and the busiest kernels.

Each part is timed with a sync around it, so the parts add up to more
than an unsynced decode.  Prints a readable report and one JSON line;
``--json`` also writes the JSON to a file.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from defl_tpu_torch.corpus import make_silesia_like
from defl_tpu_torch.runtime import native
from defl_tpu_torch.runtime.pack import pack_streams
from defl_tpu_torch.ops import inflate_batch as ib
from defl_tpu_torch.ops.checksums import adler32_batch
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.ops.resolve import resolve_tokens
from defl_tpu_torch.runtime.session import _bucket, fetch_tokens


def corpus(n: int, block: int):
    payloads = make_silesia_like(n * block, block)[:n]
    cache = {}
    streams = [cache.setdefault(id(p), zlib.compress(p, 6)) for p in payloads]
    return payloads, streams


def _timed(fn, acc, key):
    def run(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn(*a, **k)
        torch.cuda.synchronize()
        acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        return r
    return run


@contextlib.contextmanager
def _loop_timers(acc):
    """Wrap the chunk loop's parts in synced timers for one decode."""
    saved = [(ib, "_chunk_gate"), (ib, "_apply_builds"),
             (decode_cu, "_kernel_inputs"), (decode_cu, "_unpack_state")]
    names = ["gate_sync", "table_builds", "kernel_input_repack",
             "state_unpack"]
    old = [getattr(m, a) for m, a in saved]
    try:
        for (m, a), f, name in zip(saved, old, names):
            setattr(m, a, _timed(f, acc, name))
        yield _timed(decode_cu.decode_chunk, acc, "kernel")
    finally:
        for (m, a), f in zip(saved, old):
            setattr(m, a, f)


def stages(streams, payloads, block):
    """One device_inflate batch, stage by stage (seconds)."""
    dev = torch.device("cuda")
    t = {}
    t0 = time.perf_counter()
    p = pack_streams(streams, 1, block)
    t["pack"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    as_dev = lambda a: torch.from_numpy(a).to(dev)
    args = (as_dev(p.words.view(np.int32)), as_dev(p.nbits),
            as_dev(p.zflag), as_dev(p.dst_cap))
    torch.cuda.synchronize()
    t["upload"] = time.perf_counter() - t0
    C = _bucket(block)
    l0 = decode_cu.launches
    t0 = time.perf_counter()
    tokens, st = decode_cu.decode_tokens(*args, T=ib.step_budget(C))
    torch.cuda.synchronize()
    t["decode"] = time.perf_counter() - t0
    t["chunks"] = decode_cu.launches - l0
    t0 = time.perf_counter()
    toks = fetch_tokens([(tokens, st["tok_rows"])])
    dst_pos = st["dst_pos"].cpu().numpy()
    t["fetch"] = time.perf_counter() - t0
    t["fetch_bytes"] = toks.nbytes
    # the device-resident route's pass 2, on the same tokens
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out_dev = resolve_tokens(tokens[: st["tok_rows"]], args[0],
                             st["dst_pos"], C=C)
    torch.cuda.synchronize()
    t["device_resolve"] = time.perf_counter() - t0
    t["device_resolve_peak_bytes"] = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    sums = adler32_batch(out_dev, st["dst_pos"]).cpu().tolist()
    t["device_adler32"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_host = out_dev.cpu().numpy()
    t["device_output_copy"] = time.perf_counter() - t0
    del tokens, out_dev
    t0 = time.perf_counter()
    out = native.native_resolve_tokens(toks, p.words, dst_pos, C)
    t["resolve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [out[i, : dst_pos[i]].tobytes() for i in range(len(streams))]
    t["bytes"] = time.perf_counter() - t0
    if outs != payloads or (st["status"] != 0).any():
        raise AssertionError("stage run decoded wrong bytes")
    # (the host resolver may write past a lane's end: compare to dst_pos)
    if any(out_host[i, : dst_pos[i]].tobytes() != x
           for i, x in enumerate(payloads)) or \
            sums != [zlib.adler32(x) for x in payloads]:
        raise AssertionError("device resolve or adler32 disagree with the "
                             "host route")
    return t, args, C


def loop_split(args, C):
    """The chunk loop's parts, summed over one decode (seconds)."""
    acc = {}
    ref = decode_cu.decode_tokens(*args, T=ib.step_budget(C))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _loop_timers(acc) as chunk:
        tok, st = decode_cu.decode_tokens(*args, T=ib.step_budget(C),
                                          _chunk=chunk)
    acc["wall"] = time.perf_counter() - t0
    if st["tok_rows"] != ref[1]["tok_rows"] or not torch.equal(tok, ref[0]):
        raise AssertionError("timed loop differs from the plain loop")
    return acc


def profile(args, C):
    """One decode under torch.profiler: device busy time (union of device
    activity), wall, idle share and the busiest kernels."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode_cu.decode_tokens(*args, T=ib.step_budget(C))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, per_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        n, us = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (n + 1, us + (b - a))
    busy_us, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:6]
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6 if spans else None,
            "idle_share": 1 - busy_us / 1e6 / wall if spans else None,
            "device_events": len(spans),
            "top": [{"name": k, "count": n, "s": us / 1e6}
                    for k, (n, us) in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=8192)
    ap.add_argument("--block", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    payloads, streams = corpus(a.streams, a.block)
    print(f"corpus: {a.streams} x {a.block} B, raw "
          f"{sum(map(len, payloads))} B", flush=True)
    reps = []
    for r in range(a.reps):
        t, args, C = stages(streams, payloads, a.block)
        reps.append(t)
        print(f"stages rep {r}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()), flush=True)
    split = loop_split(args, C)
    print("chunk loop (s, synced): " + ", ".join(
        f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    prof = profile(args, C)
    print(f"profiler: wall {prof['wall_s']:.4f} s, device busy "
          f"{prof['device_busy_s']}, idle share {prof['idle_share']}",
          flush=True)
    for k in prof["top"]:
        print(f"  {k['count']:5d} x {k['s'] * 1e3:9.3f} ms  {k['name'][:70]}")
    rec = {"card": card, "streams": a.streams, "block": a.block,
           "stages": reps,
           "chunk_loop": split, "profiler": prof}
    if a.json:
        with open(a.json, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
