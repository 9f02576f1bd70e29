"""Where one batch's time goes on the card: the stage and chunk-loop split.

    python -m defl_tpu_torch.breakdown [--streams 8192] [--block 65536]
                                       [--reps 3] [--json PATH]
    python -m defl_tpu_torch.breakdown --probe
    python -m defl_tpu_torch.breakdown --large [--payloads 1024]
    python -m defl_tpu_torch.breakdown --deflate [--streams 2048]

On bench.py's corpus (``make_silesia_like``, zlib level 6) it measures,
with a device sync after each part:

- the stages of one ``device_inflate`` batch, ``reps`` times: pack,
  upload, decode, token fetch, host resolve, per-lane ``bytes``; and
  beside them the device-resident route's pass 2 on the same tokens:
  device resolve, the adler32 kernel, and the output's copy to the host;
- inside one decode (``decode_cu.decode_tokens`` itself, ``reps`` times):
  the host's work before the launch (the carry packed once, the token
  buffer zero-filled, the lanes ordered), the stream kernel's device time
  by CUDA events, the call's one sync (the read of the launch's totals),
  the unpacking after it; launches, ``tok_rows``, steps, builds and the
  builds' share of the lanes' cycles;
- one decode under ``torch.profiler``: the union of device activity
  against the wall, i.e. the device's idle share, and the busiest kernels.

With ``--probe`` it times the stream kernel alone instead (CUDA events
around the launch, best of ``reps``): the whole batch, and with only the
batch's longest lane, only its 32 longest lanes, and only its median lane
running, which is the serial chain no launch shape can shorten.

With ``--large`` it joins the corpus's first ``payloads`` payloads into one
zlib level 6 stream and times ``inflate_large`` into a caller-owned,
pre-faulted buffer, ``reps`` times: the device route's stages (find, what
is left of the body's upload, decode, fetch, stitch), the launch's device
time by CUDA events, lanes, valid lanes and token rows; and beside it the
host-parallel engine and the serial C++ engine on the same buffer.

With ``--deflate`` it times ``device_deflate`` on ``streams`` payloads of
``block`` bytes, level 6, stage by stage (fields, upload, pack, fetch,
assemble) for both packs, ``native_deflate_batch`` beside them, and holds
all three byte-identical.

Prints a readable report and one JSON line; ``--json`` also writes the
JSON to a file.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from defl_tpu_torch.corpus import make_silesia_like
from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB
from defl_tpu_torch.runtime import large, native
from defl_tpu_torch.runtime.pack import pack_streams
from defl_tpu_torch.ops import inflate_batch as ib
from defl_tpu_torch.ops.checksums import adler32_batch
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.ops.resolve import resolve_tokens
from defl_tpu_torch.runtime.session import (_bucket, device_deflate,
                                            fetch_tokens)


def corpus(n: int, block: int):
    payloads = make_silesia_like(n * block, block)[:n]
    cache = {}
    streams = [cache.setdefault(id(p), zlib.compress(p, 6)) for p in payloads]
    return payloads, streams


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
    t["launches"] = decode_cu.launches - l0
    t["tok_rows"] = st["tok_rows"]
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


def decode_split(args, C, reps):
    """One decode's parts (seconds), ``reps`` times after a warm-up."""
    launch, read = decode_cu._launch_stream, decode_cu._read_meta
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = {}

    def timed_launch(*a, **k):
        e0.record()
        launch(*a, **k)
        e1.record()
        t["launched"] = time.perf_counter()

    def timed_read(meta):
        t["read_from"] = time.perf_counter()
        out = read(meta)
        t["read_to"] = time.perf_counter()
        return out

    decode_cu._launch_stream, decode_cu._read_meta = timed_launch, timed_read
    out = []
    try:
        for r in range(reps + 1):
            l0 = decode_cu.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, st = decode_cu.decode_tokens(*args, T=ib.step_budget(C))
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if r:
                out.append({
                    "wall": t2 - t0, "before_launch": t["launched"] - t0,
                    "kernel_device": e0.elapsed_time(e1) / 1e3,
                    "sync_read": t["read_to"] - t["read_from"],
                    "after_read": t1 - t["read_to"], "drain": t2 - t1,
                    "launches": decode_cu.launches - l0,
                    **st["stream_stats"]})
    finally:
        decode_cu._launch_stream, decode_cu._read_meta = launch, read
    return out


def probe(args, C, reps):
    """The stream kernel alone: the whole batch, and single lanes."""
    from defl_tpu_torch.ops.cuda import build

    N = args[1].shape[0]
    T = ib.step_budget(C)
    launch = decode_cu._launch_stream
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed_launch(*a, **k):
        e0.record()
        launch(*a, **k)
        e1.record()

    def best(carry=None):
        times = []
        for _ in range(reps + 1):
            tok, st = decode_cu.decode_tokens(*args, T=T, carry=carry)
            torch.cuda.synchronize()
            times.append(e0.elapsed_time(e1))
        return min(times[1:]), tok, st

    def only(lanes):
        """A fresh carry in which only ``lanes`` are RUNNING."""
        dev = args[0].device
        st = ib._init_scan_state(N, dev)
        st["state"] = torch.where(args[2] > 0, ib.S_ZHDR,
                                  ib.S_BHDR).to(torch.int32)
        st["status"].fill_(0)
        st["status"][torch.as_tensor(lanes, device=dev)] = ib.STATUS_RUNNING
        return {**st, **ib._init_chunk_state(N, dev)}

    decode_cu._launch_stream = timed_launch
    try:
        ms, tok, st = best()
        if (st["status"] != 0).any():
            raise AssertionError("whole batch: lanes not OK")
        rec = {"threads": decode_cu.STREAM_THREADS,
               "lanes_per_warp": decode_cu.STREAM_LANES_PER_WARP,
               "ptxas": [l.strip() for l in build.build_log.splitlines()
                         if "registers" in l],
               "whole_batch": {"ms": ms, **st["stream_stats"]}}
        by_len = torch.argsort(lane_rows(tok, st["tok_rows"])).tolist()
        for name, lanes in (("longest_lane", by_len[-1:]),
                            ("longest_32_lanes", by_len[-32:]),
                            ("median_lane", by_len[N // 2:N // 2 + 1])):
            ms, _, one = best(carry=only(lanes))
            rec[name] = {"ms": ms, "steps": one["stream_stats"]["steps"]}
    finally:
        decode_cu._launch_stream = launch
    print(json.dumps(rec), flush=True)
    return rec


def lane_rows(tok, rows):
    """int64 [N]: one past the last token row each lane wrote, i.e. twice
    the steps it took up to its last token."""
    used = torch.zeros(tok.shape[1], dtype=torch.int64, device=tok.device)
    for r0 in range(0, rows, 4096):
        live = tok[r0:min(r0 + 4096, rows)] != 0
        at = torch.arange(r0, r0 + live.shape[0],
                          device=tok.device)[:, None] + 1
        used = torch.maximum(used, torch.where(live, at, 0).amax(0))
    return used


def profile(args, C, K=None, trace=None):
    """One decode under torch.profiler: device busy time (union of device
    activity), wall, idle share and the busiest kernels.  ``K`` is the
    decode's chunk length (``decode_tokens``'s default when None);
    ``trace`` (a file path) also keeps the timeline as a Chrome trace.
    Tensors on the CPU trace the host alone: no device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    on_card = args[0].device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    with tprofile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])) as prof:
        t0 = time.perf_counter()
        decode_cu.decode_tokens(*args, T=ib.step_budget(C), K=K)
        sync()
        wall = time.perf_counter() - t0
    if trace:
        prof.export_chrome_trace(trace)
    spans, per_name = [], {}
    # (the CPU's plain version records ~10^5 ops a chunk and no device
    # event: nothing to scan)
    for e in prof.events() if on_card else ():
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


class timed_stream_launch:
    """While active, every launch of the stream kernel is bracketed by
    CUDA events and every decode's totals are kept: ``ms`` lists the
    launches' device times (read after a sync), ``stats`` the
    ``stream_stats`` of each decode."""

    def __enter__(self):
        self._launch, self._read = (decode_cu._launch_stream,
                                    decode_cu._read_meta)
        self._events, self.meta = [], []

        def launch(*a, **k):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            self._launch(*a, **k)
            e1.record()
            self._events.append((e0, e1))

        def read(meta):
            out = self._read(meta)
            self.meta.append(out)
            return out

        decode_cu._launch_stream, decode_cu._read_meta = launch, read
        return self

    def __exit__(self, *exc):
        decode_cu._launch_stream, decode_cu._read_meta = (self._launch,
                                                          self._read)

    @property
    def ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self._events]


def large_stream(n_payloads: int, block: int = 65536):
    """(raw, zlib level 6 stream) of the corpus's first payloads joined."""
    raw = b"".join(make_silesia_like(n_payloads * block, block)[:n_payloads])
    return raw, zlib.compress(raw, 6)


def large_stages(raw, comp, reps, flags=FLAG_ZLIB | FLAG_VERIFY_ADLER32):
    """``inflate_large`` into one caller-owned, pre-faulted buffer: the
    device route stage by stage, then the host-parallel and the serial C++
    engines.  Every run's bytes are held against ``raw``."""
    buf = np.zeros(len(raw) + 64, np.uint8)
    buf.fill(1)                         # touch every page before timing
    want = np.frombuffer(raw, np.uint8)

    def check(r, n, what):
        if int(r) != 0 or n != len(raw) or not np.array_equal(buf[:n], want):
            raise AssertionError(f"{what}: result {r}, {n} bytes, or bytes "
                                 f"differ")
        buf[:n] = 1

    out = {"device": [], "host_parallel": [], "serial": []}
    for r in range(reps + 1):           # the first run warms up
        st = {}
        l0 = decode_cu.launches
        with timed_stream_launch() as tl:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, n = large.inflate_large(comp, flags, use_device=True,
                                         out=buf, stats_out=st)
            st["wall_s"] = time.perf_counter() - t0
            st["launch_ms"] = tl.ms
        st["launches"] = decode_cu.launches - l0
        check(res, n, "device route")
        if st["route"] != "device":
            raise AssertionError(f"route {st['route']}, not the device")
        st["tokens"], st["steps"] = tl.meta[-1][6], tl.meta[-1][1]
        if r:
            out["device"].append(st)
    for r in range(reps):
        st = {}
        t0 = time.perf_counter()
        res, n = large.inflate_large(comp, flags, use_device=False, out=buf,
                                     stats_out=st)
        st["wall_s"] = time.perf_counter() - t0
        check(res, n, "host-parallel engine")
        out["host_parallel"].append(st)
        t0 = time.perf_counter()
        res, n = native.native_inflate(comp, len(raw), flags, out=buf)
        wall = time.perf_counter() - t0
        check(res, n, "serial engine")
        out["serial"].append({"wall_s": wall})
    return out


def deflate_stages(payloads, reps, level=6):
    """``device_deflate`` stage by stage for both packs, and
    ``native_deflate_batch`` beside them; all byte-identical."""
    out = {"scan": [], "scatter": [], "host": []}
    _, want = native.native_deflate_batch(payloads, level=level)
    for r in range(reps + 1):           # the first run warms up
        for pack in ("scan", "scatter"):
            st = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = device_deflate(payloads, level=level, stats_out=st,
                                 pack=pack)
            st["wall_s"] = time.perf_counter() - t0
            if got != want or st["device_fallbacks"]:
                raise AssertionError(f"device_deflate({pack}) differs from "
                                     f"the host encoder, or fell back")
            if r:
                out[pack].append(st)
        t0 = time.perf_counter()
        native.native_deflate_batch(payloads, level=level)
        if r:
            out["host"].append({"wall_s": time.perf_counter() - t0})
    out["bytes_in"] = sum(map(len, payloads))
    out["bytes_out"] = sum(map(len, want))
    return out


def _fmt(d):
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in d.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=None,
                    help="8192, or 2048 with --deflate")
    ap.add_argument("--block", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", default=None)
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--large", action="store_true")
    ap.add_argument("--payloads", type=int, default=1024)
    ap.add_argument("--deflate", action="store_true")
    a = ap.parse_args(argv)
    if a.streams is None:
        a.streams = 2048 if a.deflate else 8192
    if not torch.cuda.is_available():
        print("breakdown: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    def finish(rec):
        if a.json:
            with open(a.json, "w") as f:
                json.dump(rec, f, indent=1)
        print(json.dumps(rec))
        return 0

    if a.large:
        t0 = time.perf_counter()
        raw, comp = large_stream(a.payloads, a.block)
        print(f"stream: {a.payloads} x {a.block} B joined, raw {len(raw)} B, "
              f"compressed {len(comp)} B, made in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        rec = large_stages(raw, comp, a.reps)
        for name in ("device", "host_parallel", "serial"):
            for r, st in enumerate(rec[name]):
                print(f"{name} rep {r}: {_fmt(st)}", flush=True)
        return finish({"card": card, "payloads": a.payloads,
                       "block": a.block, "raw_bytes": len(raw),
                       "compressed_bytes": len(comp), "large": rec})
    if a.deflate:
        n = a.streams
        payloads = make_silesia_like(n * a.block, a.block)[:n]
        rec = deflate_stages(payloads, a.reps)
        for name in ("scan", "scatter", "host"):
            for r, st in enumerate(rec[name]):
                print(f"{name} rep {r}: {_fmt(st)}", flush=True)
        return finish({"card": card, "streams": n, "block": a.block,
                       "deflate": rec})
    payloads, streams = corpus(a.streams, a.block)
    print(f"corpus: {a.streams} x {a.block} B, raw "
          f"{sum(map(len, payloads))} B", flush=True)
    if a.probe:
        dev = torch.device("cuda")
        p = pack_streams(streams, 1, a.block)
        args = tuple(torch.from_numpy(x).to(dev) for x in (
            p.words.view(np.int32), p.nbits, p.zflag, p.dst_cap))
        rec = {"card": card, "streams": a.streams, "block": a.block,
               "probe": probe(args, _bucket(a.block), a.reps)}
        if a.json:
            with open(a.json, "w") as f:
                json.dump(rec, f, indent=1)
        return 0
    reps = []
    for r in range(a.reps):
        t, args, C = stages(streams, payloads, a.block)
        reps.append(t)
        print(f"stages rep {r}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in t.items()), flush=True)
    split = decode_split(args, C, a.reps)
    for r, part in enumerate(split):
        print(f"decode rep {r}: " + ", ".join(
            f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in part.items()), flush=True)
    prof = profile(args, C)
    print(f"profiler: wall {prof['wall_s']:.4f} s, device busy "
          f"{prof['device_busy_s']}, idle share {prof['idle_share']}",
          flush=True)
    for k in prof["top"]:
        print(f"  {k['count']:5d} x {k['s'] * 1e3:9.3f} ms  {k['name'][:70]}")
    rec = {"card": card, "streams": a.streams, "block": a.block,
           "stages": reps,
           "decode": split, "profiler": prof}
    if a.json:
        with open(a.json, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
