#!/usr/bin/env python3
"""One cell of the benchmark of ``defl_tpu_torch``, run once on the card.

    python3 codec_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Everything
else is found by name: ``workloads/<cell>.json`` (the traffic: the entry,
the pool of batches, the entry's parameters, the calls checked and the
limits), the configuration file that ``BENCHMARK.json`` names (the
generator and its format), ``data/<generator>.py``, ``entries/<entry>.py``
and ``metrics/<metric>.py`` for each metric the cell reports.

A run makes its pool of batches from the seed, hands the entry each call's
argument once to warm up, then calls it in a closed loop (one caller, each
call awaited) for ``--seconds``: the window runs from the start of the
first call to the end of the last.  ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, read under
``torch.profiler``.  Then it holds a sample of the calls, drawn from the
seed, against the reference (``reference/``, the standard library's zlib),
and last, just before the result is printed, checks that no module of JAX
or of the JAX package is loaded.  The last line of standard output is the
result; the last lines of standard error are the numbers compared, each
beside its limit.  Without a card (or with fewer than the cell asks for)
it prints no result and exits 1.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the checkout's root, never this folder, heads the path: the harness's
# own modules are imported as ``codec_bench.*`` and shadow nothing
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from codec_bench import check, guard, timeline  # noqa: E402

BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


@dataclass
class Window:
    """What the readers in ``metrics/`` read."""
    kind: str
    window_s: float
    setup_s: float
    calls: int
    latencies_s: list
    lanes: int
    failed: int
    raw_bytes: int
    comp_bytes: int
    counters: dict
    cpu_s: float
    stages: dict = field(default_factory=dict)
    trace: timeline.Summary | None = None
    peak_Bps: float | None = None


class Sample:
    """A uniform sample of at most ``k`` of the items offered (reservoir
    sampling), drawn from ``rng``."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def load_json(path):
    with open(path) as f:
        return json.load(f)


def module_at(path: str):
    """The Python file at ``path`` as a module (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "codec_bench_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones (those listing the cell, or, without a
    list, those whose end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def card_name(device) -> tuple[str, str]:
    import torch

    if torch.device(device).type == "cuda":
        return "gpu", torch.cuda.get_device_name(torch.device(device))
    return "cpu", "cpu"


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


@dataclass
class Cell:
    """A cell as the files found by its name give it."""
    name: str
    chips: int
    workload: dict       # workloads/<cell>.json
    fmt: dict            # the configuration's format
    params: dict         # the entry's parameters
    pool: int            # distinct batches
    batch: int           # streams or payloads a batch
    gen: object          # data/<generator>.py
    entry: object        # entries/<entry>.py


def load_cell(bench: dict, name: str, shrink: dict | None = None,
              workloads_dir: str | None = None) -> Cell:
    """Cell ``name`` of ``bench``.  For the tests alone: ``shrink``
    overrides the format's and the workload's numbers, for a tiny run on
    the CPU; ``workloads_dir`` holds the workload files."""
    shrink = shrink or {}
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    wl = load_json(os.path.join(workloads_dir or os.path.join(
        HERE, "workloads"), name + ".json"))
    if wl["config"] != cell["config"] or wl["traffic"] != cell["traffic"]:
        raise ValueError(f"{name}: the workload file's config or traffic is "
                         f"not BENCHMARK.json's")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = load_json(os.path.join(ROOT, conf["file"]))
    return Cell(
        name=name, chips=int(cell["chips"]), workload=wl,
        fmt={**cfg["format"], **shrink.get("format", {})},
        params={**wl["params"], **shrink.get("params", {})},
        pool=int(shrink.get("pool", wl["pool"])),
        batch=int(shrink.get("batch", wl["batch"])),
        gen=importlib.import_module(f"codec_bench.data.{cfg['generator']}"),
        entry=importlib.import_module(f"codec_bench.entries.{wl['entry']}"))


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", shrink: dict | None = None,
             workloads_dir: str | None = None) -> dict:
    """Run cell ``name`` once; the result's dict.  ``shrink`` and
    ``workloads_dir``: see ``load_cell``."""
    import torch

    from defl_tpu_torch import metrics as counters

    c = load_cell(bench, name, shrink, workloads_dir)
    wl, fmt, params, entry = c.workload, c.fmt, c.params, c.entry
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    # set-up: the card, the pool from the seed, every call's argument, one
    # warm-up call of each distinct argument
    steps = [("start", time.perf_counter() - T_START)]
    torch.zeros(1, device=device)
    steps.append(("card", time.perf_counter() - T_START))
    pool = c.gen.make_pool(fmt, seed, c.pool, c.batch,
                           encode=entry.KIND == "inflate")
    steps.append(("pool", time.perf_counter() - T_START))
    args = entry.prepare(pool, params, device)
    for a in args:
        entry.call(a, params, device, {})
    sync()
    steps.append(("warm-up", time.perf_counter() - T_START))
    print("set-up, s from the start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in steps), file=sys.stderr)

    kept = Sample(int(wl["check_calls"]), random.Random(seed))
    stages: dict = {}
    lat: list = []
    lanes = failed = bytes_out = bytes_in = 0
    tracer = None
    if trace:
        from codec_bench.trace import Tracer
        tracer = Tracer(on_card)
    span = tracer.span if tracer else (lambda n: contextlib.nullcontext())
    counters.reset()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    with tracer or contextlib.nullcontext():
        with span(timeline.WINDOW_SPAN):
            t0 = time.perf_counter()
            k = 0
            while True:
                a = args[k % len(args)]
                ts = time.perf_counter()
                with span(timeline.CALL_SPAN):
                    res = entry.call(a, params, device, stages)
                te = time.perf_counter()
                lat.append(te - ts)
                n, bad, out = entry.account(a, res)
                lanes, failed = lanes + n, failed + bad
                bytes_out, bytes_in = bytes_out + out, bytes_in + a.bytes_in
                kept.offer((a, res))
                del res  # a result not kept is freed before the next call
                k += 1
                if te - t0 >= seconds:
                    break
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    window_s = te - t0
    srt = sorted(lat)
    by_arg = [sorted(lat[i::len(args)]) for i in range(min(k, len(args)))]
    print(f"window: {k} calls in {window_s:.3f} s; a call's s: min "
          f"{srt[0]:.4f}, median {srt[len(srt) // 2]:.4f}, max {srt[-1]:.4f}; "
          f"median by argument: "
          + ", ".join(f"{v[len(v) // 2]:.4f}" for v in by_arg)
          + f"; host CPU: user {ru1.ru_utime - ru0.ru_utime:.3f} s, system "
          f"{ru1.ru_stime - ru0.ru_stime:.3f} s", file=sys.stderr)
    got_counters = counters.snapshot()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    summary = tracer.summary() if tracer else None

    platform, kind = card_name(device)
    peaks = load_json(os.path.join(HERE, "peaks.json"))
    inflate = entry.KIND == "inflate"
    w = Window(kind=entry.KIND, window_s=window_s,
               setup_s=t0 - T_START, calls=k, latencies_s=lat, lanes=lanes,
               failed=failed, raw_bytes=bytes_out if inflate else bytes_in,
               comp_bytes=bytes_in if inflate else bytes_out,
               counters=got_counters,
               cpu_s=(ru1.ru_utime + ru1.ru_stime
                      - ru0.ru_utime - ru0.ru_stime),
               stages=stages, trace=summary,
               peak_Bps=peaks.get(kind, {}).get("hbm_bytes_per_s"))
    out_metrics = {}
    for m in cell_metrics(bench, name, trace):
        v = module_at(os.path.join(HERE, "metrics", m["name"] + ".py")).read(w)
        if v is not None:
            out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": platform, "kind": kind, "count": c.chips,
           "memory_peak_bytes": int(peak)}
    if summary is not None and summary.busy_s > 0:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    if on_card:
        dev["power_limit"] = power_limit()

    # the check, once the window has closed and the peak has been read
    got = check.numbers(entry.KIND, entry, pool, kept.items, failed,
                        int(fmt["level"]))
    correct, checks = check.judge(got, wl["limits"])
    result = {"correct": correct, "attempted": lanes, "failed": failed,
              "metrics": out_metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result


def finish(result: dict) -> int:
    """Print ``result``, its numbers compared last on standard error and
    the line itself last on standard output, and return 0; or, when a
    module of JAX or of the JAX package is loaded by now (the check runs
    after everything else of the run, the metric readers and the
    comparison too), name it and print no result: 1."""
    found = guard.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 1
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(BENCHMARK)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2

    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    return finish(run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace)))


if __name__ == "__main__":
    sys.exit(main())
