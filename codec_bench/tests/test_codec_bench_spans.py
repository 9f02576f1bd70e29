"""The readers of the program's spans (``spans.share_pct``), on synthetic
windows, and a tiny traced run of each inflate cell on the CPU that
reports them."""

import json
import os
import subprocess
import sys

import pytest

from codec_bench import run, timeline
from codec_bench.timeline import Event

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
B = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))

#: each reader and the span it reads
READERS = {
    "inflate_pack_pct": "defl.pack",
    "inflate_upload_pct": "defl.upload",
    "inflate_fetch_pct": "defl.fetch",
    "resolve_pct": "defl.resolve",
    "resolve_wait_pct": "defl.resolve_wait",
    "lane_bytes_pct": "defl.lane_bytes",
}


def window(**kw):
    base = dict(kind="inflate", window_s=2.0, setup_s=12.5, calls=4,
                latencies_s=[0.4, 0.5, 0.6, 0.5], lanes=100, failed=0,
                raw_bytes=4_000_000_000, comp_bytes=1_000_000_000,
                counters={}, cpu_s=8.0, stages={}, trace=None,
                peak_Bps=3.35e12)
    base.update(kw)
    return run.Window(**base)


def read(name, w):
    return run.module_at(os.path.join(BENCH, "metrics", name + ".py")).read(w)


@pytest.mark.parametrize("name,span", sorted(READERS.items()))
def test_span_reader_value_and_nothing_without_its_counter(name, span):
    # 0.5 s of the span in a 2-s window, over 3 spans
    counters = {span + ".ns": 500_000_000, span + ".n": 3,
                "defl.other.ns": 1_900_000_000}
    assert read(name, window(counters=counters)) == pytest.approx(25.0)
    assert read(name, window(counters={"defl.other.ns": 10**9})) is None
    assert read(name, window(counters={span + ".ns": 0})) is None
    assert read(name, window(kind="deflate", counters=counters)) is None
    assert read(name, window(counters=counters, window_s=0.0)) is None


def test_span_metrics_are_entries_of_the_benchmark():
    per_layer = {m["name"]: m for m in B["per_layer"]}
    cells = {"hbase64k.pipeline", "kodak32.batch"}
    for name in READERS:
        m = per_layer[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == \
            ("%", "lower", "program_span", "inflate_GBps")
        assert set(m["workloads"]) <= cells
    assert per_layer["resolve_wait_pct"]["workloads"] == ["hbase64k.pipeline"]
    assert per_layer["lane_bytes_pct"]["workloads"] == ["kodak32.batch"]


def test_an_idle_gap_inside_a_call_is_named_by_the_program_span():
    ev = [Event(timeline.WINDOW_SPAN, 0.0, 10.0, False),
          Event(timeline.CALL_SPAN, 0.0, 10.0, False),
          Event("defl.pack", 0.0, 2.0, False),
          Event("defl.decode", 2.0, 5.0, False),
          Event("decode_stream_kernel", 2.0, 5.0, True),
          Event("defl.resolve_wait", 5.0, 9.0, False),
          Event("defl.resolve_wait", 5.0, 9.0, True),   # its mirror
          Event("Memcpy DtoH (Device -> Pinned)", 9.0, 9.5, True)]
    s = timeline.summarize(ev, 0.0, 10.0)
    assert dict((k, v) for k, v in s.idle_gaps) == {
        "defl.pack": pytest.approx(2.0),
        "defl.resolve_wait": pytest.approx(4.0),
        timeline.CALL_SPAN: pytest.approx(0.5)}


@pytest.mark.parametrize("name", ["kodak32.batch", "hbase64k.pipeline"])
def test_a_tiny_traced_run_reports_the_span_metrics_it_lists(name):
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "tiny.py"),
         os.path.join(ROOT, "BENCHMARK.json"),
         os.path.join(BENCH, "workloads"), name, "1"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    listed = {m["name"] for m in B["per_layer"]
              if m["name"] in READERS and name in m["workloads"]}
    got = {k: v["value"] for k, v in r["metrics"].items() if k in READERS}
    assert set(got) == listed
    for k, v in got.items():
        assert 0 < v <= 100, (k, v)
        assert r["metrics"][k]["unit"] == "%"
