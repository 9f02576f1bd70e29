"""The metric arithmetic on synthetic events and windows, one reader per
metric, and BENCHMARK.json against the files the harness finds by name."""

import json
import os
import re

import pytest

from codec_bench import run, timeline
from codec_bench.timeline import Event

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
B = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
METRICS = B["end_to_end"] + B["per_layer"]

K = lambda n, a, b: Event(n, a, b, True)     # noqa: E731
H = lambda n, a, b: Event(n, a, b, False)    # noqa: E731


def test_union_merges_overlapping_copies_and_kernels_and_clips():
    iv = [(1, 3), (2, 4), (6, 7), (6.5, 6.6), (-1, 0.5), (9, 12)]
    assert timeline.union(iv, 0, 10) == [(0, 0.5), (1, 4), (6, 7), (9, 10)]
    assert timeline.gaps(iv, 0, 10) == [(0.5, 1), (4, 6), (7, 9)]
    assert timeline.gaps([], 2, 5) == [(2, 5)]
    assert timeline.union([(3, 3), (5, 4)], 0, 10) == []


def test_summary_busy_idle_kernels_and_names():
    ev = [K("decode_stream_kernel", 1.0, 2.0),
          K("Memcpy DtoH (Device -> Pinned)", 1.5, 2.5),   # overlaps
          K("fill_kernel", 1.8, 1.9),                        # inside both
          K("decode_stream_kernel", 5.0, 6.0),
          K("Memset (Device)", 8.0, 8.5),
          K("late_kernel", 9.5, 11.0),                       # past the end
          K(timeline.CALL_SPAN, 0.0, 10.0),       # a span's mirror: no work
          H(timeline.WINDOW_SPAN, 0.0, 10.0),
          H(timeline.CALL_SPAN, 0.0, 4.0),
          H("aten::copy_", 2.6, 3.4),
          H(timeline.CALL_SPAN, 4.5, 10.0),
          H("cudaStreamSynchronize", 6.0, 7.9)]
    s = timeline.summarize(ev, 0.0, 10.0)
    assert s.window_s == 10.0
    assert s.busy_s == pytest.approx(1.5 + 1.0 + 0.5 + 0.5)
    assert s.kernel_s == pytest.approx(1.0 + 0.1 + 1.0 + 0.5)
    assert s.device_ops[0] == ["decode_stream_kernel", pytest.approx(2.0)]
    assert ["Memcpy DtoH (Device -> Pinned)", pytest.approx(1.0)] in \
        s.device_ops
    gaps = dict((k, v) for k, v in s.idle_gaps)
    # 0-1 and 2.5-5: calls; 2.5-5 has its middle (3.75) in neither op
    assert gaps[timeline.CALL_SPAN] == pytest.approx(1.0 + 2.5 + 1.0)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(2.0)
    assert timeline.idle_pct(s) == pytest.approx(65.0)


def test_gaps_between_calls_and_without_a_trace():
    ev = [H(timeline.CALL_SPAN, 0, 1), K("k", 0, 1), H(timeline.CALL_SPAN,
                                                      2, 3), K("k", 2, 3)]
    s = timeline.summarize(ev, 0, 3)
    assert s.idle_gaps == [[timeline.BETWEEN_CALLS, 1]]
    assert timeline.idle_pct(None) is None
    assert timeline.idle_pct(timeline.summarize([], 0, 1)) is None
    assert timeline.top_ops([H("x", 0, 1)], 0, 1) == []


def test_bytes_bound():
    assert timeline.bytes_bound_s(3.35e9, 3.35e12) == pytest.approx(1e-3)


def window(**kw):
    base = dict(kind="inflate", window_s=2.0, setup_s=12.5, calls=4,
                latencies_s=[0.4, 0.5, 0.6, 0.5], lanes=100, failed=0,
                raw_bytes=4_000_000_000, comp_bytes=1_000_000_000,
                counters={"token_fetch_bytes": 9_000_000_000,
                          "pipeline_host_retries": 3,
                          "host_fallback_lanes": 2},
                cpu_s=8.0, stages={}, trace=None, peak_Bps=3.35e12)
    base.update(kw)
    return run.Window(**base)


def read(name, w):
    return run.module_at(os.path.join(BENCH, "metrics", name + ".py")).read(w)


def test_end_to_end_readers():
    w = window()
    assert read("inflate_GBps", w) == pytest.approx(2.0)
    assert read("deflate_GBps", w) is None
    assert read("setup_s", w) == 12.5
    assert read("call_p90_ms", w) == pytest.approx(570.0)
    d = window(kind="deflate", raw_bytes=1e9)
    assert read("deflate_GBps", d) == pytest.approx(0.5)
    assert read("inflate_GBps", d) is None
    assert read("call_p90_ms", window(latencies_s=[1.0])) is None


def test_per_layer_readers_on_counters_and_clocks():
    w = window()
    assert read("host_retry_lanes_pct", w) == pytest.approx(5.0)
    assert read("host_cpu_s_per_GB.inflate", w) == pytest.approx(2.0)
    assert read("host_cpu_s_per_GB.deflate", w) is None
    assert read("token_fetch_B_per_B", w) == pytest.approx(2.25)
    assert read("token_fetch_B_per_B", window(counters={})) is None
    d = window(kind="deflate", raw_bytes=1e9,
               stages={"fields_s": 1.7, "pack_s": 0.1})
    assert read("host_cpu_s_per_GB.deflate", d) == pytest.approx(8.0)
    assert read("deflate_fields_pct", d) == pytest.approx(85.0)
    assert read("deflate_pack_ms", d) == pytest.approx(25.0)
    assert read("deflate_fields_pct", w) is None


def test_trace_readers_need_a_trace_and_a_peak():
    s = timeline.Summary(window_s=2.0, busy_s=0.5, kernel_s=0.1)
    w = window(trace=s)
    # bound: 5e9 B / 3.35e12 B/s = 1.4925 ms over 100 ms of kernels
    assert read("inflate_roofline", w) == pytest.approx(
        100 * 5e9 / 3.35e12 / 0.1)
    assert read("device_idle_pct.inflate", w) == pytest.approx(75.0)
    assert read("device_idle_pct.deflate", w) is None
    assert read("inflate_roofline", window()) is None
    assert read("inflate_roofline", window(trace=s, peak_Bps=None)) \
        is None
    assert read("inflate_roofline", window(
        trace=timeline.Summary(2.0, 0.0, 0.0))) is None


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_metric_has_a_reader_and_every_cell_its_files():
    for m in METRICS:
        assert NAME.match(m["name"])
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py")), m["name"]
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for c in B["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] == \
            c["name"]
    for w in B["workloads"]:
        wl = json.load(open(os.path.join(BENCH, "workloads",
                                         w["name"] + ".json")))
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        assert os.path.isfile(os.path.join(BENCH, "entries",
                                           wl["entry"] + ".py"))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in B["workloads"]:
        e2e = [m["name"] for m in run.cell_metrics(B, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert run.cell_metrics(B, w["name"], True)
    for m in B["per_layer"]:
        moved = next(e for e in B["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", []):
            assert "workloads" not in moved or cell in moved["workloads"]


def test_benchmark_json_keeps_to_its_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= B["run_seconds"] <= 51
    for e in B["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    for text in ([c["why"] for c in B["configs"] + B["workloads"]]
                 + [m["layer"] for m in B["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len(json.dumps(B)) < 64 * 1024
