"""The reader of ``split_lane_valid_pct``: the share of the program's split
decode lanes that validated, and nothing where the program has no such
counter."""

import os

import pytest

from codec_bench import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def window(**kw):
    base = dict(kind="inflate", window_s=2.0, setup_s=12.5, calls=4,
                latencies_s=[0.4, 0.5, 0.6, 0.5], lanes=100, failed=0,
                raw_bytes=4_000_000_000, comp_bytes=1_000_000_000,
                counters={}, cpu_s=8.0, stages={}, trace=None,
                peak_Bps=3.35e12)
    base.update(kw)
    return run.Window(**base)


def read(w):
    path = os.path.join(BENCH, "metrics", "split_lane_valid_pct.py")
    return run.module_at(path).read(w)


def test_split_lane_share_needs_the_split_counters():
    """Nothing without the program's counters (a parent without the split
    decode, a cell whose streams are all short), the share with them."""
    assert read(window()) is None
    assert read(window(counters={"batch_split_lanes": 0})) is None
    w = window(counters={"batch_split_lanes": 640,
                         "batch_split_lanes_valid": 632})
    assert read(w) == pytest.approx(98.75)
    assert read(window(counters={"batch_split_lanes": 8})) == 0.0
    assert read(window(kind="deflate",
                       counters={"batch_split_lanes": 8})) is None
