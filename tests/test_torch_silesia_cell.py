"""The benchmark's ``silesia.large`` cell on the CPU: its generator (the
Silesia corpus as one ustar archive from a seed, one zlib stream), and the
cell run whole through ``codec_bench.run.run_cell`` at a shrunk size with
the large route's plain versions (``inflate_large(use_device=True,
device="cpu")``).

The shrunk archive scales every member down by ``DIV``; its stream takes
blocks of memLevel 4 and the route segments of 1 KiB, so that it spans
many segments and takes the card's route, while the decode kernel's plain
version stays within seconds.
"""

import io
import os
import tarfile
import zlib

import numpy as np
import pytest

from codec_bench import run
from codec_bench.data import silesia_tar
from defl_tpu_torch import metrics
from defl_tpu_torch.errors import Result
from defl_tpu_torch.runtime import large
from defl_tpu_torch.runtime import native as tnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
CONFIG = run.load_json(os.path.join(ROOT, "codec_bench", "configs",
                                    "silesia_tar_zlib6.json"))
FMT = CONFIG["format"]
CELL = "silesia.large"
DIV = 4000
SEED = 2**33 + 17

needs_native = pytest.mark.skipif(not tnative.available(),
                                  reason="native library unavailable")


def _small(div=DIV, **kw):
    return {**FMT, **kw, "members": [{**m, "bytes": m["bytes"] // div}
                                     for m in FMT["members"]]}


SMALL = _small(mem_level=4)
SHRINK = {"format": {"members": SMALL["members"], "mem_level": 4},
          "pool": 1,
          "params": {"dst_capacity": silesia_tar.layout(SMALL)[1]}}


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

def test_the_published_archive_length_from_the_format_alone():
    sizes = [m["bytes"] for m in FMT["members"]]
    assert sum(sizes) == 211_938_580 and len(sizes) == 12
    assert silesia_tar.layout(FMT)[1] == 211_957_760 \
        == CONFIG["archive_bytes"]
    wl = run.load_json(os.path.join(ROOT, "codec_bench", "workloads",
                                    CELL + ".json"))
    assert wl["params"]["dst_capacity"] == 211_957_760


def test_members_order_sizes_and_tar_framing():
    fmt = _small(div=2000)
    raw = silesia_tar.make_pool(fmt, SEED, 1, 1, encode=False)[0].raw[0]
    assert len(raw) == silesia_tar.layout(fmt)[1]
    assert len(raw) % fmt["record_bytes"] == 0
    offs, _ = silesia_tar.layout(fmt)
    with tarfile.open(fileobj=io.BytesIO(raw), mode="r:") as tf:
        got = tf.getmembers()
        assert [(i.name, i.size, i.offset_data) for i in got] == \
            [(m["name"], m["bytes"], o) for m, o in zip(fmt["members"], offs)]
        for i, m in zip(got, fmt["members"]):
            assert tf.extractfile(i).read() == \
                silesia_tar.member(SEED, 0, fmt["members"].index(m),
                                   m["kind"], m["bytes"],
                                   fmt["piece_bytes"])
    end = offs[-1] + fmt["members"][-1]["bytes"]
    assert raw[end:] == bytes(len(raw) - end)
    assert [m["name"] for m in FMT["members"]] == sorted(
        m["name"] for m in FMT["members"])


def test_kinds_are_drawn_as_the_format_names_them():
    piece = FMT["piece_bytes"]
    text = silesia_tar.member(SEED, 0, 0, "text", 3 * piece, piece)
    recs = silesia_tar.member(SEED, 0, 3, "records", 3 * piece, piece)
    ints = silesia_tar.member(SEED, 0, 2, "ints", 3 * piece, piece)
    assert len(text) == len(recs) == len(ints) == 3 * piece
    assert text.count(b" ") > piece // 3
    assert recs.startswith(b'<row id="')
    walk = np.frombuffer(ints, "<u4").astype(np.int64)
    assert np.abs(np.diff(walk[: piece // 4])).max() <= 1000


def test_same_seed_same_archive_other_seed_other_members():
    a = silesia_tar.make_pool(SMALL, SEED, 2, 1)
    b = silesia_tar.make_pool(SMALL, SEED, 2, 1)
    c = silesia_tar.make_pool(SMALL, SEED + 1, 1, 1)
    assert [x.raw for x in a] == [x.raw for x in b]
    assert [x.streams for x in a] == [x.streams for x in b]
    offs, _ = silesia_tar.layout(SMALL)
    for k, m in enumerate(SMALL["members"]):
        part = slice(offs[k], offs[k] + m["bytes"])
        assert a[0].raw[0][part] != a[1].raw[0][part], m["name"]
        assert a[0].raw[0][part] != c[0].raw[0][part], m["name"]


def test_a_shrunk_archive_is_one_zlib_stream_of_its_payload():
    pool = silesia_tar.make_pool(SMALL, SEED, 2, 1)
    for b in pool:
        (s,), (raw,) = b.streams, b.raw
        assert b.inputs == [s]
        d = zlib.decompressobj()
        assert d.decompress(s) == raw and d.eof and not d.unused_data
        assert s[:2] == b"\x78\x9c"        # 32 KiB window, level 6


def test_a_batch_is_one_archive():
    with pytest.raises(ValueError, match="one archive"):
        silesia_tar.make_pool(SMALL, SEED, 1, 2)


# ---------------------------------------------------------------------------
# the cell, shrunk, through the harness
# ---------------------------------------------------------------------------

@pytest.fixture
def small_segments(monkeypatch):
    monkeypatch.setattr(large, "SEGMENT_BYTES", 1024)


def _run(trace=False):
    return run.run_cell(BENCH, CELL, SEED, 0.01, trace, device="cpu",
                        shrink=SHRINK)


@needs_native
def test_the_shrunk_cell_is_correct_on_the_device_route_and_reads_its_metrics(
        small_segments):
    n_seg = (len(silesia_tar.make_pool(SMALL, SEED, 1, 1)[0].streams[0])
             - 2) // large.SEGMENT_BYTES
    assert n_seg >= 3
    r = _run(trace=True)
    snap = metrics.snapshot()
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["lanes_wrong"]["value"] == 0
    assert snap["large_device_lanes"] >= 3
    assert snap.get("large_device_rerouted", 0) == 0
    want = {m["name"] for m in BENCH["per_layer"]
            if CELL in m.get("workloads", ())}
    assert {"large_find_pct", "large_stitch_pct", "large_body_pct",
            "large_verify_pct", "large_lane_valid_pct",
            "host_cpu_s_per_GB.inflate"} <= want
    # the CPU has no device trace: the readers of the card's trace report
    # nothing there
    assert set(r["metrics"]) == want - {"inflate_roofline",
                                        "device_idle_pct.inflate"}
    assert r["metrics"]["large_lane_valid_pct"]["value"] == \
        100.0 * snap["large_device_lanes_valid"] / snap["large_device_lanes"]
    # every find on the host: the CPU has no card to find on
    assert snap["lane_finds"] > 0
    assert r["metrics"]["find_card_pct"]["value"] == 0.0
    for name in ("large_find_pct", "large_stitch_pct", "large_body_pct",
                 "large_verify_pct"):
        assert 0 < r["metrics"][name]["value"] < 100, name


def _patch(monkeypatch, how):
    from codec_bench.entries import inflate_large as entry

    orig = entry.inflate_large

    def patched(data, **kw):
        if how == "unwritten":
            return Result.OK, kw["dst_capacity"]
        r, n = orig(data, **kw)
        kw["out"][n // 2] ^= 1
        return r, n
    monkeypatch.setattr(entry, "inflate_large", patched)


@needs_native
@pytest.mark.parametrize("how", ["flipped", "unwritten"])
def test_a_broken_output_is_not_correct(monkeypatch, small_segments, how):
    """One byte flipped after the decode, or OK returned over a buffer left
    as the entry made it: the comparison with zlib calls the lane wrong
    (the program's own trailer check never sees either)."""
    _patch(monkeypatch, how)
    r = _run()
    assert r["correct"] is False
    # every kept call (at most the workload's check_calls) is wrong
    assert r["checks"]["lanes_wrong"]["value"] == min(r["attempted"], 4)
    assert r["checks"]["window_lanes_not_ok"]["value"] == 0
