"""Every workload file run whole on the CPU at a tiny size, each in a
process of its own: the result line, one reader per metric, the end-of-run
module check, and a cell added by files and entries alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from codec_bench.tests import tiny

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
B = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]

DUMMY = {"name": "hbase64k.host_resolve", "config": "hbase_blocks64k_zlib6",
         "traffic": "compaction6144_host_resolve", "chips": 1,
         "why": "a cell made of a workload file and entries alone"}
DUMMY_FILE = {"config": DUMMY["config"], "traffic": DUMMY["traffic"],
              "why": DUMMY["why"], "entry": "device_inflate", "pool": 2,
              "batch": 6144, "check_calls": 2,
              "params": {"dst_capacity": 65536, "resolve": "host",
                         "flags": ["FLAG_ZLIB"]},
              "limits": {"lanes_wrong": 0, "window_lanes_not_ok": 0}}


def tiny_run(bench_path, wdir, name, trace):
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "tiny.py"), bench_path, wdir,
         name, str(trace)], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def check_line(r, bench, name, trace):
    keys = list(r)
    assert keys[:5] == REQUIRED and keys[-1] == "checks"
    assert set(keys) - set(REQUIRED) <= {"breakdown", "checks"}
    assert ("breakdown" in r) == bool(trace)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert r["device"]["platform"] == "cpu" and r["device"]["count"] == 1
    from codec_bench import run
    want = {m["name"] for m in run.cell_metrics(bench, name, trace)}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
        assert all(m["value"] > 0 for m in r["metrics"].values())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in B["workloads"]])
def test_each_workload_runs_whole_on_the_cpu(name, trace):
    r = tiny_run(os.path.join(ROOT, "BENCHMARK.json"),
                 os.path.join(BENCH, "workloads"), name, trace)
    check_line(r, B, name, trace)


#: the cell measured and left out of BENCHMARK.json: its workload file is
#: there, so an entry alone brings it back
LEFT_OUT = {"name": "hbase64k.device_resolve",
            "config": "hbase_blocks64k_zlib6",
            "traffic": "compaction6144_card_resolve", "chips": 1,
            "why": "a cell whose workload file is there, added by entries"}


@pytest.mark.parametrize("cell,wfile", [(DUMMY, DUMMY_FILE), (LEFT_OUT, None)],
                         ids=["new_file", "left_out_cell"])
def test_a_cell_is_added_by_a_workload_file_and_entries(tmp_path, cell,
                                                        wfile):
    wdir = tmp_path / "workloads"
    shutil.copytree(os.path.join(BENCH, "workloads"), wdir)
    if wfile is not None:
        (wdir / (cell["name"] + ".json")).write_text(json.dumps(wfile))
    bench = json.loads(json.dumps(B))
    bench["workloads"].append(cell)
    next(m for m in bench["end_to_end"]
         if m["name"] == "inflate_GBps")["workloads"].append(cell["name"])
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    r = tiny_run(str(path), str(wdir), cell["name"], 0)
    check_line(r, bench, cell["name"], 0)
    assert set(r["metrics"]) == {"inflate_GBps", "setup_s"}


PROBE = """import sys
import types


def read(w):
    # a reader that loads JAX: the run must refuse to print its result
    sys.modules.setdefault("jax", types.ModuleType("jax"))
    return 1.0
"""


@pytest.mark.parametrize("kind,trace", [("end_to_end", 0), ("per_layer", 1)])
def test_a_metric_reader_that_loads_jax_leaves_no_result(tmp_path, kind,
                                                         trace):
    shutil.copytree(BENCH, tmp_path / "codec_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "codec_bench" / "metrics" / "jax_probe.py").write_text(PROBE)
    bench = json.loads(json.dumps(B))
    name = "hbase64k.deflate"
    metric = {"name": "jax_probe", "unit": "s", "better": "lower",
              "source": "host_clock", "workloads": [name]}
    if kind == "end_to_end":
        metric["bound"] = 0.1
    else:
        metric.update(layer="harness", moves="deflate_GBps")
    bench[kind].append(metric)
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, str(tmp_path / "codec_bench" / "tests" / "tiny.py"),
         str(path), str(tmp_path / "codec_bench" / "workloads"), name,
         str(trace)], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 1, out.stderr[-3000:]
    assert out.stdout.strip() == ""
    assert "forbidden modules loaded: jax" in out.stderr


def test_without_a_card_the_command_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the cell")
    out = subprocess.run(
        [sys.executable, "codec_bench/run.py", "--workload",
         B["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_program_the_command_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "codec_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "codec_bench/run.py", "--workload",
         B["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.needs_cuda
def test_one_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    name = "kodak32.batch"
    out = subprocess.run(
        [sys.executable, "codec_bench/run.py", "--workload", name, "--seed",
         str(tiny.SEED), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
