"""defl_tpu_torch.bench on the CPU, at 8 streams x 1 KiB: one JSON line,
every ``*_ok`` true, an error line and a non-zero exit without a card
(never a run on the CPU in its place), ``"mismatch xN"`` when a lane's
bytes are wrong, an error when a pipeline re-decodes a lane on the host
or a scaling mode fails, the split decode's route held, the profiler's
trace, and no jax or ``defl_tpu`` loaded.
The line held against ``defl_tpu.bench``'s is in
tests/test_torch_bench_parity.py."""

import json
import os
import subprocess
import sys

import pytest
import torch

from defl_tpu_torch import bench, cli
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.runtime import large, native, pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"DEFL_BENCH_STREAMS": "8", "DEFL_BENCH_BLOCK": "1024",
        "DEFL_BENCH_REPS": "1", "DEFL_BENCH_PIPELINE_BATCHES": "2",
        "DEFL_BENCH_PIPELINE_FETCH_BATCHES": "1", "DEFL_BENCH_SCALING": "0"}
OK_KEYS = ("pipeline_fetch_ok", "large64_ok", "large64_device_ok",
           "encode_ok")

_RUN = r"""
import json, sys
from defl_tpu_torch import bench
rc = bench.main(["--device", "cpu"])
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "defl_tpu"))
print(json.dumps({"rc": rc, "foreign": foreign}), file=sys.stderr)
"""


@pytest.fixture(scope="module")
def cpu_run():
    """The whole bench on the CPU in a process of its own (tests/
    conftest.py imports jax into this one): (stdout lines, the line, the
    exit code and foreign modules the process reported)."""
    env = {**os.environ, **TINY}
    env.pop("DEFL_PROFILE_DIR", None)
    r = subprocess.run([sys.executable, "-c", _RUN], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    tail = json.loads(r.stderr.strip().splitlines()[-1])
    lines = r.stdout.strip().splitlines()
    return lines, json.loads(lines[-1]), tail


def _tiny(monkeypatch, **extra):
    for k, v in {**TINY, **extra}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("DEFL_PROFILE_DIR", raising=False)


def _line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_cpu_run_prints_exactly_one_json_line(cpu_run):
    lines, _, tail = cpu_run
    assert len(lines) == 1, lines
    assert tail["rc"] == 0


def test_cpu_run_line_is_the_cpus_and_has_no_error(cpu_run):
    _, line, _ = cpu_run
    assert "error" not in line, line
    assert line["metric"] == "inflate_GBps_per_chip"
    assert line["device"] == "cpu"
    assert line["value"] > 0
    assert line["value"] == line["pipeline_fetch_wall_GBps"]
    assert (line["streams"], line["block"]) == (8, 1024)


@pytest.mark.parametrize("key", OK_KEYS)
def test_cpu_run_every_ok_is_true(cpu_run, key):
    _, line, _ = cpu_run
    assert line[key] is True


def test_cpu_run_loads_no_jax_nor_the_jax_package(cpu_run):
    _, _, tail = cpu_run
    assert tail["foreign"] == []


def test_default_device_without_a_card_is_an_error(monkeypatch, capsys):
    """No card and no --device cpu: one line naming CUDA, exit 1, and the
    decoder (whose CPU twin would run here) is never called."""
    _tiny(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_decode(*a, **k):
        raise AssertionError("the decoder was called")

    monkeypatch.setattr(decode_cu, "decode_tokens", no_decode)
    assert bench.main([]) == 1
    line = _line(capsys)
    assert line["value"] == 0.0
    assert "CUDA" in line["error"], line
    assert "decoder was called" not in line["error"]


def test_a_wrong_byte_is_a_mismatch(monkeypatch, capsys):
    _tiny(monkeypatch)
    real = native.native_resolve_tokens

    def flipping(*a, **k):
        out = real(*a, **k)
        out[0, 0] ^= 1
        return out

    monkeypatch.setattr(native, "native_resolve_tokens", flipping)
    assert bench.main(["--device", "cpu"]) == 1
    line = _line(capsys)
    assert line["value"] == 0.0
    assert line["error"] == "mismatch x1"


def test_profile_dir_leaves_a_trace(monkeypatch, capsys, tmp_path):
    """DEFL_PROFILE_DIR: one decode under torch.profiler, its Chrome trace
    in that directory.  With the card's resolver (RESOLVE=device) the
    bench stops after phase 2, as the JAX package's does, and the value
    is the decode's rate.  (Shorter lanes and chunks: the profiler records
    every op of the CPU's plain version.)"""
    _tiny(monkeypatch, DEFL_BENCH_RESOLVE="device", DEFL_BENCH_STREAMS="4",
          DEFL_BENCH_BLOCK="700", DEFL_BENCH_K="128")
    monkeypatch.setenv("DEFL_PROFILE_DIR", str(tmp_path / "prof"))
    assert bench.main(["--device", "cpu"]) == 0
    line = _line(capsys)
    assert "error" not in line
    assert line["value"] == line["decode_GBps"] > 0
    assert "pipeline_fetch_ok" not in line
    files = list((tmp_path / "prof").iterdir())
    assert [f.name for f in files] == ["decode_trace.json"]
    assert json.loads(files[0].read_text())["traceEvents"]


def test_scaling_is_not_run_on_the_cpu(monkeypatch, capsys):
    """bench_scaling's modes on the CPU would time the plain versions:
    with --device cpu no subprocess starts and no scaling key appears."""
    _tiny(monkeypatch, DEFL_BENCH_RESOLVE="device", DEFL_BENCH_SCALING="1")

    def no_run(*a, **k):
        raise AssertionError("a subprocess was started")

    monkeypatch.setattr(bench.subprocess, "run", no_run)
    assert bench.main(["--device", "cpu"]) == 0
    line = _line(capsys)
    assert "error" not in line
    assert not {"dist_overhead_pct", "codec1_s", "shard1_s",
                "n_devices"} & set(line)


def test_cli_bench_main_exits_with_mains_status(monkeypatch):
    monkeypatch.setattr(bench, "main", lambda: 3)
    with pytest.raises(SystemExit) as e:
        cli.bench_main()
    assert e.value.code == 3


def test_cpu_run_line_shows_the_split_decodes_route(cpu_run):
    """The 8 KiB stream is one segment: the serial stitch by design, no
    speculative lane."""
    _, line, _ = cpu_run
    assert line["large64_device_route"] == "serial"
    assert line["large64_device_lanes"] == 0
    assert line["large64_device_lanes_valid"] == 0


@pytest.mark.parametrize("phase,retried", [("stubbed fetch", 3 * 8),
                                            ("real fetch", 8)])
def test_a_host_retry_in_a_pipeline_is_an_error(monkeypatch, capsys, phase,
                                                retried):
    """Lanes out of their step budget (status 127) are re-decoded by the
    pipeline's host retry and then read OK: the bench counts them (8
    lanes a pass of one batch; the stubbed phase makes three passes) and
    makes the phase an error, stubbed fetch or real."""
    _tiny(monkeypatch, DEFL_BENCH_LARGE="0", DEFL_BENCH_ENCODE="0",
          DEFL_BENCH_PIPELINE_BATCHES="1")
    real_pipe = pipeline.pipeline_inflate
    real_decode = decode_cu.decode_tokens

    def short(*a, **k):     # 4 steps a lane: every lane left at 127
        return real_decode(*a, **{**k, "T": 8, "K": 4})

    def pipe(*a, **k):
        if (k.get("_fetch") is None) == (phase == "real fetch"):
            monkeypatch.setattr(decode_cu, "decode_tokens", short)
        try:
            return real_pipe(*a, **k)
        finally:
            monkeypatch.setattr(decode_cu, "decode_tokens", real_decode)

    monkeypatch.setattr(pipeline, "pipeline_inflate", pipe)
    assert bench.main(["--device", "cpu"]) == 1
    line = _line(capsys)
    assert line["value"] == 0.0
    assert line["error"].startswith(f"pipeline ({phase})"), line
    assert f"{retried} lanes re-decoded on the host" in line["error"]


def test_a_serial_stitch_of_a_splittable_stream_is_not_ok(monkeypatch,
                                                          capsys):
    """The device route's bytes are right through the serial stitch too,
    so a stream long enough to split that took it reads as not OK."""
    _tiny(monkeypatch, DEFL_BENCH_ENCODE="0",
          DEFL_BENCH_PIPELINE_BATCHES="1")
    real = large.inflate_large

    def long_serial(*a, **k):
        r = real(*a, **k)
        if k.get("use_device"):
            k["stats_out"]["segments"] = 3
        return r

    monkeypatch.setattr(large, "inflate_large", long_serial)
    assert bench.main(["--device", "cpu"]) == 0
    line = _line(capsys)
    assert line["large64_ok"] is True
    assert line["large64_device_route"] == "serial"
    assert line["large64_device_ok"] is False


@pytest.mark.parametrize("stats,ok", [
    ({"segments": 2, "route": "serial"}, True),
    ({"segments": 1118, "route": "serial"}, False),
    ({"segments": 1118, "route": "device", "lanes": 1075,
      "lanes_valid": 1065}, True),
    ({"segments": 1118, "route": "device", "lanes": 100,
      "lanes_valid": 80}, True),
    ({"segments": 1118, "route": "device", "lanes": 100,
      "lanes_valid": 79}, False),
])
def test_split_decoded(stats, ok):
    assert bench.split_decoded(stats) is ok


def _completed(monkeypatch, rc=0, stdout="", seen=None):
    def fake_run(cmd, **k):
        if seen is not None:
            seen.append(cmd)
        return subprocess.CompletedProcess(cmd, rc, stdout, "its stderr")

    monkeypatch.setattr(bench.subprocess, "run", fake_run)


def test_scaling_mode_runs_at_the_benchs_size(monkeypatch):
    seen = []
    _completed(monkeypatch, stdout='log\n{"dist_overhead_pct": 0.5, '
                                   '"device": "card"}\n', seen=seen)
    part = bench._scaling_mode("overhead", 1000.0, 8192, 65536)
    assert part == {"dist_overhead_pct": 0.5}
    assert seen[0][-6:] == ["defl_tpu_torch.bench_scaling", "overhead",
                            "--streams", "8192", "--block", "65536"]


@pytest.mark.parametrize("how", ["timeout", "exit", "silent"])
def test_a_failed_scaling_mode_raises(monkeypatch, how):
    if how == "timeout":
        def fake_run(cmd, **k):
            raise subprocess.TimeoutExpired(cmd, k["timeout"])

        monkeypatch.setattr(bench.subprocess, "run", fake_run)
    else:
        _completed(monkeypatch, rc=1 if how == "exit" else 0,
                   stdout='{"dist_overhead_pct": 0.5}' if how == "exit"
                   else "")
    with pytest.raises(RuntimeError, match="scaling mode overhead"):
        bench._scaling_mode("overhead", 1000.0, 8, 1024)
