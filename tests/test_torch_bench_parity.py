"""defl_tpu_torch.bench held against defl_tpu.bench on the CPU, at 8
streams x 1 KiB: both run whole, each in a process of its own (the JAX
package's on one CPU device, about 45 s), and their lines must agree under
the port's key map (bench.py's docstring): the same keys but
``token_fetch_MBps`` for ``tunnel_fetch_MBps`` and the split decode's
route and lanes beside ``large64_device_ok``, the same sizes and
``encode_size_vs_zlib6``, every ``*_ok`` true on both sides, and the port's
token fetch exactly its occupied rows, never more than the JAX package's
4,096-row rounding.  Its own file, so that ``--dist loadfile`` gives it a
worker of its own."""

import json
import os
import subprocess
import sys

import pytest

from defl_tpu_torch.breakdown import corpus
from defl_tpu_torch.ops import inflate_batch as ib
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.runtime.pack import pack_streams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BLOCK, PIPE_K = 8, 1024, 512
TINY = {"DEFL_BENCH_STREAMS": str(N), "DEFL_BENCH_BLOCK": str(BLOCK),
        "DEFL_BENCH_REPS": "1", "DEFL_BENCH_PIPELINE_BATCHES": "2",
        "DEFL_BENCH_PIPELINE_FETCH_BATCHES": "1", "DEFL_BENCH_SCALING": "0"}
RENAMED = {"tunnel_fetch_MBps": "token_fetch_MBps"}
PORT_ONLY = {"large64_device_route", "large64_device_lanes",
             "large64_device_lanes_valid"}
EQUAL = ("streams", "block", "raw_mb", "decode_K", "pipeline_K",
         "encode_size_vs_zlib6")
OK_KEYS = ("pipeline_fetch_ok", "large64_ok", "large64_device_ok",
           "encode_ok")


@pytest.fixture(scope="module")
def lines():
    """(the JAX package's line, the port's line), run side by side."""
    env = {**os.environ, **TINY, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)          # one CPU device, as on one chip
    env.pop("DEFL_PROFILE_DIR", None)
    cmds = ([sys.executable, "-m", "defl_tpu.bench"],
            [sys.executable, "-m", "defl_tpu_torch.bench", "--device", "cpu"])
    procs = [subprocess.Popen(c, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=600)
            assert p.returncode == 0, se[-3000:]
            out.append(json.loads(so.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return tuple(out)


def test_key_sets_agree_under_the_key_map(lines):
    ref, port = lines
    assert "error" not in ref and "error" not in port
    assert {RENAMED.get(k, k) for k in ref} | PORT_ONLY == set(port)


@pytest.mark.parametrize("key", EQUAL)
def test_sizes_and_encoded_size_are_equal(lines, key):
    ref, port = lines
    assert port[key] == ref[key]


@pytest.mark.parametrize("key", OK_KEYS)
def test_every_ok_is_true_on_both_sides(lines, key):
    ref, port = lines
    assert ref[key] is True and port[key] is True


def test_fetch_bytes_are_the_occupied_rows_only(lines):
    """tok_rows x N x 4 B of the port's own decode of that batch (the
    chunk loop at the pipeline's K), at most the JAX package's rounding."""
    ref, port = lines
    _, streams = corpus(N, BLOCK)
    p = pack_streams(streams, 1, BLOCK)
    _, st = decode_cu.decode_tokens(p.words, p.nbits, p.zflag, p.dst_cap,
                                    T=ib.step_budget(BLOCK), K=PIPE_K,
                                    device="cpu")
    assert port["pipeline_fetch_bytes_per_batch"] == st["tok_rows"] * N * 4
    assert port["pipeline_fetch_bytes_per_batch"] \
        <= ref["pipeline_fetch_bytes_per_batch"]
