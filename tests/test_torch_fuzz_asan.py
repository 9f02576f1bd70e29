"""The decode kernel's per-lane code under malformed input, built with
AddressSanitizer and UndefinedBehaviorSanitizer, on the CPU.

compute-sanitizer 2025.2.1 refuses the H100 this port is measured on
("Device not supported": chip_smoke.py [11c] says so), so the source's
memory accesses are checked here: ``tests/decode_host.py`` builds
``csrc/decode_stream.cu`` for the host with ``-fsanitize=address,undefined
-fno-sanitize-recover=all``, every lane in its own allocation of exactly
its shared memory (``LANE_BYTES``), and a subprocess with the sanitizers'
runtime preloaded runs it inside ``decode_cu.decode_tokens`` over
malformed lanes: tests/test_fuzz.py's streams (``corpus.fuzz_cases`` over
its payloads), the cut streams of ``BAD_CODE_CUT_SHORT``, a bench-corpus
batch with every 8th lane malformed, and a bit-flipped, cut body in
shared-input mode.  A read past a lane's shared memory, past the input
words or past the token buffer, an out-of-range shift or a signed overflow
ends the run with the sanitizer's report.  What the card's compiler makes
of the source and what lanes do to one another's shared memory in a block
only the card shows (tests/test_torch_cuda_fuzz.py, chip_smoke.py [11]).

The host library (``csrc/defl_batch.cc`` with the engine it includes) is
built the same way, and ``dt_stitch_many`` stitches one long chain on 8
threads under it: the two passes, and the chains they give back to the
one-thread walk.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests.decode_host import REPO, SANITIZE_FLAGS, build
from tests.test_torch_fuzz import BAD_CODE_CUT_SHORT

_RUN = r"""
import ctypes, sys, zlib
import numpy as np
import pytest
import torch
from defl_tpu_torch import corpus, malformed
from defl_tpu_torch.ops import inflate_batch as ib
from defl_tpu_torch.runtime import large
from defl_tpu_torch.runtime.pack import pack_streams
from tests.decode_host import _host_split_decode, _host_stream
from tests.gendata import make_corpus

lib = ctypes.CDLL(sys.argv[1])
bad_codes = [bytes.fromhex(h) for h in sys.argv[2].split(",")]
mp = pytest.MonkeyPatch()
decode = _host_stream(lib, mp)
ENDS = {0, -1, 2, -105}


def run(streams, zflag, cap, T):
    p = pack_streams(streams, zflag, cap)
    carry = None
    for _ in range(40):
        tok, carry = decode(p.words, p.nbits, p.zflag, p.dst_cap,
                            carry=carry, T=T, K=128)
        if not (carry["status"] == ib.STATUS_RUNNING).any():
            break
    status = set(carry["status"].tolist())
    assert status <= ENDS, status
    return len(streams), status


c = make_corpus()
base = [c["text"][:400], c["rand_255"], c["period_3"][:300], b"", b"a"]
lanes, seen = 0, set()
for seed in (1, 2, 3, 7, 100):
    n, st = run([d for _, d in corpus.fuzz_cases(seed, 60, base)], 1, 1024,
                ib.step_budget(1024))
    lanes += n
    seen |= st
n, st = run(bad_codes, 0, 1024, ib.step_budget(1024))
assert st == {-1}, st
lanes += n
blocks = corpus.make_silesia_like(32 * 4096, 4096)
streams = [zlib.compress(b, 6) for b in blocks]
mixed, _ = corpus.mixed_batch(streams, blocks, seed=11)
n, st = run(mixed, 1, 4096, ib.step_budget(4096))
lanes += n
seen |= st
for seed in (5, 6):
    raw = b"".join(corpus.make_silesia_like(1 << 17, 65536))
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 4)
    body = np.frombuffer(malformed.mutate(co.compress(raw) + co.flush(), seed,
                                          4, cut=True), np.uint8)
    cands = large._find_candidates(body, 0, body.size // 1024, 8 * 1024)
    _, carry = _host_split_decode(lib, mp, body, large.lane_args(body.size,
                                                                 cands))
    assert set(carry["status"].tolist()) <= ENDS
    lanes += len(cands)
print("sanitized lanes", lanes, "classes", sorted(seen))
"""


def test_kernel_source_is_clean_under_asan_and_ubsan(tmp_path):
    libasan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                             capture_output=True, text=True).stdout.strip()
    if not os.path.isabs(libasan):
        pytest.skip("g++ has no AddressSanitizer runtime here")
    lib = build(tmp_path, sanitize=True)
    env = dict(os.environ, LD_PRELOAD=libasan,
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=0",
               UBSAN_OPTIONS="print_stacktrace=1")
    r = subprocess.run([sys.executable, "-c", _RUN, lib,
                        ",".join(BAD_CODE_CUT_SHORT)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    report = [ln for ln in r.stderr.splitlines()
              if "Sanitizer" in ln or "runtime error" in ln]
    assert r.returncode == 0 and not report, (report, r.stderr[-4000:])
    words = r.stdout.split()
    assert words[:2] == ["sanitized", "lanes"] and int(words[2]) > 350
    assert "classes [-1, 0, 2]" in r.stdout           # ERR, OK, UNFINISHED


_STITCH = r"""
import sys
import numpy as np
from defl_tpu_torch.runtime import native

native.lib_path = lambda: sys.argv[1]
lib = native.load()
d = np.load(sys.argv[2])
body, cands, raw_len = d["body"], d["cands"], int(d["raw_len"])
info = tuple(d[k] for k in ("toks", "dst_pos", "status", "final", "bit_end"))
no_lanes = (*info[:2], np.ones_like(info[2]), *info[3:])
garbage = (d["junk"], *info[1:])
modes = []
for lanes, cap in ((info, raw_len + 64), (no_lanes, raw_len + 64),
                   (info, raw_len - 1), (garbage, raw_len + 64)):
    outs = [np.zeros(cap, np.uint8) for _ in range(2)]
    rs, totals, ends, mode = native.stitch_many(
        lib, body, [0], [body.size], [0], [cands.size], cands, lanes,
        [outs[0]], n_threads=8)
    want = native.stitch(lib, body, cands, lanes, outs[1])
    assert (rs[0], int(totals[0]), int(ends[0])) == want, (rs, want)
    assert np.array_equal(outs[0][:want[1]], outs[1][:want[1]])
    modes.append(int(mode[0]))
print("stitched modes", *modes)
"""


def test_parallel_stitch_is_clean_under_asan_and_ubsan(tmp_path):
    """One chain from the split decode's plan (16 lanes or more) through
    dt_stitch_many on 8 threads, in the host library built with the
    sanitizers: clean, no lanes (every gap decoded to tokens), one byte
    short (EFULL) and garbage tokens; each against dt_stitch."""
    from tests.test_torch_stitch_parallel import _plan, _small_blocks
    from defl_tpu_torch.corpus import make_silesia_like

    libasan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                             capture_output=True, text=True).stdout.strip()
    if not os.path.isabs(libasan):
        pytest.skip("g++ has no AddressSanitizer runtime here")
    raw = b"".join(make_silesia_like(1 << 17, 65536))[:100000]
    _, _, (body, cands, info), _ = _plan(_small_blocks(raw))
    rng = np.random.default_rng(7)
    junk = rng.integers(0, 1 << 32, info[0].shape, np.uint64).astype(np.uint32)
    lanes = tmp_path / "lanes.npz"
    np.savez(lanes, body=body, cands=cands, raw_len=len(raw), junk=junk,
             **dict(zip(("toks", "dst_pos", "status", "final", "bit_end"),
                        info)))
    src = os.path.join(REPO, "defl_tpu_torch", "csrc", "defl_batch.cc")
    lib = str(tmp_path / "libdefl_host_asan.so")
    flags = [f for f in SANITIZE_FLAGS if f != "-DSMEM_PER_LANE"]
    subprocess.run(["g++", "-O1", *flags, "-fPIC", "-shared", "-std=c++17",
                    "-pthread", "-o", lib, src], check=True, timeout=300)
    env = dict(os.environ, LD_PRELOAD=libasan,
               ASAN_OPTIONS="detect_leaks=0:abort_on_error=0",
               UBSAN_OPTIONS="print_stacktrace=1")
    r = subprocess.run([sys.executable, "-c", _STITCH, lib, str(lanes)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    report = [ln for ln in r.stderr.splitlines()
              if "Sanitizer" in ln or "runtime error" in ln]
    assert r.returncode == 0 and not report, (report, r.stderr[-4000:])
    # the two passes twice, then given back twice (EFULL, garbage tokens)
    assert r.stdout.split() == ["stitched", "modes", "1", "1", "2", "2"]
