"""The decode kernel's own per-lane code under malformed input, on the CPU.

``csrc/decode_stream.cu`` builds with g++ for the host (the shim of
tests/test_torch_stream_decode.py: a few intrinsics defined, one lane
after the other), and ``decode_cu.decode_tokens`` runs around it exactly
as it runs around a launch on the card.  What the card's fuzz holds
(tests/test_torch_cuda_fuzz.py, ``chip_smoke.py`` [11]) is held here first
for the source's arithmetic:

- tests/test_fuzz.py's cases (``_gen_cases``: truncated, bit-flipped,
  garbage, garbage after a valid header), packed as one batch, against the
  chunk loop over ``decode_chunk_ref`` by ``decode_cu.compare_decodes``:
  every lane's end state, its tokens in order and, for a lane that could
  resume, its tables.  Lookup-table holes of incomplete codes, the second
  token's checks, the stall-or-error rule at a stream's end and the stored
  blocks' LEN/NLEN all lie on these lanes;
- the shared-input mode: one body of small blocks with bit flips, lanes at
  the block starts the finder sees in it, against the chunk loop.

What nvcc makes of the source, and what shared memory does between lanes,
only the card shows.  Exact comparisons.
"""

import ctypes
import random
import zlib

import numpy as np
import pytest
import torch

from defl_tpu_torch.corpus import make_silesia_like
from defl_tpu_torch.ops import inflate_batch as tib
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.runtime import large
from defl_tpu_torch.runtime.pack import pack_streams
from tests.test_fuzz import CAP, _gen_cases
from tests.decode_host import _host_split_decode, _host_stream, build
from tests.test_torch_stream_decode import _until_done

T = tib.step_budget(CAP)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    return ctypes.CDLL(build(tmp_path_factory.mktemp("decode_stream_fuzz")))


@pytest.mark.parametrize("seed", [1, 2, 3, 7])
def test_host_build_of_the_kernel_equals_the_chunk_loop_on_fuzz_cases(
        host_kernels, monkeypatch, seed):
    cases = _gen_cases(seed, 60)
    p = pack_streams(cases, 1, CAP)
    packed = (p.words, p.nbits, p.zflag, p.dst_cap)
    got = _until_done(_host_stream(host_kernels, monkeypatch), packed, T=T)
    want = _until_done(lambda *a, **k: decode_cu.decode_tokens(
        *a, K=128, device="cpu", **k), packed, T=T)
    assert decode_cu.compare_decodes(got, want) == 0
    status = set(got[1]["status"].tolist())
    assert status >= {0, -1, 2}
    assert len(got[0]) == 1              # one call: every lane at its end


def test_host_build_of_the_kernel_errs_on_a_bad_code_cut_short(
        host_kernels, monkeypatch):
    """tests/test_torch_fuzz.py's ``BAD_CODE_CUT_SHORT``: ERR in the
    kernel's own code as in the chunk loop, not a stall."""
    from tests.test_torch_fuzz import BAD_CODE_CUT_SHORT

    cases = [bytes.fromhex(h) for h in BAD_CODE_CUT_SHORT]
    p = pack_streams(cases, 0, CAP)
    packed = (p.words, p.nbits, p.zflag, p.dst_cap)
    got = _until_done(_host_stream(host_kernels, monkeypatch), packed, T=T)
    want = _until_done(lambda *a, **k: decode_cu.decode_tokens(
        *a, K=128, device="cpu", **k), packed, T=T)
    assert decode_cu.compare_decodes(got, want) == 0
    assert got[1]["status"].tolist() == [-1] * len(cases)


def _flipped_body(seed):
    raw = b"".join(make_silesia_like(1 << 16, 65536))[:60_000]
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 4)
    body = bytearray(co.compress(raw) + co.flush())
    rng = random.Random(seed)
    for _ in range(rng.randrange(1, 5)):
        body[rng.randrange(len(body))] ^= 1 << rng.randrange(8)
    if seed % 2:
        body = body[: rng.randrange(len(body) // 2, len(body))]
    return np.frombuffer(bytes(body), np.uint8)


@pytest.mark.parametrize("seed", [5, 6, 8])
def test_host_build_shared_input_on_a_flipped_body_equals_the_chunk_loop(
        host_kernels, monkeypatch, seed):
    """Many cursors read one corrupted body (row stride 0); a lane that
    runs past its segment reads its neighbour's bytes, as on the card."""
    body = _flipped_body(seed)
    cands = large._find_candidates(body, 0, body.size // 1024, 8 * 1024)
    assert len(cands) > 5
    kw = large.lane_args(body.size, cands)
    got = _host_split_decode(host_kernels, monkeypatch, body, kw)
    T_split = kw.pop("T")
    args = (kw.pop("nbits"), kw.pop("zflag"), kw.pop("cap"))
    want = decode_cu.decode_tokens(body.copy(), *args, T=T_split, K=128,
                                   dict_len=large.WINDOW, shared_input=True,
                                   device="cpu", **kw)
    assert decode_cu.compare_decodes(got, want) == 0
    status = got[1]["status"]
    assert (status != tib.STATUS_RUNNING).all()
    assert torch.isin(status, torch.tensor([0, -1, 2, -105])).all()
