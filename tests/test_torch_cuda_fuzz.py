"""The decode and adler32 kernels under malformed input, on the card.

Marked ``needs_cuda`` and skipped without a card (decided in a fixture).
The card machine has no jax: run with ``--noconftest``, as
tests/test_torch_cuda.py is run.  The streams are tests/test_fuzz.py's
(``corpus.fuzz_cases`` over that file's payloads, held byte for byte
against ``_gen_cases`` by tests/test_torch_fuzz.py), and the class each
lane must end in is the port oracle's, which tier-1 holds against
``defl_tpu``'s.  Every comparison is exact.

- The stream kernel against its plain version, the chunk loop over
  ``decode_chunk_ref``, by ``decode_cu.compare_decodes``: one batch of
  fuzz cases, and the shared-input mode over a bit-flipped body with its
  cursors at the block starts ``large._find_candidates`` sees in it.
- No poisoning: 8,192 lanes of the bench corpus with every 8th lane
  swapped for a malformed stream, in one launch: every corpus lane ends
  where it ends in the clean batch (status, ``dst_pos``, ``bitpos``, its
  tokens), every malformed lane as in the chunk loop; then through both
  resolvers (``malformed.run``): each lane its oracle class and bytes.
- The split decode of the bench's 64 MiB stream with 16 bit flips and a
  cut tail: the host-parallel engine's class, in one launch.
- The checked build (``checked=True``: every access checked against its
  extent, shared memory also against a shadow of what the launch wrote)
  on 64 lanes of a mixed batch: no fault, the unchecked launch's tokens,
  carry and totals bit for bit; and one injected out-of-extent access,
  which must raise with its site and lane.
"""

import functools
import zlib

import numpy as np
import pytest
import torch

from defl_tpu_torch import corpus, malformed
from defl_tpu_torch.ops import inflate_batch as ib
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.runtime import large
from defl_tpu_torch.runtime.pack import pack_streams
from defl_tpu_torch.runtime.session import device_inflate
from tests.gendata import make_corpus
from tests.test_torch_cuda import _until_done

pytestmark = pytest.mark.needs_cuda

#: tests/test_fuzz.py's capacity
CAP = 1024
N_BENCH = 8192
BLOCK = 65536


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


@functools.lru_cache(maxsize=None)
def _base_payloads():
    c = make_corpus()
    return (c["text"][:400], c["rand_255"], c["period_3"][:300], b"", b"a")


def _fuzz_cases(seed, n=60):
    return [d for _, d in corpus.fuzz_cases(seed, n, list(_base_payloads()))]


@pytest.mark.parametrize("seed", [1, 2, 3, 7])
def test_stream_kernel_equals_the_chunk_loop_on_fuzz_cases(seed):
    cases = _fuzz_cases(seed)
    p = pack_streams(cases, 1, CAP)
    packed = (p.words, p.nbits, p.zflag, p.dst_cap)
    T = ib.step_budget(CAP)
    launches = decode_cu.launches
    got = _until_done(packed, T=T)
    assert len(got[0]) == 1 and decode_cu.launches == launches + 1
    want = _until_done(packed, T=T, K=128, _chunk=decode_cu.decode_chunk_ref)
    assert decode_cu.compare_decodes(got, want) == 0
    assert set(got[1]["status"].tolist()) >= {0, -1, 2}
    # the whole call: each lane its oracle class, an OK lane its bytes
    want = malformed.oracle_results(cases, 1, CAP)
    res, outs, st = device_inflate(cases, dst_capacities=CAP)
    assert malformed.differing_lanes(res, outs, want) == []
    assert not st["host_fallbacks"]


@pytest.mark.parametrize("seed", [5, 6, 8])
def test_shared_input_on_a_flipped_body_equals_the_chunk_loop(seed):
    """Many cursors read one corrupted body (row stride 0); a lane that
    runs past its segment reads its neighbour's bytes."""
    raw = b"".join(corpus.make_silesia_like(1 << 18, 65536))
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 4)
    body = malformed.mutate(co.compress(raw) + co.flush(), seed, 4,
                            cut=seed % 2 == 1)
    body = np.frombuffer(body, np.uint8)
    cands = large._find_candidates(body, 0, body.size // 2048, 8 * 2048)
    assert len(cands) > 20
    kw = large.lane_args(body.size, cands)
    args = (kw.pop("nbits"), kw.pop("zflag"), kw.pop("cap"))
    kw.update(dict_len=large.WINDOW, shared_input=True)
    words = torch.from_numpy(decode_cu.pad_body(body)).view(torch.int32)
    words = words.cuda()
    got = decode_cu.decode_tokens(words, *args, **kw)
    want = decode_cu.decode_tokens(words, *args, K=128, **kw,
                                   _chunk=decode_cu.decode_chunk_ref)
    assert decode_cu.compare_decodes(got, want) == 0
    status = got[1]["status"]
    assert (status != ib.STATUS_RUNNING).all() and (status == 0).any()


@functools.lru_cache(maxsize=1)
def _bench_batch():
    blocks = corpus.make_silesia_like(N_BENCH * BLOCK, BLOCK)[:N_BENCH]
    streams = [zlib.compress(b, 6) for b in blocks]
    return blocks, streams


def test_malformed_lanes_poison_no_corpus_lane_in_one_launch():
    blocks, streams = _bench_batch()
    mixed, bad = corpus.mixed_batch(streams, blocks, seed=11)
    T = ib.step_budget(BLOCK)
    runs = []
    for batch in (streams, mixed):
        p = pack_streams(batch, 1, BLOCK)
        launches = decode_cu.launches
        runs.append(decode_cu.decode_tokens(p.words, p.nbits, p.zflag,
                                            p.dst_cap, T=T, device="cuda"))
        assert decode_cu.launches == launches + 1
    torch.cuda.synchronize()
    good = [i for i in range(N_BENCH) if i not in set(bad)]
    (_, clean), (_, mix) = runs
    for k in ("status", "dst_pos", "bitpos"):
        assert torch.equal(clean[k][good], mix[k][good]), k
    assert (clean["status"] == 0).all()
    assert decode_cu.compare_decodes(decode_cu.select_lanes(runs[0], good),
                                     decode_cu.select_lanes(runs[1], good)) \
        == 0
    # the malformed lanes of that launch against the chunk loop
    p = pack_streams([mixed[i] for i in bad], 1, BLOCK)
    want = _until_done((p.words, p.nbits, p.zflag, p.dst_cap), T=T, K=128,
                       _chunk=decode_cu.decode_chunk_ref)
    assert decode_cu.compare_decodes(decode_cu.select_lanes(runs[1], bad),
                                     want) == 0


def test_mixed_bench_batch_through_both_resolvers():
    """Every lane of the mixed batch its oracle class and bytes, with the
    host resolver and with the device resolver and the trailer check on
    the adler32 kernel; the corpus lanes' device end state is the clean
    batch's."""
    rec = malformed.run(N_BENCH, BLOCK, seed=11, device="cuda",
                        batch=_bench_batch())
    for resolve in ("resolve_host", "resolve_device"):
        r = rec[resolve]
        assert r["n_differ"] == 0 and not r["corpus_lanes_moved"], r
        assert r["host_fallbacks"] == 0
    assert rec["resolve_device"]["launches"]["adler32_batch"] >= 1
    assert rec["large"]["same"] and rec["large"]["route"] == "device"
    assert rec["ok"]


def test_checked_build_on_64_lanes_of_the_mixed_batch():
    from defl_tpu_torch.ops.cuda import build

    blocks = corpus.make_silesia_like(64 * BLOCK, BLOCK)[:64]
    streams = [zlib.compress(b, 6) for b in blocks]
    mixed, _ = corpus.mixed_batch(streams, blocks, seed=11)
    p = pack_streams(mixed, 1, BLOCK)
    args = (torch.from_numpy(p.words.view(np.int32)).cuda(), p.nbits,
            p.zflag, p.dst_cap)
    T = ib.step_budget(BLOCK)
    launches = (decode_cu.launches, decode_cu.checked_launches)
    plain = decode_cu.decode_tokens(*args, T=T)
    checked = decode_cu.decode_tokens(*args, T=T, checked=True)
    assert (decode_cu.launches, decode_cu.checked_launches) == (
        launches[0] + 1, launches[1] + 1)
    assert decode_cu.identical_decodes(plain, checked) == []
    # the lane in the middle slot of the second block of 32 lanes
    lanes = decode_cu.STREAM_THREADS // 32 * decode_cu.STREAM_LANES_PER_WARP
    lane = int(decode_cu.stream_order(p.nbits)[lanes + lanes // 2])
    with pytest.raises(build.KernelFault) as e:
        decode_cu.decode_tokens(*args, T=T, inject=("shared", lane))
    assert (e.value.site, e.value.lane, e.value.block, e.value.slot) == (
        "shared", lane, 1, lanes // 2)


def test_split_decode_of_the_mutated_large64_stream():
    from defl_tpu_torch import Result, inflate_large

    blocks, _ = _bench_batch()
    raw = b"".join(blocks[:1024])
    data = malformed.mutate(zlib.compress(raw, 6), 64, 16, cut=True)
    st = {}
    launches = decode_cu.launches
    r, out = inflate_large(data, malformed.FLAGS, use_device=True,
                           stats_out=st)
    assert st["route"] == "device" and decode_cu.launches == launches + 1
    assert st["lanes"] > 500
    r_host, _ = inflate_large(data, malformed.FLAGS, use_device=False)
    assert int(r) == int(r_host) and r is not Result.OK
