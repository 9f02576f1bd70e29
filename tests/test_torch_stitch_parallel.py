"""One long chain stitched on every thread (``dt_stitch_many`` with fewer
chains than threads: the plan, pass A into 16-bit cells with window
markers, pass B into the output), held against ``dt_stitch``'s one-thread
walk over the same lanes.

The lanes are those of ``inflate_large(use_device=True, device="cpu")``
at 1 KiB segments (the decode kernel's plain version), as the route hands
them to its stitch (``large.head_guard`` applied).  The streams take small
blocks (zlib ``memLevel`` 4), so that a chain has 20 to 40 lanes of a few
KB each: far shorter than the 32 KiB window, so that back-references
cross several lanes.  Each case compares the result, the total, the end
bit and the bytes, and the chain's mode: stitched by the two passes, or
given back to the walk (a stream error, EFULL), or one chain a task.
"""

import zlib

import numpy as np
import pytest

from defl_tpu_torch import metrics
from defl_tpu_torch.corpus import make_silesia_like
from defl_tpu_torch.errors import Result
from defl_tpu_torch.runtime import large
from defl_tpu_torch.runtime import native as tnative

pytestmark = pytest.mark.skipif(not tnative.available(),
                                reason="native library unavailable")

THREADS = 8
SEG = 1024
SENTINEL = 0xA5


def _small_blocks(raw: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 4)
    return co.compress(raw) + co.flush()


def _plan(comp: bytes):
    """(Result, output) of ``inflate_large(use_device=True, device="cpu")``
    at 1 KiB segments, and the (body, lane starts, lanes) its stitch was
    handed, the head guard applied as the stitch applies it, and the lanes
    as they were handed."""
    got = {}
    stitch = large.stitch_chains

    def keep(body, chains, lane_info, outs, grow, ceiling):
        got["lanes"] = (body, chains, lane_info)
        return stitch(body, chains, lane_info, outs, grow, ceiling)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(large, "SEGMENT_BYTES", SEG)
        mp.setattr(large, "stitch_chains", keep)
        r, out = large.inflate_large(comp, use_device=True, device="cpu")
    body, [(_, _, cands, _)], lane_info = got["lanes"]
    return r, out, (body, np.asarray(cands, np.int64),
                    large.head_guard(cands, lane_info, body)), lane_info


@pytest.fixture(scope="module")
def mixed():
    """Text; short runs of one to five letters (distances 1 to 5), so that
    lanes start inside runs (the seed is one where a lane starts at a
    distance of 1 and one at a distance from 2 to 7); incompressible bytes
    in two places (stored blocks in two lanes); zeros."""
    rng = np.random.default_rng(19)
    text = b"".join(make_silesia_like(1 << 17, 65536))
    runs = b"".join(bytes(rng.integers(97, 105, 1 + k % 5, np.uint8)) * int(n)
                    for k, n in enumerate(rng.integers(3, 16, 3000)))
    noise = rng.integers(0, 256, 20000, np.uint8).tobytes()
    raw = b"".join([text[:30000], runs, noise[:10000], text[30000:70000],
                    bytes(30000), noise[10000:], text[70000:100000]])
    r, out, lanes, unguarded = _plan(_small_blocks(raw))
    assert r is Result.OK and out == raw
    return raw, lanes, unguarded


@pytest.fixture(scope="module")
def flipped():
    """C7: a flip in the stream's first block that turns a distance into
    one that reaches before the stream's first byte (zlib: "invalid
    distance too far back")."""
    raw = b"".join(make_silesia_like(1 << 17, 65536))
    comp = _small_blocks(raw)
    for pos in range(40, len(comp)):
        bad = bytearray(comp)
        bad[pos] ^= 0x80
        try:
            zlib.decompress(bytes(bad))
        except zlib.error as e:
            if "too far back" in str(e):
                break
    r, _, lanes, unguarded = _plan(bytes(bad))
    assert r is Result.ERR
    return lanes, unguarded


def _many(body, chains, lane_info, outs, threads=THREADS):
    """stitch_many over ``chains`` = [(byte offset, bytes, lane starts)],
    whose lanes lie one after another in ``lane_info``."""
    first = np.cumsum([0] + [len(c) for _, _, c in chains])[:-1]
    return tnative.stitch_many(
        tnative.load(), body, [o for o, _, _ in chains],
        [n for _, n, _ in chains], first, [len(c) for _, _, c in chains],
        np.concatenate([c for _, _, c in chains]), lane_info, outs,
        n_threads=threads)


def _one(body, cands, lane_info, cap):
    """The chain through stitch_many on every thread and through stitch,
    each into a buffer of ``cap`` sentinel bytes: both results, and both
    buffers."""
    outs = [np.full(cap, SENTINEL, np.uint8) for _ in range(2)]
    rs, totals, ends, modes = _many(body, [(0, body.size, cands)],
                                    lane_info, [outs[0]])
    want = tnative.stitch(tnative.load(), body, cands, lane_info, outs[1])
    return (rs[0], int(totals[0]), int(ends[0])), int(modes[0]), want, outs


def _same(got, mode, want, outs):
    assert got == want
    total = got[1]
    assert np.array_equal(outs[0][:total], outs[1][:total])
    if mode == tnative.STITCH_PARALLEL:
        # the passes write the chain's bytes and nothing past them
        assert (outs[0][total:] == SENTINEL).all()
    else:
        assert np.array_equal(outs[0], outs[1])


def _with_false_candidates(body, cands, lane_info, rng):
    """A false candidate between some lanes (a block start the finder
    would have had wrong): the lane before it no longer ends on the next
    start, so the walk decodes a gap up to the next true one."""
    toks, dst_pos, status, final, bit_end = lane_info
    at = sorted(rng.choice(np.arange(2, cands.size - 1), 4, replace=False))
    fake = [int(cands[k]) + 3 + int(rng.integers(0, 64)) for k in at]
    keep = np.concatenate([cands, fake])
    order = np.argsort(keep, kind="stable")
    n = len(fake)
    z = np.zeros(n, np.int32)
    return keep[order], (
        np.concatenate([toks, np.zeros((n, toks.shape[1]), np.uint32)])[order],
        np.concatenate([dst_pos, rng.integers(0, 4000, n).astype(np.int32)])
        [order], np.concatenate([status, z])[order],
        np.concatenate([final, z])[order],
        np.concatenate([bit_end, rng.integers(0, 8 * body.size, n)])[order])


def _seam_distances(body, cands, lane_info):
    """The distances of the matches in valid lanes' first 8 bytes that
    reach across their lane's start (a lane's row holds a token a step of
    the decoder, a no-op where the step put out none)."""
    toks, dst_pos, status, final, bit_end = lane_info
    seams = large.seams(list(cands), lane_info)
    found = []
    for k in np.flatnonzero(seams)[1:]:
        p = 0
        for v in toks[k].tolist():
            kind = v >> 30
            if kind == 1:
                p += 1 + ((v >> 16) & 1)
            elif kind == 2:
                dist = (v & 0x7FFF) + 1
                if p - dist < 0:
                    found.append(dist)
                p += ((v >> 21) & 0x1FF) + 3
            elif kind == 3:
                p += ((v >> 22) & 0xFF) + 1
            if p >= 8:
                break
    return found


CASES = ["clean", "false_candidates", "gaps", "stored", "short_distances",
         "c7_flip", "one_byte_short", "no_lanes"]


@pytest.mark.parametrize("case", CASES)
def test_one_chain_on_every_thread_is_dt_stitch(mixed, flipped, case):
    raw, (body, cands, lane_info), _ = mixed
    cap = len(raw) + 4096
    rng = np.random.default_rng(CASES.index(case))
    expect = tnative.STITCH_PARALLEL
    if case == "false_candidates":
        cands, lane_info = _with_false_candidates(body, cands, lane_info, rng)
    elif case == "gaps":
        status = lane_info[2].copy()
        status[rng.choice(np.arange(1, cands.size), 6, replace=False)] = 1
        lane_info = (*lane_info[:2], status, *lane_info[3:])
    elif case == "stored":
        # stored blocks inside valid lanes, and a lane over them decoded
        # as a gap
        kinds = lane_info[0] >> 30
        ok = large.seams(list(cands), lane_info)
        stored = np.flatnonzero((kinds == 3).any(axis=1) & ok)
        assert stored.size >= 2
        status = lane_info[2].copy()
        status[stored[0]] = 1
        lane_info = (*lane_info[:2], status, *lane_info[3:])
    elif case == "short_distances":
        dists = _seam_distances(body, cands, lane_info)
        assert 1 in dists and any(1 < d < 8 for d in dists)
    elif case == "c7_flip":
        body, cands, lane_info = flipped[0]
        expect = tnative.STITCH_FALLBACK
    elif case == "one_byte_short":
        cap = len(raw) - 1
        expect = tnative.STITCH_FALLBACK
    elif case == "no_lanes":
        lane_info = (*lane_info[:2], np.ones_like(lane_info[2]),
                     *lane_info[3:])
    assert cands.size >= 16
    got, mode, want, outs = _one(body, cands, lane_info, cap)
    _same(got, mode, want, outs)
    assert mode == expect
    if case == "c7_flip":
        assert got[0] is Result.ERR
    elif case == "one_byte_short":
        assert got[0] is Result.EFULL
    else:
        assert got[0] is Result.OK and outs[0][:got[1]].tobytes() == raw


@pytest.mark.parametrize("n_chains, modes", [
    (32, {tnative.STITCH_TASK}), (2, {tnative.STITCH_PARALLEL,
                                      tnative.STITCH_TASK})])
def test_many_chains_keep_one_chain_a_task(mixed, n_chains, modes):
    """As many chains as threads or more (kodak32.batch's 32 on 8): one
    chain a task, as before, and no chain on every thread.  Two chains,
    one of them too short to split (its first 8 lanes, ended at the 8th
    lane's end): the long one on every thread, the short one a task."""
    raw, (body, cands, lane_info), _ = mixed
    if n_chains == 2:
        short = 8
        head = tuple(a[:short] for a in lane_info)
        tail_end = int(head[4][-1])
        nbytes = (tail_end + 7) // 8 + 16
        chains = [(0, body.size, cands), (body.size, nbytes, cands[:short])]
        big = np.concatenate([body, body[:nbytes]])
        info = tuple(np.concatenate([a, h]) for a, h in zip(lane_info, head))
    else:
        chains = [(k * body.size, body.size, cands) for k in range(n_chains)]
        big = np.concatenate([body] * n_chains)
        info = tuple(np.concatenate([a] * n_chains) for a in lane_info)
    outs = [np.full(len(raw) + 4096, SENTINEL, np.uint8)
            for _ in range(n_chains)]
    rs, totals, ends, got_modes = _many(big, chains, info, outs)
    assert set(got_modes.tolist()) == modes
    first = np.cumsum([0] + [len(c) for _, _, c in chains])
    for k, (off, n, c) in enumerate(chains):
        own = tuple(a[first[k]:first[k + 1]] for a in info)
        want_out = np.full(outs[k].size, SENTINEL, np.uint8)
        want = tnative.stitch(tnative.load(), big[off:off + n], c, own,
                              want_out)
        assert (rs[k], int(totals[k]), int(ends[k])) == want
        _same(want, int(got_modes[k]), want, [outs[k], want_out])
    assert rs[0] is Result.OK and outs[0][:totals[0]].tobytes() == raw


def test_stitch_chains_counts_the_modes(mixed):
    """large.stitch_chains, which both split routes run, counts its chains
    and those that the two passes stitched or gave back."""
    raw, (body, cands, _), lane_info = mixed
    chains = [(0, body.size, cands, large.SEGMENT_CAP)]
    names = ("stitch_chains", "stitch_chains_parallel",
             "stitch_chains_fallback")
    for cap, moved in ((len(raw), (1, 1, 0)), (len(raw) - 1, (1, 0, 1))):
        m0 = metrics.snapshot()
        [done] = large.stitch_chains(body, chains, lane_info,
                                     [np.empty(cap, np.uint8)], False, 0)
        m1 = metrics.snapshot()
        assert tuple(m1.get(k, 0) - m0.get(k, 0) for k in names) == moved
        assert done[0] is (Result.OK if cap == len(raw) else Result.EFULL)


@pytest.mark.parametrize("case", ["clean", "c7_flip"])
def test_a_false_start_at_the_head_keeps_the_lanes_past_a_window(
        mixed, flipped, case):
    """A false block start right after the head (a lane of 20 bytes that
    validates, so that the head's lane no longer ends on the next start)
    breaks the chain of validated lanes before it has put out a window.
    Decoded serially to the first boundary past a window, the head leaves
    every later lane standing (where the head does not decode, all of them
    are marked); the stitch's output and result are the serial engines'
    all the same, the C7 flip's ERR included."""
    raw, (body, cands, _), lanes = mixed
    if case == "c7_flip":
        (body, cands, _), lanes = flipped
    toks, dst_pos, status, final, bit_end = lanes
    fake = int(cands[0] + cands[1]) // 2
    at = np.searchsorted(cands, fake)
    cands = np.insert(cands, at, fake)
    info = (np.insert(toks, at, 0, axis=0), np.insert(dst_pos, at, 20),
            np.insert(status, at, 0), np.insert(final, at, 0),
            np.insert(bit_end, at, cands[at + 1]))
    assert not large.seams(list(cands), info)[0]
    guarded = large.head_guard(cands, info, body)
    marked = np.flatnonzero((info[2] == 0) & (guarded[2] != 0))
    if case == "clean":
        assert 0 < marked.size < cands.size // 2
        bit = large.head_window_bit(body, cands)
        assert (cands[marked] < bit).all() and cands[marked[-1] + 1] >= bit
    got, mode, want, outs = _one(body, cands, guarded, 1 << 20)
    _same(got, mode, want, outs)
    if case == "clean":
        assert got[0] is Result.OK and outs[0][:got[1]].tobytes() == raw
        assert mode == tnative.STITCH_PARALLEL
    else:
        assert (guarded[2][1:] != 0).all() and got[0] is Result.ERR
