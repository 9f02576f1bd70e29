"""The split decode of a batch's long streams: ``session.device_inflate``'s
route for a batch that holds a stream of three segments or more.

One lane a stream runs as long as the stream's serial chain, so a batch of
a few long streams (PNG IDATs, ORC stripes, log segments) leaves the card
almost empty.  Here every long stream is cut at speculated block starts
with the pieces ``runtime/large.py`` cuts one huge stream with, and all
the batch's lanes run in one launch of the decode kernel's shared-input
mode:

  1. The streams' deflate bodies (zlib headers checked and stripped on the
     host) are copied chunk by chunk into one page-locked body, which goes
     up on a side stream.
  2. The block finder looks for a block start near every segment target
     of every long stream; the finds of the whole batch run at once
     (``large.find_lane_starts``): on a card in one launch of its kernel
     over the uploaded body, on the CPU in one native call on the host's
     threads.
  3. One launch decodes every segment of every stream: each lane's cursors
     are positions in the joined body, its ``nbits`` is the end of its own
     stream (no lane reads into the next one), its reach before its start
     is 0 at a stream's head and the whole window elsewhere
     (``large.lane_args``).  A short stream of a mixed batch is a chain of
     one segment.
  4. The occupied token rows come back, and each stream's chain is
     stitched into that stream's output, one stream a task on the host's
     threads in one native call (``dt_stitch_many``, ``dt_stitch``'s walk
     per chain): valid lanes resolve, and any gap (a false candidate,
     EFULL, a spent budget, a lane before the output holds a window:
     ``large.head_guard``) is decoded serially, so a wrong candidate costs
     time and never output.  A stream the host decoded any part of is
     one of the stats' ``host_fallbacks``.

Nothing is kept from one call to the next.  The segment target is
``SEGMENT_BYTES``; a batch whose bodies pass the kernel's int32 bit
cursors goes in more than one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from defl_tpu_torch import metrics
from defl_tpu_torch.errors import FLAG_ZLIB, Result
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.runtime import large, native, session
from defl_tpu_torch.runtime.pack import MAX_STREAM_BYTES

#: target compressed bytes of one lane of a split stream; a stream is split
#: when its body holds three targets or more
SEGMENT_BYTES = 32768
#: a lane's output counter, and an output that grows, stop here at most
#: (as ``device_inflate``'s one-lane route grows)
_LANE_CAP = 1 << 30


def _chunks(s):
    return [s] if isinstance(s, (bytes, bytearray, memoryview)) else s


def _length(s) -> int:
    return sum(len(c) for c in _chunks(s))


def _head(s, n: int) -> bytes:
    """The first ``n`` bytes of a stream (bytes or a list of chunks)."""
    out = b""
    for c in _chunks(s):
        out += bytes(memoryview(c)[:n - len(out)])
        if len(out) >= n:
            break
    return out


def wanted(streams, zlib_wrapped: bool) -> bool:
    """Whether a batch takes the split route: some stream's body spans at
    least three segment targets, has a valid zlib header without a preset
    dictionary (when the streams are zlib-wrapped), and fits a lane's
    packing limit like every stream of the batch."""
    lengths = [_length(s) for s in streams]
    if max(lengths, default=0) > MAX_STREAM_BYTES:
        return False        # today's route, which refuses it
    hdr = 2 if zlib_wrapped else 0
    return any(n - hdr >= 3 * SEGMENT_BYTES and
               (not zlib_wrapped or large.header_result(_head(s, 2)) is None)
               for s, n in zip(streams, lengths))


def _groups(sizes) -> list[list[int]]:
    """Streams in order, cut into runs whose joined body stays under the
    kernel's int32 bit cursors (with its padding)."""
    groups, cur, total = [], [], 0
    room = 4 * decode_cu.PAD_WORDS + 16
    for i, n in enumerate(sizes):
        if cur and not large.device_route_allowed(total + n + room):
            groups.append(cur)
            cur, total = [], 0
        cur.append(i)
        total += n
    return groups + [cur] if cur else groups


def inflate(streams, flags, dst_capacities, chunk_steps, dev):
    """``device_inflate(resolve="host")`` of a batch ``wanted`` says yes
    to; returns what it returns: (results, outputs, stats)."""
    lib = native.load()
    n_in = len(streams)
    zf = bool(flags & FLAG_ZLIB)
    hdr = 2 if zf else 0
    lengths = [_length(s) for s in streams]
    grow = dst_capacities is None
    if grow:
        caps = [min(64 * n, 1 << 26) or 64 for n in lengths]
    else:
        caps = ([int(dst_capacities)] * n_in
                if np.isscalar(dst_capacities) else
                [int(c) for c in dst_capacities])

    verdict: list = [None] * n_in
    if zf:
        for i, s in enumerate(streams):
            verdict[i] = large.header_result(_head(s, 2))
    sizes = [0 if verdict[i] is not None else lengths[i] - hdr
             for i in range(n_in)]
    for i in range(n_in):
        if verdict[i] is None and sizes[i] == 0:
            verdict[i] = Result.UNFINISHED     # a header and nothing more

    status = np.zeros(n_in, np.int32)
    dst_pos = np.zeros(n_in, np.int32)
    bitpos = np.zeros(n_in, np.int32)
    results: list = list(verdict)
    outputs: list = [b""] * n_in
    fallbacks: list[int] = []
    launches0 = decode_cu.launches
    T = 0
    n_split = n_lanes = n_valid = 0
    for group in _groups(sizes):
        got = _launch(lib, streams, group, sizes, caps, hdr, chunk_steps, dev)
        if got is None:
            continue
        body, chains, lane_info, t = got
        T = max(T, t)
        with metrics.span("defl.resolve"):
            done = _stitch(lib, body, chains, lane_info, sizes, caps, grow)
        with metrics.span("defl.lane_bytes"):
            for (i, off, cands, lanes), (r, total, end, buf, cap, serial) \
                    in zip(chains, done):
                status[i], dst_pos[i], bitpos[i] = int(r), total, end + 8 * hdr
                caps[i] = cap
                results[i], outputs[i] = large._finish(
                    r, total, end, body[off:off + sizes[i]], buf, flags, zf,
                    False)
                if serial:
                    fallbacks.append(i)
                if sizes[i] // SEGMENT_BYTES >= 3:
                    n_split += 1
                    n_lanes += len(cands)
                    n_valid += int(large.seams(
                        cands, _own(lane_info, lanes)).sum())
    for i in range(n_in):
        if verdict[i] is not None:
            status[i] = int(verdict[i])

    launched = decode_cu.launches - launches0
    metrics.inc("batch_split_streams", n_split)
    metrics.inc("batch_split_lanes", n_lanes)
    metrics.inc("batch_split_lanes_valid", n_valid)
    stats = {"bitpos": bitpos, "dst_pos": dst_pos, "status": status,
             "T": T, "C": session._bucket(max(caps)),
             "host_fallbacks": sorted(fallbacks),
             "decode_chunk_launches": launched, "adler32_batch_launches": 0,
             "split_streams": n_split, "split_lanes": n_lanes,
             "split_lanes_valid": n_valid}
    return results, outputs, stats


def _launch(lib, streams, group, sizes, caps, hdr, chunk_steps, dev):
    """One body, one find, one launch and one fetch for the streams of
    ``group``.  Returns (the host body, each stream's chain (index, byte
    offset in the body, lane starts, its lanes' slice), lane_info over every
    lane with its end bit in its own stream, T), or None when no stream has
    a body."""
    live = [i for i in group if sizes[i] > 0]
    if not live:
        return None
    offs, total = {}, 0
    for i in live:
        offs[i] = total
        total += sizes[i]
    seg_bits = 8 * SEGMENT_BYTES
    with metrics.span("defl.pack"):
        host, body = large.host_body(total, dev)
        for i in live:
            pos, skip = offs[i], hdr
            for c in _chunks(streams[i]):
                a = np.frombuffer(c, np.uint8)[skip:] if len(c) > skip \
                    else None
                skip = max(skip - len(c), 0)
                if a is not None:
                    body[pos:pos + a.size] = a
                    pos += a.size
        body_dev, side = large.upload_body(host, dev)
        spans = []
        for i in live:
            n_seg = sizes[i] // SEGMENT_BYTES
            bits = 8 * sizes[i]
            spans.append((offs[i], sizes[i], 0,
                          [k * bits // n_seg for k in range(1, n_seg)]
                          if n_seg >= 3 else []))
        with metrics.span("defl.upload"):
            large.wait_body(body_dev, side, dev)
        with metrics.span("defl.split.find"):
            cands = dict(zip(live, large.find_lane_starts(
                body, spans, seg_bits, body_dev=body_dev)))
        kws = [large.lane_args(sizes[i], cands[i], offs[i],
                               min(caps[i], _LANE_CAP)) for i in live]
        kw = {k: np.concatenate([a[k] for a in kws])
              for k in kws[0] if k != "T"}
        nbits, zflag, cap = kw.pop("nbits"), kw.pop("zflag"), kw.pop("cap")
        kw["T"] = max(a["T"] for a in kws)
    with metrics.span("defl.decode"):
        toks, st = decode_cu.decode_tokens(
            body_dev, nbits, zflag, cap, K=chunk_steps,
            dict_len=large.WINDOW, shared_input=True, device=dev, **kw)
    with metrics.span("defl.fetch"):
        toks_nt = session.fetch_tokens([(toks, st["tok_rows"])])
        meta = torch.stack([st["dst_pos"], st["status"], st["final"],
                            st["bitpos"]]).cpu().numpy()
    chains, a = [], 0
    for i in live:
        b = a + len(cands[i])
        chains.append((i, offs[i], cands[i], slice(a, b)))
        a = b
    dst_pos, status, final, bitpos = meta
    base = np.repeat([8 * offs[i] for i in live],
                     [len(cands[i]) for i in live])
    return body, chains, (toks_nt, dst_pos, status, final,
                          bitpos.astype(np.int64) - base), kw["T"]


def _own(lane_info, lanes):
    """A chain's share of a launch's lane info."""
    return tuple(a[lanes] for a in lane_info)


def _stitch(lib, body, chains, lane_info, sizes, caps, grow):
    """Every chain of a launch stitched into an output of its own, in one
    native call on the host's threads (``dt_stitch_many``: valid lanes
    resolve, gaps and the lanes ``large.head_guard`` marks decode
    serially).  A chain that ends EFULL is stitched again into a grown
    output when no capacity was declared (``large.stitch_grown``); one
    still EFULL is decoded serially, which fills its output as far as the
    engines fill it.  Returns (Result, bytes out, end bit in its stream,
    the output buffer, the capacity it ended with, whether the host
    decoded any of it serially) a chain."""
    guarded = [large.head_guard(c[2], _own(lane_info, c[3])) for c in chains]
    status = np.concatenate([g[2] for g in guarded])
    taken = [bool(large.seams(c[2], g).all()) for c, g in zip(chains, guarded)]
    bufs = [np.empty(caps[c[0]], np.uint8) for c in chains]
    rs, totals, ends = native.stitch_many(
        lib, body, [c[1] for c in chains], [sizes[c[0]] for c in chains],
        [c[3].start for c in chains], [len(c[2]) for c in chains],
        np.concatenate([c[2] for c in chains]),
        (*lane_info[:2], status, *lane_info[3:]), bufs)
    done = []
    for chain, g, ok, r, total, end, buf in zip(
            chains, guarded, taken, rs, totals.tolist(), ends.tolist(), bufs):
        i, off, cands, _ = chain
        own, cap = body[off:off + sizes[i]], caps[i]
        if r is Result.EFULL and grow and cap < _LANE_CAP:
            r, total, end, buf, cap = large.stitch_grown(
                own, cands, g, min(4 * cap, _LANE_CAP), True, _LANE_CAP)
        if r is Result.EFULL:
            r, total, end = native.stitch(lib, own, cands, None, buf[:cap])
            ok = False
        done.append((r, total, end, buf, cap, not ok))
    return done
