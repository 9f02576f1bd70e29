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
  3. One launch decodes every segment of every stream, and each stream's
     chain is stitched into that stream's output, through the chain path
     ``inflate_large(use_device=True)`` takes with a chain of one
     (``large.chain_lanes``, ``decode_chains``, ``stitch_chains``): each
     lane's ``nbits`` is the end of its own stream (no lane reads into the
     next one), and the stitch runs one stream a task on the host's
     threads.  A short stream of a mixed batch is a chain of one segment.
     A stream the host decoded any part of is one of the stats'
     ``host_fallbacks``.

Nothing is kept from one call to the next.  The segment target is
``SEGMENT_BYTES``; a batch whose bodies pass the kernel's int32 bit
cursors goes in more than one launch.
"""

from __future__ import annotations

import numpy as np

from defl_tpu_torch import metrics
from defl_tpu_torch.errors import FLAG_ZLIB, Result
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.runtime import large, native, session
from defl_tpu_torch.runtime.pack import (MAX_STREAM_BYTES, chunks,
                                         stream_caps, stream_head,
                                         stream_length)

#: target compressed bytes of one lane of a split stream; a stream is split
#: when its body holds three targets or more
SEGMENT_BYTES = 32768
#: a lane's output counter, and an output that grows, stop here at most
#: (as ``device_inflate``'s one-lane route grows)
_LANE_CAP = 1 << 30


def wanted(streams, zlib_wrapped: bool) -> bool:
    """Whether a batch takes the split route: some stream's body spans at
    least three segment targets, has a valid zlib header without a preset
    dictionary (when the streams are zlib-wrapped), and fits a lane's
    packing limit like every stream of the batch."""
    lengths = [stream_length(s) for s in streams]
    if max(lengths, default=0) > MAX_STREAM_BYTES:
        return False        # today's route, which refuses it
    hdr = 2 if zlib_wrapped else 0
    return any(n - hdr >= 3 * SEGMENT_BYTES and (
        not zlib_wrapped or large.header_result(stream_head(s, 2)) is None)
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
    grow = dst_capacities is None
    caps = stream_caps(streams, dst_capacities)

    verdict = [large.header_result(stream_head(s, 2)) if zf else None
               for s in streams]
    sizes = [0 if v is not None else stream_length(s) - hdr
             for s, v in zip(streams, verdict)]
    # a header and nothing more is UNFINISHED
    verdict = [Result.UNFINISHED if v is None and n == 0 else v
               for v, n in zip(verdict, sizes)]

    status = np.array([0 if v is None else int(v) for v in verdict],
                      np.int32)
    dst_pos = np.zeros(n_in, np.int32)
    bitpos = np.zeros(n_in, np.int32)
    results: list = list(verdict)
    outputs: list = [b""] * n_in
    fallbacks: list[int] = []
    launches0 = decode_cu.launches
    T = 0
    n_split = n_lanes = n_valid = 0
    for group in _groups(sizes):
        live = [i for i in group if sizes[i] > 0]
        if not live:
            continue
        body, body_dev, chains, kw = _pack(streams, live, sizes, caps, hdr,
                                           dev)
        lane_info, _ = large.decode_chains(body_dev, chains, kw, chunk_steps,
                                           dev)
        del body_dev
        T = max(T, kw["T"])
        with metrics.span("defl.resolve"):
            done = large.stitch_chains(
                body, chains, lane_info,
                [np.empty(caps[i], np.uint8) for i in live], grow, _LANE_CAP)
            for k, (off, n, cands, _) in enumerate(chains):
                r, total, end, buf, cap, valid, _ = done[k]
                if r is Result.EFULL:
                    # still EFULL: decoded serially, which fills its output
                    # as far as the engines fill it
                    done[k] = (*native.stitch(lib, body[off:off + n], cands,
                                              None, buf[:cap]),
                               buf, cap, valid, False)
        with metrics.span("defl.lane_bytes"):
            for i, (off, n, cands, _), (r, total, end, buf, cap, valid,
                                        taken) in zip(live, chains, done):
                status[i], dst_pos[i], bitpos[i] = int(r), total, end + 8 * hdr
                caps[i] = cap
                results[i], outputs[i] = large._finish(
                    r, total, end, body[off:off + n], buf, flags, zf, False)
                if not taken:
                    fallbacks.append(i)
                if n // SEGMENT_BYTES >= 3:
                    n_split += 1
                    n_lanes += len(cands)
                    n_valid += valid

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


def _pack(streams, live, sizes, caps, hdr, dev):
    """One body for the streams of ``live``, its upload and its finds, in
    span ``defl.pack``.  Returns (the host body, the body on ``dev``, each
    stream's chain as ``large.chain_lanes`` takes it, the lanes' launch
    arguments)."""
    ends = np.cumsum([sizes[i] for i in live]).tolist()
    offs = [0] + ends[:-1]
    with metrics.span("defl.pack"):
        host, body = large.host_body(ends[-1], dev)
        for i, pos in zip(live, offs):
            skip = hdr
            for c in chunks(streams[i]):
                a = np.frombuffer(c, np.uint8)[skip:] if len(c) > skip \
                    else None
                skip = max(skip - len(c), 0)
                if a is not None:
                    body[pos:pos + a.size] = a
                    pos += a.size
        body_dev, side = large.upload_body(host, dev)
        spans = []
        for i, off in zip(live, offs):
            n_seg = sizes[i] // SEGMENT_BYTES
            bits = 8 * sizes[i]
            spans.append((off, sizes[i], 0,
                          [k * bits // n_seg for k in range(1, n_seg)]
                          if n_seg >= 3 else []))
        with metrics.span("defl.upload"):
            large.wait_body(body_dev, side, dev)
        with metrics.span("defl.split.find"):
            cands = large.find_lane_starts(body, spans, 8 * SEGMENT_BYTES,
                                           body_dev=body_dev)
        chains = [(off, sizes[i], c, min(caps[i], _LANE_CAP))
                  for i, off, c in zip(live, offs, cands)]
        kw = large.chain_lanes(chains)
    return body, body_dev, chains, kw
