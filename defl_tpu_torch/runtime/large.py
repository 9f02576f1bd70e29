"""Arbitrary-size single-stream inflate via speculative block-parallel decode.

Counterpart of ``defl_tpu/runtime/large.py``.  DEFLATE is bit-serial, so
one huge stream cannot be split into lanes directly; the answer is
speculation on block boundaries (rapidgzip, CODAG):

  1. The block finder scans for dynamic-block headers at arbitrary bit
     offsets near evenly spaced byte targets (3-bit BTYPE filter,
     code-length Kraft filter, then a full table-free validation of the
     header): on a card its kernel over the uploaded body
     (``csrc/find_starts.cu``), on the CPU the native finder
     (``dt_find_block_starts``); both give the same starts.
  2. Every segment becomes one lane of the decode kernel, which reads the
     one body on the card (``decode_tokens(shared_input=True)``).  Lanes
     run with a reach of 32768 before their start: back-references into
     the previous segment are emitted as they are and resolve against its
     output, like a preset dictionary.  A per-lane ``limit`` stops each
     lane at the first block boundary at or past the next segment's start.
  3. The host stitches: lane k is valid iff it ended exactly at lane
     k+1's start bit.  Valid segments resolve straight into one output
     buffer (C++ resolver, ``dst_start`` window chaining); any gap (a
     false candidate, EFULL, a spent step budget) is decoded again
     serially by ``dt_inflate_span`` from the last good boundary, and the
     chain joins up again at the next candidate.

A wrong candidate can never corrupt output: it only costs a serial decode
of its segment.  At worst (no candidate validates) the call is the serial
C++ engine.

Differences from the JAX module:
- ``device`` is explicit, CUDA by default; ``use_device=True`` without a
  card raises.  ``device="cpu"`` runs the decode kernel's plain version.
- ``use_device=None`` (the default) is the host-parallel engine, as the
  JAX module's default is; there is no environment switch.  The card
  route is taken by name: ``use_device=True``, or
  ``batch_inflate(backend="device")`` for a stream past the lane limit.
- The body goes up once, from page-locked memory on a side stream, and
  the finds and the decode read it there; exactly the occupied token rows
  come back (``session.fetch_tokens``).
- The JAX module's quiet reroutes of ``use_device=True`` show: too few
  segments or candidates leave the serial stitch, ``stats_out["route"]``
  is ``"device"``, ``"host_parallel"`` or ``"serial"``, and ``metrics``
  counts ``large_device_lanes``, ``large_device_lanes_valid`` and, for
  every call that named the device and ran no lane there,
  ``large_device_rerouted``; a body past the int32 bit cursors raises
  ``ValueError`` instead of taking the host engine.
- The finds of a call run in one launch of the block finder on the
  card (``ops/cuda/find_cu``) over the uploaded body, not from a pool of
  Python threads on the host; on the CPU, in one native call on the
  host's threads (``dt_find_block_starts``).
- The lanes after the head that the stitch could take before the output
  holds a whole window are decoded serially (``head_guard``): in the JAX
  module a corrupt distance there that reaches before the stream's first
  byte resolves against bytes the stream does not have, and comes back
  OK.
- The launch and the stitch are the chain path (``chain_lanes``,
  ``decode_chains``, ``stitch_chains``), which ``runtime/split.py`` runs a
  batch's long streams through as many chains of one launch.
- The stitch gets ``out[:cap_total]``: a caller buffer larger than the
  declared ``dst_capacity`` is filled up to the capacity only, and EFULL
  comes back past it.  (The JAX module hands its stitch the whole buffer.)
- A host engine that does not build raises; there is no Python engine to
  carry on with.
"""

from __future__ import annotations

import numpy as np
import torch

from defl_tpu_torch import metrics
from defl_tpu_torch.constants import (ZLIB_CM_DEFLATE, ZLIB_FLAG_FDICT,
                                      ZLIB_MAX_CINFO)
from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result
from defl_tpu_torch.ops.cuda import decode_cu, find_cu
from defl_tpu_torch.runtime import native, session

#: target compressed bytes per device lane (about one deflate block at
#: zlib level 6)
SEGMENT_BYTES = 24576
#: target compressed bytes per work unit of the host-parallel engine
#: (several deflate blocks, so that finding a boundary stays cheap beside
#: decoding the segment)
HOST_SEGMENT_BYTES = 393216
#: per-lane output capacity: a speculative segment whose output exceeds
#: this ends EFULL and is decoded serially by the stitch
SEGMENT_CAP = 1 << 19
WINDOW = 32768


def header_result(head: bytes) -> Result | None:
    """A zlib header's verdict on the host, as the decoders give it: None
    for a valid header without a preset dictionary, UNFINISHED for one cut
    short, ERR otherwise (a preset dictionary included: the split decode
    has none to give)."""
    if len(head) < 2:
        return Result.UNFINISHED
    cmf, flg = head[0], head[1]
    if ((cmf & 0xF) != ZLIB_CM_DEFLATE or (cmf >> 4) > ZLIB_MAX_CINFO
            or ((cmf << 8) | flg) % 31 != 0 or flg & ZLIB_FLAG_FDICT):
        return Result.ERR
    return None


def device_route_allowed(body_size: int) -> bool:
    """Whether the device split decode can take a compressed body.

    The decoder's shared-input mode addresses the body with int32 *bit*
    cursors, which bounds it to just under 256 MiB of compressed input
    (less a guard for a lane's lookahead).  ``use_device=True`` raises
    for a larger body; the host-parallel engine's cursors are int64."""
    return 8 * body_size < (1 << 31) - (1 << 22)


def find_lane_starts(body: np.ndarray, spans, seg_bits: int,
                     n_threads: int | None = None,
                     body_dev: torch.Tensor | None = None) -> list[list[int]]:
    """Each chain's lane starts, in bits of its own stream: ``spans[s]`` =
    (byte offset of the stream in ``body``, its bytes, the chain's head
    bit, the bit targets to find near).  A chain is its head, then the
    first block start the finder validates between each target and two
    segments past it, in increasing order (a find that sees none, or the
    one before's, adds no lane).  Every find of every chain reads its own
    stream only, and all run at once: where ``body_dev``, the body as
    ``upload_body`` gave it and ordered by ``wait_body``, lies on a CUDA
    device, in one launch of the block finder there
    (``find_cu.find_block_starts``); else in one native call on the host's
    threads over ``body`` (``dt_find_block_starts``).  ``metrics`` counts
    every find in ``lane_finds``, and those on the card also in
    ``lane_finds_card``."""
    owner, offs, lens, lo, hi = [], [], [], [], []
    for s, (off, n, _, targets) in enumerate(spans):
        for t in targets:
            owner.append(s)
            offs.append(off)
            lens.append(n)
            lo.append(t)
            hi.append(min(t + 2 * seg_bits, 8 * n))
    if body_dev is not None and body_dev.device.type == "cuda":
        hits = find_cu.find_block_starts(body_dev, offs, lens, lo, hi)
        metrics.inc("lane_finds_card", len(lo))
    else:
        hits = native.find_block_starts(native.load(), body, offs, lens, lo,
                                        hi, n_threads)
    metrics.inc("lane_finds", len(lo))
    chains = [[head] for _, _, head, _ in spans]
    for s, h in zip(owner, hits.tolist()):
        if h > chains[s][-1]:
            chains[s].append(h)
    return chains


def _find_candidates(body: np.ndarray, start_bit: int, n_seg: int,
                     seg_bits: int, n_threads: int = 4,
                     body_dev: torch.Tensor | None = None) -> list[int]:
    targets = [start_bit + k * seg_bits for k in range(1, n_seg)]
    return find_lane_starts(body, [(0, body.size, start_bit, targets)],
                            seg_bits, n_threads, body_dev)[0]


def host_body(total: int, dev: torch.device):
    """A host buffer for a body of ``total`` bytes with the decoder's zero
    words behind it, as (uint8 tensor, its ndarray view); the caller fills
    ``view[:total]``.  Page-locked for a card, so that its upload
    (``upload_body``) runs beside whatever the host does next."""
    size = -(-(total + 4 * decode_cu.PAD_WORDS) // 16) * 16
    host = torch.empty(size, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    view = host.numpy()
    view[total:] = 0
    return host, view


def upload_body(host: torch.Tensor, dev: torch.device):
    """``host_body``'s buffer as an int32 tensor on ``dev``, and the side
    stream its copy runs on (None on the CPU, where the decoder reads the
    buffer itself).  A launch that reads it waits first: ``wait_body``."""
    if dev.type == "cpu":
        return host.view(torch.int32), None
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        body_dev = host.to(dev, non_blocking=True)
    return body_dev.view(torch.int32), side


def wait_body(body_dev: torch.Tensor, side, dev: torch.device) -> None:
    """Orders the next launch after the body's upload on its side stream."""
    if side is not None:
        torch.cuda.current_stream(dev).wait_stream(side)
        body_dev.record_stream(torch.cuda.current_stream(dev))
        side.synchronize()


def inflate_large(data, flags=FLAG_ZLIB, dst_capacity=None,
                  chunk_steps: int | None = None,
                  use_device: bool | None = None,
                  stats_out: dict | None = None, seg_bytes: int | None = None,
                  n_threads: int | None = None, out=None, device="cuda"):
    """One huge stream -> (Result, bytes), or (Result, n_bytes) with ``out``.

    ``out`` (writable uint8 ndarray): caller-owned output buffer, ≙ the
    reference's ``infl_init(dst, dstlen)`` contract: the decode writes in
    place, returns the byte count, and never allocates or copies the
    output.  At most ``min(dst_capacity, out.size)`` bytes are written;
    EFULL is returned to the caller (grow-and-retry is the caller's job,
    ≙ infl_resize_output).

    Two speculative block-parallel engines share the find, validate and
    stitch design (module docstring):

    - ``use_device=True``: segments decode as lanes of the decode kernel
      on ``device`` over one body that lies there; the host stitches.
      Bodies at or above ~256 MiB compressed exceed the int32 bit cursors
      (``device_route_allowed``) and raise ``ValueError``.  A body of one
      or two segments, or one in which the finder sees no block start
      (stored or fixed blocks only), is decoded serially by the stitch,
      on the host; ``metrics`` counts such a call as
      ``large_device_rerouted``.
    - ``use_device=None`` (the default, as in the JAX module) and
      ``False``: the all-native parallel engine
      (``dt_inflate_large``): worker threads find boundaries and
      token-decode segments while the calling thread stitches behind
      them.  ``seg_bytes`` and ``n_threads`` are its segment size and
      worker count.

    stats_out (optional dict) receives ``route`` and per-stage seconds,
    each the length of its span ``defl.large.<stage>`` (``metrics.span``):
    ``parallel_s`` (host engine) or ``body_s`` (the page-locked body's
    allocation, fill and the upload's start), ``upload_s`` (the wait for
    the upload, which the finds and the decode read), ``find_s``,
    ``decode_s`` and ``fetch_s`` (spans ``defl.decode`` and ``defl.fetch``
    of ``decode_chains``), ``stitch_s`` with ``segments`` (of
    ``SEGMENT_BYTES``; under 3 the stream is too short to split and takes
    the serial stitch), ``lanes``, ``lanes_valid`` and ``tok_rows``
    (device engine).  Under FLAG_VERIFY_ADLER32 the trailer's check of an OK
    stream is span ``defl.large.verify``, on either engine (``_finish``)."""
    data = bytes(data)
    zf = bool(flags & FLAG_ZLIB)
    caller_out = out is not None
    empty = 0 if caller_out else b""
    start = 0
    dev = None
    if use_device:
        dev = session._pick_decoder(device)
    native.load()
    if zf:
        verdict = header_result(data[:2])
        if verdict is not None:
            return verdict, empty
        start = 2

    body = np.frombuffer(data, np.uint8)[start:]
    if caller_out:
        if not (isinstance(out, np.ndarray) and out.dtype == np.uint8
                and out.ndim == 1 and out.flags.c_contiguous
                and out.flags.writeable):
            raise ValueError("out must be a writable C-contiguous 1-D uint8 "
                             "array")
        grow = False
        cap_total = min(int(dst_capacity), out.size) \
            if dst_capacity is not None else out.size
    else:
        grow = dst_capacity is None
        cap_total = int(dst_capacity) if dst_capacity is not None \
            else max(16 * body.size, 1 << 20)

    st = stats_out if stats_out is not None else {}
    seg = SEGMENT_BYTES
    n_seg = max(1, body.size // seg)
    if use_device and not device_route_allowed(body.size):
        raise ValueError(
            f"inflate_large(use_device=True): a body of {body.size} bytes is "
            f"past the device decoder's int32 bit cursors (under "
            f"{((1 << 31) - (1 << 22)) // 8} bytes); pass use_device=None "
            f"or False for the host-parallel engine")

    metrics.inc("large_streams")
    if not use_device:
        st["route"] = "host_parallel"
        return _host_parallel(body, zf, flags, cap_total, grow, seg_bytes,
                              n_threads, st, out)

    st["segments"] = n_seg
    body_dev = side = None
    if n_seg > 2:
        # one upload of the shared body, read by the finds and the decode:
        # nothing per lane ships to the device
        with metrics.span("defl.large.body") as sp:
            host, view = host_body(body.size, dev)
            view[:body.size] = body
            body_dev, side = upload_body(host, dev)
        st["body_s"] = sp.s
        with metrics.span("defl.large.upload") as sp:
            wait_body(body_dev, side, dev)
        st["upload_s"] = sp.s

    with metrics.span("defl.large.find") as sp:
        cands = _find_candidates(body, 0, n_seg, 8 * seg,
                                 native._default_threads(), body_dev) \
            if n_seg > 1 else [0]
    st["find_s"] = sp.s

    lane_info = None
    st["route"] = "serial"
    if body_dev is not None and len(cands) > 2:
        st["route"] = "device"
        chains = [(0, body.size, cands, SEGMENT_CAP)]
        lane_info, got = decode_chains(body_dev, chains, chain_lanes(chains),
                                       chunk_steps, dev)
        st.update(got)
    else:
        metrics.inc("large_device_rerouted")
    del body_dev

    # Undeclared capacity has grow-on-EFULL semantics (≙ the oracle and
    # device_inflate): only the stitch depends on the output buffer, so a
    # high-ratio stream retries the stitch alone; the block find and the
    # device decode are reused.
    with metrics.span("defl.large.stitch") as sp:
        if lane_info is None:
            r, total, end_bit, buf, _ = stitch_grown(body, cands, None,
                                                     cap_total, grow, 1 << 40,
                                                     out)
        else:
            buf = out[:cap_total] if caller_out \
                else np.zeros(cap_total, np.uint8)
            [(r, total, end_bit, buf, _, valid, _)] = stitch_chains(
                body, chains, lane_info, [buf], grow, 1 << 40)
            # how many speculative lanes validated: the stitch span-decodes
            # any gap, so a broken device path only shows as serial speed
            st["lanes"], st["lanes_valid"] = len(cands), valid
            metrics.inc("large_device_lanes", len(cands))
            metrics.inc("large_device_lanes_valid", valid)
    st["stitch_s"] = sp.s
    return _finish(r, total, end_bit, body, buf, flags, zf, caller_out)


def _finish(r, total, end_bit, body, buf, flags, zf, caller_out):
    """The call's return value; with FLAG_VERIFY_ADLER32 an OK stream's
    trailer (4 big-endian bytes after the byte-aligned final block) is
    held against the output's checksum first."""
    if r is Result.OK and (flags & FLAG_VERIFY_ADLER32) and zf:
        tb = (end_bit + 7) // 8
        if tb + 4 > body.size:
            r = Result.UNFINISHED
        else:
            with metrics.span("defl.large.verify"):
                adler = native.native_adler32(buf[:total])
            if int.from_bytes(body[tb: tb + 4].tobytes(), "big") != adler:
                r = Result.ERR
    return (r, total) if caller_out else (r, buf[:total].tobytes())


def _host_parallel(body, zf, flags, cap_total, grow, seg_bytes, n_threads,
                   st, caller_buf=None):
    """All-native parallel engine: dt_inflate_large (find ‖ token-decode
    workers + stitcher on this thread).  Grow-on-EFULL retries reuse the
    decoded tokens: only the stitch runs again."""
    lib = native.load()
    with metrics.span("defl.large.parallel") as sp:
        state = None
        try:
            while True:
                out = caller_buf if caller_buf is not None \
                    else np.zeros(cap_total, np.uint8)
                r, total, end_bit, state = native.inflate_large_parallel(
                    lib, body, out[:cap_total],
                    seg_bytes=seg_bytes or HOST_SEGMENT_BYTES,
                    n_threads=n_threads, state=state)
                if r is Result.EFULL and grow and cap_total < (1 << 40):
                    cap_total *= 4
                    continue
                break
        finally:
            native.large_free(lib, state)
    st["parallel_s"] = sp.s
    return _finish(r, total, end_bit, body, out, flags, zf,
                   caller_buf is not None)


def stitch_grown(body, cands, lane_info, cap: int, grow: bool, limit: int,
                 out=None):
    """The chain stitched into ``cap`` bytes (of ``out`` when given, else
    of a new buffer).  With ``grow`` (no declared capacity, as the oracle
    and ``device_inflate`` grow) an EFULL output grows fourfold up to
    ``limit`` and the chain is stitched again: only the stitch depends on
    the output buffer.  Returns (Result, total, end bit, buffer, cap)."""
    while True:
        buf = out if out is not None else np.zeros(cap, np.uint8)
        r, total, end_bit = native.stitch(native.load(), body, cands,
                                         lane_info, buf[:cap])
        if r is Result.EFULL and grow and cap < limit:
            cap = min(4 * cap, limit)
            continue
        return r, total, end_bit, buf, cap


def lane_args(body_bytes: int, cands, byte_off: int = 0,
              cap: int = SEGMENT_CAP) -> dict:
    """``decode_tokens``' arguments for the split decode of a body of
    ``body_bytes`` at the candidate bit offsets ``cands``: every lane's
    cursors are positions in the whole stream, which lies ``byte_off``
    bytes into the body on the device (each lane's ``nbits`` is the
    stream's end there), and each lane's output stops at ``cap``."""
    M = len(cands)
    start = 8 * byte_off + np.asarray(cands, np.int64)
    end = np.concatenate([start[1:], [8 * (byte_off + body_bytes)]])
    # the step budget follows the LONGEST segment (a lane spends a step
    # only where it does one; a tail segment that is longer still spends
    # its budget and is decoded serially by the stitch)
    max_seg_bits = int((end - start).max())
    T = 16384
    while T < max_seg_bits // 5 + 8192:
        T *= 2
    # the lane at the stream's head has NO window before position 0: its
    # distance-too-far check must be the serial engines' (a corrupt
    # distance in the first 32 KiB is an error, not garbage); speculative
    # lanes reach the full window into the segment before them
    reach = np.full(M, WINDOW, np.int32)
    if cands[0] == 0:
        reach[0] = 0
    return dict(nbits=np.full(M, end[-1], np.int32),
                zflag=np.zeros(M, np.int32),
                cap=np.full(M, cap, np.int32), T=T,
                limit=end.astype(np.int32), start_bit=start.astype(np.int32),
                dict_reach=reach, in_base=(start // 8).astype(np.int32))


def seams(cands, lane_info) -> np.ndarray:
    """The lanes that validated: status OK and ended exactly on the next
    candidate, or in the final block.  The stitch takes such a lane's
    tokens where its walk reaches the lane's start; it decodes any other
    gap serially."""
    _, _, status, final, bit_end = lane_info
    nxt = np.append(np.asarray(cands[1:], np.int64), -1)
    return (status == 0) & ((final > 0) | (bit_end == nxt))


def head_guard(cands, lane_info, body):
    """``lane_info`` with the lanes after the head that the stitch could
    take before its output holds a whole window marked not OK, so that
    the stitch decodes them serially.

    A lane after the head decodes with the whole window before its start
    (``lane_args``), so a corrupt distance that reaches before the
    stream's first byte decodes OK there and would resolve against bytes
    the stream does not have; the serial decode meets it as the engines
    do.  Once the chain of validated lanes from the head has put out a
    window, no distance can reach before the stream, and every later lane
    stands.  Where that chain breaks first (a false block start among the
    first lanes), the head of the chain's stream ``body`` is decoded
    serially (``head_window_bit``) to the first block boundary after a
    whole window, and the lanes from there on stand; where that decode
    fails, every lane after the head is marked.  A chain whose head is not
    bit 0 is left as it is."""
    M = len(cands)
    if M < 2 or cands[0] != 0:
        return lane_info
    toks, dst_pos, status, final, bit_end = lane_info
    ok = np.logical_and.accumulate(seams(cands, lane_info)[:-1])
    out = np.cumsum(dst_pos[:-1].astype(np.int64))   # before lane k = 1..
    whole = np.flatnonzero(ok & (out >= WINDOW))
    if whole.size:
        first = int(whole[0]) + 1
    else:
        first = int(np.searchsorted(cands, head_window_bit(body, cands)))
    if first <= 1:
        return lane_info
    status = status.copy()
    status[1:first] = 1
    return toks, dst_pos, status, final, bit_end


#: the output ``head_window_bit`` decodes into, at most: a window and a
#: lane's cap past it
_HEAD_CAP = WINDOW + SEGMENT_CAP


def head_window_bit(body, cands) -> int:
    """The first block boundary, among the points where the stitch's
    serial decode from bit 0 stops (the first at or past each lane start
    in turn), at which the stream's output holds a whole window; past the
    stream's end (no lane stands) where the decode ends, fails or puts
    out more than ``_HEAD_CAP`` bytes first."""
    lib = native.load()
    out = np.empty(_HEAD_CAP, np.uint8)
    bit = n = 0
    while n < WINDOW:
        k = int(np.searchsorted(cands, bit, side="right"))
        if k == len(cands):
            return 8 * body.size + 1
        r, n, bit = native.inflate_span(lib, body, bit, int(cands[k]), out, n)
        if r is not Result.OK or bit < 0:
            return 8 * body.size + 1
    return bit


def chain_lanes(chains) -> dict:
    """``decode_tokens``' arguments for many chains in one launch over one
    body: chain s = (byte offset of its stream in the body, the stream's
    bytes, its lane starts, its lanes' output cap), each as ``lane_args``
    gives it, under the largest step budget."""
    kws = [lane_args(n, cands, off, cap) for off, n, cands, cap in chains]
    kw = {k: np.concatenate([a[k] for a in kws]) for k in kws[0] if k != "T"}
    kw["T"] = max(a["T"] for a in kws)
    return kw


def decode_chains(body_dev, chains, kw, chunk_steps, dev):
    """One launch over every lane of ``chains`` (``kw`` from
    ``chain_lanes``) against the SHARED body ``body_dev``, in span
    ``defl.decode``; the occupied token rows and the lanes' totals come
    back in span ``defl.fetch``.  Returns (lane_info = (tokens u32 [M,
    rows], dst_pos, status, final, bit_end in bits of each chain's own
    stream), {``tok_rows``, ``decode_s``, ``fetch_s``})."""
    kw = dict(kw)
    nbits, zflag, cap = kw.pop("nbits"), kw.pop("zflag"), kw.pop("cap")
    with metrics.span("defl.decode") as decode:
        toks, st = decode_cu.decode_tokens(
            body_dev, nbits, zflag, cap, K=chunk_steps, dict_len=WINDOW,
            shared_input=True, device=dev, **kw)
    # only the occupied token rows cross, lane-major for the stitch
    with metrics.span("defl.fetch") as fetch:
        toks_nt = session.fetch_tokens([(toks, st["tok_rows"])])
        meta = torch.stack([st["dst_pos"], st["status"], st["final"],
                            st["bitpos"]]).cpu().numpy()
    dst_pos, status, final, bitpos = meta
    base = np.repeat([8 * c[0] for c in chains], [len(c[2]) for c in chains])
    return ((toks_nt, dst_pos, status, final, bitpos.astype(np.int64) - base),
            {"tok_rows": int(st["tok_rows"]), "decode_s": decode.s,
             "fetch_s": fetch.s})


def stitch_chains(body, chains, lane_info, outs, grow: bool, ceiling: int):
    """Every chain of one launch stitched into its own output ``outs[s]``
    (a whole uint8 array a chain), in one native call (``dt_stitch_many``
    on the host's threads: one chain a task, or, with fewer chains than
    threads, each long chain on every thread): valid lanes resolve, and
    gaps and the lanes ``head_guard`` marks decode.  ``metrics`` counts
    the chains in ``stitch_chains``, those stitched on every thread in
    ``stitch_chains_parallel``, and those that the parallel stitch gave
    back to the one-thread walk in ``stitch_chains_fallback``.
    With ``grow`` a chain that ends EFULL is stitched again into a grown
    output, up to ``ceiling`` bytes (``stitch_grown``).  Returns a tuple a
    chain: (Result, bytes out, end bit in its stream, its output buffer,
    the capacity it ended with, its valid lanes (``seams``, before the
    guard), whether the stitch took every lane's tokens)."""
    first = np.cumsum([0] + [len(c[2]) for c in chains])
    own = [tuple(a[f:f + len(c[2])] for a in lane_info)
           for c, f in zip(chains, first)]
    guarded = [head_guard(c[2], o, body[c[0]:c[0] + c[1]])
               for c, o in zip(chains, own)]
    rs, totals, ends, modes = native.stitch_many(
        native.load(), body, [c[0] for c in chains], [c[1] for c in chains],
        first[:-1], [len(c[2]) for c in chains],
        np.concatenate([c[2] for c in chains]),
        (*lane_info[:2], np.concatenate([g[2] for g in guarded]),
         *lane_info[3:]), outs, n_threads=native._default_threads())
    metrics.inc("stitch_chains", len(chains))
    metrics.inc("stitch_chains_parallel",
                int((modes == native.STITCH_PARALLEL).sum()))
    metrics.inc("stitch_chains_fallback",
                int((modes == native.STITCH_FALLBACK).sum()))
    done = []
    for (off, n, cands, _), o, g, r, total, end, buf in zip(
            chains, own, guarded, rs, totals.tolist(), ends.tolist(), outs):
        cap = buf.size
        if r is Result.EFULL and grow and cap < ceiling:
            r, total, end, buf, cap = stitch_grown(
                body[off:off + n], cands, g, min(4 * cap, ceiling), True,
                ceiling)
        done.append((r, total, end, buf, cap, int(seams(cands, o).sum()),
                     bool(seams(cands, g).all())))
    return done
