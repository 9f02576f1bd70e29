"""Arbitrary-size single-stream inflate via speculative block-parallel decode.

Counterpart of ``defl_tpu/runtime/large.py``.  DEFLATE is bit-serial, so
one huge stream cannot be split into lanes directly; the answer is
speculation on block boundaries (rapidgzip, CODAG):

  1. The native block finder (``dt_find_block_start``) scans for dynamic-
     block headers at arbitrary bit offsets near evenly spaced byte
     targets (3-bit BTYPE filter, code-length Kraft filter, then a full
     table-free validation of the header).
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
- The body goes up once, from page-locked memory on a side stream, while
  the host finds the block starts; exactly the occupied token rows come
  back (``session.fetch_tokens``).
- The JAX module's quiet reroutes of ``use_device=True`` show: too few
  segments or candidates leave the serial stitch, ``stats_out["route"]``
  is ``"device"``, ``"host_parallel"`` or ``"serial"``, and ``metrics``
  counts ``large_device_lanes``, ``large_device_lanes_valid`` and, for
  every call that named the device and ran no lane there,
  ``large_device_rerouted``; a body past the int32 bit cursors raises
  ``ValueError`` instead of taking the host engine.
- The stitch gets ``out[:cap_total]``: a caller buffer larger than the
  declared ``dst_capacity`` is filled up to the capacity only, and EFULL
  comes back past it.  (The JAX module hands its stitch the whole buffer.)
- A host engine that does not build raises; there is no Python engine to
  carry on with.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from defl_tpu_torch import metrics
from defl_tpu_torch.constants import (ZLIB_CM_DEFLATE, ZLIB_FLAG_FDICT,
                                      ZLIB_MAX_CINFO)
from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result
from defl_tpu_torch.ops.cuda import decode_cu
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


def device_route_allowed(body_size: int) -> bool:
    """Whether the device split decode can take a compressed body.

    The decoder's shared-input mode addresses the body with int32 *bit*
    cursors, which bounds it to just under 256 MiB of compressed input
    (less a guard for a lane's lookahead).  ``use_device=True`` raises
    for a larger body; the host-parallel engine's cursors are int64."""
    return 8 * body_size < (1 << 31) - (1 << 22)


def _find_candidates(body: np.ndarray, start_bit: int, n_seg: int,
                     seg_bits: int, n_threads: int = 4) -> list[int]:
    lib = native.load()
    nbits = 8 * body.size

    def find(k):
        lo = start_bit + k * seg_bits
        return int(native.find_block_start(
            lib, body, lo, min(lo + 2 * seg_bits, nbits)))

    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        hits = list(ex.map(find, range(1, n_seg)))
    out = [start_bit]
    for h in hits:
        if h > out[-1]:
            out.append(h)
    return out


def _upload_body(body: np.ndarray, dev: torch.device):
    """The padded body as an int32 tensor on ``dev``, and the side stream
    its copy runs on (None on the CPU).  The copy leaves page-locked
    memory, so it runs beside whatever the host does next."""
    if dev.type == "cpu":
        return torch.from_numpy(decode_cu.pad_body(body)).view(torch.int32), \
            None
    size = -(-(body.size + 4 * decode_cu.PAD_WORDS) // 16) * 16
    host = torch.empty(size, dtype=torch.uint8, pin_memory=True)
    view = host.numpy()
    view[:body.size] = body
    view[body.size:] = 0
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        body_dev = host.to(dev, non_blocking=True)
    return body_dev.view(torch.int32), side


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

    stats_out (optional dict) receives ``route`` and per-stage seconds:
    ``parallel_s`` (host engine) or ``find_s``, ``upload_s`` (what was
    left of the body's upload after the find), ``decode_s``, ``fetch_s``,
    ``stitch_s`` with ``lanes``, ``lanes_valid`` and ``tok_rows`` (device
    engine)."""
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
        if len(data) < 2:
            return Result.UNFINISHED, empty
        cmf, flg = data[0], data[1]
        if ((cmf & 0xF) != ZLIB_CM_DEFLATE or (cmf >> 4) > ZLIB_MAX_CINFO
                or ((cmf << 8) | flg) % 31 != 0):
            return Result.ERR, empty
        if flg & ZLIB_FLAG_FDICT:
            return Result.ERR, empty  # preset dict on huge streams: host path
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
    metrics.inc("large_bytes_in", len(data))
    if not use_device:
        st["route"] = "host_parallel"
        return _host_parallel(body, zf, flags, cap_total, grow, seg_bytes,
                              n_threads, st, out)

    body_dev = side = None
    if n_seg > 2:
        # the upload of the shared body runs beside the block find below:
        # nothing per lane ships to the device
        body_dev, side = _upload_body(body, dev)

    t0 = time.perf_counter()
    cands = _find_candidates(body, 0, n_seg, 8 * seg,
                             native._default_threads()) \
        if n_seg > 1 else [0]
    st["find_s"] = time.perf_counter() - t0

    lane_info = None
    st["route"] = "serial"
    if body_dev is not None and len(cands) > 2:
        st["route"] = "device"
        t0 = time.perf_counter()
        if side is not None:
            torch.cuda.current_stream(dev).wait_stream(side)
            body_dev.record_stream(torch.cuda.current_stream(dev))
            side.synchronize()
        st["upload_s"] = time.perf_counter() - t0
        lane_info = _device_decode(body_dev, body.size, cands, chunk_steps,
                                   st)
        # how many speculative lanes validated (status OK and ended
        # exactly on the next candidate, or in the final block).  The
        # stitch span-decodes any gap, so a broken device path only shows
        # as serial speed: this count makes it visible and testable
        _, dst_pos, status, final, bit_end = lane_info
        nxt = np.concatenate([np.asarray(cands[1:], np.int64), [-1]])
        st["lanes_valid"] = int(((status == 0)
                                 & ((final > 0) | (bit_end == nxt))).sum())
        st["lanes"] = len(cands)
        metrics.inc("large_device_lanes", st["lanes"])
        metrics.inc("large_device_lanes_valid", st["lanes_valid"])
    else:
        metrics.inc("large_device_rerouted")
    del body_dev

    # Undeclared capacity has grow-on-EFULL semantics (≙ the oracle and
    # device_inflate): only the stitch depends on the output buffer, so a
    # high-ratio stream retries the stitch alone; the block find and the
    # device decode are reused.
    t0 = time.perf_counter()
    while True:
        buf = out if caller_out else np.zeros(cap_total, np.uint8)
        r, total, end_bit = _stitch(body, cands, lane_info, buf[:cap_total])
        if r is Result.EFULL and grow and cap_total < (1 << 40):
            cap_total *= 4
            continue
        break
    st["stitch_s"] = time.perf_counter() - t0
    return _finish(r, total, end_bit, body, buf, flags, zf, caller_out)


def _finish(r, total, end_bit, body, buf, flags, zf, caller_out):
    """The call's return value; with FLAG_VERIFY_ADLER32 an OK stream's
    trailer (4 big-endian bytes after the byte-aligned final block) is
    held against the output's checksum first."""
    if r is Result.OK and (flags & FLAG_VERIFY_ADLER32) and zf:
        tb = (end_bit + 7) // 8
        if tb + 4 > body.size:
            r = Result.UNFINISHED
        elif int.from_bytes(body[tb: tb + 4].tobytes(), "big") \
                != native.native_adler32(buf[:total]):
            r = Result.ERR
    return (r, total) if caller_out else (r, buf[:total].tobytes())


def _host_parallel(body, zf, flags, cap_total, grow, seg_bytes, n_threads,
                   st, caller_buf=None):
    """All-native parallel engine: dt_inflate_large (find ‖ token-decode
    workers + stitcher on this thread).  Grow-on-EFULL retries reuse the
    decoded tokens: only the stitch runs again."""
    lib = native.load()
    t0 = time.perf_counter()
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
    st["parallel_s"] = time.perf_counter() - t0
    return _finish(r, total, end_bit, body, out, flags, zf,
                   caller_buf is not None)


def lane_args(body_bytes: int, cands) -> dict:
    """``decode_tokens``' arguments for the split decode of a body of
    ``body_bytes`` at the candidate bit offsets ``cands``: every lane's
    cursors are positions in the whole stream."""
    M = len(cands)
    start = np.asarray(cands, np.int64)
    end = np.concatenate([start[1:], [8 * body_bytes]])
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
    return dict(nbits=np.full(M, 8 * body_bytes, np.int32),
                zflag=np.zeros(M, np.int32),
                cap=np.full(M, SEGMENT_CAP, np.int32), T=T,
                limit=end.astype(np.int32), start_bit=start.astype(np.int32),
                dict_reach=reach, in_base=(start // 8).astype(np.int32))


def _device_decode(body_dev, body_bytes, cands, chunk_steps, stats=None):
    """Decode every candidate segment as one lane against the SHARED body
    on the device (one upload, per-lane cursors into the whole stream).
    Returns (toks u32 [M, rows], dst_pos, status, final, bit_end)."""
    kw = lane_args(body_bytes, cands)
    nbits, zflag, cap = kw.pop("nbits"), kw.pop("zflag"), kw.pop("cap")
    t0 = time.perf_counter()
    toks, st = decode_cu.decode_tokens(
        body_dev, nbits, zflag, cap, K=chunk_steps, dict_len=WINDOW,
        shared_input=True, **kw)
    meta = torch.stack([st["dst_pos"], st["status"], st["final"],
                        st["bitpos"]]).cpu().numpy()
    if stats is not None:
        stats["decode_s"] = time.perf_counter() - t0
        stats["tok_rows"] = int(st["tok_rows"])
        t0 = time.perf_counter()
    # only the occupied token rows cross, lane-major for the stitch
    toks_nt = session.fetch_tokens([(toks, st["tok_rows"])])
    if stats is not None:
        stats["fetch_s"] = time.perf_counter() - t0
    dst_pos, status, final, bitpos = meta
    return toks_nt, dst_pos, status, final, bitpos.astype(np.int64)


def _stitch(body, cands, lane_info, out):
    """Stitch the speculative chain: resolve valid lanes, span-decode the
    gaps, in one native call (dt_stitch) over the whole chain.  Returns
    (Result, total_bytes, end_bit)."""
    return native.stitch(native.load(), body, cands, lane_info, out)
