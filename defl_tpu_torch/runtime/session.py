"""Batch codec sessions: pack -> decode_tokens -> resolve (host or device),
and the hybrid encode: host fields -> bit-pack on the device -> compact.

Counterpart of ``defl_tpu/runtime/session.py``.
Each lane carries its own status, so a malformed stream never poisons
its batch; lanes that exhaust the device step budget (adversarial floods
of empty blocks) are retried on the host engine.

Differences from the JAX session:
- ``device`` is explicit: CUDA by default, which raises without a card;
  the CPU (the kernel's plain twin) runs only when asked for.
- The caller picks pass 2: ``resolve="host"`` (the C++ resolver, the
  default) or ``resolve="device"`` (ops/resolve.py, with the trailer
  check by the adler32 kernel).  A host engine that does not build raises
  instead of switching resolvers.
- ``backend="auto"`` decides by the batch alone; a batch it sends to the
  device raises when ``device`` is CUDA and there is no card.
- No N/W padding to shape buckets: they exist to bound XLA recompiles.
  Capacity keeps its bucket so that T = step_budget(C) equals JAX's.
- ``device_deflate`` takes a field buffer of its own for every call
  (page-locked, from PyTorch's caching host allocator), so concurrent
  calls never share one; its scan pack is the closed form of
  ``ops/huffman_pack.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result
from defl_tpu_torch import metrics
from defl_tpu_torch.core.oracle import inflate_oracle
from defl_tpu_torch.ops import huffman_pack
from defl_tpu_torch.ops import inflate_batch as ib
from defl_tpu_torch.ops.checksums import adler32_batch
from defl_tpu_torch.ops.cuda import checksums_cu, decode_cu
from defl_tpu_torch.ops.resolve import resolve_tokens
from defl_tpu_torch.runtime import native
from defl_tpu_torch.runtime.pack import (MAX_STREAM_BYTES, joined,
                                         pack_dictionary, pack_streams,
                                         stream_caps, stream_length)


def _bucket(x: int) -> int:
    """Round a capacity up to a power-of-two bucket (>= 1024), as the JAX
    session does, so both packages give a batch the same step budget."""
    b = 1024
    while b < x:
        b *= 2
    return b


def _pick_decoder(device) -> torch.device:
    """The device the decode runs on.

    The port has one decoder, ``decode_cu.decode_tokens``: the kernel or
    its twin is chosen by where the tensors lie.  What is left to pick is
    the device: CUDA by default, which raises when there is no card; the
    CPU only when the caller names it.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_inflate: CUDA requested but "
                           "torch.cuda.is_available() is False (pass "
                           "device='cpu' to run the plain twin)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def fetch_tokens(parts) -> np.ndarray:
    """Token parts [(tokbuf, tok_rows), ...] -> uint32 [N, rows] on the
    host, lane-major as the resolver wants it.  Exactly the occupied rows
    cross; the transpose runs on the card, and the copy lands in a pinned
    buffer of this call's own.  The buffer comes from PyTorch's caching
    host allocator, so later batches reuse its pages, and the returned
    array keeps it alive until the resolver is done with it."""
    toks = [t[:rows] for t, rows in parts]
    toks = toks[0] if len(toks) == 1 else torch.cat(toks, 0)
    nt = toks.t().contiguous()
    metrics.inc("token_fetch_bytes", nt.numel() * 4)
    if nt.device.type == "cpu":
        return nt.numpy().view(np.uint32)
    host = torch.empty(nt.shape, dtype=torch.int32, pin_memory=True)
    host.copy_(nt)
    return host.numpy().view(np.uint32)


def device_inflate(streams, flags=FLAG_ZLIB, dictionary=None,
                   dst_capacities=None, chunk_steps: int | None = None,
                   resolve: str = "host", device="cuda"):
    """Batched device decode.  Returns (results, outputs, stats dict);
    the stats hold each lane's device ``status``, ``dst_pos`` and
    ``bitpos`` (before the host retry) and the lanes retried on the host.

    Pass 1 (bitstream -> tokens) runs on ``device``.  Pass 2:
    ``resolve="host"`` ships the occupied token rows to the multithreaded
    C++ resolver; ``resolve="device"`` resolves on ``device``
    (ops/resolve.py), so the tokens never leave it, and with
    FLAG_VERIFY_ADLER32 the zlib trailers are checked against checksums
    computed there too (ops/checksums.py): only the resolved bytes and
    4 bytes per lane come back.

    With ``resolve="host"`` and no dictionary, a batch that holds a long
    stream (a body of three ``split.SEGMENT_BYTES`` or more) is split at
    speculated block starts into lanes of one launch and stitched on the
    host (runtime/split.py); its stats mean the same, with the stitch's
    status, bytes and end bit for each stream and, as ``host_fallbacks``,
    the streams the host decoded any part of serially, and add
    ``split_streams``, ``split_lanes`` and ``split_lanes_valid``.
    """
    if resolve not in ("host", "device"):
        raise ValueError(f"resolve must be 'host' or 'device', got "
                         f"{resolve!r}")
    dev = _pick_decoder(device)
    if resolve == "host":
        native.load()

    n_in = len(streams)
    if n_in == 0:
        return [], [], {}
    if resolve == "host" and dictionary is None:
        from defl_tpu_torch.runtime import split

        if split.wanted(streams, bool(flags & FLAG_ZLIB)):
            results, outputs, stats = split.inflate(
                streams, flags, dst_capacities, chunk_steps, dev)
            _count(n_in, outputs, stats)
            return results, outputs, stats

    # No declared capacity: a generous ratio is assumed; lanes that still
    # hit EFULL resume on the device with a grown budget below.
    caps = stream_caps(streams, dst_capacities)

    zf = flags & FLAG_ZLIB
    with metrics.span("defl.pack"):
        packed = pack_streams(streams, zf, caps)
    C = _bucket(max(caps))
    T = ib.step_budget(C)
    dict_len = len(bytes(dictionary)) if dictionary else 0
    launches0 = decode_cu.launches
    adler0 = checksums_cu.launches

    as_dev = lambda a: torch.from_numpy(a).to(dev)
    with metrics.span("defl.upload"):
        words = as_dev(packed.words.view(np.int32))
        nbits, zflag = as_dev(packed.nbits), as_dev(packed.zflag)
        cap_dev = as_dev(packed.dst_cap)
    kw = dict(K=chunk_steps, dict_len=dict_len,
              has_dict=dictionary is not None)
    with metrics.span("defl.decode"):
        tokens, st = decode_cu.decode_tokens(words, nbits, zflag, cap_dev,
                                             T=T, **kw)

    # Undeclared-capacity EFULL lanes resume on the device with a grown
    # budget (revive_carry + a second decode continuing from the saved
    # resume state — ≙ infl_resize_output-then-continue); token buffers
    # of successive calls concatenate along the step axis.
    tok_parts = [(tokens, st["tok_rows"])]
    if dst_capacities is None:
        caps_np = packed.dst_cap.astype(np.int64)
        for _ in range(4):  # 64 -> up to 16384x the compressed size
            efull = st["status"].cpu().numpy() == int(Result.EFULL)
            if not efull.any() or caps_np.max() >= (1 << 30):
                break
            caps_np = np.where(efull, np.minimum(caps_np * 4, 1 << 30),
                               caps_np)
            with metrics.span("defl.upload"):
                cap_dev = as_dev(caps_np.astype(np.int32))
            carry = ib.revive_carry(st, new_cap=cap_dev)
            C = _bucket(int(caps_np.max()))
            T = ib.step_budget(C)
            with metrics.span("defl.decode"):
                tokens, st = decode_cu.decode_tokens(
                    words, nbits, zflag, cap_dev, T=T, carry=carry, **kw)
            tok_parts.append((tokens, st["tok_rows"]))
        caps = [int(c) for c in caps_np[:n_in]]

    verify = bool(flags & FLAG_VERIFY_ADLER32) and bool(zf)
    adler_dev = None
    if resolve == "host":
        with metrics.span("defl.fetch"):
            toks_nt = fetch_tokens(tok_parts)
            meta = torch.stack([st["dst_pos"], st["status"],
                                st["bitpos"]]).cpu()
        dst_pos, status, bitpos = (m.numpy() for m in meta)
        with metrics.span("defl.resolve"):
            out_np = native.native_resolve_tokens(toks_nt, packed.words,
                                                  dst_pos, C, dictionary)
    else:
        toks = [t[:rows] for t, rows in tok_parts]
        with metrics.span("defl.resolve"):
            out = resolve_tokens(
                toks[0] if len(toks) == 1 else torch.cat(toks, 0), words,
                st["dst_pos"], C=C, dict_len=dict_len,
                dict_words=(pack_dictionary(dictionary)[0] if dictionary
                            else None))
            if verify:
                # trailers are checked against checksums taken on the
                # device: the outputs do not ship to the host for that
                adler_dev = adler32_batch(out, st["dst_pos"]).cpu().numpy()
        with metrics.span("defl.fetch"):
            meta = torch.stack([st["dst_pos"], st["status"],
                                st["bitpos"]]).cpu()
            out_np = out.cpu().numpy()
        dst_pos, status, bitpos = (m.numpy() for m in meta)
    in_bytes = packed.words.view(np.uint8)

    # Lanes needing a host-engine pass: step-budget exhaustion only
    # (undeclared-capacity EFULL lanes were resumed above; a lane still
    # EFULL here ran into the 1GB growth ceiling and keeps its status).
    fb_idx = [i for i in range(n_in) if int(status[i]) == ib.STATUS_RUNNING]
    fb = {}
    if fb_idx:
        fb = dict(zip(fb_idx, _host_fallback(
            [joined(streams[i]) for i in fb_idx],
            None if dst_capacities is None else [caps[i] for i in fb_idx],
            flags, dictionary)))

    results: list[Result] = []
    outputs: list[bytes] = []
    with metrics.span("defl.lane_bytes"):
        for i in range(n_in):
            if i in fb:
                r, o = fb[i]
                results.append(r)
                outputs.append(o)
                continue
            r = Result(int(status[i]))
            o = out_np[i, : int(dst_pos[i])].tobytes()
            if verify and r is Result.OK:
                # zlib trailer: 4 big-endian bytes after the byte-aligned
                # end of the final block (the FLAG_VERIFY_ADLER32 extension)
                tp = (int(bitpos[i]) + 7) // 8
                stored = int.from_bytes(in_bytes[i, tp: tp + 4], "big")
                if tp + 4 > packed.nbits[i] // 8:
                    r = Result.UNFINISHED
                elif stored != (int(adler_dev[i]) if adler_dev is not None
                                else native.native_adler32(o)):
                    r = Result.ERR
            results.append(r)
            outputs.append(o)
    launched = decode_cu.launches - launches0
    adler_launched = checksums_cu.launches - adler0
    stats = {"bitpos": bitpos, "dst_pos": dst_pos, "status": status,
             "T": T, "C": C,
             "host_fallbacks": fb_idx, "decode_chunk_launches": launched,
             "adler32_batch_launches": adler_launched}
    _count(n_in, outputs, stats)
    return results, outputs, stats


def _count(n_in, outputs, stats):
    """``device_inflate``'s counters for one call, whatever its route."""
    metrics.inc("device_inflate_batches")
    metrics.inc("device_inflate_lanes", n_in)
    metrics.inc("device_inflate_bytes_out",
                int(sum(len(o) for o in outputs)))
    metrics.inc("host_fallback_lanes", len(stats["host_fallbacks"]))
    metrics.inc("decode_chunk_launches", stats["decode_chunk_launches"])
    metrics.inc("adler32_batch_launches", stats["adler32_batch_launches"])


def _host_fallback(datas, caps, flags, dictionary):
    """Host-engine decode for lanes the device path couldn't finish.

    caps=None means grow-on-EFULL semantics.  The multithreaded C++ batch
    engine serves streams without a dictionary; dictionary streams go
    through the oracle (the native one-shot path rejects FDICT)."""
    if dictionary:
        return [inflate_oracle(bytes(d), flags,
                               None if caps is None else caps[k], dictionary)
                for k, d in enumerate(datas)]
    grow = caps is None
    cur = [max(64 * len(d), 4096) for d in datas] if grow else list(caps)
    results: list = [None] * len(datas)
    outputs: list = [b""] * len(datas)
    pending = list(range(len(datas)))
    while pending:
        rs, os_ = native.native_inflate_batch(
            [datas[i] for i in pending], [cur[i] for i in pending], flags)
        nxt = []
        for j, i in enumerate(pending):
            if grow and rs[j] is Result.EFULL and cur[i] < (1 << 31):
                cur[i] *= 4
                nxt.append(i)
            else:
                results[i], outputs[i] = rs[j], os_[j]
        pending = nxt
    return list(zip(results, outputs))


def batch_inflate(streams, flags=FLAG_ZLIB, backend="auto", dictionary=None,
                  dst_capacities=None, device="cuda"):
    """Public batch decode entry (see api.inflate_batch).

    Streams over ``MAX_STREAM_BYTES`` (the per-lane packing limit) take
    the speculative block-parallel path, ``runtime/large.py``, one by one:
    on ``device`` under ``backend="device"`` (a body past the device
    decoder's cursors then raises ``ValueError``), on the host-parallel
    engine under ``"auto"`` (``inflate_large``'s default); the rest batch
    as follows.  ``auto`` decides
    by the batch alone, as the JAX session does: 8 or more streams go to
    ``device``.  With ``device="cuda"`` and no card that raises; a caller
    who wants the host says ``backend="host"`` or ``device="cpu"``.
    """
    n = len(streams)
    caps = [None] * n if dst_capacities is None else \
        stream_caps(streams, dst_capacities)
    big = [i for i, s in enumerate(streams)
           if stream_length(s) > MAX_STREAM_BYTES]
    if big and backend in ("auto", "device") and not dictionary:
        from defl_tpu_torch.runtime.large import inflate_large

        big_set = set(big)
        small_idx = [i for i in range(n) if i not in big_set]
        s_res, s_out = batch_inflate(
            [streams[i] for i in small_idx], flags, backend, dictionary,
            None if dst_capacities is None else [caps[i] for i in small_idx],
            device) if small_idx else ([], [])
        results = [None] * n
        outputs = [b""] * n
        for j, i in enumerate(small_idx):
            results[i], outputs[i] = s_res[j], s_out[j]
        for i in big:
            results[i], outputs[i] = inflate_large(
                joined(streams[i]), flags, caps[i],
                use_device=True if backend == "device" else None,
                device=device)
        return results, outputs

    use_device = backend == "device" or (
        backend == "auto" and n >= 8 and not big)
    if use_device:
        results, outputs, _ = device_inflate(
            streams, flags, dictionary, dst_capacities, device=device)
        return results, outputs

    results = []
    outputs = []
    for i, s in enumerate(streams):
        r, o = inflate_oracle(joined(s), flags, caps[i], dictionary)
        results.append(r)
        outputs.append(o)
    return results, outputs


def device_deflate(payloads, level=6, flags=FLAG_ZLIB, stats_out=None,
                   pack="scatter", device="cuda"):
    """Hybrid encode: the C++ host engine computes LZ77 tokens, Huffman
    trees and block layout as (value, nbits) fields; ``device``
    concatenates the fields lane-parallel (ops/huffman_pack.py).
    Byte-identical to the serial C++ encoder by construction (both consume
    the same put() sequence).  Returns list[bytes].

    pack="scatter" (default) assembles each lane's packed words on
    ``device`` and only those come back; pack="scan" (the JAX session's
    default) computes the lockstep reservoir's word slots (in closed form)
    and the host compactor gathers the used ones by the nbits schedule.
    The output is the same bytes; the scan fetches a slot for every field
    (9x the bytes of the packed words at 2048 x 64 KiB) and needs the
    compactor, and was the slower of the two wherever both were timed
    (PERF.md), so it is kept by name for parity and is not the default.

    stats_out (optional dict) receives the stage seconds ``fields_s``,
    ``upload_s``, ``pack_s``, ``fetch_s``, ``assemble_s`` (each the
    length of its span ``defl.deflate.<stage>``, ``metrics.span``) and
    ``device_fallbacks``: the lanes whose fields overflowed the field
    budget and went through the serial encoder instead.
    """
    if pack not in ("scan", "scatter"):
        raise ValueError(f"pack must be 'scan' or 'scatter', got {pack!r}")
    dev = _pick_decoder(device)
    on_card = dev.type == "cuda"
    payloads = [bytes(p) for p in payloads]
    st = stats_out if stats_out is not None else {}
    if not payloads:
        st["device_fallbacks"] = []
        return []

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def fetch(t):
        """A device tensor of u32 patterns -> uint32 ndarray on the host,
        through a page-locked buffer of this call's own."""
        if not on_card:
            return huffman_pack.to_u32(t)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host.numpy().view(np.uint32)

    with metrics.span("defl.deflate.fields") as sp:
        fields, n_fields, total_bits, adlers, results = \
            native.native_deflate_fields(payloads, level=level, pin=on_card)
    st["fields_s"] = sp.s

    with metrics.span("defl.deflate.upload") as sp:
        fields_dev = torch.from_numpy(fields.view(np.int32)).to(dev)
        nf_dev = torch.from_numpy(n_fields.astype(np.int32)).to(dev)
        sync()
    st["upload_s"] = sp.s

    with metrics.span("defl.deflate.pack") as sp:
        if pack == "scan":
            slots, final_lo, _ = huffman_pack.pack_fields_scan(fields_dev,
                                                               nf_dev)
        else:
            W = 1024
            while W * 32 < int(total_bits.max()) + 32:
                W *= 2
            words, _ = huffman_pack.pack_fields(fields_dev, nf_dev,
                                                n_words=W)
        sync()
    st["pack_s"] = sp.s

    with metrics.span("defl.deflate.fetch") as sp:
        if pack == "scan":
            slots_np, lo_np = fetch(slots), fetch(final_lo)
        else:
            wb = fetch(words)
    st["fetch_s"] = sp.s

    with metrics.span("defl.deflate.assemble") as sp:
        if pack == "scan":
            bodies = native.native_encode_compact(fields, slots_np, n_fields,
                                                  lo_np, total_bits)
        else:
            bodies = [wb[i].view(np.uint8)[: (int(total_bits[i]) + 7) // 8]
                      .tobytes() for i in range(len(payloads))]
        zf = bool(flags & FLAG_ZLIB)
        outs = []
        fallback = []
        for i in range(len(payloads)):
            if results[i] is not Result.OK:
                fallback.append(i)
                outs.append(b"")
            elif zf:
                outs.append(b"\x78\x01" + bodies[i]
                            + int(adlers[i]).to_bytes(4, "big"))
            else:
                outs.append(bodies[i])
        if fallback:  # field-budget overflow: serial encoder for those lanes
            rs, fb_outs = native.native_deflate_batch(
                [payloads[i] for i in fallback], level=level, flags=flags)
            bad = [i for i, r in zip(fallback, rs) if r is not Result.OK]
            if bad:
                raise RuntimeError(
                    f"serial encoder failed for lanes {bad[:5]}")
            for j, i in enumerate(fallback):
                outs[i] = fb_outs[j]
    st["assemble_s"] = sp.s
    st["device_fallbacks"] = fallback
    metrics.inc("device_deflate_lanes", len(payloads))
    metrics.inc("device_deflate_fallback_lanes", len(fallback))
    metrics.inc("deflate_bytes_in", int(sum(len(p) for p in payloads)))
    return outs


def batch_deflate(payloads, level=6, flags=FLAG_ZLIB, backend="auto",
                  device="cuda"):
    """Compress many payloads.

    backend: "host" is the multithreaded C++ engine; "device" is the
    hybrid of host fields and the bit-pack on ``device``
    (``device_deflate``); "auto" is the host engine, as in the JAX
    session: the hybrid's output is byte-identical, and whether it is
    faster on a given card is a measurement (PERF.md), not a default.
    ``device`` matters to backend="device" only."""
    if backend not in ("host", "device", "auto"):
        raise ValueError(f"backend must be 'host', 'device' or 'auto', got "
                         f"{backend!r}")
    if backend == "device":
        return device_deflate(payloads, level=level, flags=flags,
                              device=device)
    payloads = [bytes(p) for p in payloads]
    results, outs = native.native_deflate_batch(payloads, level=level,
                                                flags=flags)
    bad = [i for i, r in enumerate(results) if r is not Result.OK]
    if bad:
        # the engine's output bound did not hold for these: the reference
        # encoder has none
        from defl_tpu_torch.core.deflate_ref import deflate_oracle

        for i in bad:
            outs[i] = deflate_oracle(payloads[i], level=level, flags=flags)
    return outs
