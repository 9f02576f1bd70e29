"""Batch codec sessions: pack -> decode_tokens -> resolve (host or device).

Counterpart of ``defl_tpu/runtime/session.py`` for the batched inflate.
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
"""

from __future__ import annotations

import numpy as np
import torch

from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result
from defl_tpu_torch import metrics
from defl_tpu_torch.core.oracle import inflate_oracle
from defl_tpu_torch.ops import inflate_batch as ib
from defl_tpu_torch.ops.checksums import adler32_batch
from defl_tpu_torch.ops.cuda import checksums_cu, decode_cu
from defl_tpu_torch.ops.resolve import resolve_tokens
from defl_tpu_torch.runtime import native
from defl_tpu_torch.runtime.pack import (MAX_STREAM_BYTES, pack_dictionary,
                                         pack_streams)


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
    """Batched device decode.  Returns (results, outputs, stats dict).

    Pass 1 (bitstream -> tokens) runs on ``device``.  Pass 2:
    ``resolve="host"`` ships the occupied token rows to the multithreaded
    C++ resolver; ``resolve="device"`` resolves on ``device``
    (ops/resolve.py), so the tokens never leave it, and with
    FLAG_VERIFY_ADLER32 the zlib trailers are checked against checksums
    computed there too (ops/checksums.py): only the resolved bytes and
    4 bytes per lane come back.
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

    if dst_capacities is None:
        # No declared capacity: assume a generous ratio; lanes that still
        # hit EFULL resume on the device with a grown budget below.
        caps = [min(64 * len(b) if isinstance(b, (bytes, bytearray)) else
                    64 * sum(len(c) for c in b), 1 << 26) or 64
                for b in streams]
    else:
        caps = ([int(dst_capacities)] * n_in
                if np.isscalar(dst_capacities) else
                [int(c) for c in dst_capacities])

    zf = flags & FLAG_ZLIB
    packed = pack_streams(streams, zf, caps)
    C = _bucket(max(caps))
    T = ib.step_budget(C)
    dict_len = len(bytes(dictionary)) if dictionary else 0
    launches0 = decode_cu.launches
    adler0 = checksums_cu.launches

    as_dev = lambda a: torch.from_numpy(a).to(dev)
    words = as_dev(packed.words.view(np.int32))
    nbits, zflag = as_dev(packed.nbits), as_dev(packed.zflag)
    kw = dict(K=chunk_steps, dict_len=dict_len,
              has_dict=dictionary is not None)
    tokens, st = decode_cu.decode_tokens(words, nbits, zflag,
                                         as_dev(packed.dst_cap), T=T, **kw)

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
            cap_dev = as_dev(caps_np.astype(np.int32))
            carry = ib.revive_carry(st, new_cap=cap_dev)
            C = _bucket(int(caps_np.max()))
            T = ib.step_budget(C)
            tokens, st = decode_cu.decode_tokens(words, nbits, zflag, cap_dev,
                                                 T=T, carry=carry, **kw)
            tok_parts.append((tokens, st["tok_rows"]))
        caps = [int(c) for c in caps_np[:n_in]]

    verify = bool(flags & FLAG_VERIFY_ADLER32) and bool(zf)
    adler_dev = None
    if resolve == "host":
        toks_nt = fetch_tokens(tok_parts)
        meta = torch.stack([st["dst_pos"], st["status"], st["bitpos"]]).cpu()
        dst_pos, status, bitpos = (m.numpy() for m in meta)
        out_np = native.native_resolve_tokens(toks_nt, packed.words, dst_pos,
                                              C, dictionary)
    else:
        toks = [t[:rows] for t, rows in tok_parts]
        out = resolve_tokens(
            toks[0] if len(toks) == 1 else torch.cat(toks, 0), words,
            st["dst_pos"], C=C, dict_len=dict_len,
            dict_words=pack_dictionary(dictionary)[0] if dictionary else None)
        if verify:
            # trailers are checked against checksums taken on the device:
            # the outputs do not ship to the host for that
            adler_dev = adler32_batch(out, st["dst_pos"]).cpu().numpy()
        meta = torch.stack([st["dst_pos"], st["status"], st["bitpos"]]).cpu()
        dst_pos, status, bitpos = (m.numpy() for m in meta)
        out_np = out.cpu().numpy()
    in_bytes = packed.words.view(np.uint8)

    # Lanes needing a host-engine pass: step-budget exhaustion only
    # (undeclared-capacity EFULL lanes were resumed above; a lane still
    # EFULL here ran into the 1GB growth ceiling and keeps its status).
    fb_idx = [i for i in range(n_in) if int(status[i]) == ib.STATUS_RUNNING]
    fb = {}
    if fb_idx:
        datas = [bytes(streams[i]) if isinstance(streams[i],
                                                 (bytes, bytearray))
                 else b"".join(bytes(c) for c in streams[i])
                 for i in fb_idx]
        fb = dict(zip(fb_idx, _host_fallback(
            datas, None if dst_capacities is None
            else [caps[i] for i in fb_idx], flags, dictionary)))

    results: list[Result] = []
    outputs: list[bytes] = []
    for i in range(n_in):
        if i in fb:
            r, o = fb[i]
            results.append(r)
            outputs.append(o)
            continue
        r = Result(int(status[i]))
        o = out_np[i, : int(dst_pos[i])].tobytes()
        if verify and r is Result.OK:
            # zlib trailer: 4 big-endian bytes after the byte-aligned end
            # of the final block (the FLAG_VERIFY_ADLER32 extension)
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
    stats = {"bitpos": bitpos, "dst_pos": dst_pos, "T": T, "C": C,
             "host_fallbacks": fb_idx, "decode_chunk_launches": launched,
             "adler32_batch_launches": adler_launched}
    metrics.inc("device_inflate_batches")
    metrics.inc("device_inflate_lanes", n_in)
    metrics.inc("device_inflate_bytes_out",
                int(sum(len(o) for o in outputs)))
    metrics.inc("host_fallback_lanes", len(fb_idx))
    metrics.inc("decode_chunk_launches", launched)
    metrics.inc("adler32_batch_launches", adler_launched)
    return results, outputs, stats


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

    ``auto`` decides by the batch alone, as the JAX session does: 8 or
    more streams, none over ``MAX_STREAM_BYTES``, go to ``device``.  With
    ``device="cuda"`` and no card that raises; a caller who wants the host
    says ``backend="host"`` or ``device="cpu"``.
    """
    n = len(streams)
    sizes = [len(s) if isinstance(s, (bytes, bytearray)) else
             sum(len(c) for c in s) for s in streams]
    big = any(sz > MAX_STREAM_BYTES for sz in sizes)
    if backend == "device" and big:
        raise NotImplementedError(
            f"streams over {MAX_STREAM_BYTES} bytes take runtime/large.py's "
            "device route, which is not ported yet")
    use_device = backend == "device" or (
        backend == "auto" and n >= 8 and not big)
    if use_device:
        results, outputs, _ = device_inflate(
            streams, flags, dictionary, dst_capacities, device=device)
        return results, outputs

    results = []
    outputs = []
    for i, s in enumerate(streams):
        data = s if isinstance(s, (bytes, bytearray)) else \
            b"".join(bytes(c) for c in s)
        cap = None
        if dst_capacities is not None:
            cap = int(dst_capacities) if np.isscalar(dst_capacities) \
                else int(dst_capacities[i])
        r, o = inflate_oracle(bytes(data), flags, cap, dictionary)
        results.append(r)
        outputs.append(o)
    return results, outputs
