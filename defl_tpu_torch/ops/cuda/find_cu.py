"""The block finder's kernel wrapper and its plain PyTorch version.

The split decode (``runtime/large.py``, ``runtime/split.py``) cuts a
stream at speculated block starts: the first bit in a window of the stream
at which a dynamic block's header validates.  ``find_block_starts`` runs
many such finds at once: on a CUDA body it launches the kernel
``csrc/find_starts.cu`` (one launch, one block a find), counted in
``launches``; on a CPU body it runs ``find_block_starts_ref``.  Either
gives, find for find, the bit the host finder gives
(``runtime/native.find_block_starts``, ``find_block_start_impl`` in
``csrc/defl_host.cc``), or -1.  ``checked=True`` launches the kernel's
checked build (``build.load(checked=True)``), counted in
``checked_launches``: a read outside a find's own stream raises
``build.KernelFault``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from defl_tpu_torch.runtime import native

#: the host finder stays this many bits clear of a stream's end
TAIL_BITS = 144
#: a code-length symbol is read only while this many bits are left
SYMBOL_BITS = 14
#: the order of the code-length code's lengths in a header (RFC 1951 3.2.7)
CL_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
#: the thread of a find's block whose first read an injection moves: the
#: one that reads the window's start
INJECT_SLOT = 0

#: launches of the CUDA kernel since import (or since a caller reset it)
launches = 0
#: launches of the checked build (``checked=True``)
checked_launches = 0
_count_lock = threading.Lock()


def _body_bytes(body: torch.Tensor) -> torch.Tensor:
    """``body`` (1-D, contiguous, uint8 or int32) as its uint8 bytes."""
    if body.dim() != 1 or body.dtype not in (torch.uint8, torch.int32):
        raise TypeError(f"body must be a 1-D uint8 or int32 tensor, got "
                        f"{body.dtype} {tuple(body.shape)}")
    if not body.is_contiguous():
        raise ValueError("body must be contiguous")
    return body.view(torch.uint8)


def find_block_starts(body: torch.Tensor, offs, lens, lo, hi, *,
                      checked: bool = False, inject=None) -> torch.Tensor:
    """Find k: the first bit in ``[lo[k], hi[k])`` of the stream of
    ``lens[k]`` bytes at byte ``offs[k]`` of ``body`` at which a dynamic
    block's header validates, in bits of that stream, or -1; nothing
    outside the stream is read.  Returns int64 [n] on the host.

    ``body``: 1-D uint8 or int32 (the bytes the streams lie in).  On a CUDA
    device the kernel runs on the current stream, and the copy of the hits
    to the host is the call's one sync; on the CPU the plain version runs.
    ``checked``: the kernel's checked build; ``inject=k`` moves the first
    read of find k's thread 0 out of its stream (a checked launch; find k
    must have a window that is not empty).
    """
    data = _body_bytes(body)
    args = np.stack(native.find_args(data.numel(), offs, lens, lo, hi))
    if body.device.type != "cuda":
        if checked or inject is not None:
            raise ValueError("the checked build runs on a CUDA device")
        return find_block_starts_ref(data, *args)
    n = args.shape[1]
    if n == 0:
        return torch.empty(0, dtype=torch.int64)
    if n >= 1 << 31:
        raise ValueError(f"{n} finds: a launch takes fewer than 2^31")
    from defl_tpu_torch.ops.cuda import build

    checked = bool(checked or inject is not None)
    lib = build.load(checked)
    dev = body.device
    args_dev = torch.from_numpy(args).to(dev)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    extra = ()
    if checked:
        fault = torch.zeros(build.FAULT_WORDS, dtype=torch.int64, device=dev)
        extra = (fault.data_ptr(), -1 if inject is None else int(inject))
    rc = lib.find_starts_launch(
        data.data_ptr(), args_dev.data_ptr(), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        *extra)
    if rc != 0:
        raise RuntimeError(f"find_starts kernel launch failed: CUDA error "
                           f"{rc}")
    global launches, checked_launches
    with _count_lock:
        if checked:
            checked_launches += 1
        else:
            launches += 1
    if checked:
        build.raise_fault("find_starts", fault.tolist())
    return out.cpu()


def _windows(data: torch.Tensor) -> torch.Tensor:
    """int64 [len(data)]: bytes j .. j + 7 of a stream as a little-endian
    word at j (0 past the stream's end)."""
    n = data.numel()
    d = torch.cat([data.to(torch.int64), torch.zeros(8, dtype=torch.int64)])
    w = torch.zeros(n, dtype=torch.int64)
    for i in range(8):
        w |= d[i:i + n] << (8 * i)
    return w


def _at(w: torch.Tensor, base: torch.Tensor | int, bit: torch.Tensor,
        k: int) -> torch.Tensor:
    """The k <= 57 bits from stream bit ``bit``, least significant first,
    of streams whose windows (``_windows``) start at ``base`` in ``w``."""
    return (w[base + (bit >> 3)] >> (bit & 7)) & ((1 << k) - 1)


#: positions of a window the plain version filters a round: a find whose
#: header validates in its first chunk decodes no header of the others
CHUNK_BITS = 1 << 15


def _filtered(w: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Positions of [a, b) in a stream (its windows ``w``) that pass the
    kernel's masks: BTYPE 2, HLIT and HDIST <= 29, and a complete
    code-length code (its Kraft sum)."""
    p = torch.arange(a, b)
    v = _at(w, 0, p, 17)
    m = (((v >> 1) & 3) == 2) & (((v >> 4) & 15) != 15) \
        & (((v >> 9) & 15) != 15)
    p, v = p[m], v[m]
    hclen = 4 + ((v >> 13) & 15)
    h = _at(w, 0, p + 17, 57)
    kraft = torch.zeros_like(p)
    for q in range(19):
        cl = (h >> (3 * q)) & 7
        kraft += torch.where((q < hclen) & (cl > 0), 128 >> cl, 0)
    return p[kraft == 128]


def find_block_starts_ref(data: torch.Tensor, offs, lens, lo,
                          hi) -> torch.Tensor:
    """Plain PyTorch version of the kernel on CPU tensors: ``data`` uint8
    [B] (the body's bytes), the rest int64 [n] each.  Returns int64 [n].

    The finds walk their clamped windows together, a chunk of
    ``CHUNK_BITS`` positions a round: every position of the round is
    filtered at once with the kernel's masks, then the headers at every
    position that passes are decoded together, a symbol a step; a find
    takes its first position whose header validates, and leaves the walk
    then or at its window's end."""
    n = len(offs)
    out = torch.full((n,), -1, dtype=torch.int64)
    streams = {}    # (offset, length) -> the stream's windows, their base
    wins, todo, at = [], [], 0
    for k in range(n):
        off, ln = int(offs[k]), int(lens[k])
        a, b = max(int(lo[k]), 0), min(int(hi[k]), 8 * ln - TAIL_BITS)
        if b <= a:
            continue
        if (off, ln) not in streams:
            streams[off, ln] = _windows(data[off:off + ln]), at
            wins.append(streams[off, ln][0])
            at += ln
        todo.append((k, off, ln, a, b))
    if not todo:
        return out
    w_all = torch.cat(wins)
    while todo:
        base, end, pos, owner = [], [], [], []
        for k, off, ln, a, b in todo:
            w, wb = streams[off, ln]
            p = _filtered(w, a, min(a + CHUNK_BITS, b))
            base.append(torch.full_like(p, wb))
            end.append(torch.full_like(p, 8 * ln))
            pos.append(p)
            owner.append(torch.full_like(p, k))
        p = torch.cat(pos)
        ok = _headers_valid(w_all, torch.cat(base), torch.cat(end), p)
        for k, bit in zip(torch.cat(owner)[ok].tolist(), p[ok].tolist()):
            if out[k] < 0:      # a find's positions come in order
                out[k] = bit
        todo = [(k, off, ln, a + CHUNK_BITS, b)
                for k, off, ln, a, b in todo
                if out[k] < 0 and a + CHUNK_BITS < b]
    return out


def _headers_valid(w, base, end, p) -> torch.Tensor:
    """``validate_dyn_header`` at stream bits ``p`` of candidates whose
    streams' windows start at ``base`` in ``w`` and whose streams end at
    bit ``end``, all candidates a step together.  Returns bool [C]."""
    C = p.numel()
    rows = torch.arange(C)
    g = lambda bit, k: _at(w, base, bit, k)
    hlit = 257 + g(p + 3, 5)
    hdist = 1 + g(p + 8, 5)
    hclen = 4 + g(p + 13, 4)
    # the code-length code, canonical (defl_host.cc's MiniCanon)
    cl = torch.zeros((C, 19), dtype=torch.int64)
    for q in range(19):
        v = torch.where(q < hclen, g(p + 17 + 3 * q, 3), 0)
        cl[:, CL_ORDER[q]] = v
    count = torch.stack([(cl == v).sum(1) for v in range(8)], 1)
    first = torch.zeros((C, 8), dtype=torch.int64)
    offs = torch.zeros((C, 8), dtype=torch.int64)
    code = torch.zeros(C, dtype=torch.int64)
    idx = torch.zeros(C, dtype=torch.int64)
    left = torch.ones(C, dtype=torch.int64)
    alive = torch.ones(C, dtype=torch.bool)
    for ln in range(1, 8):
        left = 2 * left - count[:, ln]
        alive &= left >= 0
        first[:, ln] = code
        offs[:, ln] = idx
        idx = idx + count[:, ln]
        code = (code + count[:, ln]) << 1
    alive &= left == 0
    # symbols by length, then by value: a symbol's rank among its length's
    same = torch.nn.functional.one_hot(cl, 8).cumsum(1)
    rank = same.gather(2, cl[:, :, None])[:, :, 0] - 1
    slot = torch.where(cl > 0, offs.gather(1, cl) + rank, 19)
    syms = torch.zeros((C, 20), dtype=torch.int64)
    syms.scatter_(1, slot, torch.arange(19).expand(C, 19).clone())

    c = p + 17 + 3 * hclen
    total = hlit + hdist
    i = torch.zeros(C, dtype=torch.int64)
    prev = torch.zeros(C, dtype=torch.int64)
    eob = torch.zeros(C, dtype=torch.int64)
    cnt = torch.zeros((C, 16), dtype=torch.int64)
    dcnt = torch.zeros((C, 16), dtype=torch.int64)
    while True:
        run = alive & (i < total)
        if not run.any():
            break
        alive &= ~(run & (end - c < SYMBOL_BITS))   # cut by the stream's end
        run &= alive
        cc = torch.where(run, c, 0)
        peek = g(cc, 7)
        rev = torch.zeros_like(peek)
        for j in range(7):
            rev |= ((peek >> j) & 1) << (6 - j)
        sym = torch.full((C,), -1, dtype=torch.int64)
        used = torch.zeros(C, dtype=torch.int64)
        for ln in range(1, 8):
            cd = rev >> (7 - ln)
            hit = (sym < 0) & (cd >= first[:, ln]) \
                & (cd - first[:, ln] < count[:, ln])
            at = (offs[:, ln] + cd - first[:, ln]).clamp(0, 19)
            sym = torch.where(hit, syms[rows, at], sym)
            used = torch.where(hit, ln, used)
        alive &= ~(run & (sym < 0))
        run &= alive
        c = torch.where(run, c + used, c)
        eb = torch.where(sym == 16, 2, torch.where(sym == 17, 3, 7))
        extra = torch.where(run & (sym >= 16),
                            g(torch.where(run, c, 0), 7) & ((1 << eb) - 1), 0)
        c = torch.where(run & (sym >= 16), c + eb, c)
        rep = torch.where(sym < 16, 1,
                          torch.where(sym == 18, 11, 3) + extra)
        alive &= ~(run & (sym == 16) & (i == 0))
        alive &= ~(run & (sym >= 16) & (i + rep > total))
        run &= alive
        val = torch.where(sym < 16, sym, torch.where(sym == 16, prev, 0))
        prev = torch.where(run & (sym != 16), torch.where(sym < 16, sym, 0),
                           prev)
        lit = torch.where(i < hlit, torch.minimum(i + rep, hlit) - i, 0)
        v = val.clamp(0, 15)[:, None]
        cnt.scatter_add_(1, v, torch.where(run, lit, 0)[:, None])
        dcnt.scatter_add_(1, v, torch.where(run, rep - lit, 0)[:, None])
        eob = torch.where(run & (i <= 256) & (256 < i + rep), val, eob)
        i = torch.where(run, i + rep, i)
    alive &= eob != 0
    left = torch.ones(C, dtype=torch.int64)
    dleft = torch.ones(C, dtype=torch.int64)
    for ln in range(1, 16):
        left = 2 * left - cnt[:, ln]
        dleft = 2 * dleft - dcnt[:, ln]
        alive &= (left >= 0) & (dleft >= 0)
    return alive & (left == 0)
