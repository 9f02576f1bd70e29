"""The adler32 kernel's wrapper.

Counterpart of ``defl_tpu/ops/pallas/checksums_pl.py``.
``adler32_batch_cuda`` launches the CUDA kernel ``csrc/adler32_batch.cu``
on CUDA tensors and counts each launch in ``launches``; it refuses
anything else.  The plain PyTorch version and the function that chooses
between the two by where the tensors lie are in ``ops/checksums.py``.
``checked=True`` launches the kernel's checked build (``build.load(
checked=True)``), counted in ``checked_launches``: a read outside a lane's
bytes or a store past N raises ``build.KernelFault``.
"""

from __future__ import annotations

import threading

import torch

#: the widest row the kernel's 64-bit per-thread sums hold (see the
#: overflow note in csrc/adler32_batch.cu); also the session's capacity
#: ceiling
MAX_ROW_BYTES = 1 << 30

#: launches of the CUDA kernel since import (or since a caller reset it);
#: shards on several cards launch from threads of their own, so the count
#: is raised under a lock
launches = 0
#: launches of the checked build (``checked=True``)
checked_launches = 0
_count_lock = threading.Lock()


def adler32_batch_cuda(data: torch.Tensor, lengths: torch.Tensor, *,
                       checked: bool = False,
                       inject=None) -> torch.Tensor:
    """data: uint8 [N, C] on a CUDA device, unit stride along a row (rows
    may be a slice of a wider buffer, at any alignment); lengths: int32
    [N] on the same device, clipped to [0, C] by the kernel.  Returns
    int32 [N] holding the u32 checksum bits ``(B << 16) | A``.

    Launches on the current stream of ``data``'s device and does not
    synchronise, unless ``checked``: the checked build syncs to read its
    fault record.  ``inject=("adler32", lane)`` makes that lane's first
    access leave its extent (a checked launch).
    """
    if data.device.type != "cuda":
        raise ValueError(f"adler32_batch_cuda takes CUDA tensors, data is "
                         f"on {data.device}")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise TypeError(f"data must be uint8 [N, C], got {data.dtype} "
                        f"{tuple(data.shape)}")
    N, C = data.shape
    if lengths.device != data.device:
        raise ValueError(f"lengths is on {lengths.device}, data on "
                         f"{data.device}")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (N,):
        raise TypeError(f"lengths must be int32 [{N}], got {lengths.dtype} "
                        f"{tuple(lengths.shape)}")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")
    if C > MAX_ROW_BYTES:
        raise ValueError(f"rows of {C} bytes exceed the kernel's bound "
                         f"{MAX_ROW_BYTES}")
    if C > 1 and data.stride(1) != 1:
        raise ValueError("data must have unit stride along a row")
    if N > 1 and data.stride(0) < 0:
        raise ValueError("data must have a non-negative row stride")
    out = torch.empty(N, dtype=torch.int32, device=data.device)
    if N == 0:
        return out
    from defl_tpu_torch.ops.cuda import build

    checked = bool(checked or inject)
    lib = build.load(checked)
    dev = data.device
    extra = ()
    if checked:
        site, lane = inject or ("adler32", -1)
        if site != "adler32":
            raise ValueError(f"the adler32 kernel has one site, 'adler32', "
                             f"not {site!r}")
        fault = torch.zeros(build.FAULT_WORDS, dtype=torch.int64, device=dev)
        extra = (fault.data_ptr(), int(lane))
    rc = lib.adler32_batch_launch(
        data.data_ptr(), data.stride(0) if N > 1 else C, N, C,
        lengths.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        *extra)
    if rc != 0:
        raise RuntimeError(f"adler32_batch kernel launch failed: CUDA error "
                           f"{rc}")
    global launches, checked_launches
    with _count_lock:
        if checked:
            checked_launches += 1
        else:
            launches += 1
    if checked:
        build.raise_fault("adler32_batch", fault.tolist())
    return out
