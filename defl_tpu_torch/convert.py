"""Decoder carry and session conversion between the JAX package and the port.

A codec has no weights; what crosses between the two packages is the
resumable decoder carry (≙ the reference's ``unz__stream_t``).  With
these two functions a stream half-decoded by one package finishes in the
other, and the two token buffers concatenate along axis 0.  The two
session functions do the same for a whole ``DeviceInflateSession`` (its
carry, unconsumed input, output accumulator and positions), so a stream
begun by one package's session is finished by the other's.  Neither
imports the JAX package: a JAX session is read and written through its
attributes, which the two classes share.

- The port keeps the JAX carry's keys, minus the chunk input window
  (``win``, ``win_word``, ``rr``): its kernel reads the input directly.
- i32 fields stay int32; u32 fields (``cl_lo``, ``cl_hi``, ``lens_pk``,
  ``syms``) are int64 masked to 32 bits in the port (``ops/bitio.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from defl_tpu_torch.ops import inflate_batch as ib

_WINDOW_KEYS = ("win", "win_word", "rr")


def carry_from_jax(carry: dict, device) -> dict[str, torch.Tensor]:
    """A JAX ``decode_tokens`` carry (arrays, e.g. ``np.asarray`` of each
    value) -> the port's carry on ``device``."""
    out = {}
    for k in ib.SCAN_KEYS + ib.CHUNK_KEYS:
        a = np.asarray(carry[k])
        if k in ib.U32_KEYS:
            t = torch.from_numpy(a.astype(np.uint32).astype(np.int64))
        else:
            t = torch.from_numpy(a.astype(np.int32))
        out[k] = t.to(device)
    if "tok_rows" in carry:
        out["tok_rows"] = int(np.asarray(carry["tok_rows"]))
    return out


def carry_to_numpy(carry: dict) -> dict[str, np.ndarray]:
    """The port's carry -> NumPy arrays a JAX ``decode_tokens`` resumes
    from.  The window keys are refilled as the JAX decoder refills them on
    resume: ``win_word = -(10 * WIN)`` lies far outside every cursor and
    forces a window refill before the first step; ``win`` and ``rr`` are
    zeros."""
    out = {}
    for k in ib.SCAN_KEYS + ib.CHUNK_KEYS:
        a = carry[k].cpu().numpy()
        out[k] = a.astype(np.uint32) if k in ib.U32_KEYS else \
            a.astype(np.int32)
    N = out["status"].shape[0]
    out["win"] = np.zeros((N, ib.WIN), np.uint32)
    out["win_word"] = np.full((N,), -(10 * ib.WIN), np.int32)
    out["rr"] = np.zeros((N,), np.int32)
    if "tok_rows" in carry:
        out["tok_rows"] = np.int32(carry["tok_rows"])
    return out


def session_from_jax(src, *, resolve: str = "host", device="cuda"):
    """A ``defl_tpu`` ``DeviceInflateSession`` -> a port session on
    ``device`` that continues it: same lanes, budgets, unconsumed input,
    output so far and decoder carry."""
    from defl_tpu_torch.runtime.stream_device import DeviceInflateSession

    s = DeviceInflateSession(src.n, src.out.shape[1], src.flags,
                             src.dictionary, src.chunk_steps,
                             src.feed_step_budget, resolve=resolve,
                             device=device)
    s.caps = np.array(src.caps, np.int32)
    s.bufs = [bytearray(b) for b in src.bufs]
    s.consumed = np.array(src.consumed, np.int64)
    s.dst_pos = np.array(src.dst_pos, np.int64)
    s.out = np.array(src.out, np.uint8)
    if src.carry is not None:
        s.carry = carry_from_jax(src.carry, s.device)
    return s


def session_into_jax(sess, dst) -> None:
    """Copy a port session's state onto ``dst``, a ``defl_tpu``
    ``DeviceInflateSession`` the caller made with the same arguments; its
    carry arrives as NumPy arrays, which the JAX decoder takes."""
    dst.caps = np.array(sess.caps, np.int32)
    dst.bufs = [bytearray(b) for b in sess.bufs]
    dst.consumed = np.array(sess.consumed, np.int64)
    dst.dst_pos = np.array(sess.dst_pos, np.int64)
    dst.out = np.array(sess.out, np.uint8)
    dst.carry = None if sess.carry is None else carry_to_numpy(sess.carry)
