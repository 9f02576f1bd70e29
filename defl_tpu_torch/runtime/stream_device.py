"""Incremental batched device decode with an explicit carry.

Counterpart of ``defl_tpu/runtime/stream_device.py``: the decoder carry
(ops.inflate_batch) is the ``unz__stream_t`` of the device path — bit
cursors, Huffman structures, block micro-state — and survives across
``feed()`` calls at byte granularity.

Each feed appends per-lane input, resumes the lockstep decode, resolves
the new tokens straight into the per-lane output accumulator, then
**rebases**: consumed whole bytes are dropped from the input buffers and
every bit cursor shifts down accordingly.  Per-feed cost therefore
depends on the feed size and the decoder's unconsumed backlog, not on
the session history.

EFULL works like the reference's resize-then-continue protocol:
``resize_output`` raises per-lane budgets and revives EFULL lanes through
their saved resume state.

Differences from the JAX session:
- ``device`` is explicit: CUDA by default, which raises without a card.
- The caller picks the resolver, ``resolve="host"`` (the C++ resolver,
  the default) or ``resolve="device"`` (ops/resolve.py with a per-lane
  prefix); the JAX class takes the device resolver only when its native
  library is missing.
- The input width is not padded to a bucket (that bounds XLA recompiles).
"""

from __future__ import annotations

import numpy as np
import torch

from defl_tpu_torch.errors import FLAG_ZLIB, Result
from defl_tpu_torch.ops import inflate_batch as ib
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.ops.resolve import resolve_tokens
from defl_tpu_torch.runtime import native
from defl_tpu_torch.runtime.pack import MAX_STREAM_BYTES
from defl_tpu_torch.runtime.session import _pick_decoder

#: back-reference reach: the DEFLATE window (RFC 1951 max distance)
_WINDOW = 32768


class DeviceInflateSession:
    def __init__(self, n_lanes: int, dst_capacity: int,
                 flags: int = FLAG_ZLIB, dictionary: bytes | None = None,
                 chunk_steps: int = 128, feed_step_budget: int = 8192,
                 resolve: str = "host", device="cuda"):
        if resolve not in ("host", "device"):
            raise ValueError(f"resolve must be 'host' or 'device', got "
                             f"{resolve!r}")
        self.device = _pick_decoder(device)
        self.resolve = resolve
        if resolve == "host":
            native.load()
        self.n = n_lanes
        self.flags = flags
        self.dictionary = bytes(dictionary) if dictionary else None
        self.chunk_steps = chunk_steps
        self.feed_step_budget = feed_step_budget
        self.caps = np.full(n_lanes, int(dst_capacity), np.int32)
        self.bufs = [bytearray() for _ in range(n_lanes)]  # unconsumed only
        self.carry = None
        self.consumed = np.zeros(n_lanes, np.int64)  # rebased-away bytes
        self.dst_pos = np.zeros(n_lanes, np.int64)   # absolute output pos
        self.out = np.zeros((n_lanes, int(dst_capacity)), np.uint8)

    # -- input ---------------------------------------------------------------
    def feed(self, new_data) -> list[Result]:
        """Append per-lane compressed chunks (None/b'' = no new data for
        that lane), run the decoder as far as it can go, resolve the new
        tokens into the output accumulator, and rebase consumed input."""
        for i, d in enumerate(new_data):
            if d:
                if len(self.bufs[i]) + len(d) > MAX_STREAM_BYTES:
                    raise ValueError(
                        f"lane {i}: unconsumed backlog would exceed "
                        f"{MAX_STREAM_BYTES} bytes — drain the lane "
                        f"(resize_output on EFULL) before feeding more")
                self.bufs[i] += bytes(d)

        w_bytes = max(8, max(len(b) for b in self.bufs))
        words = np.zeros((self.n, (w_bytes + 3) // 4 + 1), np.uint32)
        in_bytes = words.view(np.uint8)
        nbits = np.zeros(self.n, np.int32)
        for i, b in enumerate(self.bufs):
            in_bytes[i, : len(b)] = np.frombuffer(b, np.uint8)
            nbits[i] = 8 * len(b)

        dict_len = len(self.dictionary) if self.dictionary else 0
        carry = None
        if self.carry is not None:
            carry = ib.revive_carry(self.carry)

        dev = self.device
        words_dev = torch.from_numpy(words.view(np.int32)).to(dev)
        tokens, carry = decode_cu.decode_tokens(
            words_dev, torch.from_numpy(nbits).to(dev),
            torch.full((self.n,), self.flags & FLAG_ZLIB, dtype=torch.int32,
                       device=dev),
            torch.from_numpy(self.caps).to(dev),
            T=self.feed_step_budget, K=self.chunk_steps,
            dict_len=dict_len, has_dict=self.dictionary is not None,
            carry=carry)

        meta = torch.stack([carry["bitpos"], carry["dst_pos"]]).cpu().numpy()
        bitpos = meta[0].astype(np.int64)
        new_dst = meta[1].astype(np.int64)
        self._resolve_feed(tokens[: carry["tok_rows"]], words, words_dev,
                           new_dst)

        # rebase: drop consumed whole bytes, keep the partial byte
        drop = bitpos >> 3
        for i in range(self.n):
            if drop[i]:
                del self.bufs[i][: int(drop[i])]
        self.consumed += drop
        self.dst_pos = new_dst
        carry = dict(carry)
        carry["bitpos"] = carry["bitpos"] & 7
        self.carry = carry
        return self.statuses()

    # -- incremental resolve -------------------------------------------------
    def _resolve_feed(self, tokens, words, words_dev, new_dst):
        """Resolve this feed's tokens into self.out[prev:new) per lane.
        Back-references may reach up to 32KB into the already-resolved
        output (and the preset dictionary below that)."""
        if not np.any(new_dst > self.dst_pos):
            return
        C = self.out.shape[1]

        if self.resolve == "host":
            toks_nt = tokens.T.contiguous().cpu().numpy().view(np.uint32)
            native.native_resolve_tokens(
                toks_nt, words, new_dst.astype(np.int32), C,
                self.dictionary, out=self.out,
                dst_start=self.dst_pos.astype(np.int32))
            return

        # device resolve: per-lane window prefix = last D bytes of
        # (dictionary ⊕ resolved output), right-aligned
        dict_len = len(self.dictionary) if self.dictionary else 0
        D = min(_WINDOW, C + dict_len)
        prefix = np.zeros((self.n, D), np.uint8)
        for i in range(self.n):
            hist = (self.dictionary or b"") + \
                self.out[i, : int(self.dst_pos[i])].tobytes()
            tail = hist[-D:] if len(hist) > D else hist
            if tail:
                prefix[i, D - len(tail):] = np.frombuffer(tail, np.uint8)
        feed_len = (new_dst - self.dst_pos).astype(np.int32)
        val = resolve_tokens(
            tokens, words_dev, torch.from_numpy(feed_len).to(self.device),
            C=C, prefix=torch.from_numpy(prefix).to(self.device)).cpu().numpy()
        for i in range(self.n):
            lo, hi = int(self.dst_pos[i]), int(new_dst[i])
            if hi > lo:
                self.out[i, lo:hi] = val[i, : hi - lo]

    def resize_output(self, new_capacity) -> None:
        """Raise per-lane output budgets and revive EFULL lanes."""
        self.caps = (np.full(self.n, int(new_capacity), np.int32)
                     if np.isscalar(new_capacity)
                     else np.asarray(new_capacity, np.int32))
        cap = int(self.caps.max())
        if cap > self.out.shape[1]:
            self.out = np.pad(self.out, ((0, 0), (0, cap - self.out.shape[1])))
        if self.carry is not None:
            self.carry = ib.revive_carry(
                self.carry,
                new_cap=torch.from_numpy(self.caps).to(self.device))

    # -- results -------------------------------------------------------------
    def statuses(self) -> list[Result]:
        s = self.carry["status"].cpu().numpy()
        return [Result(int(v)) if int(v) != ib.STATUS_RUNNING
                else Result.UNFINISHED for v in s]

    def input_pos(self, lane: int) -> int:
        """Compressed bytes consumed so far, counting a partially-consumed
        final byte (≙ infl_input_pos of the reference)."""
        bp = int(self.carry["bitpos"][lane]) if self.carry else 0
        return int(self.consumed[lane]) + (bp + 7) // 8

    def outputs(self):
        """(statuses, list[bytes]) — everything decoded so far."""
        return self.statuses(), [
            self.out[i, : int(self.dst_pos[i])].tobytes()
            for i in range(self.n)]
