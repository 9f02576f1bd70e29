"""User-facing batch entry of the port (counterpart of ``defl_tpu.api``).

Only ``inflate_batch`` is ported so far; the one-shot and streaming API
of ``defl_tpu.api`` runs on the host engines.
"""

from __future__ import annotations

from defl_tpu_torch.errors import FLAG_ZLIB


def inflate_batch(streams, flags: int = FLAG_ZLIB, backend: str = "auto",
                  dictionary: bytes | None = None, dst_capacities=None,
                  device="cuda"):
    """Decode many independent streams.

    backend:
      - "host":   per-stream host engine
      - "device": batched lockstep decode on ``device`` (CUDA by default,
                  which raises without a card; "cpu" runs the plain twin)
      - "auto":   decided by the batch alone: 8 or more streams, none
                  over the per-lane packing limit, take the device (and
                  raise like "device" when ``device`` is CUDA and there
                  is no card); smaller batches take the host

    Returns (results, outputs): a list of Result and a list of bytes.
    """
    from defl_tpu_torch.runtime.session import batch_inflate

    return batch_inflate(streams, flags=flags, backend=backend,
                         dictionary=dictionary, dst_capacities=dst_capacities,
                         device=device)
