"""``api.inflate_batch(streams, backend="device")``: one batch of zlib
streams (bytes, or lists of chunk payloads) a call, Python ``bytes`` out.
Its calls and results are ``device_inflate``'s (results, outputs).

params: ``dst_capacity``.
"""

from __future__ import annotations

from defl_tpu_torch.api import inflate_batch

from codec_bench.entries.device_inflate import account, lanes, prepare

KIND = "inflate"
__all__ = ["KIND", "prepare", "call", "account", "lanes"]


def call(c, params, device, stages):
    return inflate_batch(c.data, backend="device",
                         dst_capacities=int(params["dst_capacity"]),
                         device=device)
