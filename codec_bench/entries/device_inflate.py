"""``runtime.session.device_inflate``: one batch of zlib streams a call,
with the resolve on the host or on the card, Python ``bytes`` out.

params: ``dst_capacity``, ``resolve`` ("host" or "device") and ``flags``
(names of ``defl_tpu_torch.errors`` flags, OR-ed).
"""

from __future__ import annotations

from defl_tpu_torch import errors
from defl_tpu_torch.errors import Result
from defl_tpu_torch.runtime.session import device_inflate

from codec_bench.entries.calls import Call

KIND = "inflate"


def prepare(pool, params, device):
    return [Call(ids=[j], data=b.inputs,
                 bytes_in=sum(len(s) for s in b.streams))
            for j, b in enumerate(pool)]


def call(c, params, device, stages):
    flags = 0
    for name in params["flags"]:
        flags |= getattr(errors, name)
    res, outs, _ = device_inflate(c.data, flags=flags,
                                  dst_capacities=int(params["dst_capacity"]),
                                  resolve=params["resolve"], device=device)
    return res, outs


def account(c, result):
    res, outs = result
    return (len(res), sum(r is not Result.OK for r in res),
            sum(len(o) for o in outs))


def lanes(c, result):
    res, outs = result
    return [(c.ids[0], [r is Result.OK for r in res], outs)]
