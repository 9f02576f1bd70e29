"""``inflate_large(use_device=True)``: one whole zlib stream a call
through the card's split decode, into a caller buffer.

Each call hands the stream to ``inflate_large`` with a fresh zeroed
``np.zeros(dst_capacity)`` as ``out`` (at the archive's size fresh pages,
as ``np.empty`` would map), so output a call leaves unwritten never holds
an earlier call's bytes; the call's result holds the buffer.

params: ``dst_capacity`` (the buffer's size, the archive's) and ``flags``
(names of ``defl_tpu_torch.errors`` flags, OR-ed).
"""

from __future__ import annotations

import numpy as np

from defl_tpu_torch import errors, inflate_large
from defl_tpu_torch.errors import Result

from codec_bench.entries.calls import Call

KIND = "inflate"


def prepare(pool, params, device):
    return [Call(ids=[j], data=b.inputs[0], bytes_in=len(b.inputs[0]))
            for j, b in enumerate(pool)]


def call(c, params, device, stages):
    flags = 0
    for name in params["flags"]:
        flags |= getattr(errors, name)
    cap = int(params["dst_capacity"])
    buf = np.zeros(cap, np.uint8)
    r, n = inflate_large(c.data, flags=flags, dst_capacity=cap,
                         use_device=True, out=buf, device=device)
    return r, n, buf


def account(c, result):
    """(lanes, lanes not OK, bytes out): one lane a call."""
    r, n, _ = result
    return 1, int(r is not Result.OK), n


def lanes(c, result):
    r, n, buf = result
    return [(c.ids[0], [r is Result.OK], [buf[:n]])]
