"""``runtime.session.device_deflate``: one batch of payloads a call,
LZ77 and trees on the host, the bit-pack on the card, zlib streams out.

params: ``level``.  The call's stage seconds (``stats_out``) are summed
into the window's ``stages``.
"""

from __future__ import annotations

from defl_tpu_torch.runtime.session import device_deflate

from codec_bench.entries.calls import Call

KIND = "deflate"
STAGES = ("fields_s", "upload_s", "pack_s", "fetch_s", "assemble_s")


def prepare(pool, params, device):
    return [Call(ids=[j], data=b.raw, bytes_in=sum(len(p) for p in b.raw))
            for j, b in enumerate(pool)]


def call(c, params, device, stages):
    st = {}
    outs = device_deflate(c.data, level=int(params["level"]), stats_out=st,
                          device=device)
    for k in STAGES:
        stages[k] = stages.get(k, 0.0) + st[k]
    return outs


def account(c, result):
    """(lanes, lanes with no stream, bytes out)."""
    return len(result), sum(not o for o in result), sum(map(len, result))


def lanes(c, result):
    return [(c.ids[0], None, result)]
