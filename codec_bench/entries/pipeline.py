"""``runtime.pipeline.pipeline_inflate``: batches of zlib streams through
the decode on the card beside the host resolver, with the real token fetch
and the zero-copy ``[N, C]`` output.

params: ``batches_per_call`` (each a list object of its own, so that the
pipeline packs and uploads every one of them, rotating over the pool),
``dst_capacity`` and, optionally, ``n_threads`` (the host resolver's
threads; the program's default without it).
"""

from __future__ import annotations

from defl_tpu_torch.errors import Result
from defl_tpu_torch.runtime.pipeline import pipeline_inflate

from codec_bench.entries.calls import Call

KIND = "inflate"
_OK = int(Result.OK)


def prepare(pool, params, device):
    ids = [j % len(pool) for j in range(int(params["batches_per_call"]))]
    return [Call(ids=ids, data=[list(pool[i].inputs) for i in ids],
                 bytes_in=sum(len(s) for i in ids for s in pool[i].inputs))]


def call(c, params, device, stages):
    per_batch, _ = pipeline_inflate(c.data, int(params["dst_capacity"]),
                                    n_threads=params.get("n_threads"),
                                    device=device)
    return per_batch


def account(c, result):
    """(lanes, lanes not OK, bytes out)."""
    return (sum(len(s) for s, _, _ in result),
            sum(int((s != _OK).sum()) for s, _, _ in result),
            sum(int(d.sum()) for _, _, d in result))


def lanes(c, result):
    """[(pool batch, [ok], [output])] of every batch of the call."""
    return [(i, list(s == _OK), [o[k, : int(d[k])] for k in range(len(s))])
            for i, (s, o, d) in zip(c.ids, result)]
