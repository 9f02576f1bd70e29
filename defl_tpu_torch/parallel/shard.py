"""Sharded batch decode over a stream mesh.

Counterpart of ``defl_tpu/parallel/shard.py``.  The decode is
embarrassingly parallel along the stream axis: each local shard takes its
contiguous rows and runs the whole single-device path on its own device
(``session.device_inflate``: pack, one launch of the decode kernel, EFULL
resume, resolve, host retry of lanes that ran out of steps).  Cards of
one process overlap, one host thread per card; CPU shards run one after
another in the calling thread (the plain version is Python-bound:
threads would only trade the interpreter lock at every op).  Only three
things cross ranks:

  - the preset dictionary: rank 0's, broadcast to every rank,
  - reduced statistics (decoded bytes, lanes OK) by ``all_reduce``,
  - nothing else: each rank gets its own rows back, in submission order.

Differences from the JAX package:
- each shard resolves where the caller says, ``resolve="host"`` (the C++
  resolver, the default: about twice as fast per batch as the device
  resolver on an 8-core host) or ``resolve="device"`` (tokens stay on the
  card; with FLAG_VERIFY_ADLER32 the trailers are checked by the adler32
  kernel).  The JAX package resolves on the device inside ``shard_map``;
- no padding of the batch to a multiple of the shard count, no agreement
  of padded shapes across hosts and no per-shape compile cache: they
  exist to give XLA one compiled shape.  A shard's step budget follows
  its own largest capacity (the JAX package takes the batch's), and ranks
  may pass different row counts;
- a shard whose rows run out (fewer rows than shards) launches nothing.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch
import torch.distributed as dist

from defl_tpu_torch.errors import FLAG_ZLIB, Result
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.parallel import mesh as mesh_lib
from defl_tpu_torch.runtime import session


def _overlapped(devices) -> bool:
    """Whether the local shards decode in threads of their own: several
    shards, all on cards."""
    return len(devices) > 1 and all(d.type == "cuda" for d in devices)


class DistributedCodec:
    """Stream-parallel inflate over a mesh (default: every visible card).

    ``chunk_steps`` is the chunk length of the plain version (the CPU
    route); the kernel decodes each shard in one launch whatever it is.
    """

    def __init__(self, mesh=None, dictionary: bytes | None = None,
                 chunk_steps: int | None = None, resolve: str = "host"):
        if resolve not in ("host", "device"):
            raise ValueError(f"resolve must be 'host' or 'device', got "
                             f"{resolve!r}")
        self.mesh = mesh if mesh is not None else mesh_lib.make_stream_mesh()
        self.n_shards = self.mesh.size
        self.dictionary = bytes(dictionary) if dictionary else None
        self.chunk_steps = chunk_steps
        self.resolve = resolve

    def _shared_dictionary(self) -> bytes | None:
        """Rank 0's dictionary (its length, then its bytes), whatever this
        rank was constructed with; without a group, our own."""
        if not self.mesh.grouped:
            return self.dictionary
        dev = self.mesh.collective_device()
        mine = self.dictionary or b""
        n = torch.tensor([len(mine)], dtype=torch.int64, device=dev)
        n = int(mesh_lib.replicated(self.mesh, n).item())
        if n == 0:
            return None
        buf = torch.zeros(n, dtype=torch.uint8)
        if self.mesh.rank == 0:
            buf.copy_(torch.frombuffer(bytearray(mine), dtype=torch.uint8))
        buf = mesh_lib.replicated(self.mesh, buf.to(dev))
        return buf.cpu().numpy().tobytes()

    def _decode_shard(self, dev, streams, caps, flags, dictionary):
        if not streams:
            return [], [], None
        scope = torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()
        with scope:
            return session.device_inflate(
                streams, flags, dictionary, caps, self.chunk_steps,
                self.resolve, device=dev)

    def inflate(self, streams, flags=FLAG_ZLIB, dst_capacities=1 << 16):
        """Decode a batch sharded over the mesh.  Returns (results,
        outputs, stats).

        Single controller (no group, or a group of one rank): ``streams``
        is the whole batch and comes back whole, in submission order.
        Multi controller (every rank runs this same call): ``streams`` is
        this rank's rows of the host-major global batch
        (``multihost.local_stream_slice``), and the results and outputs
        are those rows only.

        stats: ``total_bytes`` (the decoded bytes of every lane, on every
        rank) and ``ok_lanes`` (lanes the device finished OK, before the
        host retry), both summed over the group; ``shards``, the shard
        count over all ranks; this rank's ``bitpos`` per lane,
        ``host_fallbacks`` (its row indices retried on the host) and
        ``decode_launches``; ``reduced_on``, the device the sums were
        reduced on (None without a group).  ``dst_capacities=None`` lets
        each shard grow the capacity of its EFULL lanes on its device.
        """
        n_in = len(streams)
        if dst_capacities is None:
            caps = None
        elif np.isscalar(dst_capacities):
            caps = [int(dst_capacities)] * n_in
        else:
            caps = [int(c) for c in dst_capacities]
            if len(caps) != n_in:
                raise ValueError(f"{len(caps)} capacities for {n_in} "
                                 f"streams")
        dictionary = self._shared_dictionary()
        parts = mesh_lib.stream_sharding(self.mesh, n_in)
        args = [(dev, list(streams[sl]), None if caps is None else caps[sl],
                 flags, dictionary) for dev, sl in parts]
        launches0 = decode_cu.launches
        if _overlapped(self.mesh.devices):
            with ThreadPoolExecutor(max_workers=len(args)) as pool:
                futures = [pool.submit(self._decode_shard, *a) for a in args]
                outs = [f.result() for f in futures]
        else:
            outs = [self._decode_shard(*a) for a in args]
        launched = decode_cu.launches - launches0

        results, outputs, bitpos, fallbacks = [], [], [], []
        total = ok = 0
        for (_, sl), (res, outs_k, st) in zip(parts, outs):
            results += res
            outputs += outs_k
            if st is None:
                continue
            bitpos.append(st["bitpos"])
            total += int(st["dst_pos"].astype(np.int64).sum())
            ok += int((st["status"] == int(Result.OK)).sum())
            fallbacks += [sl.start + i for i in st["host_fallbacks"]]
        reduced_on = None
        if self.mesh.grouped:
            dev = self.mesh.collective_device()
            sums = torch.tensor([total, ok], dtype=torch.int64, device=dev)
            dist.all_reduce(sums, op=dist.ReduceOp.SUM)
            total, ok = sums.tolist()
            reduced_on = str(dev)
        stats = {
            "total_bytes": total,
            "ok_lanes": ok,
            "bitpos": (np.concatenate(bitpos) if bitpos
                       else np.zeros(0, np.int32)),
            "shards": self.n_shards,
            "host_fallbacks": fallbacks,
            "decode_launches": launched,
            "reduced_on": reduced_on,
        }
        return results, outputs, stats
