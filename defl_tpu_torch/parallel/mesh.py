"""The stream mesh: which devices decode which rows of a batch.

Counterpart of ``defl_tpu/parallel/mesh.py``.  The batch axis ("streams")
is the unit of data parallelism: independent zlib streams shard over this
process's devices and over the ranks of a ``torch.distributed`` process
group, when one is initialised.  A mesh here is a plain layout: the local
devices, the axis names and sizes, and this process's rank in the group.

- ``make_stream_mesh`` is the 1-D mesh, ``("streams",)``.
- ``make_host_chip_mesh`` is the 2-D ``("hosts", "chips")`` layout: one
  row per rank, rank-major, so that each rank feeds its own rows.
- ``stream_sharding`` is the row range of each local shard: contiguous and
  host-major, the split that ``P(mesh.axis_names)`` gives in the JAX
  package.
- ``replicated`` broadcasts a tensor from rank 0 (the dictionary).

Devices default to every visible CUDA device (under a group of several
ranks, the rank's own card); without a card that raises: the CPU runs
only when the caller names it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

STREAM_AXIS = "streams"


class StreamMesh:
    """Shards of a stream batch: this process's ``devices`` times the
    ranks of the process group the mesh was made under.

    ``shape`` maps each axis name to its size over all ranks;
    ``grouped`` says whether collectives run (a group was initialised
    when the mesh was made, even a group of one rank).
    """

    def __init__(self, devices, axis_names, shape):
        self.devices = tuple(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.grouped = dist.is_available() and dist.is_initialized()
        self.world_size = dist.get_world_size() if self.grouped else 1
        self.rank = dist.get_rank() if self.grouped else 0
        if self.size != len(self.devices) * self.world_size:
            raise ValueError(f"mesh {self.shape} does not hold "
                             f"{len(self.devices)} devices x "
                             f"{self.world_size} ranks")

    @property
    def size(self) -> int:
        """Shards over all ranks."""
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def collective_device(self) -> torch.device:
        """Where this rank's collective tensors live: its first card under
        NCCL, the CPU under gloo."""
        backend = dist.get_backend()
        if "nccl" in backend and "gloo" not in backend:
            dev = self.devices[0]
            if dev.type != "cuda":
                raise ValueError(f"an NCCL group needs CUDA devices, the "
                                 f"mesh has {dev}")
            return dev
        return torch.device("cpu")

    def __repr__(self) -> str:
        return (f"StreamMesh({self.shape}, devices={list(self.devices)}, "
                f"rank={self.rank}/{self.world_size})")


def _local_devices(devices) -> list[torch.device]:
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        for d in devs:
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {d}")
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"mesh device {d}: torch.cuda.is_available"
                                   f"() is False")
        return devs
    if not torch.cuda.is_available():
        raise RuntimeError("make_stream_mesh: no CUDA device (pass devices="
                           "['cpu', ...] to run the plain versions)")
    n = torch.cuda.device_count()
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        # one rank per card, as torchrun starts them
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % n))
        return [torch.device("cuda", local)]
    return [torch.device("cuda", i) for i in range(n)]


def make_stream_mesh(devices=None) -> StreamMesh:
    """1-D mesh ``("streams",)`` over ``devices`` (default: every visible
    CUDA device) times the ranks of the process group."""
    devs = _local_devices(devices)
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    return StreamMesh(devs, (STREAM_AXIS,), (len(devs) * world,))


def make_host_chip_mesh(devices=None) -> StreamMesh:
    """2-D ``("hosts", "chips")`` mesh: one row per rank (a single process
    is ``(1, n)``), so the stream axis is laid out host-major and each
    rank packs only its own rows."""
    devs = _local_devices(devices)
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    return StreamMesh(devs, ("hosts", "chips"), (world, len(devs)))


def stream_sharding(mesh: StreamMesh, n_rows: int):
    """[(device, slice)]: the rows of this rank's ``n_rows`` that each
    local shard decodes.  Contiguous and in order, ``ceil(n / shards)``
    rows a shard, as the JAX package's ``P(mesh.axis_names)`` places the
    rows of a batch padded to a multiple of the shard count; a shard past
    the end gets an empty slice."""
    k = len(mesh.devices)
    per = max(1, -(-n_rows // k))
    return [(dev, slice(min(n_rows, i * per), min(n_rows, (i + 1) * per)))
            for i, dev in enumerate(mesh.devices)]


def replicated(mesh: StreamMesh, tensor: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``tensor`` on every rank (broadcast in place; the tensor
    must lie on ``mesh.collective_device()``).  Without a group it is
    returned as it is."""
    if mesh.grouped:
        dist.broadcast(tensor, src=0)
    return tensor
