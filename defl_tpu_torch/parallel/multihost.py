"""Multi-process launch glue.

Counterpart of ``defl_tpu/parallel/multihost.py``.  ``initialize`` joins
a ``torch.distributed`` process group; every rank then contributes its
local devices to one mesh (``mesh.make_host_chip_mesh``) and packs only
the rows of the batch that its own devices decode (host-major layout), so
input bytes never cross ranks: only the dictionary broadcast and the
reduced stats do.

Launch with torchrun, one rank per card::

    torchrun --nproc-per-node=4 my_decode.py

where ``my_decode.py`` calls ``initialize()`` (which reads torchrun's
environment), ``local_stream_slice(n)`` and ``global_codec()``.  Outside
torchrun, pass the rendezvous yourself: ``"host:port"`` (TCP) or a
``file://`` path that every rank can reach, and the process count and
this process's rank.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device="cuda", timeout_s: float | None = None) -> None:
    """Join (or bootstrap) the default process group.

    With no arguments the rendezvous, world size and rank come from
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``).  ``device`` is where this rank's shards decode: a
    CUDA device means the ``nccl`` backend, bound to that card (``"cuda"``
    alone is the card of ``LOCAL_RANK``, else of the rank modulo the
    cards), the CPU means ``gloo``.
    ``backend`` overrides that choice (gloo for ranks that share one
    card: two NCCL ranks may not).  Nothing switches backend on failure.
    """
    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("multihost.initialize: CUDA device requested but "
                           "torch.cuda.is_available() is False")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    if backend == "nccl":
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None else
                               (process_id or 0) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def _rank_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_stream_slice(n_streams: int) -> slice:
    """Rows of a global stream batch this rank packs and decodes.

    With the host-major layout rank r owns rows ``[r * per, (r + 1) *
    per)``, ``per = ceil(n / ranks)``: its local devices consume exactly
    those rows, so packed input never crosses ranks."""
    r, world = _rank_world()
    per = (n_streams + world - 1) // world
    return slice(min(n_streams, r * per), min(n_streams, (r + 1) * per))


def global_codec(dictionary: bytes | None = None, devices=None, **kwargs):
    """A DistributedCodec over every rank's devices (default: each rank's
    card), on the 2-D ``(hosts, chips)`` mesh."""
    from defl_tpu_torch.parallel.mesh import make_host_chip_mesh
    from defl_tpu_torch.parallel.shard import DistributedCodec

    return DistributedCodec(make_host_chip_mesh(devices),
                            dictionary=dictionary, **kwargs)
