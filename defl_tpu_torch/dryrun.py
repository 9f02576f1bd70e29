"""Entry points of the port (counterpart of the root
``__graft_entry__.py``) and the workers it spawns.

- ``entry(device)``: (fn, example_args), one decode step of the flagship
  path on one device: the decode kernel (token decode) and the resolve.
- ``dryrun_multichip(n, device)``: one FULL sharded decode over ``n``
  shards, laid out as the JAX package's dry run lays them: a 2-D
  ``(hosts, chips)`` mesh when ``n`` factors (4 -> 2 x 2, 8 -> 4 x 2),
  one spawned process per host row (gloo on the CPU, NCCL on the cards),
  ``chips`` shards in each.  Rank 0 alone is given the dictionary: the
  others must decode with the one it broadcasts.  It asserts what the JAX
  dry run asserts (outputs equal, every lane OK, the shard count) and
  that the stats are the global sums.
- ``run_workers``: spawn a process group of workers whose target lives in
  this module, so a worker imports torch and this package only (it
  checks that no jax and nothing of ``defl_tpu`` was loaded).  Each
  worker's output goes to a log file; its last line, a JSON object, and
  its exit code come back to the parent, and a worker that fails or
  outlives the timeout fails the call (the others are killed then).

Run::

  python -m defl_tpu_torch.dryrun 4 --device cpu    # 2 gloo processes x 2
  python -m defl_tpu_torch.dryrun 1                 # one card
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import zlib

#: the dry run's dictionary and payloads (the JAX dry run's own)
DICTIONARY = b"dryrun shared dictionary " * 4


def _layout(n_devices: int) -> tuple[int, int]:
    """(hosts, chips): 2-D when the count factors, as the JAX dry run
    does (``__graft_entry__.py:76-82``)."""
    for r in (4, 2):
        if n_devices % r == 0 and n_devices > r:
            return r, n_devices // r
    return 1, n_devices


def dict_streams(n: int):
    """n payloads and their zlib streams compressed against DICTIONARY."""
    payloads = [b"dryrun shared dictionary stream %04d" % i for i in range(n)]
    streams = []
    for p in payloads:
        co = zlib.compressobj(6, zlib.DEFLATED, 15, zdict=DICTIONARY)
        streams.append(co.compress(p) + co.flush())
    return payloads, streams


def entry(device="cuda"):
    """(fn, example_args): one decode step on ``device`` (8 tiny streams):
    ``fn(words, nbits, zflag, cap)`` -> (out, status, dst_pos)."""
    import torch

    from defl_tpu_torch.ops.cuda.decode_cu import decode_tokens
    from defl_tpu_torch.ops.resolve import resolve_tokens
    from defl_tpu_torch.runtime.pack import pack_streams

    C, T = 512, 1024
    payloads = [bytes([i & 0xFF]) * (64 + 8 * i) for i in range(8)]
    packed = pack_streams([zlib.compress(p, 6) for p in payloads], 1, C)
    dev = torch.device(device)
    args = tuple(torch.from_numpy(a).to(dev) for a in (
        packed.words.view("<i4"), packed.nbits, packed.zflag,
        packed.dst_cap))

    def forward(words, nbits, zflag, cap):
        tokens, st = decode_tokens(words, nbits, zflag, cap, T=T)
        out = resolve_tokens(tokens[: st["tok_rows"]], words, st["dst_pos"],
                             C=C)
        return out, st["status"], st["dst_pos"]

    return forward, args


# ---------------------------------------------------------------------------
# spawned workers
# ---------------------------------------------------------------------------

def _worker_main(rank, world, target, backend, device, workdir, kwargs):
    """A spawned worker: its output to its log, the no-jax check, the
    group, the target, its JSON result as the last line."""
    log = open(os.path.join(workdir, f"rank{rank}.log"), "w", buffering=1)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    sys.stdout = sys.stderr = log
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "defl_tpu"))
    if foreign:
        raise RuntimeError(f"worker {rank} imported {foreign}")
    import torch.distributed as dist

    from defl_tpu_torch.parallel import multihost

    multihost.initialize("file://" + os.path.join(workdir, "store"), world,
                         rank, backend=backend, device=device,
                         timeout_s=300)
    try:
        res = globals()[target](rank=rank, world=world, workdir=workdir,
                                **kwargs)
        # every rank is done before any group goes away
        dist.barrier()
    finally:
        dist.destroy_process_group()
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "defl_tpu"))
    if foreign:
        raise RuntimeError(f"worker {rank} imported {foreign}")
    print(json.dumps({"rank": rank, **res}), flush=True)


def run_workers(target: str, world: int, backend: str, devices,
                kwargs=None, timeout_s: float = 600.0, workdir=None):
    """Spawn ``world`` workers running ``target`` (a function of this
    module) in one process group; ``devices[r]`` is rank r's device.
    Returns each rank's result (its last line, a JSON object), in rank
    order.  ``workdir`` holds the rendezvous file and the logs (a fresh
    temporary directory by default)."""
    from multiprocessing.connection import wait

    import torch.multiprocessing as mp

    own = workdir is None
    tmp = tempfile.TemporaryDirectory(prefix="defl_dryrun_") if own else None
    workdir = tmp.name if own else workdir
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_worker_main, args=(
                     r, world, target, backend, devices[r], workdir,
                     dict(kwargs or {})), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            pending = list(procs)
            # a failed worker ends the wait: the others would wait for it
            # in a collective until the group's timeout
            while pending and not any(p.exitcode for p in procs):
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                wait([p.sentinel for p in pending], left)
                pending = [p for p in pending if p.exitcode is None]
        finally:
            alive = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results, failed = [], []
        for r, p in enumerate(procs):
            path = os.path.join(workdir, f"rank{r}.log")
            lines = (open(path).read().splitlines()
                     if os.path.exists(path) else [])
            if r in alive or p.exitcode != 0 or not lines:
                why = " (killed)" if r in alive else ""
                failed.append(f"worker {r}: exit code {p.exitcode}{why}\n"
                              + "\n".join(lines[-30:]))
                continue
            results.append(json.loads(lines[-1]))
        if failed:
            raise RuntimeError("spawned workers failed:\n" + "\n".join(failed))
        return results
    finally:
        if own:
            tmp.cleanup()


def dryrun_worker(rank, world, workdir, chips, device):
    """One rank of the dry run: its rows of 2 x n dictionary streams,
    resolved on the device, as the JAX dry run resolves inside the sharded
    step."""
    from defl_tpu_torch.parallel import multihost
    from defl_tpu_torch.parallel.mesh import make_host_chip_mesh
    from defl_tpu_torch.parallel.shard import DistributedCodec

    if device == "cpu":
        devices = ["cpu"] * chips
    else:
        devices = [f"cuda:{rank * chips + c}" for c in range(chips)]
    n = world * chips
    mesh = make_host_chip_mesh(devices)
    codec = DistributedCodec(mesh, dictionary=DICTIONARY if rank == 0
                             else None, resolve="device")
    payloads, streams = dict_streams(2 * n)
    sl = multihost.local_stream_slice(len(streams))
    res, outs, stats = codec.inflate(streams[sl], dst_capacities=512)
    if outs != payloads[sl] or any(int(r) != 0 for r in res):
        raise AssertionError(f"rank {rank}: sharded decode mismatch")
    if stats["shards"] != n or mesh.shape != {"hosts": world, "chips": chips}:
        raise AssertionError(f"rank {rank}: {stats['shards']} shards, mesh "
                             f"{mesh.shape}")
    return {"rows": [sl.start, sl.stop], "ok_lanes": stats["ok_lanes"],
            "total_bytes": stats["total_bytes"],
            "launches": stats["decode_launches"],
            "reduced_on": stats["reduced_on"]}


def shared_device_worker(rank, world, workdir, n_streams, block, device):
    """One rank of several that share one ``device`` (two NCCL ranks may
    not share a card: the group is gloo): decode its rows of the batch the
    parent wrote to ``workdir`` (``streams.bin``, ``lengths.npy``; the
    payloads are the corpus's, made again here from its seed), one launch
    on a card, then a dictionary matrix that only rank 0 was given the
    dictionary of."""
    import numpy as np
    import torch

    from defl_tpu_torch.corpus import make_silesia_like
    from defl_tpu_torch.ops.cuda import decode_cu
    from defl_tpu_torch.parallel import multihost
    from defl_tpu_torch.parallel.mesh import make_stream_mesh
    from defl_tpu_torch.parallel.shard import DistributedCodec

    sl = multihost.local_stream_slice(n_streams)
    lengths = np.load(os.path.join(workdir, "lengths.npy"))
    ends = np.cumsum(lengths.astype(np.int64))
    starts = ends - lengths
    with open(os.path.join(workdir, "streams.bin"), "rb") as f:
        f.seek(int(starts[sl.start]))
        body = f.read(int(ends[sl.stop - 1] - starts[sl.start]))
    base = int(starts[sl.start])
    streams = [body[int(starts[i]) - base: int(ends[i]) - base]
               for i in range(sl.start, sl.stop)]
    payloads = make_silesia_like(n_streams * block, block)[sl]

    codec = DistributedCodec(make_stream_mesh([device]))
    decode_cu.launches = 0
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    res, outs, stats = codec.inflate(streams, dst_capacities=block)
    wall = time.perf_counter() - t0
    launches = decode_cu.launches
    bad = [sl.start + i for i, (r, o) in enumerate(zip(res, outs))
           if int(r) != 0 or o != payloads[i]]
    if bad:
        raise AssertionError(f"rank {rank}: {len(bad)} rows wrong, first "
                             f"{bad[:5]}")
    del outs

    dcodec = DistributedCodec(make_stream_mesh([device]),
                              dictionary=DICTIONARY if rank == 0 else None)
    dpay, dstr = dict_streams(64)
    dsl = multihost.local_stream_slice(len(dstr))
    dres, douts, dstats = dcodec.inflate(dstr[dsl], dst_capacities=512)
    if douts != dpay[dsl] or any(int(r) != 0 for r in dres):
        raise AssertionError(f"rank {rank}: dictionary rows wrong")
    return {"rows": [sl.start, sl.stop], "launches": launches,
            "wall_s": wall, "ok_lanes": stats["ok_lanes"],
            "total_bytes": stats["total_bytes"],
            "host_fallbacks": len(stats["host_fallbacks"]),
            "reduced_on": stats["reduced_on"],
            "dict_rows": [dsl.start, dsl.stop],
            "dict_ok_lanes": dstats["ok_lanes"]}


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout_s: float = 600.0) -> dict:
    """Run one FULL sharded decode over ``n_devices`` shards (see the
    module's docstring).  On the CPU each host row is a gloo process with
    ``chips`` CPU shards; on CUDA one NCCL process per row with ``chips``
    cards (``n_devices`` may not exceed the visible cards).  Returns the
    summary it prints."""
    import torch

    hosts, chips = _layout(n_devices)
    if device == "cpu":
        backend = "gloo"
        devices = ["cpu"] * hosts
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device (pass "
                               "device='cpu' for gloo processes)")
        if n_devices > torch.cuda.device_count():
            raise ValueError(f"dryrun_multichip({n_devices}): "
                             f"{torch.cuda.device_count()} cards visible")
        backend = "nccl"
        devices = [f"cuda:{h * chips}" for h in range(hosts)]
    ranks = run_workers("dryrun_worker", hosts, backend, devices,
                        dict(chips=chips, device=device),
                        timeout_s=timeout_s)
    payloads = dict_streams(2 * n_devices)[0]
    n_rows = len(payloads)
    per = -(-n_rows // hosts)
    want_rows = [[min(n_rows, h * per), min(n_rows, (h + 1) * per)]
                 for h in range(hosts)]
    if [r["rows"] for r in ranks] != want_rows:
        raise AssertionError(f"rows by rank {[r['rows'] for r in ranks]}, "
                             f"want host-major {want_rows}")
    for r in ranks:
        if r["ok_lanes"] != n_rows or \
                r["total_bytes"] != sum(len(p) for p in payloads):
            raise AssertionError(f"rank {r['rank']}: stats {r}")
    summary = {"n_devices": n_devices, "mesh": {"hosts": hosts,
                                               "chips": chips},
               "backend": backend, "ok_lanes": ranks[0]["ok_lanes"],
               "total_bytes": ranks[0]["total_bytes"], "ranks": ranks}
    print(f"dryrun_multichip({n_devices}): OK — {summary['ok_lanes']} lanes, "
          f"{summary['total_bytes']} bytes, mesh={summary['mesh']}, "
          f"{backend} over {hosts} processes", flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m defl_tpu_torch.dryrun")
    ap.add_argument("n_devices", type=int, nargs="?", default=None,
                    help="shards (default: every visible card)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    import torch

    fn, ex = entry(args.device)
    out, status, dst = fn(*ex)
    print("entry: ok", status.tolist(), flush=True)
    n = args.n_devices
    if n is None:
        n = torch.cuda.device_count() if args.device == "cuda" else 1
    dryrun_multichip(n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
