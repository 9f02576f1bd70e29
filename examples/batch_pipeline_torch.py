"""Production-shape usage of defl_tpu_torch: batch decode, the overlapped
pipeline, encode, and the distributed codec.

Run:  python examples/batch_pipeline_torch.py [--device cuda|cpu]
      [--streams 64]
(``cuda`` by default, which raises without a card; ``cpu`` runs the
kernels' plain versions.)
"""

import argparse
import os
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description="batch, pipeline, encode, "
                                 "distributed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--streams", type=int, default=64)
    a = ap.parse_args(argv)

    import numpy as np

    from defl_tpu_torch import (DistributedCodec, deflate_batch, inflate_batch,
                                pipeline_inflate)
    from defl_tpu_torch.parallel.mesh import make_stream_mesh

    dev = a.device
    rng = np.random.default_rng(1)
    payloads = [(b"a structured record, " * 50)[: rng.integers(200, 1000)]
                for _ in range(a.streams)]

    # -- encode a batch: the C++ encoder's LZ77 and trees on host threads,
    #    the Huffman bit-pack on the device; byte-identical to the host ----
    streams = deflate_batch(payloads, level=6, backend="device", device=dev)
    assert streams == deflate_batch(payloads, level=6, backend="host")
    z6 = sum(len(zlib.compress(p, 6)) for p in payloads)
    print(f"encode on {dev}: {sum(map(len, streams))} bytes vs zlib-6 {z6}")

    # -- batch decode: one call, a status per stream ----------------------
    results, outputs = inflate_batch(streams, backend="device", device=dev)
    assert all(int(r) == 0 for r in results) and outputs == payloads
    print(f"inflate_batch: {len(streams)} streams ok")

    # a malformed stream errs alone; the batch survives
    broken = list(streams)
    broken[3] = b"\x78\x9c" + b"\xff" * 40
    results, outputs = inflate_batch(broken, backend="device", device=dev)
    assert int(results[3]) != 0
    assert sum(int(r) != 0 for r in results) == 1
    assert outputs[:3] + outputs[4:] == payloads[:3] + payloads[4:]
    print(f"containment: lane 3 ERR, {len(streams) - 1} lanes ok")

    # -- overlapped pipeline: device decode ‖ host resolve, a sink takes
    #    each batch as it lands ------------------------------------------
    batches = [streams[i:] + streams[:i] for i in range(4)]
    seen = []
    per_batch, wall = pipeline_inflate(
        batches, dst_capacity=1024, device=dev,
        sink=lambda i, status, out, dst_pos: seen.append(
            (i, int((status == 0).sum()))))
    assert sorted(s[0] for s in seen) == [0, 1, 2, 3]
    assert all(ok == len(streams) for _, ok in seen)
    print(f"pipeline: 4 batches in {wall:.2f}s, ok-counts "
          f"{[s[1] for s in sorted(seen)]}")

    # -- distributed: the stream axis sharded over the mesh's devices, a
    #    preset dictionary broadcast, outputs in submission order ---------
    dictionary = b"a structured record, "
    dict_streams = []
    for p in payloads[:16]:
        co = zlib.compressobj(6, zlib.DEFLATED, 15, 8,
                              zlib.Z_DEFAULT_STRATEGY, zdict=dictionary)
        dict_streams.append(co.compress(p) + co.flush())
    devices = [dev] * 2 if dev == "cpu" else None   # None: every card
    codec = DistributedCodec(make_stream_mesh(devices), dictionary=dictionary)
    res, outs, stats = codec.inflate(dict_streams, dst_capacities=1024)
    assert all(int(r) == 0 for r in res) and outs == payloads[:16]
    print(f"DistributedCodec: {len(dict_streams)} FDICT streams over "
          f"{stats['shards']} shard(s) ok")


if __name__ == "__main__":
    main()
