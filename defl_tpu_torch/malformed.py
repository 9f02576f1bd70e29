"""Malformed streams among good ones on the decode route: a malformed
stream never poisons its batch.

A batch of the bench corpus (``corpus.make_silesia_like``, zlib level 6)
has every 8th lane swapped for a malformed stream (``corpus.mixed_batch``:
truncated, bit-flipped, garbage, a valid zlib header before a garbage
body), and one stream of the corpus's payloads joined gets bit flips and
a cut tail.  ``run`` decodes them on ``device`` and holds every lane:

- a malformed lane has the port oracle's class (``core.oracle``), and its
  bytes when that class is OK;
- a corpus lane is OK, its payload byte for byte, and leaves the decoder
  at the same ``dst_pos`` and ``bitpos`` as in the clean batch;
- the split decode of the mutated stream (``inflate_large(use_device=
  True)``) has the host-parallel engine's class, and its bytes when OK.

Both resolvers run, so the decode kernel (batch and shared-input mode) and
the adler32 kernel (``FLAG_VERIFY_ADLER32`` on the device resolver) both
see malformed lanes.  Run from the repository root:

    python -m defl_tpu_torch.malformed [--lanes 256] [--block 65536]
                                       [--seed 11] [--device cuda]

It prints one JSON line and exits 1 on any difference.  ``chip_smoke.py``
[11c] and ``tests/soak_torch_differential.py --sanitizer`` run it under
``compute-sanitizer``.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import time
import zlib
from collections import Counter

import torch

from defl_tpu_torch import corpus
from defl_tpu_torch.core.oracle import inflate_oracle
from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB

FLAGS = FLAG_ZLIB | FLAG_VERIFY_ADLER32
#: the kernels whose launches ``run`` counts
KERNELS = ("decode_stream", "adler32_batch")
#: the mutated stream: 1024 payloads of 64 KiB joined (the bench's
#: "large64"), with this many bit flips and a cut tail
LARGE_LANES = 1024
FLIPS = 16


def oracle_results(streams, flags: int, cap: int) -> list[tuple[int, bytes]]:
    """The port oracle's (class, bytes) for each stream."""
    return [(int(r), o) for r, o in
            (inflate_oracle(d, flags, cap) for d in streams)]


def differing_lanes(results, outputs, want) -> list[int]:
    """Lanes whose class, or whose bytes when OK, are not ``want``'s."""
    return [i for i, (r, o, (wr, wo)) in enumerate(zip(results, outputs,
                                                       want))
            if int(r) != wr or (wr == 0 and bytes(o) != wo)]


def class_counts(results) -> dict[str, int]:
    """How many lanes ended in each result class."""
    return {str(k): v for k, v in sorted(Counter(int(r)
                                                 for r in results).items())}


def mutate(data: bytes, seed: int, flips: int, cut: bool) -> bytes:
    """``data`` with ``flips`` bit flips past its two header bytes, from
    ``random.Random(seed)``, and, with ``cut``, its tail cut off somewhere
    in its second half."""
    rng = random.Random(seed)
    d = bytearray(data)
    for _ in range(flips):
        d[rng.randrange(2, len(d))] ^= 1 << rng.randrange(8)
    if cut:
        d = d[: rng.randrange(len(d) // 2, len(d))]
    return bytes(d)


def run(lanes: int = 256, block: int = 65536, seed: int = 11,
        device="cuda", batch=None) -> dict:
    """The checks of the module docstring; ``ok`` in the returned record
    says whether every lane held and, on a card, whether the kernels ran:
    the decode kernel on both resolvers, the adler32 kernel on the device
    resolver, and the mutated stream in one launch of the device route.

    ``batch`` is the corpus's (payloads, zlib streams) when the caller has
    made them; the mutated stream joins the first ``LARGE_LANES`` payloads
    and gets ``FLIPS`` bit flips."""
    from defl_tpu_torch.ops.cuda import checksums_cu, decode_cu
    from defl_tpu_torch.runtime.large import inflate_large
    from defl_tpu_torch.runtime.session import device_inflate

    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    if batch is None:
        blocks = corpus.make_silesia_like(lanes * block, block)[:lanes]
        streams = [zlib.compress(b, 6) for b in blocks]
    else:
        blocks, streams = (list(x[:lanes]) for x in batch)
    mixed, bad = corpus.mixed_batch(streams, blocks, seed)
    bad_set = set(bad)
    want = {}
    for flags in (FLAG_ZLIB, FLAGS):
        got = dict(zip(bad, oracle_results([mixed[i] for i in bad], flags,
                                           block)))
        want[flags] = [got.get(i, (0, blocks[i])) for i in range(lanes)]
    rec = {"lanes": lanes, "block": block, "seed": seed,
           "malformed_lanes": len(bad), "device": str(device),
           "made_s": time.perf_counter() - t0}

    _, _, clean = device_inflate(streams, FLAG_ZLIB, dst_capacities=block,
                                 device=device)
    ok = True
    for resolve, flags in (("host", FLAG_ZLIB), ("device", FLAGS)):
        decode_cu.launches = checksums_cu.launches = 0
        t0 = time.perf_counter()
        res, outs, st = device_inflate(mixed, flags, dst_capacities=block,
                                       resolve=resolve, device=device)
        wall = time.perf_counter() - t0
        differ = differing_lanes(res, outs, want[flags])
        # the corpus lanes' device end state is the clean batch's
        moved = [i for i in range(lanes) if i not in bad_set and any(
            int(st[k][i]) != int(clean[k][i])
            for k in ("status", "dst_pos", "bitpos"))]
        launched = (decode_cu.launches, checksums_cu.launches)
        rec[f"resolve_{resolve}"] = {
            "classes": class_counts(res), "differ": differ[:8],
            "n_differ": len(differ), "corpus_lanes_moved": moved[:8],
            "host_fallbacks": len(st["host_fallbacks"]),
            "launches": dict(zip(KERNELS, launched)), "wall_s": wall}
        ok = ok and not differ and not moved
        if on_card:         # the kernels ran: both on the device resolver
            ok = ok and launched[0] > 0 and (resolve == "host"
                                             or launched[1] > 0)

    # one stream of the payloads joined, flipped and cut: split decode
    # against the host-parallel engine
    data = mutate(zlib.compress(b"".join(blocks[:LARGE_LANES]), 6), seed,
                  FLIPS, cut=True)
    decode_cu.launches = 0
    st = {}
    r_dev, o_dev = inflate_large(data, FLAGS, use_device=True, device=device,
                                 stats_out=st)
    r_host, o_host = inflate_large(data, FLAGS, use_device=False)
    same = int(r_dev) == int(r_host) and (int(r_host) != 0 or o_dev == o_host)
    rec["large"] = {"bytes": len(data), "flips": FLIPS, "class": int(r_dev),
                    "host_parallel_class": int(r_host), "same": same,
                    "route": st["route"], "lanes": st.get("lanes", 0),
                    "lanes_valid": st.get("lanes_valid", 0),
                    "launches": decode_cu.launches}
    if on_card:
        same = same and st["route"] == "device" and decode_cu.launches == 1
    rec["ok"] = ok and same
    return rec


def sanitizer_path():
    """``compute-sanitizer`` on the PATH or under the CUDA toolkit
    (``CUDA_HOME``, else /usr/local/cuda), or None."""
    found = shutil.which("compute-sanitizer")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        for rel in ("bin", "compute-sanitizer"):
            path = os.path.join(root or "", rel, "compute-sanitizer")
            if root and os.access(path, os.X_OK):
                return path
    return None


def sanitizer_refusal(output: str) -> str | None:
    """compute-sanitizer's own line saying that it cannot check this card
    ("Device not supported"), or None.  Such a run checked nothing: its
    error count is that of the CUDA calls that failed after it refused."""
    refused = [ln.strip() for ln in output.splitlines()
               if "Device not supported" in ln]
    reports = [ln for ln in output.splitlines() if "Invalid " in ln
               or "Race reported" in ln]
    return refused[0] if refused and not reports else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--block", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    rec = run(a.lanes, a.block, a.seed, a.device)
    print(json.dumps(rec), flush=True)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
