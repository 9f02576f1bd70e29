"""Long-running cross-engine differential soak of defl_tpu_torch on a CUDA
card (not collected by pytest): the port's counterpart of
tests/soak_differential.py.

Ground truth is CPython zlib (the card's machine has no jax, so defl_tpu
cannot be the reference there).  Every iteration builds a payload from
tests/soak_differential.py's generator mix, compresses it (zlib at a
random level, or the port's own C++ encoder), and drives the result
through every decode engine of the port:

  - core.oracle (the pure-Python resumable engine, random feed granularity)
  - native serial (dt_inflate) and native large-parallel
    (inflate_large(use_device=False), random seg_bytes and threads)
  - the CUDA decode kernel: device_inflate on the card in batches of 16,
    each batch with the host resolver or with the device resolver and the
    trailer check on the adler32 kernel
  - the chunk loop over the kernel's twin (decode_chunk_ref) on the small
    payloads of every 8th batch, held against the kernel's launch by
    decode_cu.compare_decodes
  - inflate_large(use_device=True), the split decode on the card, for a
    joined payload of 1-16 MiB every 25 iterations

plus mutation rounds of streams up to 64 KiB (bit flips and a cut tail):
the oracle, the serial engine and the card's decode (in batches) must
agree on the class and, for an OK stream, the bytes; the two inflate_large
routes must agree with each other.  The one divergence allowed is a fault
of the reference that the port keeps in its C++ engine: a stored block cut
short whose LEN is past the capacity is EFULL there and UNFINISHED in the
oracle (counted).

    python tests/soak_torch_differential.py [seconds] [seed] [--sanitizer]

(``--device cpu`` rehearses it on the kernels' plain versions, slowly.)
``--sanitizer`` runs the same soak under compute-sanitizer memcheck
(``--error-exitcode 1``): every launch of it is checked for out-of-bounds
and misaligned accesses.  Prints a one-line summary; exits non-zero on any
divergence.
"""

from __future__ import annotations

import os
import random
import subprocess
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tests.soak_differential import gen_payload  # noqa: E402

#: streams per batch of the card's decode, and payloads up to this size join
#: the chunk loop's batches
BATCH = 16
PLAIN_MAX = 2048


def _under_sanitizer(args) -> int:
    from defl_tpu_torch.malformed import sanitizer_path, sanitizer_refusal

    san = sanitizer_path()
    if san is None:
        print("soak: compute-sanitizer is absent (not on the PATH, not under "
              "the CUDA toolkit)", file=sys.stderr)
        return 2
    cmd = [san, "--tool", "memcheck", "--error-exitcode", "1",
           sys.executable, os.path.abspath(__file__), *args]
    r = subprocess.run(cmd, capture_output=True, text=True)
    refused = sanitizer_refusal(r.stdout + r.stderr)
    if refused:
        print(f"soak: {san} refuses this card ({refused!r}): nothing was "
              f"checked", file=sys.stderr)
        return 2
    summary = [ln for ln in (r.stdout + r.stderr).splitlines()
               if "ERROR SUMMARY" in ln]
    last = [ln for ln in r.stdout.splitlines() if ln.startswith("soak")]
    print(f"{last[-1] if last else 'soak: no summary'}; memcheck exit "
          f"{r.returncode}, {summary[-1] if summary else 'no summary line'}")
    if r.returncode:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
    return r.returncode


def main(argv) -> int:
    args = [a for a in argv if a != "--sanitizer"]
    if len(args) != len(argv):
        return _under_sanitizer(args)
    device = "cuda"
    if "--device" in args:
        k = args.index("--device")
        device = args[k + 1]
        del args[k:k + 2]
    budget_s = float(args[0]) if args else 600
    seed = int(args[1]) if len(args) > 1 else int(time.time())
    rng = random.Random(seed)

    import torch

    from defl_tpu_torch.core.oracle import InflateEngine, inflate_oracle
    from defl_tpu_torch.corpus import make_silesia_like
    from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB, Result
    from defl_tpu_torch.malformed import mutate
    from defl_tpu_torch.ops import inflate_batch as ib
    from defl_tpu_torch.ops.cuda import decode_cu
    from defl_tpu_torch.runtime import native
    from defl_tpu_torch.runtime.large import inflate_large
    from defl_tpu_torch.runtime.pack import pack_streams
    from defl_tpu_torch.runtime.session import device_inflate

    if device == "cuda" and not torch.cuda.is_available():
        print("soak: torch.cuda.is_available() is False; this soak needs a "
              "CUDA card", file=sys.stderr)
        return 1
    native.load()
    blocks = make_silesia_like(8 << 20, 65536)
    t_end = time.time() + budget_s
    n = {"iterations": 0, "device_lanes": 0, "device_batches": 0,
         "plain_batches": 0, "large_device": 0, "mutations": 0,
         "mutated_device_lanes": 0, "efull_quirk": 0}
    bad: list[str] = []
    good_batch: list[tuple[bytes, bytes]] = []
    mutated_batch: list[tuple[bytes, int, bytes, int]] = []

    def diverged(what, data):
        bad.append(f"{what} (iteration {n['iterations']}, stream "
                   f"{data[:48].hex()}{'...' if len(data) > 48 else ''}, "
                   f"{len(data)} B)")

    def run_good_batch():
        streams = [c for c, _ in good_batch]
        caps = [len(p) + 1 for _, p in good_batch]
        resolve = rng.choice(["host", "device"])
        flags = FLAG_ZLIB | (FLAG_VERIFY_ADLER32 if resolve == "device"
                             else 0)
        res, outs, st = device_inflate(streams, flags, dst_capacities=caps,
                                       resolve=resolve, device=device)
        for (c, p), r, o in zip(good_batch, res, outs):
            if int(r) != 0 or o != p:
                diverged(f"device_inflate({resolve}): {int(r)}", c)
        if st["host_fallbacks"]:
            diverged(f"device_inflate({resolve}) fell back on "
                     f"{st['host_fallbacks']}", streams[0])
        n["device_batches"] += 1
        n["device_lanes"] += len(streams)
        small = [(c, p) for c, p in good_batch if len(p) <= PLAIN_MAX]
        if small and n["device_batches"] % 8 == 0:
            pk = pack_streams([c for c, _ in small], 1, PLAIN_MAX)
            args = (pk.words, pk.nbits, pk.zflag, pk.dst_cap)
            T = ib.step_budget(PLAIN_MAX)
            kern = decode_cu.decode_tokens(*args, T=T, device=device)
            twin = decode_cu.decode_tokens(*args, T=T, K=128, device=device,
                                           _chunk=decode_cu.decode_chunk_ref)
            if decode_cu.compare_decodes(kern, twin):
                diverged("stream kernel against the chunk loop", small[0][0])
            n["plain_batches"] += 1
        good_batch.clear()

    def run_mutated_batch():
        streams = [m for m, _, _, _ in mutated_batch]
        caps = [cap for _, _, _, cap in mutated_batch]
        res, outs, _ = device_inflate(streams, dst_capacities=caps,
                                      device=device)
        for (m, r_want, o_want, _), r, o in zip(mutated_batch, res, outs):
            if int(r) != r_want or (r_want == 0 and o != o_want):
                diverged(f"mutated, device_inflate {int(r)} against the "
                         f"oracle's {r_want}", m)
        n["mutated_device_lanes"] += len(streams)
        mutated_batch.clear()

    while time.time() < t_end and len(bad) < 20:
        n["iterations"] += 1
        p = gen_payload(rng, blocks)
        lvl = rng.choice([0, 1, 2, 4, 6, 9])
        comp = (native.native_deflate(p, max(lvl, 1)) if rng.random() < 0.25
                else zlib.compress(p, lvl))
        if zlib.decompress(comp) != p:
            diverged("zlib rejects the port's encoder", comp)

        if len(comp) < 300000 and rng.random() < 0.3:
            eng = InflateEngine(len(p) + 1)
            g = rng.choice([1, 7, 4096, len(comp) or 1])
            r = None
            for ofs in range(0, len(comp), g):
                eng.include(comp[ofs:ofs + g])
                r = eng.step()
            if r is not Result.OK or bytes(eng.out) != p:
                diverged(f"oracle at {g}-byte feeds: {r}", comp)

        r, out = native.native_inflate(comp, len(p) + 1)
        if r is not Result.OK or out != p:
            diverged(f"native serial: {r}", comp)
        r, out = inflate_large(comp, use_device=False,
                               seg_bytes=rng.choice([8192, 65536]),
                               n_threads=rng.choice([1, 3]))
        if r is not Result.OK or out != p:
            diverged(f"native large-parallel: {r}", comp)

        if len(p) <= 1 << 18:
            good_batch.append((comp, p))
            if len(good_batch) == BATCH:
                run_good_batch()

        if n["iterations"] % 25 == 0:
            big = b"".join(rng.choice(blocks)
                           for _ in range(rng.randrange(16, 257)))
            zb = zlib.compress(big, rng.choice([1, 6, 9]))
            st = {}
            r, out = inflate_large(zb, FLAG_ZLIB | FLAG_VERIFY_ADLER32,
                                   use_device=True, device=device,
                                   stats_out=st)
            if r is not Result.OK or out != big or st["route"] != "device":
                diverged(f"inflate_large on the card: {r}, route "
                         f"{st.get('route')}", zb)
            n["large_device"] += 1
            m = mutate(zb, rng.randrange(1 << 30), rng.randrange(1, 17),
                       cut=rng.random() < 0.5)
            r1, o1 = inflate_large(m, use_device=True, device=device)
            r2, o2 = inflate_large(m, use_device=False)
            if int(r1) != int(r2) or (r1 is Result.OK and o1 != o2):
                diverged(f"mutated inflate_large: card {int(r1)}, host "
                         f"{int(r2)}", m)

        if 4 < len(comp) <= 1 << 16 and rng.random() < 0.5:
            n["mutations"] += 1
            m = mutate(comp, rng.randrange(1 << 30), rng.randrange(1, 6),
                       cut=rng.random() < 0.5)
            cap = 2 * len(p) + 64
            ro, oo = inflate_oracle(m, FLAG_ZLIB, cap)
            rn, on = native.native_inflate(m, cap)
            if (rn, ro) == (Result.EFULL, Result.UNFINISHED):
                n["efull_quirk"] += 1
            elif rn is not ro or (ro is Result.OK and on != oo):
                diverged(f"mutated, native serial {int(rn)} against the "
                         f"oracle's {int(ro)}", m)
            mutated_batch.append((m, int(ro), oo, cap))
            if len(mutated_batch) == BATCH:
                run_mutated_batch()

    if good_batch:
        run_good_batch()
    if mutated_batch:
        run_mutated_batch()
    counts = ", ".join(f"{k} {v}" for k, v in n.items())
    if bad:
        print(f"soak FAILED: {len(bad)} divergences, seed={seed}, {counts}")
        for b in bad:
            print(f"  {b}")
        return 1
    where = (torch.cuda.get_device_name(0) if device == "cuda" else device)
    print(f"soak OK: seed={seed}, {budget_s:.0f} s on {where}, {counts}, "
          f"0 divergences")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
