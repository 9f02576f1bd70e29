"""Tiny sizes at which every cell runs on the CPU through the program's
plain versions (``device="cpu"``), for the tests alone."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

BLOCKS = {"format": {"block_bytes": 1024}, "batch": 6,
          "params": {"dst_capacity": 1024}}
SHRINK = {
    "hbase64k.pipeline": {**BLOCKS, "params": {"batches_per_call": 2,
                                               "dst_capacity": 1024}},
    "kodak32.batch": {"format": {"height": 16, "width": 16}, "batch": 2,
                      "pool": 2, "params": {"dst_capacity": 16 * 49}},
    "hbase64k.device_resolve": BLOCKS,
    "hbase64k.deflate": {"format": {"block_bytes": 4096}, "batch": 6},
}
#: the seed of the tiny runs: past 32 bits, as the driver's are
SEED = 2**33 + 17


def shrink_for(name: str) -> dict:
    """A cell's tiny sizes; a cell the table lacks is taken as one of the
    HBase block cells."""
    return SHRINK.get(name, BLOCKS)


def main(argv):
    """``python tiny.py <BENCHMARK.json> <workloads dir> <cell> <trace>``:
    one tiny run, its result as the last line."""
    sys.path.insert(0, ROOT)
    from codec_bench import run

    bench_path, wdir, name, trace = argv
    bench = run.load_json(bench_path)
    return run.finish(run.run_cell(bench, name, SEED, 1.0, trace == "1",
                                   device="cpu", shrink=shrink_for(name),
                                   workloads_dir=wdir))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
