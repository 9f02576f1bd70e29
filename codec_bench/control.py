#!/usr/bin/env python3
"""The controls of the comparison that decides ``correct``: the reference
put in the program's place with one stated guarantee broken
(``reference/controls.py``), over the cell's whole pool at the cell's own
size, held to the same numbers and limits as a run.  Each has to come out
as not correct.

    python3 codec_bench/control.py --workload <cell> --seeds <n>[,<n>...]

prints one JSON line a seed: the numbers compared, each beside its limit,
and ``correct``.  It calls nothing of the program (the entry's module is
loaded for its kind alone); the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from codec_bench import check, run  # noqa: E402
from codec_bench.entries.calls import Call  # noqa: E402
from codec_bench.reference import controls  # noqa: E402


class InflateControl:
    """Inflates each stream into one byte less than ``dst_capacity``."""

    def __init__(self, capacity: int):
        self.capacity = capacity

    def call(self, c):
        return controls.inflate_capacity_short(c.data, self.capacity)

    @staticmethod
    def lanes(c, result):
        return [(c.ids[0], result[0], result[1])]


class DeflateControl:
    """Compresses each payload at zlib level 1."""

    @staticmethod
    def call(c):
        return controls.deflate_level1(c.data)

    @staticmethod
    def lanes(c, result):
        return [(c.ids[0], None, result)]


def readings(bench: dict, name: str, seed: int, shrink=None,
             workloads_dir=None) -> dict:
    """The control's numbers on the pool of ``seed``: {"numbers",
    "checks", "correct"}.  ``shrink``, ``workloads_dir``: as for
    ``run.load_cell``."""
    c = run.load_cell(bench, name, shrink, workloads_dir)
    kind = c.entry.KIND
    pool = c.gen.make_pool(c.fmt, seed, c.pool, c.batch,
                           encode=kind == "inflate")
    if kind == "inflate":
        ctl = InflateControl(int(c.params["dst_capacity"]))
        calls = [Call([j], b.streams, 0) for j, b in enumerate(pool)]
    else:
        ctl = DeflateControl()
        calls = [Call([j], b.raw, 0) for j, b in enumerate(pool)]
    kept = [(a, ctl.call(a)) for a in calls]
    not_ok = sum(sum(not x for x in ok) if ok is not None
                 else sum(not o for o in outs)
                 for a, r in kept for _, ok, outs in ctl.lanes(a, r))
    got = check.numbers(kind, ctl, pool, kept, not_ok, int(c.fmt["level"]))
    correct, checks = check.judge(got, c.workload["limits"])
    return {"numbers": got, "checks": checks, "correct": correct}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    bench = run.load_json(run.BENCHMARK)
    for s in args.seeds.split(","):
        r = readings(bench, args.workload, int(s))
        print(json.dumps({"workload": args.workload, "seed": int(s), **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
