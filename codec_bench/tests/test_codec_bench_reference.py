"""The reference imports nothing of the program, JAX or the JAX package;
the end-of-run check finds a planted import by its whole top-level name;
the comparisons and the controls call wrong answers wrong."""

import ast
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

from codec_bench import check, guard
from codec_bench.reference import controls, deflate, inflate

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(os.path.join(BENCH, "reference"))
    if f.endswith(".py")))
def test_the_reference_imports_nothing_of_the_program(name):
    mods = list(_imports(os.path.join(BENCH, "reference", name)))
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"defl_tpu_torch", "defl_tpu", "jax", "jaxlib",
                       "flax", "torch"}
    assert all(m.split(".")[0] in {"codec_bench", "__future__", "os",
                                   "zlib", "concurrent"} for m in mods)


def test_the_guard_compares_whole_top_level_names():
    mods = {"defl_tpu_torch": 1, "defl_tpu_torch.api": 1, "jaxtyping": 1,
            "numpy": 1, "defl_tpuX": 1}
    assert guard.forbidden_loaded(mods) == []
    mods.update({"defl_tpu": 1, "jax.numpy": 1, "jaxlib": 1, "flax.core": 1})
    assert guard.forbidden_loaded(mods) == ["defl_tpu", "flax.core",
                                            "jax.numpy", "jaxlib"]


def test_the_guard_finds_a_planted_defl_tpu_import_in_a_process():
    code = ("import sys, types; sys.path.insert(0, %r)\n"
            "from codec_bench import guard\n"
            "import defl_tpu_torch\n"
            "assert guard.forbidden_loaded() == [], guard.forbidden_loaded()\n"
            "sys.modules['defl_tpu'] = types.ModuleType('defl_tpu')\n"
            "print(guard.forbidden_loaded())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['defl_tpu']"


def test_lanes_wrong_counts_status_bytes_and_missing_lanes():
    exp = [b"abc", b"", b"x" * 100]
    assert inflate.lanes_wrong([True] * 3, [b"abc", b"", b"x" * 100],
                               exp) == 0
    arr = np.frombuffer(b"abc", np.uint8)
    assert inflate.lanes_wrong([True] * 3, [arr, b"", b"x" * 100], exp) == 0
    assert inflate.lanes_wrong([True] * 3, [b"abd", b"", b"x" * 100],
                               exp) == 1
    assert inflate.lanes_wrong([True, False, True],
                               [b"abc", b"", b"x" * 100], exp) == 1
    assert inflate.lanes_wrong([True] * 2, [b"abc", b""], exp) == 2
    assert inflate.lanes_wrong([True] * 3, [b"abc", b"", b"x" * 99],
                               exp) == 1


def test_inflate_all_refuses_invalid_and_unfinished_streams():
    good = zlib.compress(b"hello" * 50)
    assert inflate.inflate_all([good]) == [b"hello" * 50]
    for bad in (good[:-1], good + b"\0", b"\x78\x9c\xff\xff"):
        with pytest.raises(zlib.error):
            inflate.inflate_all([bad])


def test_streams_wrong_checks_body_trailer_and_count():
    p = [b"abc" * 1000, bytes(range(256)) * 10]
    outs = [zlib.compress(x, 6) for x in p]
    assert deflate.streams_wrong(outs, p) == 0
    flipped = bytearray(outs[0])
    flipped[len(flipped) // 2] ^= 0x10
    assert deflate.streams_wrong([bytes(flipped), outs[1]], p) == 1
    trailer = outs[1][:-4] + bytes(4)
    assert deflate.streams_wrong([outs[0], trailer], p) == 1
    assert deflate.streams_wrong(outs[:1], p) == 1
    assert deflate.streams_wrong([outs[0], outs[0]], p) == 1
    assert deflate.streams_wrong([b"", outs[1]], p) == 1


def test_the_controls_break_their_guarantee():
    full = [bytes(range(256)) * 4, b"short"]
    ok, outs = controls.inflate_capacity_short(
        [zlib.compress(x) for x in full], 1024)
    assert ok == [False, True] and outs == [full[0][:1023], b"short"]
    p = [bytes(range(256)) * 64 + b"ab" * 3000]
    assert sum(map(len, controls.deflate_level1(p))) > \
        sum(deflate.zlib_sizes(p, 6))


def test_judge_needs_every_number_under_its_limit():
    assert check.judge({"a": 0, "b": 1.5}, {"a": 0, "b": 2.0})[0]
    assert not check.judge({"a": 1, "b": 1.5}, {"a": 0, "b": 2.0})[0]
    assert not check.judge({"a": 0}, {"a": 0, "b": 2.0})[0]
    assert not check.judge({"a": 0, "c": 0}, {"a": 0})[0]
    assert not check.judge({"a": None}, {"a": 0})[0]
    ok, checks = check.judge({"a": 0}, {"a": 0})
    assert checks == {"a": {"value": 0, "limit": 0}}
