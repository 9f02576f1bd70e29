"""The port's mirrored format constants, and its independence from jax.

``defl_tpu_torch`` mirrors the constants of jax-importing modules instead
of importing them; these tests hold every mirror — the Python ones and
the CUDA kernel's — against the JAX package's values, and check that the
port and its CPU main path never import jax.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from defl_tpu.errors import Result
from defl_tpu.ops import inflate_batch as jib
from defl_tpu.ops import tables as jtables
from defl_tpu.ops.pallas import decode_pl as jpl
from defl_tpu_torch.ops import inflate_batch as tib
from defl_tpu_torch.ops import tables as ttables
from defl_tpu_torch.ops.cuda import decode_cu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(REPO, "defl_tpu_torch", "csrc", "decode_stream.cu")

INFLATE_NAMES = [n for n in dir(jib) if re.fullmatch(r"S_[A-Z_]+", n)] + [
    "STATUS_RUNNING", "TOK_NOP", "TOK_LIT", "TOK_MATCH", "TOK_STORED",
    "TOK_LIT_PAIR_BIT", "STORED_MAX_RUN", "WIN", "LENS_WORDS"]
TABLE_NAMES = ["CL_BASE", "LIT_BASE", "DIST_BASE_", "SYMS_BANK", "SYMS_WORDS"]
ROW_NAMES = [n for n in dir(jpl) if re.fullmatch(r"R_[A-Z]+", n)] + ["NROWS"]


@pytest.mark.parametrize("name", INFLATE_NAMES)
def test_inflate_constants_mirror_jax(name):
    assert getattr(tib, name) == getattr(jib, name)


@pytest.mark.parametrize("name", TABLE_NAMES)
def test_table_constants_mirror_jax(name):
    assert getattr(ttables, name) == getattr(jtables, name)


@pytest.mark.parametrize("name", ROW_NAMES)
def test_state_rows_mirror_jax(name):
    assert getattr(decode_cu, name) == getattr(jpl, name)


def test_state_keys_mirror_jax():
    assert decode_cu.ST_KEYS == jpl.ST_KEYS
    assert set(tib.SCAN_KEYS) == set(jib._init_scan_state(1))
    assert set(tib.CHUNK_KEYS) == set(jib._init_chunk_state(1)) - {
        "win", "win_word", "rr"}


@pytest.mark.parametrize("cap", [1, 1024, 4096, 65536, 1 << 20])
def test_step_budget_mirrors_jax(cap):
    assert tib.step_budget(cap) == jib.step_budget(cap)


def test_fixed_tables_mirror_jax():
    for (cnt, first, offs, syms), (jc, jf, jo, js) in (
            (tib._FX_LIT, (jib._FX_LIT_COUNT, jib._FX_LIT_FIRST,
                           jib._FX_LIT_OFFS, jib._FX_LIT_SYMS)),
            (tib._FX_DIST, (jib._FX_DIST_COUNT, jib._FX_DIST_FIRST,
                            jib._FX_DIST_OFFS, jib._FX_DIST_SYMS))):
        np.testing.assert_array_equal(cnt.numpy(), jc)
        np.testing.assert_array_equal(first.numpy(), jf)
        np.testing.assert_array_equal(offs.numpy(), jo)
        np.testing.assert_array_equal(syms.numpy(), js.astype(np.int64))


def _cu_constants():
    src = open(CU).read()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"\b([A-Z][A-Z0-9_]*) = (-?\d+)\b", src)}


@pytest.mark.parametrize("name", sorted(
    n for n in _cu_constants() if n.startswith(("S_", "R_"))))
def test_kernel_states_and_rows_mirror_jax(name):
    want = getattr(jib, name) if name.startswith("S_") else getattr(jpl, name)
    assert _cu_constants()[name] == want


def test_kernel_codes_mirror_jax():
    cu = _cu_constants()
    assert cu["RES_OK"] == int(Result.OK)
    assert cu["RES_ERR"] == int(Result.ERR)
    assert cu["RES_UNFINISHED"] == int(Result.UNFINISHED)
    assert cu["RES_EFULL"] == int(Result.EFULL)
    assert cu["STORED_MAX_RUN"] == jib.STORED_MAX_RUN
    assert cu["SYMS_BANK"] == jtables.SYMS_BANK
    for kind in ("LIT", "MATCH", "STORED"):
        assert cu[f"TOK_{kind}"] == getattr(jib, f"TOK_{kind}")
    for name in ("STATUS_RUNNING", "LENS_WORDS"):
        assert cu[name] == getattr(jib, name)
    for name in ("CL_BASE", "LIT_BASE", "DIST_BASE_", "SYMS_WORDS"):
        assert cu[name] == getattr(jtables, name)


def test_kernel_shared_memory_layout_holds_the_tables():
    """The stream kernel's per-lane shared words lie back to back: the
    symbol bank, adjoff and the boundaries (3 tables x 16 lengths each),
    the lens words, 16 sort counters and the 8-word input ring; a lookup
    entry holds any symbol beside any code length."""
    cu = _cu_constants()
    assert cu["OFF_SYMS"] == 0
    assert cu["OFF_ADJ"] == cu["OFF_SYMS"] + jtables.SYMS_WORDS
    assert cu["OFF_BND"] == cu["OFF_ADJ"] + 48
    assert cu["OFF_LENS"] == cu["OFF_BND"] + 48
    assert cu["OFF_CNT"] == cu["OFF_LENS"] + jib.LENS_WORDS
    assert cu["OFF_RING"] == cu["OFF_CNT"] + 16
    assert cu["LANE_WORDS"] == cu["OFF_RING"] + 8
    assert 287 < (1 << cu["LUT_LEN_SHIFT"]) and (15 << cu["LUT_LEN_SHIFT"]) \
        < (1 << 16)


def test_kernel_cl_order_mirrors_jax():
    import jax.numpy as jnp

    src = open(CU).read()
    body = re.search(r"kClOrder\[19\] = \{([^}]*)\}", src).group(1)
    order = [int(x) for x in body.split(",")]
    want = np.asarray(jib._ord_arith(jnp.arange(19, dtype=jnp.int32)))
    assert order == want.tolist()


_NO_JAX = r"""
import sys, zlib
import defl_tpu_torch
from defl_tpu_torch.runtime.session import device_inflate
def foreign():
    return sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "defl_tpu"))
assert not foreign(), foreign()
p = [b"no jax here " * 20, bytes(range(256))]
r, o, _ = device_inflate([zlib.compress(x) for x in p], dst_capacities=1024,
                         device="cpu")
assert o == p, "decode"
assert not foreign(), foreign()
print("clean")
"""


def test_port_never_imports_jax():
    """Subprocess: tests/conftest.py itself imports jax."""
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "clean"


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py imports the port, torch, numpy, the standard library
    and the benchmark's PNG generator (codec_bench.data, for [8c]'s
    batch): never defl_tpu or jax."""
    import ast

    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "defl_tpu_torch" in roots
    assert not roots & {"defl_tpu", "jax", "jaxlib"}
    assert roots <= {"__future__", "concurrent", "json", "os", "re",
                     "signal", "subprocess", "sys", "tempfile", "time", "zlib",
                     "numpy", "torch", "defl_tpu_torch", "codec_bench"}, roots
