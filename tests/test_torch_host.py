"""The port's own host tier against the JAX package's, module by module.

``defl_tpu_torch`` keeps its own copy of every host module it needs
(errors, constants, metrics, core, runtime.pack, runtime.native with the
C++ engine, the bench corpus maker) and imports nothing of ``defl_tpu``.
Each copy is held here against its original on the same inputs, made
from a seed with numpy.  A codec is exact: every comparison is equality.
"""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from defl_tpu import bench as jbench
from defl_tpu import constants as jconst
from defl_tpu import errors as jerrors
from defl_tpu import metrics as jmetrics
from defl_tpu.core import checksums as jchecksums
from defl_tpu.core import huffman as jhuffman
from defl_tpu.core.oracle import inflate_oracle as j_oracle
from defl_tpu.runtime import native as jnative
from defl_tpu.runtime import pack as jpack
from defl_tpu_torch import constants as tconst
from defl_tpu_torch import corpus as tcorpus
from defl_tpu_torch import errors as terrors
from defl_tpu_torch import metrics as tmetrics
from defl_tpu_torch.core import checksums as tchecksums
from defl_tpu_torch.core import huffman as thuffman
from defl_tpu_torch.core.oracle import inflate_oracle as t_oracle
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.runtime import native as tnative
from defl_tpu_torch.runtime import pack as tpack
from tests.gendata import make_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = make_corpus()
needs_jax_native = pytest.mark.skipif(
    not jnative.available(), reason="the JAX package's native library is "
    "unavailable")


# ---- errors, constants, metrics ---------------------------------------------

def test_result_and_flags_equal():
    assert {m.name: m.value for m in terrors.Result} == \
        {m.name: m.value for m in jerrors.Result}
    assert terrors.FLAG_ZLIB == jerrors.FLAG_ZLIB
    assert terrors.FLAG_VERIFY_ADLER32 == jerrors.FLAG_VERIFY_ADLER32
    e = terrors.DeflError(terrors.Result.EFULL, "grow it")
    assert str(e) == str(jerrors.DeflError(jerrors.Result.EFULL, "grow it"))
    assert e.result is terrors.Result.EFULL


def test_constants_equal():
    names = [n for n in dir(tconst)
             if n.isupper() and not n.startswith("_")]
    assert "FIXED_LITLEN_LENGTHS" in names and "DIST_BASE" in names
    for n in names:
        np.testing.assert_array_equal(np.asarray(getattr(tconst, n)),
                                      np.asarray(getattr(jconst, n)),
                                      err_msg=n)


def test_metrics_are_the_ports_own():
    tmetrics.reset()
    before = jmetrics.snapshot()
    tmetrics.inc("probe")
    tmetrics.inc("probe", 4)
    assert tmetrics.snapshot() == {"probe": 5}
    assert jmetrics.snapshot() == before   # not the JAX package's counters
    tmetrics.reset()
    assert tmetrics.snapshot() == {}


# ---- core -------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_build_decode_equal(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 12, rng.integers(2, 288)).tolist()
    if seed == 0:
        lens = list(jconst.FIXED_LITLEN_LENGTHS)
    if seed == 1:
        lens = [1, 1, 1]                       # oversubscribed -> None
    t, j = thuffman.build_decode(lens), jhuffman.build_decode(lens)
    assert (t is None) == (j is None)
    if t is not None:
        for f in ("count", "first_code", "offset", "sorted_syms"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        assert t.max_len == j.max_len


@pytest.mark.parametrize("n", [0, 1, 5551, 5552, 5553, 20000])
def test_host_adler32_equal(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    want = zlib.adler32(data)
    assert tchecksums.adler32(data) == jchecksums.adler32(data) == want
    assert tchecksums.adler32(data[n // 2:],
                              tchecksums.adler32(data[: n // 2])) == want


def _oracle_cases():
    cases = []
    for name in sorted(CORPUS):
        p = CORPUS[name][:3000]
        cases.append((name, zlib.compress(p, 6), 3, None, None))
    p = CORPUS["text"][:2000]
    good = zlib.compress(p, 6)
    d = b"the quick brown fox jumps over the lazy dog " * 4
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 9,
                          zlib.Z_DEFAULT_STRATEGY, zdict=d)
    with_dict = co.compress(p) + co.flush()
    raw = zlib.compressobj(9, zlib.DEFLATED, -15)
    bad_sum = bytearray(good)
    bad_sum[-1] ^= 1
    cases += [
        ("stored", zlib.compress(p, 0), 1, None, None),
        ("raw", raw.compress(p) + raw.flush(), 0, None, None),
        ("garbage", b"\x78\x9c\x07\xff\xff\xff", 1, None, None),
        ("bad_header", b"\x78\x9d\x00", 1, None, None),
        ("truncated", good[:-9], 1, None, None),
        ("cut_trailer", good[:-2], 3, None, None),
        ("bad_trailer", bytes(bad_sum), 3, None, None),
        ("bad_trailer_unverified", bytes(bad_sum), 1, None, None),
        ("efull", good, 1, 500, None),
        ("fdict_without_dictionary", with_dict, 1, None, None),
        ("fdict", with_dict, 3, None, d),
        ("empty_input", b"", 1, None, None),
    ]
    return cases


@pytest.mark.parametrize("name,data,flags,cap,dictionary", _oracle_cases(),
                         ids=[c[0] for c in _oracle_cases()])
def test_oracle_equal(name, data, flags, cap, dictionary):
    tr, to = t_oracle(data, flags, cap, dictionary)
    jr, jo = j_oracle(data, flags, cap, dictionary)
    assert int(tr) == int(jr) and tr.name == jr.name
    assert to == jo


# ---- runtime.pack -----------------------------------------------------------

def test_pack_streams_equal():
    rng = np.random.default_rng(2)
    streams = [rng.integers(0, 256, n, np.uint8).tobytes()
               for n in (0, 1, 3, 4, 5, 257, 1000)]
    streams.append([b"chunk", bytearray(b"ed "), memoryview(b"input")])
    caps = list(range(100, 100 + len(streams)))
    zf = [i & 1 for i in range(len(streams))]
    for args in ((streams, 1, 4096), (streams, zf, caps)):
        t, j = tpack.pack_streams(*args), jpack.pack_streams(*args)
        for f in ("words", "nbits", "zflag", "dst_cap"):
            a, b = getattr(t, f), getattr(j, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert (t.n, t.max_bytes) == (j.n, j.max_bytes)
    assert tpack.MAX_STREAM_BYTES == jpack.MAX_STREAM_BYTES
    with pytest.raises(ValueError, match="exceeds device limit"):
        tpack.pack_streams([bytes(tpack.MAX_STREAM_BYTES + 1)], 1, 64)


@pytest.mark.parametrize("n", [1, 4, 7, 300])
def test_pack_dictionary_equal(n):
    d = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    (tw, tl), (jw, jl) = tpack.pack_dictionary(d), jpack.pack_dictionary(d)
    assert tl == jl == n
    np.testing.assert_array_equal(tw, jw)


# ---- corpus -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [42, 7])
def test_make_silesia_like_equal(seed):
    t = tcorpus.make_silesia_like(70 * 4096, 4096, seed)
    j = jbench.make_silesia_like(70 * 4096, 4096, seed)
    assert t == j and len(t) == 70


# ---- runtime.native ---------------------------------------------------------

def _decoded_tokens(streams, cap, dictionary=None):
    """Tokens of the port's decoder on the CPU, lane-major for the
    resolvers."""
    p = tpack.pack_streams(streams, 1, cap)
    dl = len(dictionary) if dictionary else 0
    tok, c = decode_cu.decode_tokens(p.words, p.nbits, p.zflag, p.dst_cap,
                                     T=4096, K=128, dict_len=dl,
                                     has_dict=dictionary is not None,
                                     device="cpu")
    toks = tok[: c["tok_rows"]].T.contiguous().numpy().view(np.uint32)
    return toks, p, c["dst_pos"].numpy(), c["status"].numpy()


@needs_jax_native
def test_native_resolve_tokens_equal():
    pays = [CORPUS["text"][:900], CORPUS["period_3"][:1000],
            CORPUS["rand_255"], b"\0" * 1000]
    streams = [zlib.compress(p, 6) for p in pays[:3]] + \
        [zlib.compress(pays[3], 0)]
    toks, p, dst, status = _decoded_tokens(streams, 1024)
    assert status.tolist() == [0] * 4
    t = tnative.native_resolve_tokens(toks, p.words, dst, 1024)
    j = jnative.native_resolve_tokens(toks, p.words, dst, 1024)
    np.testing.assert_array_equal(t, j)
    assert [t[i, : dst[i]].tobytes() for i in range(4)] == pays
    # into a caller's buffer, from a start position (the streaming form)
    half = (dst // 2).astype(np.int32)
    outs = []
    for mod in (tnative, jnative):
        out = np.zeros((4, 1024), np.uint8)
        for i in range(4):
            out[i, : half[i]] = np.frombuffer(pays[i][: half[i]], np.uint8)
        # tokens before `half` are replayed without writing
        mod.native_resolve_tokens(toks, p.words, dst, 1024, out=out,
                                  dst_start=np.zeros(4, np.int32))
        outs.append(out)
    np.testing.assert_array_equal(outs[0], outs[1])


@needs_jax_native
def test_native_resolve_tokens_with_dictionary_equal():
    d = b"a shared preset dictionary: hello world, the quick brown fox " * 3
    p0 = b"hello world, the quick brown fox jumps " * 20
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 9,
                          zlib.Z_DEFAULT_STRATEGY, zdict=d)
    toks, p, dst, status = _decoded_tokens([co.compress(p0) + co.flush()],
                                           1024, d)
    assert status.tolist() == [0]
    t = tnative.native_resolve_tokens(toks, p.words, dst, 1024, d)
    j = jnative.native_resolve_tokens(toks, p.words, dst, 1024, d)
    np.testing.assert_array_equal(t, j)
    assert t[0, : dst[0]].tobytes() == p0


def test_native_resolve_checks_the_out_buffer():
    """The out buffer is checked and refused, not asserted (an assert is
    stripped under ``python -O``)."""
    toks = np.zeros((2, 4), np.uint32)
    words = np.zeros((2, 2), np.uint32)
    dst = np.zeros(2, np.int32)
    for bad in (np.zeros((2, 7), np.uint8), np.zeros((2, 8), np.int8),
                np.zeros((8, 2), np.uint8).T, [[0] * 8] * 2):
        with pytest.raises(ValueError, match="out must be"):
            tnative.native_resolve_tokens(toks, words, dst, 8, out=bad)


@needs_jax_native
def test_native_inflate_batch_equal():
    names = sorted(n for n in CORPUS if len(CORPUS[n]) <= 5000)
    pays = [CORPUS[n] for n in names]
    datas = [zlib.compress(p, 6) for p in pays]
    datas += [b"\x78\x9c\x07\xff\xff\xff", datas[3][:-7], b""]
    caps = [len(p) for p in pays] + [64, 8192, 64]
    caps[5] = max(1, caps[5] // 2)             # an EFULL lane
    for threads in (1, 3):
        t = tnative.native_inflate_batch(datas, caps, 1, n_threads=threads)
        j = jnative.native_inflate_batch(datas, caps, 1, n_threads=threads)
        assert [int(r) for r in t[0]] == [int(r) for r in j[0]]
        assert t[1] == j[1]
    assert t[1][0] == pays[0]
    assert tnative.native_inflate_batch(datas[:2], 8192)[1] == pays[:2]


@needs_jax_native
@pytest.mark.parametrize("n", [0, 1, 5553, 70000])
def test_native_adler32_equal(n):
    arr = np.random.default_rng(n).integers(0, 256, n, np.uint8)
    want = zlib.adler32(arr.tobytes())
    assert tnative.native_adler32(arr.tobytes()) == want
    assert tnative.native_adler32(arr) == jnative.native_adler32(arr) == want
    assert tnative.native_adler32(arr[n // 3:],
                                  tnative.native_adler32(arr[: n // 3])) \
        == want


def test_native_library_is_the_ports_own_build():
    tnative.load()
    path = tnative.lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == os.path.join(
        REPO, "defl_tpu_torch", "csrc", "build")
    src = open(os.path.join(REPO, "defl_tpu_torch", "csrc",
                            "defl_host.cc")).read()
    ref = open(os.path.join(REPO, "defl_tpu", "native",
                            "defl_host.cc")).read()
    # the same engine: only comments differ
    strip = lambda s: [l for l in s.splitlines()
                       if not l.lstrip().startswith("//")]
    assert strip(src) == strip(ref)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No available()-then-carry-on: a source that does not compile raises
    with g++'s own message."""
    (tmp_path / tnative.SOURCE).write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_CSRC", str(tmp_path))
    monkeypatch.setattr(tnative, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        tnative.load()
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        tnative.native_adler32(b"abc")
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_public_names_cover_the_jax_package():
    """Every public function of ``defl_tpu.runtime.native`` has its
    namesake in the port's, ``get_lib`` and ``available`` included."""
    def public(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and callable(v)
                and getattr(v, "__module__", None) == mod.__name__}

    missing = public(jnative) - public(tnative)
    assert not missing, sorted(missing)
    assert {"get_lib", "available"} <= public(tnative)


def test_native_available_and_get_lib(tmp_path, monkeypatch):
    """``available`` is True once the library loads, and False only when
    nothing can build it (no source, or no g++ and no library built);
    ``get_lib`` is the loaded library.  A source that does not compile
    raises from both, as ``load`` does."""
    assert tnative.available() is True
    assert tnative.get_lib() is tnative.load()
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_CSRC", str(tmp_path))
    monkeypatch.setattr(tnative, "_BUILD", str(tmp_path / "build"))
    assert tnative.available() is False                  # no source
    (tmp_path / tnative.SOURCE).write_text("this is not C++\n")
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert tnative.available() is False                  # no g++
    monkeypatch.undo()
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_CSRC", str(tmp_path))
    monkeypatch.setattr(tnative, "_BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        tnative.available()
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        tnative.get_lib()


# ---- the port imports neither jax nor the JAX package -----------------------

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import defl_tpu_torch
names = ["defl_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    defl_tpu_torch.__path__, "defl_tpu_torch.")]
for n in names:
    importlib.import_module(n)
# the port's examples, loaded as modules (their main() is not run)
import importlib.util
for ex in ("png_idat_torch", "batch_pipeline_torch"):
    spec = importlib.util.spec_from_file_location(ex, f"examples/{ex}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "defl_tpu"))
assert not foreign, foreign
# the sharded decode and the modules its spawned workers import
for n in ("defl_tpu_torch.parallel.mesh", "defl_tpu_torch.parallel.shard",
          "defl_tpu_torch.parallel.multihost", "defl_tpu_torch.dryrun",
          "defl_tpu_torch.bench_scaling"):
    assert n in names, n
print(len(names), "clean")
"""


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    """Subprocess (tests/conftest.py itself imports jax): import every
    module of defl_tpu_torch and load the port's two examples, then look
    at sys.modules."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    n, word = r.stdout.split()
    assert word == "clean" and int(n) >= 25


def test_port_sources_name_no_import_of_the_jax_package():
    """The same, read from the sources: no import statement of the port,
    of chip_smoke.py, of the port's examples or of its soak names defl_tpu
    or jax."""
    import ast

    files = [os.path.join(REPO, p) for p in (
        "chip_smoke.py", "examples/png_idat_torch.py",
        "examples/batch_pipeline_torch.py", "tests/soak_torch_differential.py",
        "tests/test_torch_cuda_fuzz.py")]
    for root, _, names in os.walk(os.path.join(REPO, "defl_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 25
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            for m in mods:
                assert m.split(".")[0] not in ("defl_tpu", "jax", "jaxlib"), \
                    (path, m)


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    from defl_tpu_torch import DeviceInflateSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceInflateSession(2, 256)
