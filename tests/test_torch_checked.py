"""The decode kernel's checked build, on the CPU.

``csrc/decode_stream.cu`` built with ``-DDEFL_CHECKED`` routes every access
to device and shared memory through accessors that check it against its
extent, and keeps a shadow of which shared words and lookup entries each
lane has written in this launch.  ``tests/decode_host.py`` builds it for
the host (``build(checked=True)``) and runs it in the card's layout: the
32 lanes of a block (``STREAM_THREADS`` x ``STREAM_LANES_PER_WARP`` / 32)
share one allocation of shared memory filled with junk, the i-th lane of
the order in slot ``i % 32``, so a lane that reads its neighbour's words,
or a word it did not write, is seen here, where AddressSanitizer sees
neither (tests/test_torch_fuzz_asan.py gives each lane its own
allocation).  ``decode_cu._decode_stream`` runs around it exactly as it
runs around a launch on the card, fault record and all.

For fuzz cases, the cut streams of ``BAD_CODE_CUT_SHORT``, a mixed batch
of ~1 KiB payloads, a flipped shared body, a dictionary and an EFULL
resume: no fault, and the checked build equal to the unchecked host build
bit for bit (tokens, carry, totals) and to the chunk loop by
``decode_cu.compare_decodes``; through ``device_inflate``, every lane
``defl_tpu``'s oracle class and bytes.  Then one injected out-of-extent
access at each site, in batch and in shared-input mode, must raise
``build.KernelFault`` with that site and lane: a check that never fires
proves nothing.  The same build runs on the card in chip_smoke.py [13].
Exact comparisons.
"""

import ast
import os
import re
import subprocess
import types
import zlib

import ctypes
import numpy as np
import pytest

from defl_tpu.core.oracle import inflate_oracle as jax_oracle
from defl_tpu_torch import corpus
from defl_tpu_torch.errors import FLAG_VERIFY_ADLER32, FLAG_ZLIB
from defl_tpu_torch.ops import inflate_batch as tib
from defl_tpu_torch.ops.cuda import build as cu_build
from defl_tpu_torch.ops.cuda import decode_cu
from defl_tpu_torch.runtime import large
from defl_tpu_torch.runtime import session as tsess
from defl_tpu_torch.runtime.pack import pack_dictionary, pack_streams
from tests.decode_host import REPO, _host_split_decode, _host_stream, build
from tests.test_fuzz import CAP, _gen_cases
from tests.test_torch_fuzz import BAD_CODE_CUT_SHORT
from tests.test_torch_fuzz_kernel import _flipped_body
from tests.test_torch_stream_decode import _until_done

#: lanes of a block on the card, and the slot the injections take
LANES = decode_cu.STREAM_THREADS // 32 * decode_cu.STREAM_LANES_PER_WARP
MID = LANES // 2
T = tib.step_budget(CAP)
STREAM_SITES = ("shared", "lut", "input", "token", "carry", "meta", "uninit")
CSRC = os.path.join(REPO, "defl_tpu_torch", "csrc")


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both host builds, one entry each, as ``_host_stream`` calls them."""
    d = tmp_path_factory.mktemp("decode_checked")
    plain = ctypes.CDLL(build(d))
    checked = ctypes.CDLL(build(d, checked=True))
    return types.SimpleNamespace(
        decode_stream_host=plain.decode_stream_host,
        decode_stream_host_checked=checked.decode_stream_host_checked)


def _packed(streams, zflag, cap):
    p = pack_streams(streams, zflag, cap)
    return p.words, p.nbits, p.zflag, p.dst_cap


def _both(decode, packed, **kw):
    """The unchecked and the checked host build over the same calls (the
    checked one raises on any fault), held bit for bit; the checked run."""
    plain = _until_done(decode, packed, **kw)
    checked = _until_done(decode, packed, checked=True, **kw)
    assert decode_cu.identical_decodes(plain, checked) == []
    return checked


def _loop(packed, **kw):
    return _until_done(lambda *a, **k: decode_cu.decode_tokens(
        *a, K=128, device="cpu", **k), packed, **kw)


@pytest.mark.parametrize("seed", [1, 7])
def test_checked_build_equals_unchecked_and_the_chunk_loop_on_fuzz_cases(
        libs, monkeypatch, seed):
    packed = _packed(_gen_cases(seed, 60), 1, CAP)
    got = _both(_host_stream(libs, monkeypatch, LANES), packed, T=T)
    assert decode_cu.compare_decodes(got, _loop(packed, T=T)) == 0
    assert set(got[1]["status"].tolist()) >= {0, -1, 2}


@pytest.mark.parametrize("seed", [1, 7])
def test_checked_build_through_device_inflate_holds_defl_tpus_oracle(
        libs, monkeypatch, seed):
    """The whole call with its decode on the checked host build: every lane
    the class and bytes of ``defl_tpu.core.oracle``, with both
    resolvers."""
    decode = _host_stream(libs, monkeypatch, LANES)
    monkeypatch.setattr(decode_cu, "decode_tokens",
                        lambda *a, K=None, **kw: decode(
                            *a, K=K or 512, checked=True, **kw))
    cases = _gen_cases(seed, 60)
    for resolve, flags in (("host", FLAG_ZLIB),
                           ("device", FLAG_ZLIB | FLAG_VERIFY_ADLER32)):
        res, outs, _ = tsess.device_inflate(cases, flags, dst_capacities=CAP,
                                            resolve=resolve, device="cpu")
        for i, (r, o) in enumerate(zip(res, outs)):
            wr, wo = jax_oracle(cases[i], flags, CAP)
            assert int(r) == int(wr), (resolve, i)
            if int(wr) == 0:
                assert o == wo, (resolve, i)


def test_checked_build_on_bad_codes_cut_short(libs, monkeypatch):
    packed = _packed([bytes.fromhex(h) for h in BAD_CODE_CUT_SHORT], 0, CAP)
    got = _both(_host_stream(libs, monkeypatch, LANES), packed, T=T)
    assert decode_cu.compare_decodes(got, _loop(packed, T=T)) == 0
    assert got[1]["status"].tolist() == [-1] * len(BAD_CODE_CUT_SHORT)


def test_checked_build_on_a_mixed_batch(libs, monkeypatch):
    """Every 8th lane of 64 ~1 KiB streams malformed: no fault, and the
    corpus lanes end where they end in the clean batch."""
    blocks = corpus.make_silesia_like(64 * 1024, 1024)[:64]
    streams = [zlib.compress(b, 6) for b in blocks]
    mixed, bad = corpus.mixed_batch(streams, blocks, seed=11)
    decode = _host_stream(libs, monkeypatch, LANES)
    T1 = tib.step_budget(1024)
    clean = _both(decode, _packed(streams, 1, 1024), T=T1)
    packed = _packed(mixed, 1, 1024)
    got = _both(decode, packed, T=T1)
    good = [i for i in range(64) if i not in set(bad)]
    assert decode_cu.compare_decodes(clean, got, lanes=good) == 0
    assert decode_cu.compare_decodes(got, _loop(packed, T=T1)) == 0


@pytest.mark.parametrize("seed", [5, 6])
def test_checked_build_shared_input_on_a_flipped_body(libs, monkeypatch, seed):
    """Many cursors over one corrupted body, 32 lanes to a block."""
    body = _flipped_body(seed)
    kw = large.lane_args(body.size, large._find_candidates(
        body, 0, body.size // 1024, 8 * 1024))
    plain = _host_split_decode(libs, monkeypatch, body, kw, LANES)
    got = _host_split_decode(libs, monkeypatch, body, kw, LANES, checked=True)
    assert decode_cu.identical_decodes(plain, got) == []
    T_split = kw.pop("T")
    args = (kw.pop("nbits"), kw.pop("zflag"), kw.pop("cap"))
    want = decode_cu.decode_tokens(body.copy(), *args, T=T_split, K=128,
                                   dict_len=large.WINDOW, shared_input=True,
                                   device="cpu", **kw)
    assert decode_cu.compare_decodes(got, want) == 0


def test_checked_build_with_a_dictionary(libs, monkeypatch):
    d = b"a shared preset dictionary: hello world, the quick brown fox " * 4
    pays = [b"hello world, the quick brown fox jumps " * (10 + i)
            for i in range(40)]
    streams = []
    for p in pays:
        co = zlib.compressobj(6, zlib.DEFLATED, 15, 9,
                              zlib.Z_DEFAULT_STRATEGY, zdict=d)
        streams.append(co.compress(p) + co.flush())
    packed = _packed(streams, 1, 2048)
    kw = dict(T=tib.step_budget(2048), has_dict=True,
              dict_len=pack_dictionary(d)[1])
    got = _both(_host_stream(libs, monkeypatch, LANES), packed, **kw)
    assert decode_cu.compare_decodes(got, _loop(packed, **kw)) == 0
    assert (got[1]["status"] == 0).all()


def test_checked_build_resumes_after_efull(libs, monkeypatch):
    """Capacities too small: EFULL, revive_carry with a grown capacity,
    and on to the end, in both builds alike."""
    pays = [bytes(range(256)) * 4, b"ab" * 600, b"stored " * 150]
    streams = [zlib.compress(pays[0], 6), zlib.compress(pays[1], 6),
               zlib.compress(pays[2], 0)] * 12
    packed = _packed(streams, 1, 300)
    decode = _host_stream(libs, monkeypatch, LANES)
    first = _until_done(decode, packed, checked=True, T=T)
    assert (first[1]["status"] == -105).all()
    got = _both(decode, packed, new_cap=4096, T=T)
    assert decode_cu.compare_decodes(got, _loop(packed, new_cap=4096, T=T)) \
        == 0
    assert (got[1]["status"] == 0).all()


@pytest.mark.parametrize("site", STREAM_SITES)
def test_an_injected_access_raises_with_its_site_and_lane(libs, monkeypatch,
                                                          site):
    blocks = corpus.make_silesia_like(64 * 1024, 1024)[:64]
    packed = _packed([zlib.compress(b, 6) for b in blocks], 1, 1024)
    decode = _host_stream(libs, monkeypatch, LANES)
    lane = int(decode_cu.stream_order(packed[1])[LANES + MID])
    with pytest.raises(cu_build.KernelFault) as e:
        decode(*packed, T=tib.step_budget(1024), inject=(site, lane))
    f = e.value
    assert (f.kernel, f.site, f.lane, f.block, f.slot) == \
        ("decode_stream", site, lane, 1, MID)
    # out of its extent, or (uninit) inside it but not written
    assert f.count >= 1 and (0 <= f.index < f.extent) == (site == "uninit")


@pytest.mark.parametrize("site", STREAM_SITES)
def test_an_injected_access_raises_in_shared_input_mode(libs, monkeypatch,
                                                        site):
    # blocks of ~127 symbols (memLevel 1) and 512-byte segments: 3 blocks
    # of lanes
    raw = b"".join(corpus.make_silesia_like(1 << 17, 65536))
    co = zlib.compressobj(6, zlib.DEFLATED, -15, 1)
    body = np.frombuffer(co.compress(raw) + co.flush(), np.uint8)
    kw = large.lane_args(body.size, large._find_candidates(
        body, 0, body.size // 512, 8 * 512))
    assert len(kw["nbits"]) > LANES + MID
    lane = int(decode_cu.stream_order(kw["nbits"], kw["limit"],
                                      kw["start_bit"])[LANES + MID])
    with pytest.raises(cu_build.KernelFault) as e:
        _host_split_decode(libs, monkeypatch, body, kw, LANES,
                           inject=(site, lane))
    assert (e.value.site, e.value.lane, e.value.slot) == (site, lane, MID)


#: a library with the four entry points, which g++ builds in place of
#: nvcc, and the report that stands in for ptxas's
_STUB = 'extern "C" {%s}' % "".join(
    f"int {n}_launch() {{ return 0; }} "
    for n in ("decode_stream", "decode_chunk", "adler32_batch",
              "find_starts"))
_REPORT = "ptxas info    : Used 255 registers, 64 bytes smem\n"


@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    """``build`` over a directory of its own, as a fresh process finds it,
    with g++ building a stub in nvcc's place; returns the list of the
    builds it made."""
    src = tmp_path / "stub.cc"
    src.write_text(_STUB)
    built = []

    def run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        built.append(out)
        subprocess.run(["g++", "-shared", "-fPIC", "-o", out, str(src)],
                       check=True)
        return subprocess.CompletedProcess(cmd, 0, _REPORT, "")

    monkeypatch.setattr(cu_build, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(cu_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cu_build, "subprocess",
                        types.SimpleNamespace(run=run))
    fresh = lambda: (monkeypatch.setattr(cu_build, "_libs", {}),
                     monkeypatch.setattr(cu_build, "build_log", ""),
                     monkeypatch.setattr(cu_build, "checked_build_log", ""))
    fresh()
    return types.SimpleNamespace(built=built, fresh=fresh)


@pytest.mark.parametrize("checked", [False, True])
def test_a_library_built_earlier_still_has_its_ptxas_report(stub_build,
                                                            checked):
    log = lambda: cu_build.checked_build_log if checked else \
        cu_build.build_log
    cu_build.load(checked)
    assert len(stub_build.built) == 1 and log() == _REPORT
    stub_build.fresh()                       # another process, same disk
    cu_build.load(checked)
    assert len(stub_build.built) == 1 and log() == _REPORT


def test_a_library_without_its_report_is_built_anew(stub_build):
    cu_build.load()
    os.remove(cu_build.lib_path() + ".ptxas.txt")
    stub_build.fresh()
    cu_build.load()
    assert len(stub_build.built) == 2 and cu_build.build_log == _REPORT
    assert os.path.exists(cu_build.lib_path() + ".ptxas.txt")


def test_a_fault_record_decodes_to_its_fields(monkeypatch):
    monkeypatch.setattr(cu_build, "faults", {"k": 0})
    cu_build.raise_fault("k", [0] * cu_build.FAULT_WORDS)     # no fault
    with pytest.raises(cu_build.KernelFault) as e:
        cu_build.raise_fault("k", [3, 7, 41, 1, 16, 300, 276, 0])
    assert cu_build.faults == {"k": 3}      # the record's count, summed
    f = e.value
    assert isinstance(f, RuntimeError)
    assert (f.kernel, f.count, f.site, f.lane, f.block, f.slot, f.index,
            f.extent) == ("k", 3, "uninit", 41, 1, 16, 300, 276)
    assert cu_build.site_id("adler32") == 8 and cu_build.site_id(None) == 0


def _constants(name):
    src = open(os.path.join(CSRC, name)).read()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"\b([A-Z][A-Z0-9_]*) = (-?\d+)\b", src)}


def test_the_checked_builds_constants_mirror_the_wrappers():
    h = _constants("checked.cuh")
    assert [h[f"SITE_{s}"] for s in ("SHARED", "LUT", "INPUT", "TOKEN",
                                     "CARRY", "META", "UNINIT", "ADLER",
                                     "FIND")] \
        == [cu_build.site_id(s) for s in cu_build.SITES]
    assert [h[f"F_{f.upper()}"] for f in cu_build.FAULT_FIELDS] == \
        list(range(len(cu_build.FAULT_FIELDS)))
    assert h["FAULT_WORDS"] == cu_build.FAULT_WORDS
    cu = _constants("decode_stream.cu")
    assert cu["META_WORDS"] == decode_cu.META_WORDS
    assert cu["NROWS"] == decode_cu.NROWS
    lut = (1 << cu["LIT_LUT_BITS"]) + (1 << cu["DIST_LUT_BITS"])
    assert decode_cu.SHADOW_WORDS == (cu["LANE_WORDS"] + lut + 31) // 32
    assert "checked.cuh" in cu_build.HEADERS


def test_the_checked_build_is_refused_off_the_card():
    packed = _packed([zlib.compress(b"x" * 100)], 1, 1024)
    for kw in ({"checked": True}, {"inject": ("token", 0)}):
        with pytest.raises(ValueError):
            decode_cu.decode_tokens(*packed, T=T, device="cpu", **kw)


#: the modules that define the checked launches; every other module of the
#: port, the main path among them, must never ask for one
_WRAPPERS = {"ops/cuda/build.py", "ops/cuda/decode_cu.py",
             "ops/cuda/checksums_cu.py", "ops/cuda/find_cu.py"}


def test_no_module_of_the_port_asks_for_the_checked_build():
    root = os.path.join(REPO, "defl_tpu_torch")
    seen = 0
    for d, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root)
            if not f.endswith(".py") or rel in _WRAPPERS:
                continue
            seen += 1
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call):
                    kws = {k.arg for k in node.keywords}
                    assert not kws & {"checked", "inject"}, (rel, node.lineno)
                    fn = node.func
                    if isinstance(fn, ast.Attribute) and fn.attr == "load" \
                            and isinstance(fn.value, ast.Name) \
                            and fn.value.id == "build":
                        assert not node.args, (rel, node.lineno)
                # reading the checked counts is fine (the bench logs them);
                # setting them could hide a checked launch
                if isinstance(node, ast.Attribute) \
                        and not isinstance(node.ctx, ast.Load):
                    assert node.attr not in ("checked_launches",
                                             "checked_chunk_launches",
                                             "faults"), rel
    assert seen > 20
