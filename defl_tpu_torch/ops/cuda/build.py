"""Build the port's CUDA kernels with nvcc at first use, and load them.

The sources under ``defl_tpu_torch/csrc/`` compile into one shared
library with a plain C interface, loaded with ctypes (the pattern of
``defl_tpu_torch/runtime/native.py``).  The library is named by a hash of the
sources, so an edited source builds anew and a stale library is never
loaded.  A failed build raises with nvcc's own messages.  nvcc's ptxas
report is kept beside each library (``<library>.ptxas.txt``) and read back
with it, so a library built by an earlier process still has its report.

``load(checked=True)`` is the checked build of the same sources
(``-DDEFL_CHECKED -lineinfo``, ``csrc/checked.cuh``): every access of the
kernels to device and shared memory is checked against its extent, and the
stream kernel keeps a shadow of which shared words and lookup entries the
launch has written.  Its entry points take a fault record, the stream
kernel's shadows, and one fault to inject; ``raise_fault`` reads the record
after the wrapper's sync.  The main path never loads it: only a caller that
passes ``checked=True`` to a wrapper does (chip_smoke.py [13], the tests).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_BUILD = os.path.join(_CSRC, "build")
SOURCES = ("decode_stream.cu", "adler32_batch.cu", "find_starts.cu")
HEADERS = ("checked.cuh",)
ARCH = "arch=compute_90a,code=sm_90a"
CHECKED_FLAGS = ("-DDEFL_CHECKED", "-lineinfo")

#: the checked build's sites, csrc/checked.cuh SITE_* in order from 1
SITES = ("shared", "lut", "input", "token", "carry", "meta", "uninit",
         "adler32", "find")
#: int64 words of a fault record: faults counted, then the first one's
#: site, lane, block, slot, index and extent (csrc/checked.cuh F_*)
FAULT_WORDS = 8
FAULT_FIELDS = ("count", "site", "lane", "block", "slot", "index", "extent")

# one lock a library: the two builds may run side by side
_locks = {False: threading.Lock(), True: threading.Lock()}
_libs = {}
#: nvcc's ptxas report (registers, spills) of the loaded library, and the
#: build's wall seconds; build_seconds stays 0.0 when the library was
#: already built
build_log = ""
build_seconds = 0.0
#: the same of the checked library
checked_build_log = ""
checked_build_seconds = 0.0
#: faults that checked launches found, by kernel: the count word of each
#: fault record that ``raise_fault`` read
faults = {"decode_stream": 0, "decode_chunk": 0, "adler32_batch": 0,
          "find_starts": 0}
_faults_lock = threading.Lock()


class KernelFault(RuntimeError):
    """A checked launch's first fault: ``kernel``, ``count`` (faults in the
    launch), ``site`` (a name of ``SITES``), ``lane``, ``block``, ``slot``,
    ``index`` and ``extent``."""

    def __init__(self, kernel: str, record: dict):
        self.kernel = kernel
        self.__dict__.update(record)
        super().__init__(
            f"{kernel}: {record['count']} out-of-extent or uninitialised "
            f"access(es); the first at site {record['site']!r}, lane "
            f"{record['lane']} (block {record['block']}, slot "
            f"{record['slot']}), index {record['index']} of extent "
            f"{record['extent']}")


def raise_fault(kernel: str, words) -> None:
    """Add a fault record's count (its ``FAULT_WORDS`` int64 words, as read
    from the card) to ``faults[kernel]``, and raise ``KernelFault`` when it
    counts a fault."""
    rec = dict(zip(FAULT_FIELDS, (int(w) for w in words)))
    with _faults_lock:
        faults[kernel] = faults.get(kernel, 0) + rec["count"]
    if rec["count"]:
        site = rec["site"]
        rec["site"] = SITES[site - 1] if 1 <= site <= len(SITES) else site
        raise KernelFault(kernel, rec)


def site_id(site: str | None) -> int:
    """The id a checked launch takes for an injected ``site``; 0: none."""
    return 0 if site is None else SITES.index(site) + 1


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build from source at first use")
    return found


def lib_path(checked: bool = False) -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(ARCH.encode())
    tag = "_checked" if checked else ""
    return os.path.join(_BUILD,
                        f"libdefl_tpu_torch_{h.hexdigest()[:16]}{tag}.so")


def _report_path(path: str) -> str:
    return path + ".ptxas.txt"


def _build(path: str, checked: bool) -> None:
    global build_seconds, checked_build_seconds
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    # --threads 0 lets nvcc run independent compile steps in parallel
    cmd = [_nvcc(), "--threads", "0", "-gencode", ARCH, "-std=c++17", "-O3",
           *(CHECKED_FLAGS if checked else ()),
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
           *[os.path.join(_CSRC, s) for s in SOURCES]]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    # the report first, each file by an atomic rename: a library on disk
    # always has its report, and a concurrent build never sees a partial
    with open(f"{_report_path(path)}.{os.getpid()}.tmp", "w") as f:
        f.write(r.stdout + r.stderr)
    os.replace(f.name, _report_path(path))
    os.replace(tmp, path)
    secs = time.perf_counter() - t0
    if checked:
        checked_build_seconds = secs
    else:
        build_seconds = secs


def load(checked: bool = False):
    """The loaded library (with ``checked``, the checked build), building it
    first if needed (or if its ptxas report is missing); sets
    ``build_log`` (``checked_build_log``) to its report."""
    global build_log, checked_build_log
    with _locks[checked]:
        if checked in _libs:
            return _libs[checked]
        path = lib_path(checked)
        if not (os.path.exists(path) and os.path.exists(_report_path(path))):
            _build(path, checked)
        with open(_report_path(path)) as f:
            if checked:
                checked_build_log = f.read()
            else:
                build_log = f.read()
        lib = ctypes.CDLL(path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        extra = [p, p, i, i, i] if checked else []
        lib.decode_stream_launch.restype = i
        lib.decode_stream_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, p,
                                             p, p, i, i, i, i, i, p, i,
                                             *extra]
        lib.decode_chunk_launch.restype = i
        lib.decode_chunk_launch.argtypes = [p, p, p, i, i, p, p, p, p, p, i,
                                            i, i, p, i,
                                            *([p, i, i] if checked else [])]
        lib.adler32_batch_launch.restype = i
        lib.adler32_batch_launch.argtypes = [p, ll, i, i, p, p, p, i,
                                             *([p, i] if checked else [])]
        lib.find_starts_launch.restype = i
        lib.find_starts_launch.argtypes = [p, p, i, p, p, i,
                                           *([p, i] if checked else [])]
        _libs[checked] = lib
        return lib
