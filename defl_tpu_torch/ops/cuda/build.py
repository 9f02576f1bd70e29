"""Build the port's CUDA kernels with nvcc at first use, and load them.

The sources under ``defl_tpu_torch/csrc/`` compile into one shared
library with a plain C interface, loaded with ctypes (the pattern of
``defl_tpu_torch/runtime/native.py``).  The library is named by a hash of the
sources, so an edited source builds anew and a stale library is never
loaded.  A failed build raises with nvcc's own messages.
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
SOURCES = ("decode_stream.cu", "adler32_batch.cu")
ARCH = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib = None
#: nvcc's ptxas report (registers, spills) and the build's wall seconds;
#: build_seconds stays 0.0 when the library was already built
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build from source at first use")
    return found


def lib_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(ARCH.encode())
    return os.path.join(_BUILD, f"libdefl_tpu_torch_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    global build_log, build_seconds
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    # --threads 0 lets nvcc run independent compile steps in parallel
    cmd = [_nvcc(), "--threads", "0", "-gencode", ARCH, "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
           *[os.path.join(_CSRC, s) for s in SOURCES]]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees a partial
    build_seconds = time.perf_counter() - t0
    build_log = r.stdout + r.stderr


def load():
    """The loaded library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.decode_stream_launch.restype = i
        lib.decode_stream_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, p,
                                             p, p, i, i, i, i, i, p, i]
        lib.decode_chunk_launch.restype = i
        lib.decode_chunk_launch.argtypes = [p, p, p, i, i, p, p, p, p, p, i,
                                            i, i, p, i]
        lib.adler32_batch_launch.restype = i
        lib.adler32_batch_launch.argtypes = [p, ll, i, i, p, p, p, i]
        _lib = lib
        return _lib
