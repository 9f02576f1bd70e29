"""Tests of the benchmark's own files, on the CPU.  The checkout's root
heads the path so that ``codec_bench`` and the program import."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "needs_cuda: runs only where torch sees a CUDA card")
