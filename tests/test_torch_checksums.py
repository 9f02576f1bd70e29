"""The port's batched adler32 on the CPU against the JAX package's.

``adler32_batch_ref`` (the plain PyTorch version of the CUDA kernel
``csrc/adler32_batch.cu``) is held against
``defl_tpu.ops.checksums.adler32_batch``, against the Pallas kernel in
interpret mode (as ``tests/test_device_inflate.py`` runs it on the CPU)
and against ``zlib.adler32``, on the same numpy inputs from a seed.
Tolerance 0: a checksum is exact.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from defl_tpu.ops.checksums import adler32_batch as j_adler32_batch
from defl_tpu.ops.pallas.checksums_pl import adler32_batch_pallas
from defl_tpu_torch.ops import checksums as tck
from defl_tpu_torch.ops.bitio import i32_to_u32, u32_to_i32
from defl_tpu_torch.ops.cuda import checksums_cu


def _matrix(C, seed=3):
    """Rows and lengths around the edges: empty, tiny, around the TPU
    kernel's 3072-byte slab, the whole row; random bytes and all-0xFF
    rows (the largest sums)."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, 2, 15, 16, 17, 3071, 3072, 3073, C - 1, C, C, C // 2]
    data = rng.integers(0, 256, (len(lens), C), dtype=np.uint8)
    data[-2:] = 0xFF
    return data, np.asarray(lens, np.int32)


def _zlib(data, lens):
    return [zlib.adler32(data[i, : lens[i]].tobytes())
            for i in range(len(lens))]


@pytest.mark.parametrize("C", [6144, 6001])
def test_ref_matches_jax_and_zlib(C):
    data, lens = _matrix(C)
    got = tck.adler32_batch_ref(torch.from_numpy(data),
                                torch.from_numpy(lens))
    assert got.dtype == torch.int64 and got.shape == (len(lens),)
    want = np.asarray(j_adler32_batch(jnp.asarray(data), jnp.asarray(lens)))
    assert got.tolist() == [int(v) for v in want] == _zlib(data, lens)


def test_ref_matches_pallas_kernel_interpreted():
    data, lens = _matrix(6144)
    got = tck.adler32_batch_ref(torch.from_numpy(data),
                                torch.from_numpy(lens))
    want = np.asarray(adler32_batch_pallas(jnp.asarray(data),
                                           jnp.asarray(lens), interpret=True))
    assert got.tolist() == [int(v) for v in want]


@pytest.mark.parametrize("C", [1, 4095, 4096, 4097, 9001])
def test_ref_across_its_own_slabs(C):
    """The plain version walks 4096-byte slabs; widths around them."""
    rng = np.random.default_rng(C)
    data = rng.integers(0, 256, (5, C), dtype=np.uint8)
    lens = np.asarray([C, C // 2, 0, max(C - 1, 0), min(C, 4096)], np.int32)
    got = tck.adler32_batch_ref(torch.from_numpy(data),
                                torch.from_numpy(lens))
    assert got.tolist() == _zlib(data, lens)


def test_lengths_are_clipped_to_the_row():
    """A length over C never reads past the row: it counts as C.  Negative
    lengths count as 0.  (The JAX function is not defined there: it
    checksums its zero padding.)"""
    data, _ = _matrix(600)
    lens = np.asarray([601, 1 << 30, -1, -(1 << 30)] + [600] * 9, np.int32)
    got = tck.adler32_batch_ref(torch.from_numpy(data),
                                torch.from_numpy(lens))
    assert got.tolist() == _zlib(data, np.clip(lens, 0, 600))
    assert got[2] == 1 and got[3] == 1


def test_values_over_2_to_31_survive_as_u32():
    data = np.full((2, 4096), 0xFF, np.uint8)
    lens = np.asarray([4096, 300], np.int32)
    got = tck.adler32_batch_ref(torch.from_numpy(data),
                                torch.from_numpy(lens))
    want = _zlib(data, lens)
    assert want[0] >= 2 ** 31            # the case this test is about
    assert got.tolist() == want
    # the kernel hands the same bits over as int32; the round trip is exact
    as_i32 = u32_to_i32(got)
    assert as_i32.dtype == torch.int32 and int(as_i32[0]) < 0
    assert i32_to_u32(as_i32).tolist() == want


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """``adler32_batch`` chooses by where the data lies: CPU tensors run
    the plain version and never reach the kernel's wrapper."""
    def boom(*a, **k):
        raise AssertionError("the kernel wrapper was called for a CPU tensor")

    monkeypatch.setattr(checksums_cu, "adler32_batch_cuda", boom)
    data, lens = _matrix(6001)
    wide = np.zeros((len(lens), 6001 + 67), np.uint8)
    wide[:, 3:3 + 6001] = data
    sliced = torch.from_numpy(wide)[:, 3:3 + 6001]   # strided, unaligned
    assert not sliced.is_contiguous()
    for d in (torch.from_numpy(data), sliced):
        got = tck.adler32_batch(d, torch.from_numpy(lens))
        assert got.tolist() == _zlib(data, lens)
        assert tck.adler32_batch(d, torch.from_numpy(lens).long()).tolist() \
            == got.tolist()
    assert checksums_cu.launches == 0


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The wrapper launches the kernel or raises; it has no other way.
    Every check comes before the build, so it can be tested without a
    card."""
    data = torch.zeros((2, 64), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        checksums_cu.adler32_batch_cuda(data, lens)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        checksums_cu.adler32_batch_cuda(data.to(meta), lens.to(meta))
    assert checksums_cu.launches == 0
    assert checksums_cu.MAX_ROW_BYTES == 1 << 30
