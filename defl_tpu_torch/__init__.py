"""defl_tpu_torch — the PyTorch / CUDA port of defl_tpu.

It runs the batched inflate on an NVIDIA H100: streams are packed on the
host and decoded to tokens on the card by a CUDA kernel written by hand
for Hopper (``csrc/decode_stream.cu``: one launch a decode, Huffman
tables built on the card into shared memory).  The tokens resolve to bytes
either in the C++ host resolver (the main path) or on the card
(``ops/resolve.py``), where a second hand-written kernel
(``csrc/adler32_batch.cu``) checks the zlib trailers.  One huge stream is
split at block starts the host finds and decoded by the same kernel, every
lane reading the one body on the card (``runtime/large.py``); batches are
encoded by the C++ host engine with the Huffman bit-pack on the card
(``ops/huffman_pack.py``).  A batch shards over several cards and over
the ranks of a ``torch.distributed`` group (``parallel/``).  ``defl_tpu``
stays the reference; this package stands on its own host tier and imports
neither jax nor anything of ``defl_tpu``.

Layers (module names follow ``defl_tpu``)
------
- ``api``                    ``InflateStream``, ``inflate_buffer``,
                             ``DeflateStream``, ``deflate_buffer`` (host
                             engines), ``inflate_batch``, ``deflate_batch``
- ``parallel``               ``DistributedCodec``: the stream mesh
                             (``mesh``), one ``device_inflate`` per local
                             shard, dictionary broadcast and reduced stats
                             (``shard``), process groups (``multihost``)
- ``runtime.pipeline``       overlapped decode ‖ host resolve
- ``runtime.session``        one batch: pack, decode, EFULL resume, then
                             fetch + host resolve or device resolve +
                             device checksums, host retry
                             and ``device_deflate``: host fields, bit-pack
                             on the device, host compact
- ``runtime.large``          ``inflate_large``: find block starts, upload
                             the body once, split decode, stitch
- ``runtime.stream_device``  ``DeviceInflateSession``: incremental feeds
                             over a resumable carry
- ``ops.cuda.decode_cu``     the decode: stream kernel wrapper, its plain
                             version (chunk loop over the twin), comparator
- ``ops.checksums``, ``ops.cuda.checksums_cu``
                             batched adler32: plain version, kernel wrapper
- ``ops.resolve``            tokens -> bytes on the device
- ``ops.huffman_pack``       fields -> packed words / reservoir slots
- ``ops.cuda.build``         nvcc build at first use, ctypes loader
- ``ops.inflate_batch``      carry, token format, table builds
- ``ops.tables``/``bitio``   canonical-Huffman build, bit primitives
- ``convert``                carry and session conversion to and from
                             ``defl_tpu``
- host tier: ``errors``, ``constants``, ``metrics``, ``core`` (oracle,
  huffman, checksums, deflate_ref), ``runtime.pack``, ``runtime.native``
  (g++ build of ``csrc/defl_host.cc`` at first use), ``corpus``, ``cli``
- entry points: ``bench_scaling`` (shard1 against shardN, the sharding's
  overhead), ``dryrun`` (``entry``, ``dryrun_multichip``, spawned workers)

On the CPU (no card): ``python -m pytest tests/test_torch_*.py -q``.  On
the card: ``python3 chip_smoke.py``, ``python -m pytest
tests/test_torch_cuda.py -q --noconftest``, and ``python -m
defl_tpu_torch.breakdown`` with ``--large`` or ``--deflate``.
"""

from defl_tpu_torch.errors import (FLAG_VERIFY_ADLER32, FLAG_ZLIB, DeflError,
                                   Result)
from defl_tpu_torch.api import (DeflateStream, InflateStream, deflate_batch,
                                deflate_buffer, inflate_batch, inflate_buffer)
from defl_tpu_torch.parallel.shard import DistributedCodec
from defl_tpu_torch.runtime.large import inflate_large
from defl_tpu_torch.runtime.pipeline import pipeline_inflate
from defl_tpu_torch.runtime.session import device_deflate, device_inflate
from defl_tpu_torch.runtime.stream_device import DeviceInflateSession

__all__ = ["Result", "DeflError", "FLAG_ZLIB", "FLAG_VERIFY_ADLER32",
           "InflateStream", "inflate_buffer", "DeflateStream",
           "deflate_buffer", "inflate_batch", "deflate_batch",
           "inflate_large", "device_inflate", "device_deflate",
           "pipeline_inflate", "DeviceInflateSession", "DistributedCodec"]
