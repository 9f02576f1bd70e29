"""defl_tpu_torch — the PyTorch / CUDA port of defl_tpu's batched inflate.

It runs the batched inflate on an NVIDIA H100: streams are packed on the
host and decoded to tokens on the card by a CUDA kernel written by hand
for Hopper (``csrc/decode_stream.cu``: one launch a decode, Huffman
tables built on the card in shared memory).  The tokens resolve to bytes
either in the C++ host resolver (the main path) or on the card
(``ops/resolve.py``), where a second hand-written kernel
(``csrc/adler32_batch.cu``) checks the zlib trailers.  ``defl_tpu`` stays
the reference; this package stands on its own host tier and imports
neither jax nor anything of ``defl_tpu``.

Layers (module names follow ``defl_tpu``)
------
- ``api``                    ``inflate_batch``
- ``runtime.pipeline``       overlapped decode ‖ host resolve
- ``runtime.session``        one batch: pack, decode, EFULL resume, then
                             fetch + host resolve or device resolve +
                             device checksums, host retry
- ``runtime.stream_device``  ``DeviceInflateSession``: incremental feeds
                             over a resumable carry
- ``ops.cuda.decode_cu``     the decode: stream kernel wrapper, its plain
                             version (chunk loop over the twin), comparator
- ``ops.checksums``, ``ops.cuda.checksums_cu``
                             batched adler32: plain version, kernel wrapper
- ``ops.resolve``            tokens -> bytes on the device
- ``ops.cuda.build``         nvcc build at first use, ctypes loader
- ``ops.inflate_batch``      carry, token format, table builds
- ``ops.tables``/``bitio``   canonical-Huffman build, bit primitives
- ``convert``                carry and session conversion to and from
                             ``defl_tpu``
- host tier: ``errors``, ``constants``, ``metrics``, ``core`` (oracle,
  huffman, checksums), ``runtime.pack``, ``runtime.native`` (g++ build of
  ``csrc/defl_host.cc`` at first use), ``corpus``
"""

from defl_tpu_torch.errors import Result
from defl_tpu_torch.api import inflate_batch
from defl_tpu_torch.runtime.pipeline import pipeline_inflate
from defl_tpu_torch.runtime.session import device_inflate
from defl_tpu_torch.runtime.stream_device import DeviceInflateSession

__all__ = ["Result", "inflate_batch", "device_inflate", "pipeline_inflate",
           "DeviceInflateSession"]
