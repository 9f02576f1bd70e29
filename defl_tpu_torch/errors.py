"""Result codes and exceptions (the port's own copy of ``defl_tpu/errors.py``).

Mirrors the reference's errors-as-values protocol (`UnzResult`,
the reference's `include/defl/common.h:80-90`): decode APIs return a status
per stream rather than raising, so one malformed stream in a batch cannot
poison the rest.  Exceptions are reserved for API misuse (wrong types,
invalid arguments), matching how the reference returns -EPERM/-EBADF for
bad handles but never aborts.
"""

from __future__ import annotations

import enum
import errno


class Result(enum.IntEnum):
    """Status codes (reference parity: include/defl/common.h:80-90)."""

    #: More input is required to make progress (streaming).
    UNFINISHED = 2
    #: The call had nothing to do (e.g. empty feed with no in-flight state).
    NOOP = 1
    #: Success.
    OK = 0
    #: Malformed stream (bad block, bad code, bad header, LEN/NLEN mismatch,
    #: distance too far back, oversubscribed Huffman tree, ...).
    ERR = -1
    #: Unsupported-but-valid feature found (reference rejects zlib FDICT
    #: this way; we accept FDICT when a dictionary is supplied).
    EFOUND = -1000
    #: Out of memory.
    ENOMEM = -errno.ENOMEM
    #: Operation not permitted in the current state.
    EPERM = -errno.EPERM
    #: Bad stream handle / bad argument.
    EBADF = -errno.EBADF
    #: Output buffer full; grow it (resize_output) and continue.
    EFULL = -errno.ENOBUFS


class DeflError(Exception):
    """Raised by convenience wrappers when a decode fails hard."""

    def __init__(self, result: Result, message: str = ""):
        self.result = Result(result)
        super().__init__(f"{self.result.name}: {message}" if message else self.result.name)


#: Flag accepted by inflate entry points: input carries a zlib (RFC 1950)
#: wrapper around the raw DEFLATE data.  (reference: INFL_ZLIB,
#: include/defl/common.h:99)
FLAG_ZLIB = 1
#: Extension (not in reference): verify the zlib adler32 trailer.  The
#: reference never checks the trailer (no adler code exists there at all);
#: this is off by default for behavioural parity.
FLAG_VERIFY_ADLER32 = 2
