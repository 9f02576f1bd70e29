"""DEFLATE / zlib format constants (RFC 1951 / RFC 1950).

The port's own copy of ``defl_tpu/constants.py``; every value is tested
against the JAX package's.

These are the framework's equivalent of the reference's constant tables
(the reference's `src/infl/apicommon.h:36-64`): length/distance extra-bit
tables, the code-length permutation order, and the fixed-Huffman code
lengths.  They are defined here once, as plain tuples and NumPy arrays, and
reused by the host oracle, the lockstep decoder and its CUDA kernel's wrapper.
"""

from __future__ import annotations

import numpy as np

# --- Block types (RFC 1951 §3.2.3) -----------------------------------------
BTYPE_STORED = 0
BTYPE_FIXED = 1
BTYPE_DYNAMIC = 2

# --- Alphabet sizes ---------------------------------------------------------
MAX_CODELEN_CODES = 19     # code-length alphabet (symbols 0..18)
MAX_LITLEN_CODES = 288     # literal/length alphabet (0..287; 286/287 illegal)
MAX_DIST_CODES = 32        # distance alphabet (0..31; 30/31 illegal)
MAX_CODE_LENGTH = 15       # longest Huffman code in any DEFLATE alphabet
MAX_CODELEN_LENGTH = 7     # longest code in the code-length alphabet
END_OF_BLOCK = 256         # litlen symbol terminating a block
MAX_MATCH = 258
MIN_MATCH = 3
MAX_DIST = 32768
WINDOW_SIZE = 32768

# --- Length codes (litlen symbols 257..285) ---------------------------------
# base match length and number of extra bits per symbol
# (reference: lvals[] at apicommon.h:36-41)
LENGTH_BASE = (
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
    35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258,
)
LENGTH_EXTRA = (
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
    3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0,
)

# --- Distance codes (dist symbols 0..29) ------------------------------------
# (reference: dvals[] at apicommon.h:43-49)
DIST_BASE = (
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
    257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145,
    8193, 12289, 16385, 24577,
)
DIST_EXTRA = (
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6,
    7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13,
)

# --- Code-length code order (RFC 1951 §3.2.7) -------------------------------
# (reference: ord[] at apicommon.h:52)
CODELEN_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)

# --- Fixed Huffman code lengths (RFC 1951 §3.2.6) ---------------------------
# (reference: fxd[320] at apicommon.h:53-64)
FIXED_LITLEN_LENGTHS = tuple(
    [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
)
FIXED_DIST_LENGTHS = tuple([5] * 32)

# --- zlib wrapper (RFC 1950) ------------------------------------------------
ZLIB_CM_DEFLATE = 8
ZLIB_MAX_CINFO = 7          # 32K window max (reference zlib.h:70-86)
ZLIB_FLAG_FDICT = 0x20

# --- NumPy views of the tables (shared by oracle / encoder / device path) ---
LENGTH_BASE_NP = np.asarray(LENGTH_BASE, dtype=np.int32)
LENGTH_EXTRA_NP = np.asarray(LENGTH_EXTRA, dtype=np.int32)
DIST_BASE_NP = np.asarray(DIST_BASE, dtype=np.int32)
DIST_EXTRA_NP = np.asarray(DIST_EXTRA, dtype=np.int32)
CODELEN_ORDER_NP = np.asarray(CODELEN_ORDER, dtype=np.int32)
FIXED_LITLEN_LENGTHS_NP = np.asarray(FIXED_LITLEN_LENGTHS, dtype=np.int32)
FIXED_DIST_LENGTHS_NP = np.asarray(FIXED_DIST_LENGTHS, dtype=np.int32)

# Reverse mapping: match length (3..258) -> length symbol (257..285),
# and extra-bit payload.  Used by the encoder.
_len_to_sym = np.zeros(MAX_MATCH + 1, dtype=np.int32)
for _s, (_base, _eb) in enumerate(zip(LENGTH_BASE, LENGTH_EXTRA)):
    _hi = _base + (1 << _eb) - 1
    if _s == len(LENGTH_BASE) - 1:      # symbol 285: length 258 only
        _hi = _base
    _len_to_sym[_base : min(_hi, MAX_MATCH) + 1] = 257 + _s
_len_to_sym[MAX_MATCH] = 285
LENGTH_TO_SYMBOL_NP = _len_to_sym

# Reverse mapping: distance (1..32768) -> distance symbol (0..29).
_dist_to_sym = np.zeros(MAX_DIST + 1, dtype=np.int32)
for _s, (_base, _eb) in enumerate(zip(DIST_BASE, DIST_EXTRA)):
    _hi = _base + (1 << _eb) - 1
    _dist_to_sym[_base : min(_hi, MAX_DIST) + 1] = _s
DIST_TO_SYMBOL_NP = _dist_to_sym
