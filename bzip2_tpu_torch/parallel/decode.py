"""Magic scans of .bz2 streams for the port's decoder.

``find_bit_magics`` is copied from ``bzip2_tpu/parallel/decode.py``: the
decoder's parse pool takes every 48-bit block-magic candidate from it.
"""
from __future__ import annotations

import numpy as np


def find_bit_magics(data, magic: int) -> np.ndarray:
    """Bit offsets of every occurrence of a 48-bit magic (any bit phase) —
    the vectorized form of bzip2recover's bit-serial scan
    (bzip2recover.c:367-410)."""
    b = np.frombuffer(data, np.uint8).astype(np.uint64) if not isinstance(
        data, np.ndarray) else data.astype(np.uint64)
    n = b.size
    if n < 7:
        return np.zeros(0, np.int64)
    w = np.zeros(n - 6, np.uint64)
    for k in range(7):
        w = (w << np.uint64(8)) | b[k: n - 6 + k]
    mask = np.uint64((1 << 48) - 1)
    hits = []
    for s in range(8):
        val = (w >> np.uint64(8 - s)) & mask
        pos = np.flatnonzero(val == np.uint64(magic))
        hits.append(pos.astype(np.int64) * 8 + s)
    return np.sort(np.concatenate(hits))
