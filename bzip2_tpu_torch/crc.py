# Copied from bzip2_tpu/crc.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""MSB-first CRC-32 (AUTODIN-II polynomial 0x04c11db7) as used by .bz2.

The format updates the CRC as ``crc = (crc << 8) ^ T[(crc >> 24) ^ byte]``
with init 0xFFFFFFFF and final complement (reference bzlib_private.h:187-202).
This is CRC-32/BZIP2: the non-reflected twin of zlib's CRC-32, so we compute
it at C speed by bit-reversing input bytes (vectorized 256-entry gather) and
bit-reversing zlib's 32-bit result.  Per-block CRCs fold into the stream
"combined CRC" via rotl1 ^ blockCRC (compress.c:826-828), an associative,
shard-friendly reduction.
"""
from __future__ import annotations

import zlib

import numpy as np

_POLY = 0x04C11DB7


def _make_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint64) << 24
    for _ in range(8):
        t = np.where(t & 0x80000000, ((t << 1) ^ _POLY), t << 1) & 0xFFFFFFFF
    return t.astype(np.uint32)


TABLE = _make_table()  # byte-at-a-time table, for slow-path / device use

_REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint8)
_REV32_HI = {}


def _rev32(x: int) -> int:
    return int(f"{x & 0xFFFFFFFF:032b}"[::-1], 2)


def reverse_bytes(data) -> bytes:
    arr = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    return _REV8[arr].tobytes()


def crc32(data) -> int:
    """Finalized bz2-style CRC of a whole buffer."""
    return _rev32(zlib.crc32(reverse_bytes(data)) & 0xFFFFFFFF)


class CRC32:
    """Incremental bz2-style CRC (state kept in the zlib domain)."""

    __slots__ = ("_z",)

    def __init__(self) -> None:
        self._z = 0

    def update(self, data) -> None:
        self._z = zlib.crc32(reverse_bytes(data), self._z)

    def update_repeated(self, byte: int, count: int) -> None:
        """Feed ``count`` copies of one byte (RLE1 runs) without materializing
        large buffers for huge runs."""
        if count <= 0:
            return
        chunk = bytes([_REV8[byte]]) * min(count, 1 << 16)
        while count > 0:
            take = min(count, 1 << 16)
            self._z = zlib.crc32(chunk[:take], self._z)
            count -= take

    def digest(self) -> int:
        return _rev32(self._z)


def crc32_slow(data, init: int = 0xFFFFFFFF) -> int:
    """Bit-faithful byte-at-a-time model of the format's update recurrence
    (used by tests to pin the fast path)."""
    c = init
    for b in bytes(data):
        c = ((c << 8) & 0xFFFFFFFF) ^ int(TABLE[((c >> 24) ^ b) & 0xFF])
    return c ^ 0xFFFFFFFF


def combine_block_crcs(block_crcs) -> int:
    """Stream CRC fold: combined = rotl1(combined) ^ blockCRC, per block."""
    c = 0
    for b in block_crcs:
        c = (((c << 1) | (c >> 31)) & 0xFFFFFFFF) ^ int(b)
    return c
