# Copied from bzip2_tpu/bitstream.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""MSB-first bit stream utilities.

.bz2 is a continuous MSB-first bit stream; blocks are *not* byte-aligned
(reference bsW/compress.c:58-86 writes one continuous buffer).  We therefore
represent partial streams as ``(bytes, nbits)`` pairs and provide:

* ``BitWriter`` — append scalar fields (headers) and bit arrays;
* ``BitReader`` — scalar reads for header parsing (``recover``);
* ``splice`` — concatenate bit buffers at arbitrary bit offsets (vectorized
  byte shifting), used to merge independently-encoded blocks (possibly coming
  back from different TPU devices/hosts) into one stream.
"""
from __future__ import annotations

import numpy as np


class BitWriter:
    def __init__(self) -> None:
        self._chunks: list[np.ndarray] = []   # uint8 arrays, fully packed
        self._nbits_chunks = 0
        self._acc = 0        # pending bits, MSB-aligned within _accn bits
        self._accn = 0

    def _flush_acc_bytes(self) -> None:
        nbytes = self._accn // 8
        if nbytes:
            top = self._acc >> (self._accn - nbytes * 8)
            arr = np.frombuffer(top.to_bytes(nbytes, "big"), np.uint8)
            self._chunks.append(arr)
            self._nbits_chunks += nbytes * 8
            self._accn -= nbytes * 8
            self._acc &= (1 << self._accn) - 1

    def write(self, value: int, nbits: int) -> None:
        assert 0 <= nbits <= 64 and 0 <= value < (1 << nbits) if nbits else value == 0
        self._acc = (self._acc << nbits) | value
        self._accn += nbits
        if self._accn >= 64:
            self._flush_acc_bytes()

    def write_bits_array(self, data: np.ndarray, nbits: int) -> None:
        """Append ``nbits`` bits stored MSB-first in ``data`` (uint8)."""
        if nbits == 0:
            return
        self._flush_acc_bytes()  # leaves 0..7 pending bits
        if self._accn == 0:
            full = nbits // 8
            self._chunks.append(np.ascontiguousarray(data[:full]))
            self._nbits_chunks += full * 8
            rem = nbits - full * 8
            if rem:
                self._acc = int(data[full]) >> (8 - rem)
                self._accn = rem
            return
        # Unaligned: shift the incoming byte array right by _accn bits and
        # OR the boundary byte, vectorized.
        k = self._accn
        nbytes = (nbits + 7) // 8
        d = data[:nbytes].astype(np.uint16)
        shifted = np.empty(nbytes + 1, np.uint8)
        shifted[0] = (d[0] >> k).astype(np.uint8)
        if nbytes > 1:
            carry = ((d[:-1] << (8 - k)) & 0xFF).astype(np.uint8)
            shifted[1:-1] = ((d[1:] >> k).astype(np.uint8)) | carry
        shifted[-1] = ((d[-1] << (8 - k)) & 0xFF).astype(np.uint8)
        # First byte merges with pending accumulator bits.
        head = (self._acc << (8 - k)) & 0xFF
        shifted[0] |= head
        total_bits = k + nbits
        full = total_bits // 8
        self._acc = 0
        self._accn = 0
        self._chunks.append(shifted[:full])
        self._nbits_chunks += full * 8
        rem = total_bits - full * 8
        if rem:
            self._acc = int(shifted[full]) >> (8 - rem)
            self._accn = rem

    @property
    def nbits(self) -> int:
        return self._nbits_chunks + self._accn

    def getvalue(self) -> tuple[np.ndarray, int]:
        """Return (packed uint8 array, bit length); pads the tail with zeros."""
        nbits = self.nbits
        self._flush_acc_bytes()
        parts = list(self._chunks)
        if self._accn:
            tail = (self._acc << (8 - self._accn)) & 0xFF
            parts.append(np.array([tail], np.uint8))
        buf = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        return buf, nbits

    def tobytes(self) -> bytes:
        return self.getvalue()[0].tobytes()


def splice(parts: list[tuple[np.ndarray, int]]) -> tuple[np.ndarray, int]:
    """Bit-concatenate (bytes, nbits) parts into one buffer."""
    w = BitWriter()
    for data, nbits in parts:
        w.write_bits_array(np.asarray(data, np.uint8), nbits)
    return w.getvalue()


class BitReader:
    """Scalar MSB-first reader over a byte buffer (header parsing)."""

    def __init__(self, data, start_bit: int = 0) -> None:
        self.data = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
        self.pos = start_bit          # absolute bit position
        self.nbits = self.data.size * 8

    def read(self, n: int) -> int:
        if self.pos + n > self.nbits:
            raise EOFError("bitstream exhausted")
        out = 0
        pos = self.pos
        need = n
        while need:
            byte = int(self.data[pos >> 3])
            avail = 8 - (pos & 7)
            take = min(avail, need)
            out = (out << take) | ((byte >> (avail - take)) & ((1 << take) - 1))
            pos += take
            need -= take
        self.pos = pos
        return out

    def peek(self, n: int) -> int:
        save = self.pos
        try:
            return self.read(n)
        finally:
            self.pos = save

    def byte_align_remainder(self) -> int:
        return (-self.pos) % 8
