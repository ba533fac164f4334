# Copied from bzip2_tpu/rle1.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""RLE1: bzip2's byte-level run-length pre-pass, and block splitting.

Semantics (reference ``copy_input_until_stop``, bzlib.c:212-315):

* The input is consumed as maximal runs of equal bytes, chopped into
  *segments* of at most 255 bytes (a run is flushed when a differing byte
  arrives or when its length hits 255 and another equal byte arrives).
* A segment of length L emits ``min(L, 4)`` literal copies plus, for L >= 4,
  one extra byte ``L - 4``.
* Segments are flushed whole into the current block.  The per-input-byte
  capacity check (``dst_ptr < dst_end``) means: a segment goes into a new
  block iff the current block already holds >= nblockMAX bytes when the
  segment is flushed.  This matches the reference *CLI / chunked-write*
  sequencing (BZ_RUN calls then BZ_FINISH, bzip2.c:329-380 + bzlib.c:362-396):
  a full block is compressed at the end of the RUN call that filled it, so
  the stream's final segment always opens a fresh block when the previous one
  is full.  (The one-shot BZ2_bzBuffToBuffCompress path differs in exactly
  one corner: with FINISH mode active from the start, a final segment
  arriving at EOS is flushed by the epilogue at bzlib.c:276-308 into the
  still-open full block.  The reference binary and stock bzip2 CLI both
  exhibit the chunked behavior, which is what we reproduce; verified on an
  exact-boundary input.)
* Block CRCs cover the raw (pre-RLE1) bytes whose segments landed in the
  block; ``inUse`` marks each segment's byte value plus every emitted
  ``L - 4`` length byte.

The split runs in the port's native runtime (``native.rle1_split``, C++);
the decode is vectorized NumPy over run boundaries (no per-byte Python).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from . import native
from .constants import nblock_max


@dataclass
class RLE1Block:
    """One pre-sort block: RLE1-encoded bytes + metadata for the block coder."""

    data: np.ndarray          # uint8, the RLE1-encoded block contents
    crc: int                  # finalized CRC-32 of the covered raw bytes
    in_use: np.ndarray        # bool[256]
    raw_span: tuple           # (start, end) byte range of the original input


def encode_blocks(data, level: int, _nmax: int | None = None) -> List[RLE1Block]:
    """RLE1-encode ``data`` and split into blocks exactly as the reference's
    streaming one-shot FINISH path does.  ``_nmax`` overrides the block byte
    budget (tests only).  Raises if the native runtime did not build."""
    buf = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    nmax = nblock_max(level) if _nmax is None else _nmax
    out, block_off, block_len, block_crc, in_use, raw_end = \
        native.rle1_split(buf, nmax)
    blocks = []
    raw_start = 0
    for b in range(block_off.size):
        o = int(block_off[b])
        blocks.append(RLE1Block(
            data=out[o:o + int(block_len[b])],
            crc=int(block_crc[b]),
            in_use=in_use[b],
            raw_span=(raw_start, int(raw_end[b]))))
        raw_start = int(raw_end[b])
    return blocks


class RLE1DataError(ValueError):
    pass


def decode(block: np.ndarray) -> np.ndarray:
    """Invert RLE1 on one decoded block (post inverse-BWT bytes -> raw).

    Parse: at position i, four equal bytes mean "emit 4 + block[i+4] copies
    and skip 5"; otherwise emit the literal and advance 1.  Quad candidates
    are sparse in real data, so we vectorize literal stretches and loop only
    over quads.
    """
    b = block
    n = b.size
    if n == 0:
        return b
    if n >= 4:
        eq = b[:-1] == b[1:]
        quad = np.flatnonzero(eq[:-2] & eq[1:-1] & eq[2:])
    else:
        quad = np.zeros(0, np.int64)
    vals: List[np.ndarray] = []
    reps: List[np.ndarray] = []
    pos = 0
    for q in quad:
        q = int(q)
        if q < pos:
            continue
        if q + 4 >= n:
            raise RLE1DataError("RLE1 run truncated (missing length byte)")
        if q > pos:
            vals.append(b[pos:q])
            reps.append(np.ones(q - pos, dtype=np.int64))
        vals.append(b[q:q + 1])
        reps.append(np.array([4 + int(b[q + 4])], dtype=np.int64))
        pos = q + 5
    if pos < n:
        vals.append(b[pos:])
        reps.append(np.ones(n - pos, dtype=np.int64))
    return np.repeat(np.concatenate(vals), np.concatenate(reps))
