# Copied from bzip2_tpu/oracle/block.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""Whole-block encode/decode: BWT -> MTF/RLE2 -> group search -> Huffman ->
bit serialization, and the inverse (reference compress.c:653-881 for the
wire layout, decompress.c:281-664 for parsing/validation).

Block bit layout (continuous, not byte aligned):
  48  block magic 0x314159265359
  32  block CRC (pre-RLE1 bytes)
   1  randomised flag (always 0 on encode)
  24  origPtr
  16  used 16-group map, then 16 bits per used group
   3  nGroups, 15 nSelectors
   .  selectors, unary MTF codes (1..6 bits)
   .  per table: 5-bit first length + {10 inc, 11 dec, 0 next} deltas
   .  Huffman-coded MTF symbol stream, ending with EOB
"""
from __future__ import annotations

import numpy as np

from .. import constants as C
from ..bitstream import BitReader, BitWriter
from ..rle1 import RLE1Block
from . import bwt as _bwt
from . import groups as _groups
from . import huffman as _huffman
from . import mtf as _mtf
from ..rand_table import derandomise_mask


def encode_block(blk: RLE1Block) -> tuple[np.ndarray, int]:
    """Encode one RLE1 block into its bit payload (bytes, nbits)."""
    last, orig_ptr = _bwt.bwt(blk.data)
    mtfv, freq, n_in_use = _mtf.mtf_rle2_encode(last, blk.in_use)
    alpha_size = n_in_use + 2
    n_groups, selectors, lens = _groups.group_search(mtfv, freq, alpha_size)
    codes = np.stack([_huffman.assign_codes(lens[t], alpha_size)
                      for t in range(n_groups)])

    w = BitWriter()
    w.write(C.BLOCK_MAGIC, 48)
    w.write(blk.crc, 32)
    w.write(0, 1)                      # never randomised on encode
    w.write(orig_ptr, 24)

    # Mapping table: 16-bit group map + 16-bit bitmaps for used groups.
    in_use = blk.in_use
    group_used = in_use.reshape(16, 16).any(axis=1)
    w.write(int("".join("1" if g else "0" for g in group_used), 2), 16)
    for g in range(16):
        if group_used[g]:
            bits = in_use[g * 16:(g + 1) * 16]
            w.write(int("".join("1" if b else "0" for b in bits), 2), 16)

    n_selectors = selectors.size
    w.write(n_groups, 3)
    w.write(n_selectors, 15)
    coded_sel = _groups.mtf_selectors(selectors, n_groups)
    # value v -> v ones then a zero, i.e. pattern (1<<v)-2 in v bits
    w.write_codes(((np.int64(1) << coded_sel) - 2).astype(np.uint32),
                  coded_sel.astype(np.int64))

    # Delta-coded lengths per table.
    for t in range(n_groups):
        curr = int(lens[t][0])
        w.write(curr, 5)
        for v in range(alpha_size):
            lv = int(lens[t][v])
            while curr < lv:
                w.write(2, 2)
                curr += 1
            while curr > lv:
                w.write(3, 2)
                curr -= 1
            w.write(0, 1)

    # Payload: per-symbol code from its group's selected table.
    sel_per_sym = np.repeat(selectors, C.G_SIZE)[:mtfv.size]
    sym = mtfv.astype(np.int64)
    w.write_codes(codes[sel_per_sym, sym].astype(np.uint32),
                  lens[sel_per_sym, sym].astype(np.int64))
    return w.getvalue()


class DataError(ValueError):
    """Corrupt stream (maps to BZ_DATA_ERROR)."""


def decode_block_body(r: BitReader, level: int):
    """Decode one block after its 48-bit magic has been consumed.

    Returns (stored_crc, raw_bytes) where raw_bytes is the block's pre-RLE1
    content; raises DataError on any corruption, mirroring the reference's
    validation points (decompress.c:348-351, 372, 379-380, 385, 415,
    488-494, 502, 521-523, 675-676).
    """
    max_block = 100_000 * level
    stored_crc = r.read(32)
    randomised = r.read(1)
    orig_ptr = r.read(24)
    if orig_ptr > max_block:
        raise DataError("origPtr out of range")

    group_map = r.read(16)
    used = []
    for g in range(16):
        if (group_map >> (15 - g)) & 1:
            bits = r.read(16)
            for j in range(16):
                if (bits >> (15 - j)) & 1:
                    used.append(g * 16 + j)
    if not used:
        raise DataError("empty symbol map")
    n_in_use = len(used)
    alpha_size = n_in_use + 2
    eob = n_in_use + 1

    n_groups = r.read(3)
    n_selectors = r.read(15)
    if not 2 <= n_groups <= 6:
        raise DataError("bad nGroups")
    if not 1 <= n_selectors <= C.MAX_SELECTORS:
        raise DataError("bad nSelectors")  # CVE-2010-0405 guard
    coded = np.empty(n_selectors, np.int64)
    for i in range(n_selectors):
        p = 0
        while r.read(1):
            p += 1
            if p >= n_groups:
                raise DataError("selector overflow")
        coded[i] = p
    selectors = _groups.unmtf_selectors(coded, n_groups)

    tables = []
    for t in range(n_groups):
        curr = r.read(5)
        lens = np.empty(alpha_size, np.int64)
        for v in range(alpha_size):
            while True:
                if not 1 <= curr <= C.MAX_DECODE_LEN:
                    raise DataError("code length out of range")
                two = r.read(2)
                if (two & 2) == 0:
                    r.pos -= 1  # consumed one extra bit
                    break
                curr += 1 if (two & 1) == 0 else -1
            lens[v] = curr
        try:
            tables.append(_huffman.build_decode_table(lens, alpha_size))
        except _huffman.BadTableError as e:
            raise DataError(str(e)) from e

    # Symbol loop.
    def next_sym(gidx):
        min_len, max_len, limit, base, perm = tables[selectors[gidx]]
        code = r.read(min_len)
        l = min_len
        while code > limit[l]:
            if l >= max_len:
                raise DataError("invalid Huffman code")
            code = (code << 1) | r.read(1)
            l += 1
        return int(perm[code - base[l]])

    out_vals: list[int] = []
    out_reps: list[int] = []
    mtf_list = list(used)
    total = 0
    g = 0
    pos_in_g = 0

    def bump():
        nonlocal g, pos_in_g
        if pos_in_g == C.G_SIZE:
            g += 1
            pos_in_g = 0
        if g >= n_selectors:
            raise DataError("ran out of selectors")
        pos_in_g += 1

    run = 0
    run_bit = 0
    while True:
        # EOFError (input exhausted) propagates: the caller maps it to
        # BZ_UNEXPECTED_EOF semantics, distinct from corruption.
        bump()
        v = next_sym(g)
        if v <= C.RUNB:
            if run > (1 << 28):
                raise DataError("zero-run overflow")
            run += (v + 1) << run_bit
            run_bit += 1
            continue
        if run:
            total += run
            if total > max_block:
                raise DataError("block overflow (run)")
            out_vals.append(mtf_list[0])
            out_reps.append(run)
            run = 0
            run_bit = 0
        if v == eob:
            break
        p = v - 1
        if p >= len(mtf_list):
            raise DataError("MTF position out of range")
        c = mtf_list.pop(p)
        mtf_list.insert(0, c)
        out_vals.append(c)
        out_reps.append(1)
        total += 1
        if total > max_block:
            raise DataError("block overflow")

    if total == 0:
        raise DataError("empty block")
    if orig_ptr >= total:
        raise DataError("origPtr >= block size")
    last = np.repeat(np.array(out_vals, np.uint8), np.array(out_reps, np.int64))
    plain = _bwt.ibwt(last, orig_ptr)
    if randomised:
        plain = plain ^ derandomise_mask(plain.size).astype(np.uint8)
    from ..rle1 import decode as rle1_decode, RLE1DataError
    try:
        raw = rle1_decode(plain)
    except RLE1DataError as e:
        raise DataError(str(e)) from e
    return stored_crc, raw
