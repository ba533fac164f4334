# Copied from bzip2_tpu/oracle/mtf.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""MTF + RLE2 symbol transform (encode and decode).

Semantics (reference generateMTFValues, compress.c:94-229): the BWT output is
remapped onto the ascending list of used byte values; a move-to-front list
over that alphabet emits, per position, the 0-based list position of the
character; position 0 is collapsed into zero-runs written in bijective base-2
as RUNA/RUNB (digits of run_length+1, LSB-first, top bit dropped); any other
position ``p`` is written as symbol ``p + 1``.  The stream ends with
EOB = nInUse + 1; the alphabet size is nInUse + 2.

Encode is fully vectorized: MTF rank equals the number of distinct symbols
seen strictly after the previous occurrence of the current symbol, computed
tile-by-tile from running last-occurrence tables (the same formulation the
port's MTF kernels use).
"""
from __future__ import annotations

import numpy as np

from ..constants import RUNA, RUNB


def mtf_ranks(seq: np.ndarray, k: int, tile: int = 512) -> np.ndarray:
    """MTF list positions (0-based) for ``seq`` over alphabet ``0..k-1``,
    with the list initialized to identity order.

    rank[i] = #{d : lastocc_d(i) > lastocc_c(i)} where lastocc over prefix
    [0, i) and unseen symbols d have virtual initial occurrences at time
    -(d+1) (front of the initial list is most recent).
    """
    n = seq.size
    ranks = np.empty(n, np.int64)
    last = -(np.arange(k, dtype=np.int64) + 1)  # initial virtual times
    onehot_eye = np.eye(k, dtype=np.int64)
    for t0 in range(0, n, tile):
        s = seq[t0:t0 + tile].astype(np.int64)
        t = s.size
        pos = np.arange(t0, t0 + t, dtype=np.int64)
        occ = np.full((t, k), np.iinfo(np.int64).min, np.int64)
        occ[np.arange(t), s] = pos
        incl = np.maximum.accumulate(occ, axis=0)
        excl = np.empty_like(incl)
        excl[0] = last
        np.maximum(incl[:-1], last, out=excl[1:])
        cur = excl[np.arange(t), s]
        ranks[t0:t0 + t] = (excl > cur[:, None]).sum(axis=1)
        last = excl[-1].copy()
        np.maximum(last, occ[-1], out=last)
        # maximum.accumulate already folded within tile; fold final row:
        last = np.maximum(excl[-1], occ[-1])
    return ranks


def run_digits(z: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Bijective base-2 digits for zero-run lengths ``z`` (>=1).

    Returns (counts, digit_values): run length Z emits
    ``floor(log2(Z+1))`` digits, digit_j = ((Z+1) >> j) & 1 (0=RUNA, 1=RUNB).
    """
    m = z.astype(np.int64) + 1
    counts = np.int64(np.floor(np.log2(m)))  # bit_length(m) - 1
    # robust bit_length without float issues:
    counts = np.zeros_like(m)
    mm = m.copy()
    while np.any(mm > 1):
        step = mm > 1
        counts[step] += 1
        mm[step] >>= 1
    total = int(counts.sum())
    rep = np.repeat(m, counts)
    offs = np.cumsum(counts) - counts
    local = np.arange(total, dtype=np.int64) - np.repeat(offs, counts)
    digits = (rep >> local) & 1
    return counts, digits


def mtf_rle2_encode(bwt_last: np.ndarray, in_use: np.ndarray):
    """Full encode stage: BWT output bytes -> (mtfv uint16, freq int64[258]).

    ``in_use`` is the 256-bool used-byte table from RLE1.
    """
    used = np.flatnonzero(in_use)
    k = used.size
    remap = np.zeros(256, np.int64)
    remap[used] = np.arange(k)
    s = remap[bwt_last]
    ranks = mtf_ranks(s, k)

    nz = np.flatnonzero(ranks > 0)
    prev = np.r_[-1, nz[:-1]]
    zlens = nz - prev - 1
    tail_z = ranks.size - (int(nz[-1]) + 1 if nz.size else 0)

    out_parts = []
    # interleave: digits(zlen_i) then symbol ranks[nz_i]+1, finally tail
    # digits then EOB.
    pos_counts = np.zeros(nz.size + 1, np.int64)
    if nz.size:
        dcounts, digits = run_digits(zlens[zlens > 0]) if np.any(zlens > 0) else (
            np.zeros(0, np.int64), np.zeros(0, np.int64))
        full_dcounts = np.zeros(nz.size, np.int64)
        full_dcounts[zlens > 0] = dcounts
        sym = ranks[nz] + 1
        # assemble via offsets
        counts_all = full_dcounts + 1
        offs = np.cumsum(counts_all) - counts_all
        total = int(offs[-1] + counts_all[-1])
        out = np.empty(total, np.int64)
        out[offs + full_dcounts] = sym
        if digits.size:
            doffs = np.repeat(offs[zlens > 0], dcounts)
            local = np.arange(digits.size) - np.repeat(
                np.cumsum(dcounts) - dcounts, dcounts)
            out[doffs + local] = digits + RUNA
        out_parts.append(out)
    if tail_z > 0:
        _, tdig = run_digits(np.array([tail_z], np.int64))
        out_parts.append(tdig + RUNA)
    eob = k + 1
    out_parts.append(np.array([eob], np.int64))
    mtfv = np.concatenate(out_parts).astype(np.uint16)
    freq = np.bincount(mtfv, minlength=258).astype(np.int64)
    return mtfv, freq, k


def mtf_rle2_decode(symbols, n_in_use: int, used: np.ndarray, max_block: int):
    """Decode MTF/RLE2 symbol stream back to BWT output bytes.

    ``symbols`` iterates decoder symbols (0=RUNA, 1=RUNB, 2..=positions+1,
    EOB already stripped).  Returns uint8 array.  Raises ValueError on block
    overflow (corrupt stream).
    """
    lst = list(used)  # MTF list of byte values, ascending init
    vals: list[int] = []
    reps: list[int] = []
    run = 0
    run_bit = 0
    total = 0
    for v in symbols:
        if v <= RUNB:
            run += (v + 1) << run_bit
            run_bit += 1
            continue
        if run:
            total += run
            if total > max_block:
                raise ValueError("zero-run overflows block")
            vals.append(lst[0])
            reps.append(run)
            run = 0
            run_bit = 0
        p = v - 1
        if p >= len(lst):
            raise ValueError("MTF position out of range")
        c = lst.pop(p)
        lst.insert(0, c)
        vals.append(c)
        reps.append(1)
        total += 1
        if total > max_block:
            raise ValueError("block overflow")
    if run:
        total += run
        if total > max_block:
            raise ValueError("zero-run overflows block")
        vals.append(lst[0])
        reps.append(run)
    return np.repeat(np.array(vals, np.uint8), np.array(reps, np.int64))
