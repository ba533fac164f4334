"""Batched MTF + RLE2 (port of ``bzip2_tpu/ops/mtf.py``).

The MTF ranks come from ``mtf_kernel.mtf_ranks`` (the CUDA kernels on a
card, their plain versions on the CPU).  Zero runs are then re-coded as
RUNA/RUNB digits with the same gather formulation as the JAX version: each
source (a nonzero rank, or the EOB) owns an output span; three packed
scatter-max + cummax passes spread (offset, symbol, run length) over the
span and each slot derives its digit locally.
"""
from __future__ import annotations

import torch

from .mtf_kernel import mtf_ranks


#: the JAX name of the MTF rank entry (kernels on a card, plain on the CPU)
mtf_ranks_batched = mtf_ranks


def floor_log2(m: torch.Tensor) -> torch.Tensor:
    """floor(log2 m) for 1 <= m < 2^32, exactly, by integer steps.  Stands
    in for ``31 - lax.clz(m)``, which has no torch op."""
    r = torch.zeros_like(m)
    x = m
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        r = r + big.to(m.dtype) * s
        x = torch.where(big, x >> s, x)
    return r


def mtf_rle2_batched(last_col: torch.Tensor, n: torch.Tensor,
                     in_use: torch.Tensor):
    """last_col: uint8 (B, N) BWT output; n: int32 (B,); in_use: bool (B, 256).

    Returns (mtfv int32 (B, N+1), n_mtf int32 (B,), n_in_use int32 (B,)).
    mtfv pad positions are 0."""
    B, N = last_col.shape
    M = N + 1
    if M >= (1 << 20):
        raise ValueError("offset packing assumes block size < 2^20")
    dev = last_col.device
    i32 = torch.int32
    n = n.to(i32)
    idx = torch.arange(N, dtype=i32, device=dev)[None, :]
    valid = idx < n[:, None]

    in_use_i = in_use.to(i32)
    remap = torch.cumsum(in_use_i, dim=1, dtype=i32) - in_use_i
    n_in_use = in_use_i.sum(dim=1, dtype=i32)
    seq = torch.gather(remap, 1, last_col.to(torch.int64))
    seq = torch.where(valid, seq, 0)

    ranks = torch.where(valid, mtf_ranks_batched(seq, valid), 0)

    # --- RLE2 stream layout ---
    nonzero = (ranks > 0) & valid
    marks = torch.where(nonzero, idx, -1)
    prev_incl = torch.cummax(marks, dim=1).values
    prev_excl = torch.cat([torch.full((B, 1), -1, dtype=i32, device=dev),
                           prev_incl[:, :-1]], dim=1)
    zlen = torch.where(nonzero, idx - prev_excl - 1, 0)
    m = zlen + 1
    dcount = torch.where(nonzero, floor_log2(m), 0)
    counts = torch.where(nonzero, dcount + 1, 0)

    last_nz = prev_incl[:, -1]
    tail_z = torch.where(n > 0, n - 1 - last_nz, 0)
    tail_m = tail_z + 1
    tail_d = torch.where(tail_z > 0, floor_log2(tail_m), 0)

    offs = torch.cumsum(counts, dim=1, dtype=i32) - counts
    total_body = offs[:, -1] + counts[:, -1]
    n_mtf = total_body + tail_d + 1

    # packed per-source fields: offs < 2^20, sym <= 257 (10 bits), m < 2^20
    # split as 11 low + 9 high bits
    sym = ranks + 1
    pos = torch.where(nonzero, offs, M - 1).to(torch.int64)
    v_sym = torch.where(nonzero, (offs << 10) | sym, 0)
    v_mlo = torch.where(nonzero, (offs << 11) | (m & 0x7FF), 0)
    v_mhi = torch.where(nonzero, (offs << 10) | (m >> 11), 0)
    eob_sym = n_in_use + 1
    tb = total_body.to(torch.int64)[:, None]

    def spread(vals, eob_val):
        # scatter-max: duplicates (the dump slot M-1) resolve by max, so the
        # result does not depend on the order of the updates
        a = torch.zeros((B, M), dtype=i32, device=dev)
        a.scatter_reduce_(1, pos, vals, "amax")
        a.scatter_reduce_(1, tb, eob_val[:, None], "amax")
        return torch.cummax(a, dim=1).values

    s_sym = spread(v_sym, (total_body << 10) | eob_sym)
    s_mlo = spread(v_mlo, (total_body << 11) | (tail_m & 0x7FF))
    s_mhi = spread(v_mhi, (total_body << 10) | (tail_m >> 11))

    p = torch.arange(M, dtype=i32, device=dev)[None, :]
    start = s_sym >> 10
    slot_sym = s_sym & 0x3FF
    slot_m = ((s_mhi & 0x3FF) << 11) | (s_mlo & 0x7FF)
    d = torch.clamp(p - start, 0, 31)
    dc = floor_log2(torch.clamp(slot_m, min=1))
    out = torch.where(d == dc, slot_sym, (slot_m >> d) & 1)
    out = torch.where(p < n_mtf[:, None], out, 0)
    return out, n_mtf, n_in_use
