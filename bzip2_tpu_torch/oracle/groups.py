# Copied from bzip2_tpu/oracle/groups.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""Greedy 6-table group/selector search (reference sendMTFValues).

Per block: pick nGroups from nMTF thresholds, seed tables by frequency
partition, then run BZ_N_ITERS=4 refinement passes — per 50-symbol group,
choose the cheapest table (ties -> lowest table index), accumulate chosen
frequencies, rebuild code lengths.  Selectors come from the *last* pass and
the final lengths are rebuilt after it (compress.c:251-561).

Cost/argmin/histogram steps are vectorized NumPy here and map 1:1 onto the
torch formulation in ``bzip2_tpu_torch.ops.groupsearch``.
"""
from __future__ import annotations

import numpy as np

from ..constants import G_SIZE, GREATER_ICOST, LESSER_ICOST, N_ITERS
from .huffman import make_code_lengths


def n_groups_for(n_mtf: int) -> int:
    if n_mtf < 200:
        return 2
    if n_mtf < 600:
        return 3
    if n_mtf < 1200:
        return 4
    if n_mtf < 2400:
        return 5
    return 6


def initial_tables(freq: np.ndarray, n_mtf: int, alpha_size: int, n_groups: int) -> np.ndarray:
    """Seed length tables by partitioning the alphabet into ~equal-frequency
    spans (compress.c:276-319)."""
    lens = np.full((n_groups, alpha_size), GREATER_ICOST, np.int32)
    n_part = n_groups
    rem_f = n_mtf
    gs = 0
    while n_part > 0:
        t_freq = rem_f // n_part
        ge = gs - 1
        a_freq = 0
        while a_freq < t_freq and ge < alpha_size - 1:
            ge += 1
            a_freq += int(freq[ge])
        if (ge > gs and n_part != n_groups and n_part != 1
                and ((n_groups - n_part) % 2 == 1)):
            a_freq -= int(freq[ge])
            ge -= 1
        lens[n_part - 1, gs:ge + 1] = LESSER_ICOST
        n_part -= 1
        gs = ge + 1
        rem_f -= a_freq
    return lens


def group_search(mtfv: np.ndarray, freq: np.ndarray, alpha_size: int):
    """Run the refinement; returns (n_groups, selectors, lens, codes)."""
    n_mtf = mtfv.size
    n_groups = n_groups_for(n_mtf)
    lens = initial_tables(freq, n_mtf, alpha_size, n_groups)

    n_sel = (n_mtf + G_SIZE - 1) // G_SIZE
    pad = n_sel * G_SIZE - n_mtf
    syms = np.concatenate([mtfv.astype(np.int64), np.zeros(pad, np.int64)])
    valid = np.concatenate([np.ones(n_mtf, bool), np.zeros(pad, bool)])
    syms2 = syms.reshape(n_sel, G_SIZE)
    valid2 = valid.reshape(n_sel, G_SIZE)

    selectors = None
    for _ in range(N_ITERS):
        # cost[g, t] = sum of lens[t, sym] over valid symbols of group g
        per_sym = lens[:, syms2]                  # (T, n_sel, G_SIZE)
        per_sym = np.where(valid2[None], per_sym, 0)
        cost = per_sym.sum(axis=2).T              # (n_sel, T)
        selectors = np.argmin(cost, axis=1)       # first min wins ties
        # frequency accumulation for chosen tables
        new_freq = np.zeros((n_groups, alpha_size), np.int64)
        flat = selectors.repeat(G_SIZE)[valid] * alpha_size + syms[valid]
        np.add.at(new_freq.reshape(-1), flat, 1)
        lens = np.stack([
            make_code_lengths(new_freq[t], alpha_size) for t in range(n_groups)
        ])
    return n_groups, selectors.astype(np.int64), lens


def mtf_selectors(selectors: np.ndarray, n_groups: int) -> np.ndarray:
    """MTF-code the selector sequence (values become position+1, 1..6)."""
    pos = list(range(n_groups))
    out = np.empty(selectors.size, np.int64)
    for i, v in enumerate(selectors):
        p = pos.index(int(v))
        out[i] = p + 1
        if p:
            pos.pop(p)
            pos.insert(0, int(v))
    return out


def unmtf_selectors(coded: np.ndarray, n_groups: int) -> np.ndarray:
    """Invert mtf_selectors (decoder side, values are positions 0-based)."""
    pos = list(range(n_groups))
    out = np.empty(coded.size, np.int64)
    for i, p in enumerate(coded):
        p = int(p)
        v = pos[p]
        out[i] = v
        if p:
            pos.pop(p)
            pos.insert(0, v)
    return out
