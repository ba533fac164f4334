"""Batched 6-table group search (port of ``bzip2_tpu/ops/groupsearch.py``;
reference sendMTFValues, compress.c:251-561).

Per-50-symbol group histograms are built once per block (the
``group_hist`` kernel); each refinement pass is then two small batched
matmuls plus an argmin (first minimum wins, as the reference's strict
``<`` scan), and the Huffman lengths are rebuilt: on the host in the hybrid
encoder, on the device (``huffman.make_code_lengths_lanes``) in
``group_search_batched``, the fused encoder's group search.
"""
from __future__ import annotations

import threading

import torch

from ..constants import (G_SIZE, GREATER_ICOST, LESSER_ICOST, MAX_ALPHA_SIZE,
                         N_ITERS)
from .huffman import assign_codes_lanes, make_code_lengths_lanes
from .mtf_kernel import group_hist, mtf_ranks

A = MAX_ALPHA_SIZE

#: held while group_iter turns the process-wide TF32 flag off for its two
#: products, so that with several engine threads no thread restores the
#: caller's setting while another thread's product is being launched
_TF32_LOCK = threading.Lock()


def n_groups_batched(n_mtf: torch.Tensor) -> torch.Tensor:
    i32 = torch.int32
    return (2 + (n_mtf >= 200).to(i32) + (n_mtf >= 600).to(i32)
            + (n_mtf >= 1200).to(i32) + (n_mtf >= 2400).to(i32))


def initial_tables_batched(freq: torch.Tensor, n_mtf: torch.Tensor,
                           alpha: torch.Tensor,
                           n_groups: torch.Tensor) -> torch.Tensor:
    """Frequency-partition seeding (compress.c:276-319).  freq: (B, A)
    int32.  Returns lens (B, 6, A) int32.  The JAX ``lax.scan`` over the
    six partitions is a loop here."""
    B = freq.shape[0]
    dev = freq.device
    i32 = torch.int32
    cum = torch.cumsum(freq, dim=1, dtype=i32)
    arange = torch.arange(A, dtype=i32, device=dev)[None, :]
    rows = torch.arange(B, device=dev)
    lens = torch.full((B, 6, A), GREATER_ICOST, dtype=i32, device=dev)
    gs = torch.zeros(B, dtype=i32, device=dev)
    rem_f = n_mtf.to(i32)

    def cum_at(j):
        return torch.gather(cum, 1, torch.clamp(j, min=0)[:, None]
                            .to(torch.int64))[:, 0]

    for part_idx in range(6):
        n_part = n_groups - part_idx
        active = n_part >= 1
        t_freq = torch.where(n_part > 0,
                             torch.div(rem_f, torch.clamp(n_part, min=1),
                                       rounding_mode="floor"), 0)
        prev_cum = torch.where(gs > 0, cum_at(gs - 1), 0)
        target = prev_cum + t_freq
        hit = (arange >= gs[:, None]) & (cum >= target[:, None])
        any_hit = hit.any(dim=1)
        # argmax returns the first maximal index: the first hit
        first_hit = hit.to(i32).argmax(dim=1).to(i32)
        ge = torch.where(any_hit, first_hit, A - 1)
        ge = torch.minimum(ge, alpha - 1)
        ge = torch.where(t_freq <= 0, gs - 1, ge)
        ge = torch.maximum(ge, gs - 1)
        if part_idx % 2 == 1:  # parity adjustment (compress.c:297-301)
            ge = torch.where((ge > gs) & (n_part != 1), ge - 1, ge)
        a_freq = torch.where(ge >= gs, cum_at(ge) - prev_cum, 0)
        span = (arange >= gs[:, None]) & (arange <= ge[:, None]) & active[:, None]
        row = torch.clamp(n_part - 1, min=0).to(torch.int64)
        cur = lens[rows, row]
        lens[rows, row] = torch.where(span, LESSER_ICOST, cur)
        gs = torch.where(active, ge + 1, gs)
        rem_f = torch.where(active, rem_f - a_freq, rem_f)
    return lens


def build_group_hist(mtfv: torch.Tensor, n_mtf: torch.Tensor) -> torch.Tensor:
    """(B, M) symbols -> (B, G, A) per-50-group histograms (int32)."""
    return group_hist(mtfv.contiguous(), n_mtf.to(torch.int32).contiguous(),
                      G_SIZE)


def search_init(mtfv: torch.Tensor, n_mtf: torch.Tensor,
                alpha: torch.Tensor) -> tuple:
    """The group search's state before its refinement passes: (n_groups
    (B,), hist (B, G, A) float32 for the group_iter products, the initial
    lens (B, 6, A) int32, table_invalid (B, 6) bool)."""
    n_groups = n_groups_batched(n_mtf)
    hist = build_group_hist(mtfv, n_mtf)
    lens = initial_tables_batched(hist.sum(dim=1, dtype=torch.int32), n_mtf,
                                  alpha, n_groups)
    table_invalid = (torch.arange(6, device=mtfv.device)[None, :]
                     >= n_groups[:, None])
    return n_groups, hist.to(torch.float32), lens, table_invalid


def group_iter(hist: torch.Tensor, lens: torch.Tensor,
               table_invalid: torch.Tensor):
    """One refinement pass: (B,G,A) float32 hist, (B,6,A) int32 lens ->
    (selectors (B,G) int64, freq6 (B,6,A) int32).

    The JAX version multiplies bf16 inputs into f32.  A bf16 ``bmm`` in
    torch returns bf16, which rounds costs above 256 and frequencies up to
    900k, so both products run in float32, exact for these integers
    (costs <= 50*17, frequencies < 2^24).  The math mode is read when a
    product is launched, so TF32 is off for the two launches, under
    ``_TF32_LOCK``, and the caller's setting is restored after them."""
    lens_f = lens.to(torch.float32).transpose(1, 2)
    penalty = torch.where(table_invalid, 1e9, 0.0)[:, None, :]
    with _TF32_LOCK:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            cost = torch.bmm(hist, lens_f) + penalty
            # torch.argmin returns the first minimal index on ties
            selectors = torch.argmin(cost, dim=2)               # (B, G)
            onehot = torch.nn.functional.one_hot(selectors, 6).to(
                torch.float32)
            freq6 = torch.bmm(onehot.transpose(1, 2), hist).to(torch.int32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    return selectors, freq6


def selector_mtf(selectors: torch.Tensor,
                 n_selectors: torch.Tensor) -> torch.Tensor:
    """MTF-code the selector stream; returns (B,G) int32 values in 1..6
    (0 pad).  Runs through the same MTF rank entry as the block stream."""
    B, G = selectors.shape
    gvalid = (torch.arange(G, device=selectors.device)[None, :]
              < n_selectors[:, None])
    ranks = mtf_ranks(selectors.to(torch.int32), gvalid)
    return torch.where(gvalid, ranks + 1, 0).to(torch.int32)


def group_search_batched(mtfv: torch.Tensor, n_mtf: torch.Tensor,
                         n_in_use: torch.Tensor):
    """The whole group search on the device (``bzip2_tpu/ops/groupsearch.py:
    group_search_batched``).  Returns (n_groups (B,) int32, n_selectors (B,)
    int32, selectors (B, G) int64, sel_mtf (B, G) int32 MTF-coded selector
    values (1..6), lens (B, 6, A) int32, codes (B, 6, A) int32)."""
    B = mtfv.shape[0]
    alpha = n_in_use.to(torch.int32) + 2
    alpha6 = alpha[:, None].expand(B, 6).reshape(B * 6).contiguous()
    n_selectors = -(-n_mtf // G_SIZE)
    n_groups, hist, lens, table_invalid = search_init(mtfv, n_mtf, alpha)
    selectors = None
    for _ in range(N_ITERS):
        selectors, freq6 = group_iter(hist, lens, table_invalid)
        lens = make_code_lengths_lanes(freq6.reshape(B * 6, A).contiguous(),
                                       alpha6).reshape(B, 6, A)
    codes = assign_codes_lanes(lens.reshape(B * 6, A), alpha6).reshape(B, 6, A)
    sel_mtf = selector_mtf(selectors, n_selectors)
    return n_groups, n_selectors, selectors, sel_mtf, lens, codes
