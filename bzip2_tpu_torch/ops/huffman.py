"""Canonical Huffman code assignment (port of
``bzip2_tpu/ops/huffman.py:assign_codes_lanes``; huffman.c:152-166).

The code lengths themselves come from the host's exact-heap builder
(``bzip2_tpu_torch.native.make_code_lengths_batch``) in the hybrid flow.
"""
from __future__ import annotations

import torch

from ..constants import MAX_ALPHA_SIZE as A


def assign_codes_lanes(lens: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """lens: (L, A) int32 (entries >= alpha ignored); alpha: (L,).
    Returns codes (L, A) int32."""
    L = lens.shape[0]
    dev = lens.device
    i32 = torch.int32
    active = torch.arange(A, device=dev)[None, :] < alpha[:, None]
    lens_m = torch.where(active, lens, 0).to(torch.int64)
    onehot = (lens_m[:, :, None]
              == torch.arange(24, device=dev)[None, None, :]).to(i32)
    counts = onehot.sum(dim=1, dtype=i32)                      # (L, 24)
    counts[:, 0] = 0           # pseudo-length 0 marks inactive symbols
    # first[l] = (first[l-1] + counts[l-1]) << 1, first[0] = 0
    first = torch.zeros((L, 24), dtype=i32, device=dev)
    fc = torch.zeros(L, dtype=i32, device=dev)
    for ln in range(24):
        first[:, ln] = fc
        fc = (fc + counts[:, ln]) << 1
    # rank within the same length, by symbol order
    within = torch.cumsum(onehot, dim=1, dtype=i32) - 1         # (L, A, 24)
    rank = torch.gather(within, 2, lens_m[:, :, None])[:, :, 0]
    code = torch.gather(first, 1, lens_m) + rank
    return torch.where(active, code, 0)
