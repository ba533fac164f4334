"""Variable-length bit packing on the device (port of
``bzip2_tpu/ops/bitpack.py:pack_fields``).

A block is a sequence of (value, nbits) fields.  An exclusive prefix sum
gives each field's bit offset; a field straddles at most two 32-bit words,
so two scatter-adds build the stream.  Values and words are carried in
int64 and masked to 32 bits: torch's ``>>`` on int32 is arithmetic where
the JAX version shifts uint32 logically, and ``<<`` would overflow.  The
bit regions of the fields are disjoint, so adds equal ORs and the order of
the atomic adds cannot change the result.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def pack_fields(vals: torch.Tensor, lens: torch.Tensor, n_words: int):
    """vals: (B, F) int64 (< 2**lens); lens: (B, F) int32 in 0..32.

    Returns (words (B, n_words) int64 holding uint32 big-endian bit order,
    total_bits (B,) int64)."""
    B, F = vals.shape
    dev = vals.device
    lens = lens.to(torch.int64)
    csum = torch.cumsum(lens, dim=1)
    offs = csum - lens
    total_bits = csum[:, -1]

    w = offs >> 5
    r = offs & 31
    s = 64 - r - lens                  # left shift within the 64-bit window
    code = torch.where(lens > 0, vals.to(torch.int64) & _M32, 0)
    hi = torch.where(s >= 32, code << torch.clamp(s - 32, 0, 31),
                     code >> torch.clamp(32 - s, 0, 31)) & _M32
    lo = torch.where(s >= 32, 0, code << torch.clamp(s, 0, 31)) & _M32

    # one spare word per lane: a field ending on a word boundary adds 0 to
    # the word after it
    flat = torch.zeros(B * (n_words + 1), dtype=torch.int64, device=dev)
    base = torch.arange(B, dtype=torch.int64, device=dev)[:, None] * (n_words + 1)
    flat.index_add_(0, (base + w).reshape(-1), hi.reshape(-1))
    flat.index_add_(0, (base + w + 1).reshape(-1), lo.reshape(-1))
    return flat.reshape(B, n_words + 1)[:, :n_words], total_bits
