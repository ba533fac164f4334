"""Row-wise lexicographic sort of (a, b) int32 pairs: the BWT's reorders.

Counterpart of ``bzip2_tpu/ops/sort_pallas.py:sort_pairs``.  On a CUDA
tensor it launches the bitonic network of ``csrc/sort_pairs.cu``; on a CPU
tensor it runs the plain version, one ``torch.sort`` of the packed 64-bit
key.  Callers keep the pairs distinct (a position in b's low bits), or equal
only where both halves are equal, so both give the same output.
"""
from __future__ import annotations

import ctypes as ct

import torch

from .. import _build

MIN_N = 128
MAX_N = 1 << 20

KERNEL = _build.Kernel(
    "sort_pairs", "bz2t_sort_pairs",
    [ct.c_void_p] * 5 + [ct.c_int, ct.c_int, ct.c_void_p])


def _check_shape(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape or a.dim() != 2:
        raise ValueError(f"sort_pairs: shapes {tuple(a.shape)} {tuple(b.shape)}")
    n = a.shape[1]
    if n < MIN_N or n > MAX_N or n & (n - 1):
        raise ValueError(f"sort_pairs: width {n} is not a power of two "
                         f"in [{MIN_N}, {MAX_N}]")


def sort_pairs_plain(a: torch.Tensor, b: torch.Tensor):
    """One sort of the key (a << 32) + (b + 2^31): its signed int64 order is
    the signed lexicographic order of (a, b)."""
    key = (a.to(torch.int64) << 32) | (b.to(torch.int64) + (1 << 31))
    ks = torch.sort(key, dim=1).values
    return (ks >> 32).to(torch.int32), ((ks & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def sort_pairs(a: torch.Tensor, b: torch.Tensor):
    """Sort (a, b) int32 pairs lexicographically along dim 1.

    a, b: (B, N) int32, N a power of two in [128, 2^20].  Returns the
    sorted (a, b) as new tensors."""
    _check_shape(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return sort_pairs_plain(a, b)
    _build.check(a, "sort_pairs a", torch.int32, 2)
    _build.check(b, "sort_pairs b", torch.int32, 2)
    rows, n = a.shape
    a_out = torch.empty_like(a)
    b_out = torch.empty_like(b)
    keys = torch.empty((rows, n), dtype=torch.int64, device=a.device)
    KERNEL(_build.ptr(a), _build.ptr(b), _build.ptr(a_out), _build.ptr(b_out),
           _build.ptr(keys), rows, n, _build.stream_of(a))
    return a_out, b_out
