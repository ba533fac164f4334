"""Row-wise lexicographic sort of (a, b) int32 pairs: the BWT's reorders.

Counterpart of ``bzip2_tpu/ops/sort_pallas.py:sort_pairs``.  On a CUDA
tensor it launches the merge sort of ``csrc/sort_pairs.cu``: one tile sort
in shared memory, then ``merge_rounds(n)`` merge rounds over device memory.
On a CPU tensor it runs the plain version, one ``torch.sort`` of the packed
64-bit key.  Callers keep the pairs distinct (a position in b's low bits),
or equal only where both halves are equal, so both give the same output.
"""
from __future__ import annotations

import ctypes as ct

import torch

from .. import _build

MIN_N = 128
MAX_N = 1 << 20
#: keys per shared-memory tile; csrc/sort_pairs.cu checks it equals kTile
TILE = 8192

KERNEL = _build.Kernel(
    "sort_pairs", "bz2t_sort_pairs",
    [ct.c_void_p] * 6 + [ct.c_int, ct.c_int, ct.c_int, ct.c_void_p])


def _check_shape(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.shape != b.shape or a.dim() != 2:
        raise ValueError(f"sort_pairs: shapes {tuple(a.shape)} {tuple(b.shape)}")
    n = a.shape[1]
    if n < MIN_N or n > MAX_N or n & (n - 1):
        raise ValueError(f"sort_pairs: width {n} is not a power of two "
                         f"in [{MIN_N}, {MAX_N}]")


def merge_rounds(n: int) -> int:
    """Merge rounds after the tile sort of a width-n row: log2(n / TILE),
    0 when one tile holds the row."""
    return max(0, n.bit_length() - TILE.bit_length())


def sort_buffers(rows: int, n: int, device):
    """(out, k0, k1): the output planes, (2, rows, n) int32, and the two key
    buffers of ``bz2t_sort_pairs`` (None when one tile holds a row).

    The tile sort writes k0, the merge rounds write k1, k0, ... in turn and
    the last round writes the planes, so it must read the (rows, n) int64
    scratch; the planes' own memory, of the same size, is the other key
    buffer."""
    out = torch.empty((2, rows, n), dtype=torch.int32, device=device)
    r = merge_rounds(n)
    if r == 0:
        return out, None, None
    scratch = torch.empty((rows, n), dtype=torch.int64, device=device)
    # the last round reads k0 after an even number of earlier rounds
    return (out, scratch, out) if (r - 1) % 2 == 0 else (out, out, scratch)


def sort_pairs_plain(a: torch.Tensor, b: torch.Tensor):
    """One sort of the key (a << 32) + (b + 2^31): its signed int64 order is
    the signed lexicographic order of (a, b)."""
    key = (a.to(torch.int64) << 32) | (b.to(torch.int64) + (1 << 31))
    ks = torch.sort(key, dim=1).values
    return (ks >> 32).to(torch.int32), ((ks & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def sort_pairs(a: torch.Tensor, b: torch.Tensor, bufs=None):
    """Sort (a, b) int32 pairs lexicographically along dim 1.

    a, b: (B, N) int32, N a power of two in [128, 2^20].  Returns the
    sorted (a, b) as new tensors (two views of one (2, B, N) buffer), or
    views of ``bufs`` (``sort_buffers(B, N, device)``) when given."""
    _check_shape(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return sort_pairs_plain(a, b)
    _build.check(a, "sort_pairs a", torch.int32, 2)
    _build.check(b, "sort_pairs b", torch.int32, 2)
    rows, n = a.shape
    out, k0, k1 = bufs if bufs is not None else sort_buffers(rows, n, a.device)
    if tuple(out.shape) != (2, rows, n):
        raise ValueError(f"sort_pairs: buffers of shape {tuple(out.shape)}")
    KERNEL(_build.ptr(a), _build.ptr(b), _build.ptr(out[0]), _build.ptr(out[1]),
           _build.ptr(k0), _build.ptr(k1), rows, n, TILE, _build.stream_of(a))
    return out[0], out[1]
