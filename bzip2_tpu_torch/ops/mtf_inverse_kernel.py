"""Inverse MTF of every block's symbols: wrapper of the CUDA kernels in
``csrc/mtf_inverse.cu`` and their plain PyTorch version.

Counterpart of ``mtf_inverse`` in ``bzip2_tpu/ops/decode.py``: two
``lax.scan`` loops (the chunks' local scans and the compose over their
permutations) that have no Pallas original.  The plain version is that
chunked permutation-monoid form in torch ops, one launch per step; the
kernels run the local scans (a warp per chunk, stepping on the symbols
that move the list), a compose in two levels (super-chunks in parallel,
then their nets, a CTA per block) and the anchoring pass in four launches.
Both equal a sequential MTF of the whole row at every position, at any
chunking, so the kernels take the chunk count ``chunks_for`` picks for the
card and the plain version JAX's ``MTF_CHUNKS``.  A wrapper runs its plain
version only for a tensor on the CPU; for a CUDA tensor it launches its
kernels.
"""
from __future__ import annotations

import ctypes as ct
import math

import torch

from .. import _build

MTF_CHUNKS = 512
#: warp slots of the card: 132 SMs x 64
CARD_WARPS = 132 * 64
#: fewest symbols a chunk: a chunk's compose step gathers 256 entries
MIN_CHUNK = 256

i32 = torch.int32

KERNEL = _build.Kernel("mtf_inverse", "bz2t_mtf_inverse",
                       [ct.c_void_p] * 7 + [ct.c_int] * 4 + [ct.c_void_p])


def chunks_for(B: int, M: int) -> int:
    """The chunk count of the CUDA path for B rows of M symbols: enough
    chunks that B x C warps fill the card (CARD_WARPS), none shorter than
    MIN_CHUNK symbols unless the row is, and none empty."""
    if B < 1 or M < 1:
        return 1
    C = min(-(-CARD_WARPS // B), max(1, M // MIN_CHUNK))
    K = -(-M // C)
    return -(-M // K)


def super_for(C: int) -> int:
    """Chunks a super-chunk of the two-level compose: about sqrt(C), so its
    chain of W + ceil(C / W) steps is about 2 sqrt(C)."""
    return math.isqrt(C - 1) + 1 if C > 1 else 1


def mtf_inverse_plain(syms, used_list, n_used, n_mtf,
                      n_chunks: int = MTF_CHUNKS):
    """The chunked form in torch ops: a chunk's local scan gives each
    symbol's index into the chunk-start list and the chunk's net
    permutation; a sequential compose over the n_chunks summaries anchors
    every chunk to the initial list."""
    B, M = syms.shape
    dev = syms.device
    C = n_chunks
    K = -(-M // C)
    syms_p = torch.nn.functional.pad(syms.to(i32), (0, C * K - M),
                                     value=10_000)   # no-op symbols
    xs = syms_p.reshape(B, C, K)
    # per symbol: r = its list index (RUNA/RUNB read the front, as the
    # reference's where(s <= 1, lst[0], lst[r]) does, since r clamps to 0),
    # and lim = r + 1 when it moves lst[r] to the front (0 otherwise), so a
    # step is one gather, one shift and one masked select
    r = (xs - 1).clamp(0, 255)
    lim = torch.where((xs >= 2) & (xs <= n_used.to(i32)[:, None, None]),
                      r + 1, 0)
    r = r.to(torch.int64)[..., None]
    j256 = torch.arange(256, dtype=i32, device=dev)
    lst = j256.expand(B, C, 256).contiguous()
    es = []
    for k in range(K):
        v = torch.gather(lst, 2, r[:, :, k])                # (B, C, 1)
        es.append(v)
        shifted = torch.cat([v, lst[:, :, :-1]], dim=2)
        lst = torch.where(j256 < lim[:, :, k, None], shifted, lst)
    e = torch.cat(es, dim=2)                                # (B, C, K)

    # exclusive compose over the chunk permutations: S_{c+1} = S_c[P_c]
    P = lst.to(torch.int64)
    S = j256.expand(B, 256)
    S_all = []
    for c in range(C):
        S_all.append(S)
        S = torch.gather(S, 1, P[:, c])
    S_all = torch.stack(S_all, dim=1)                       # (B, C, 256)
    F = torch.gather(used_list.to(i32)[:, None, :].expand(B, C, 256), 2,
                     S_all.to(torch.int64))
    g = (torch.arange(C, dtype=i32, device=dev)[None, :, None] * 256
         + e.clamp(0, 255)).reshape(B, C * K)
    return torch.gather(F.reshape(B, C * 256), 1, g.to(torch.int64))[:, :M]


def mtf_inverse(syms, used_list, n_used, n_mtf, n_chunks: int | None = None):
    """syms (B, M) int32; used_list (B, 256) int32 initial MTF list (padded
    0); n_used/n_mtf (B,) int32.  Returns vals (B, M) int32: the decoded
    byte per symbol (for RUNA/RUNB, the byte the zero run repeats), at
    every position, past n_mtf too.  ``n_chunks`` None takes
    ``chunks_for(B, M)`` on the card and ``MTF_CHUNKS`` on the CPU; a
    count given is honoured on both."""
    if syms.dim() != 2 or (n_chunks is not None and n_chunks < 1):
        raise ValueError(f"mtf_inverse: syms {tuple(syms.shape)}, "
                         f"{n_chunks} chunks")
    if syms.device.type == "cpu":
        return mtf_inverse_plain(syms, used_list, n_used, n_mtf,
                                 MTF_CHUNKS if n_chunks is None else n_chunks)
    B, M = syms.shape
    C = chunks_for(B, M) if n_chunks is None else n_chunks
    W = super_for(C)
    _build.check(syms, "mtf_inverse syms", i32, 2)
    _build.check(used_list, "mtf_inverse used_list", i32, 2)
    _build.check(n_used, "mtf_inverse n_used", i32, 1)
    if tuple(used_list.shape) != (B, 256) or tuple(n_used.shape) != (B,):
        raise ValueError(f"mtf_inverse: used_list {tuple(used_list.shape)}, "
                         f"n_used {tuple(n_used.shape)} for {B} rows")
    dev = syms.device
    e = torch.empty((B, M), dtype=torch.uint8, device=dev)
    perm = torch.empty((B, C, 256), dtype=torch.uint8, device=dev)
    q = torch.empty((B, -(-C // W), 256), dtype=torch.uint8, device=dev)
    vals = torch.empty((B, M), dtype=i32, device=dev)
    KERNEL(_build.ptr(syms), _build.ptr(used_list), _build.ptr(n_used),
           _build.ptr(e), _build.ptr(perm), _build.ptr(q), _build.ptr(vals),
           B, M, C, W, _build.stream_of(syms))
    return vals
