"""MTF rank scan and per-group histograms: wrappers of the CUDA kernels
in ``csrc/mtf_ranks.cu`` and ``csrc/group_hist.cu``, each with its plain
PyTorch version.

Counterpart of ``bzip2_tpu/ops/mtf_pallas.py``.  ``mtf_ranks`` keeps the
Pallas structure: per 256-position tile the last occurrence of each symbol
(kernel ``mtf_tile_last``, which writes them shifted one tile on, with the
initial list's seeds in front), the exclusive cross-tile carries by a plain
``torch.cummax`` over those slots, then the rank of each position from its
tile and the carries (kernel ``mtf_rank``).  A wrapper runs its plain
version only for a tensor on the CPU; for a CUDA tensor it launches its
kernel.
"""
from __future__ import annotations

import ctypes as ct

import torch

from .. import _build

PTILE = 256          # positions per MTF tile
PAD_SYM = 300        # symbol id of invalid positions: matches nothing
ALPHA = 258          # histogram width (MTF/RLE2 alphabet)
_NEG = -(1 << 30)
_PLAIN_ROWS = 128    # tiles per chunk of the plain rank (bounds its one-hots)
_PLAIN_GROUPS = 4096  # groups per chunk of the plain histogram

TILE_LAST = _build.Kernel("mtf_tile_last", "bz2t_mtf_tile_last",
                          [ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_int,
                           ct.c_void_p])
RANK = _build.Kernel("mtf_rank", "bz2t_mtf_rank",
                     [ct.c_void_p] * 3 + [ct.c_int64, ct.c_void_p])
GROUP_HIST = _build.Kernel("group_hist", "bz2t_group_hist",
                           [ct.c_void_p] * 3 + [ct.c_int] * 4 + [ct.c_void_p])


def _check_tiles(t: torch.Tensor, name: str) -> None:
    if t.dim() != 2 or t.shape[1] != PTILE:
        raise ValueError(f"{name}: expected (rows, {PTILE}), got {tuple(t.shape)}")


# ------------------------------------------------------------ tile last --

def tile_last_plain(seqm: torch.Tensor, tiles_per_row: int) -> torch.Tensor:
    rows = seqm.shape[0]
    dev = seqm.device
    last = torch.empty((rows, 256), dtype=torch.int32, device=dev)
    sym = torch.arange(256, dtype=torch.int32, device=dev)
    it = torch.arange(PTILE, dtype=torch.int32, device=dev)[None, :, None]
    for r0 in range(0, rows, _PLAIN_ROWS):
        s = seqm[r0:r0 + _PLAIN_ROWS]
        occ = torch.where(s[:, :, None] == sym, it, -1)
        last[r0:r0 + _PLAIN_ROWS] = occ.amax(dim=1)
    T = tiles_per_row
    l3 = last.reshape(rows // T, T, 256)
    base = (torch.arange(T, dtype=torch.int32, device=dev) * PTILE)[None, :, None]
    out = torch.empty_like(l3)
    out[:, 0] = -(sym + 1)
    out[:, 1:] = torch.where(l3 >= 0, base + l3, _NEG)[:, :-1]
    return out.reshape(rows, 256)


def tile_last(seqm: torch.Tensor, tiles_per_row: int) -> torch.Tensor:
    """seqm: (rows, 256) int32 symbols (PAD_SYM at invalid positions), rows
    = B * tiles_per_row.  Returns (rows, 256) int32, the carries' cummax
    input: in each row, slot 0 holds the initial list's seeds (symbol j at
    -(j+1)) and slot t+1 tile t's last occurrence of each symbol as a row
    index (t * 256 + in-tile index), or -2^30 where it does not occur."""
    _check_tiles(seqm, "tile_last")
    if seqm.shape[0] % tiles_per_row:
        raise ValueError(f"tile_last: {seqm.shape[0]} tiles do not split "
                         f"into rows of {tiles_per_row}")
    if seqm.device.type == "cpu":
        return tile_last_plain(seqm, tiles_per_row)
    _build.check(seqm, "tile_last seq", torch.int32, 2)
    out = torch.empty_like(seqm)
    TILE_LAST(_build.ptr(seqm), _build.ptr(out), seqm.shape[0], tiles_per_row,
              _build.stream_of(seqm))
    return out


# ----------------------------------------------------------------- rank --

def rank_plain(seqm: torch.Tensor, lx: torch.Tensor) -> torch.Tensor:
    """The one-hot cummax formulation of the Pallas rank kernel, chunked
    over tiles: rank = #{s: excl[s] > excl[cur]} if cur occurred earlier in
    the tile, else #{s seen in the tile prefix} + #{s unseen: lx[s] > lx[cur]}."""
    rows = seqm.shape[0]
    dev = seqm.device
    live = ((seqm >= 0) & (seqm < 256)).any(dim=1)
    if not bool(live.all()):    # tiles of padding alone rank to 0
        out = torch.zeros((rows, PTILE), dtype=torch.int32, device=dev)
        if bool(live.any()):
            out[live] = rank_plain(seqm[live], lx[live])
        return out
    out = torch.empty((rows, PTILE), dtype=torch.int32, device=dev)
    sym = torch.arange(256, dtype=torch.int32, device=dev)
    it = torch.arange(PTILE, dtype=torch.int32, device=dev)[None, :, None]
    for r0 in range(0, rows, _PLAIN_ROWS):
        s = seqm[r0:r0 + _PLAIN_ROWS]
        L = lx[r0:r0 + _PLAIN_ROWS]
        R = s.shape[0]
        onehot = s[:, :, None] == sym                       # (R, T, 256)
        incl = torch.cummax(torch.where(onehot, it, -1), dim=1).values
        excl = torch.cat([torch.full((R, 1, 256), -1, dtype=torch.int32,
                                     device=dev), incl[:, :-1]], dim=1)
        cur = torch.where(onehot, excl, 0).sum(dim=2)
        prv = torch.where(onehot, L[:, None, :], 0).sum(dim=2)
        within = (excl > cur[:, :, None]).sum(dim=2)
        cross = ((excl < 0) & (L[:, None, :] > prv[:, :, None])).sum(dim=2)
        r = torch.where(cur >= 0, within, within + cross)
        ok = (s >= 0) & (s < 256)
        out[r0:r0 + _PLAIN_ROWS] = torch.where(ok, r, 0).to(torch.int32)
    return out


def rank(seqm: torch.Tensor, lx: torch.Tensor) -> torch.Tensor:
    """seqm: (rows, 256) int32 symbols; lx: (rows, 256) int32 carries as
    ``carries`` makes them (distinct within a tile, in [-256, 2^24 - 256)).
    Returns (rows, 256) int32 MTF ranks, 0 at invalid symbols."""
    _check_tiles(seqm, "rank seq")
    _check_tiles(lx, "rank lx")
    if seqm.device.type == "cpu":
        return rank_plain(seqm, lx)
    _build.check(seqm, "rank seq", torch.int32, 2)
    _build.check(lx, "rank lx", torch.int32, 2)
    if lx.data_ptr() % 16:
        raise ValueError("rank lx: the kernel reads it in 16-byte vectors; "
                         "pass a 16-byte aligned tensor")
    out = torch.empty_like(seqm)
    RANK(_build.ptr(seqm), _build.ptr(lx), _build.ptr(out), seqm.shape[0],
         _build.stream_of(seqm))
    return out


def carries(tl: torch.Tensor, B: int) -> torch.Tensor:
    """Exclusive cross-tile carries (each symbol's last occurrence in its
    row before each tile, or its seed -(j+1)) from ``tile_last``'s output:
    a cummax over each row's slots."""
    return torch.cummax(tl.reshape(B, -1, 256), dim=1).values.reshape(-1, 256)


def mtf_ranks(seq: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """seq: (B, N) int32 symbols 0..255; valid: (B, N) bool.
    Returns (B, N) int32 MTF ranks; invalid positions get 0.  N is padded
    to whole tiles here."""
    B, N = seq.shape
    Np = -(-N // PTILE) * PTILE
    seqm = torch.where(valid, seq, PAD_SYM).to(torch.int32)
    if Np > N:
        seqm = torch.nn.functional.pad(seqm, (0, Np - N), value=PAD_SYM)
    seqm = seqm.reshape(B * (Np // PTILE), PTILE).contiguous()
    lx = carries(tile_last(seqm, Np // PTILE), B).contiguous()
    return rank(seqm, lx).reshape(B, Np)[:, :N]


# ----------------------------------------------------------- group hist --

def group_hist_plain(mtfv: torch.Tensor, n_mtf: torch.Tensor,
                     g_size: int = 50) -> torch.Tensor:
    """One-hot segment sum, chunked over groups."""
    B, M = mtfv.shape
    G = -(-M // g_size)
    dev = mtfv.device
    pos = torch.arange(G * g_size, dtype=torch.int64, device=dev)[None, :]
    syms = torch.nn.functional.pad(mtfv, (0, G * g_size - M))
    syms = torch.where(pos < n_mtf[:, None].to(torch.int64), syms, PAD_SYM)
    syms = syms.reshape(B, G, g_size)
    alpha = torch.arange(ALPHA, dtype=syms.dtype, device=dev)
    out = torch.empty((B, G, ALPHA), dtype=torch.int32, device=dev)
    for g0 in range(0, G, _PLAIN_GROUPS):
        s = syms[:, g0:g0 + _PLAIN_GROUPS]
        out[:, g0:g0 + _PLAIN_GROUPS] = (
            s[..., None] == alpha).sum(dim=2, dtype=torch.int32)
    return out


def group_hist(mtfv: torch.Tensor, n_mtf: torch.Tensor,
               g_size: int = 50) -> torch.Tensor:
    """(B, M) int32 symbols, (B,) int32 lengths -> (B, G, 258) int32 counts
    of each symbol in every g_size-symbol group (positions >= n_mtf and
    symbols outside 0..257 count nowhere)."""
    if mtfv.dim() != 2 or n_mtf.shape != (mtfv.shape[0],):
        raise ValueError(f"group_hist: shapes {tuple(mtfv.shape)} "
                         f"{tuple(n_mtf.shape)}")
    if mtfv.device.type == "cpu":
        return group_hist_plain(mtfv, n_mtf, g_size)
    _build.check(mtfv, "group_hist mtfv", torch.int32, 2)
    _build.check(n_mtf, "group_hist n_mtf", torch.int32, 1)
    B, M = mtfv.shape
    G = -(-M // g_size)
    out = torch.empty((B, G, ALPHA), dtype=torch.int32, device=mtfv.device)
    GROUP_HIST(_build.ptr(mtfv), _build.ptr(n_mtf), _build.ptr(out), B, M, G,
               g_size, _build.stream_of(mtfv))
    return out
