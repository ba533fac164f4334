"""Batched BWT rotation sort by prefix doubling (port of
``bzip2_tpu/ops/bwt.py:bwt_batched``, packed-pair formulation).

Every reorder after the initial 16-byte sort packs its keys into one
(a, b) int32 pair and goes through ``sort_kernel.sort_pairs``: ranks r1 and
r2 and a position take 20 bits each, over the 62 usable bits of the pair
(r1:20 | r2 hi 11 in a, r2 lo 9 | pos:20 in b).  The only device-dependent
step is that function.  The initial 4-key sort is two stable
``torch.sort``s of packed int64 keys: gapped ranks depend only on tie
classes, so the order within a class does not matter.

origPtr follows the tie policy of ``bzip2_tpu.oracle.bwt`` (last in-class
slot).
"""
from __future__ import annotations

import torch

from .sort_kernel import MIN_N, sort_pairs

INF = 0x7FFFFFFF
P20 = (1 << 20) - 1
_INIT_BYTES = 16          # initial rank depth (4 packed 32-bit keys)
_MIRROR = 2048            # static width of the pad-mirror region


def _sort_cols(A, Bv):
    """Sort packed (A, B) int32 columns lexicographically, padding the width
    to a power of two (>= 128) with distinct (INF, bit29 | pos) sentinels."""
    B, C = A.shape
    NP = max(MIN_N, 1 << (C - 1).bit_length())
    if NP > C:
        padpos = torch.arange(C, NP, dtype=torch.int32, device=A.device)
        A = torch.cat([A, torch.full((B, NP - C), INF, dtype=torch.int32,
                                     device=A.device)], dim=1)
        Bv = torch.cat([Bv, ((1 << 29) | padpos).expand(B, NP - C)], dim=1)
    As, Bs = sort_pairs(A.contiguous(), Bv.contiguous())
    return As[:, :C], Bs[:, :C]


def _pack4(p0, p1, p2, p3):
    """Four byte planes -> one sign-biased int32 key (unsigned order).
    p0 << 24 overflows int32, so the key is built in int64 and folded back
    to int32 with the bias applied (k - 2^31 for the unsigned value k)."""
    k = ((p0.to(torch.int64) << 24) | (p1.to(torch.int64) << 16)
         | (p2.to(torch.int64) << 8) | p3.to(torch.int64))
    return (k - (1 << 31)).to(torch.int32)


def _changed(cols):
    """True where any column differs from its left neighbour (and at 0)."""
    B, S = cols[0].shape
    ch = torch.zeros((B, S), dtype=torch.bool, device=cols[0].device)
    ch[:, 0] = True
    for c in cols:
        ch[:, 1:] |= c[:, 1:] != c[:, :-1]
    return ch


def _gapped_rerank(key_cols):
    """Gapped rank (sorted index of the class's first member) and singleton
    flag of every sorted entry."""
    changed = _changed(key_cols)
    B, S = changed.shape
    j = torch.arange(S, dtype=torch.int32, device=changed.device)[None, :]
    start = torch.cummax(torch.where(changed, j, 0), dim=1).values
    nxt = torch.cat([changed[:, 1:], torch.ones((B, 1), dtype=torch.bool,
                                                device=changed.device)], dim=1)
    return start, changed & nxt


def _scatter_rank(order, start, singleton, valid, n, N):
    """Map gapped ranks back to position space and refresh the pad mirror.
    Returns (rank (B,N), tied (B,N), unres (B,))."""
    B = order.shape[0]
    dev = order.device
    v = (start << 1) | singleton.to(torch.int32)
    # order is a permutation of 0..N-1 per row: a direct scatter inverts it
    packed = torch.empty((B, N), dtype=torch.int32, device=dev)
    packed.scatter_(1, order.to(torch.int64), v)
    rank = packed >> 1
    tied = ((packed & 1) == 0) & valid
    unres = tied.sum(dim=1)
    # overwrite the pad region with a cyclic mirror of rank[0:ms] so a roll
    # can realise rank[(i+k) mod n] while k <= slack.  Only the lanes that
    # land inside the row are written: the row's last slot may be the
    # target of a kept lane, and a scatter with duplicate targets has no
    # defined order on CUDA.
    ms = min(_MIRROR, N)
    jm = torch.arange(ms, dtype=torch.int64, device=dev)[None, :]
    tgt = n.to(torch.int64)[:, None] + jm
    keep = tgt < N
    mv = rank[:, :ms]
    rows = torch.arange(B, device=dev)[:, None].expand(B, ms)
    rank[rows[keep], tgt[keep]] = mv[keep]
    return rank, tied, unres


def _tail_ladder(N: int) -> list[int]:
    def p2(x):
        return 1 << (max(x, 1) - 1).bit_length()
    c = p2(max(N // 4, 128))
    out: list[int] = []
    for x in [c, c // 2, c // 4, c // 16, c // 64]:
        x = max(x, 128)
        if not out or x < out[-1]:
            out.append(x)
    return out


def _compact_by_sort(key, payload, cap):
    """Pack the entries with key < INF into the first ``cap`` columns
    (ordered by key).  Dead slots come back as (-1, INF)."""
    ks, vs = _sort_cols(key, payload)
    ks = ks[:, :cap]
    vs = vs[:, :cap]
    live = ks < INF
    return torch.where(live, ks, -1), torch.where(live, vs, INF)


def bwt_batched(blocks: torch.Tensor, n: torch.Tensor):
    """blocks: uint8 (B, N); n: int32 (B,) true lengths (>= 1).

    Returns (last uint8 (B, N), orig_ptr int32 (B,), sa int32 (B, N)).
    Pad positions of ``last`` are 0."""
    B, N = blocks.shape
    if N > (1 << 20):
        raise ValueError("rank packing assumes block size <= 2^20")
    dev = blocks.device
    i32 = torch.int32
    n = n.to(i32)
    idx = torch.arange(N, dtype=i32, device=dev)[None, :]
    valid = idx < n[:, None]
    nn = torch.clamp(n[:, None], min=1)
    # the while_loop conditions of the JAX version become host decisions
    min_slack = N - int(n.max().item())

    # --- cyclically-extended byte buffer: bx[i] = block[i mod n], i < n+16
    bi = torch.where(valid, blocks.to(i32), 0)
    ext = torch.arange(_INIT_BYTES, dtype=i32, device=dev)[None, :]
    wrap = torch.gather(bi, 1, torch.remainder(ext, nn).to(torch.int64))
    bx = torch.cat([bi, torch.zeros((B, _INIT_BYTES), dtype=i32, device=dev)],
                   dim=1)
    bx.scatter_(1, (n[:, None] + ext).to(torch.int64), wrap)

    # --- 16-byte initial keys from rolls of the extended buffer
    k1x = _pack4(bx, torch.roll(bx, -1, 1), torch.roll(bx, -2, 1),
                 torch.roll(bx, -3, 1))
    keys = [torch.where(valid, kx[:, :N], INF)
            for kx in (k1x, torch.roll(k1x, -4, 1), torch.roll(k1x, -8, 1),
                       torch.roll(k1x, -12, 1))]
    # two int64 keys ((k1, k2), (k3, k4)); LSD by stable sorts
    hi = (keys[0].to(torch.int64) << 32) | (keys[1].to(torch.int64) + (1 << 31))
    lo = (keys[2].to(torch.int64) << 32) | (keys[3].to(torch.int64) + (1 << 31))
    o1 = torch.sort(lo, dim=1, stable=True).indices
    hi1 = torch.gather(hi, 1, o1)
    hs, o2 = torch.sort(hi1, dim=1, stable=True)
    order64 = torch.gather(o1, 1, o2)
    start, singleton = _gapped_rerank([hs, torch.gather(lo, 1, order64)])
    rank, tied, unres = _scatter_rank(order64.to(i32), start, singleton,
                                      valid, n, N)

    ladder = _tail_ladder(N)
    cap0 = ladder[0]

    # ---------------- stage 1: full-width doubling passes ----------------
    def neighbour_ranks(rank, k):
        """rank[(i+k) mod n] (roll fast path when the pad mirror covers k)."""
        if k <= min(min_slack, _MIRROR):
            return torch.roll(rank, -k, 1)
        return torch.gather(rank, 1,
                            torch.remainder(idx + k, nn).to(torch.int64))

    k = _INIT_BYTES
    while k < N and bool((unres > cap0).any().item()):
        r2 = neighbour_ranks(rank, k)
        r1 = torch.where(valid, rank, P20)
        r2 = torch.where(valid, r2, P20)
        A = torch.where(valid, (r1 << 11) | (r2 >> 9), INF)
        Bv = torch.where(valid, ((r2 & 511) << 20) | idx, (1 << 29) | idx)
        As, Bs = _sort_cols(A, Bv)
        start, singleton = _gapped_rerank([As, Bs >> 20])
        rank, tied, unres = _scatter_rank(Bs & P20, start, singleton, valid,
                                          n, N)
        k *= 2

    # -------------- stages 2+: compact tail refinement --------------
    # rankD has a dump column at N for discarded scatter lanes.
    rankD = torch.cat([rank, torch.full((B, 1), N, dtype=i32, device=dev)],
                      dim=1)
    idx_b = idx.expand(B, N)
    p_buf, r_buf = _compact_by_sort(torch.where(tied, idx_b, INF), rank, cap0)

    def tail_stage(rankD, p, r1, k, unres, next_thresh):
        C = p.shape[1]
        jc = torch.arange(C, dtype=i32, device=dev)[None, :]
        unresolved = p >= 0
        while k < N and bool((unres > next_thresh).any().item()):
            live = p >= 0
            q = torch.where(live, torch.remainder(p + k, nn), N)
            n1 = torch.where(live, torch.gather(rankD, 1, q.to(torch.int64)),
                             P20)
            r1c = torch.where(live, torch.clamp(r1, max=P20), P20)
            A = torch.where(live, (r1c << 11) | (n1 >> 9), INF)
            Bv = torch.where(live, ((n1 & 511) << 20) | p, (1 << 29) | jc)
            As, Bs = _sort_cols(A, Bv)
            lives = As != INF
            ps = torch.where(lives, Bs & P20, -1)
            r1s = As >> 11
            changed_seg = _changed([r1s])
            changed_sub = changed_seg | _changed([As, Bs >> 20])
            seg_start = torch.cummax(torch.where(changed_seg, jc, 0), 1).values
            sub_start = torch.cummax(torch.where(changed_sub, jc, 0), 1).values
            new_r1 = torch.where(lives, r1s + (sub_start - seg_start), INF)
            nxt = torch.cat([changed_sub[:, 1:],
                             torch.ones((B, 1), dtype=torch.bool, device=dev)],
                            dim=1)
            unresolved = ~(changed_sub & nxt) & lives
            # dead lanes all write N into the dump column: order is moot
            rankD.scatter_(1, torch.where(lives, ps, N).to(torch.int64),
                           torch.where(lives, new_r1, N))
            unres = unresolved.sum(dim=1)
            p, r1, k = ps, new_r1, k * 2
        return rankD, p, r1, unresolved, k, unres

    for cap in ladder[1:] + [0]:
        rankD, p_buf, r_buf, unres_f, k, unres = tail_stage(
            rankD, p_buf, r_buf, k, unres, cap)
        if cap:
            p_buf, r_buf = _compact_by_sort(
                torch.where(unres_f, p_buf, INF), r_buf, cap)
    rank = rankD[:, :N]

    # ---------------- final order + last column + origPtr ----------------
    lastb = torch.gather(bi, 1, torch.clamp(n - 1, min=0)[:, None].to(torch.int64))
    pb = torch.where(idx == 0, lastb, torch.roll(bx, 1, 1)[:, :N])
    # final keys are distinct (converged ranks on valid positions, N+idx
    # on pads), so the reorder is deterministic
    rk = torch.where(valid, rank, N + idx)
    _, Bs = _sort_cols(rk, (pb << 20) | idx)
    sa = Bs & P20
    last = torch.where(valid, Bs >> 20, 0).to(torch.uint8)

    r0 = rank[:, :1]
    orig_ptr = (valid & (rank <= r0)).sum(dim=1) - 1
    return last, orig_ptr.to(i32), sa
