"""Batched BWT rotation sort by prefix doubling (port of
``bzip2_tpu/ops/bwt.py:bwt_batched``, packed-pair formulation).

Every reorder after the initial 16-byte sort packs its keys into one
(a, b) int32 pair and goes through ``sort_kernel.sort_pairs``: ranks r1 and
r2 and a position take 20 bits each, over the 62 usable bits of the pair
(r1:20 | r2 hi 11 in a, r2 lo 9 | pos:20 in b).  The initial 4-key sort is
two stable ``torch.sort``s of packed int64 keys: gapped ranks depend only
on tie classes, so the order within a class does not matter.

The doubling loops (the full-width stage and each compact tail stage, the
JAX package's ``lax.while_loop`` loops) run on the rows' device: each
stage's loop test and one round are captured into a CUDA graph whose
conditional WHILE node repeats the round while the test, run on the card,
holds (``bwt_kernel.loop``).  The graphs keep the pointers and shapes
they were captured on, so the loops' buffers and graphs form a plan: one
for each (stream, N), with as many rows as the most a call on it has had;
a call with fewer rows runs its rows and dummy rows of one byte, which
resolve at once (``_plan``).  On a CUDA tensor a call that finds its plan
makes no host sync from entry to return.  A call that makes a plan waits
for the card (instantiating a graph with conditional nodes does), and so
does one that drops a plan (a bigger one replaces it, or more than
``_PLANS_MAX`` are kept); on the CPU the same loops run on the host
through the plain versions.

origPtr follows the tie policy of ``bzip2_tpu.oracle.bwt`` (last in-class
slot).
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict

import torch

from .. import _build, tracing
from . import bwt_kernel as bk
from .sort_kernel import MIN_N, sort_buffers, sort_pairs

INF = 0x7FFFFFFF
P20 = (1 << 20) - 1
_INIT_BYTES = 16          # initial rank depth (4 packed 32-bit keys)

#: when set, called as ``ROUND_HOOK(stage, k, unres)`` for the initial
#: 16-byte ranks and each doubling round that ran in a ``bwt_batched`` call:
#: stage 0 for the initial ranks and the full-width rounds, 1, 2, ... for
#: the compact tail stages; ``k`` is the prefix length the ranks then
#: resolve and ``unres`` (B,) int32 the positions still tied.  The rows come
#: from the round record the device writes, read once at the end of the
#: call, and only when the hook is set (the span ``round_hook``).  The
#: measurement tools set it (``tools/bwt_stats.py``,
#: ``tools/scale_bench.py``, ``tools/span_idle.py --round-hook``).
ROUND_HOOK = None


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


class _Plan:
    """The buffers of bwt_batched's doubling loops for B rows of width N on
    one stream, each stage's loop on them, and (on a card) the loops' entry
    and round counts."""

    def __init__(self, B: int, N: int, dev):
        i32 = torch.int32
        self.B = B
        self.n = torch.empty((B,), dtype=i32, device=dev)
        self.rank = torch.empty((B, N), dtype=i32, device=dev)
        self.tied = torch.empty((B, N), dtype=torch.bool, device=dev)
        self.unres = torch.empty((B,), dtype=i32, device=dev)
        self.ctl = bk.control(dev)
        # the round record: the initial ranks and each round, at most one a
        # doubling of k from 16 to N
        self.rec = torch.empty((bk.rounds_bound(N) + 1, B + 2), dtype=i32,
                               device=dev)
        # rankD: rank with a dump column at N (dead tail lanes)
        self.rankD = torch.full((B, N + 1), N, dtype=i32, device=dev)
        ladder = _tail_ladder(N)
        self.caps = ladder[1:] + [0]
        # full width: the pair buffers are sort_pairs' width; the lanes past
        # N hold the distinct (INF, bit29 | pos) sentinels, which sort last
        NP = max(MIN_N, 1 << (N - 1).bit_length())
        A = torch.empty((B, NP), dtype=i32, device=dev)
        Bv = torch.empty((B, NP), dtype=i32, device=dev)
        A[:, N:].fill_(INF)
        Bv[:, N:].copy_((1 << 29) | torch.arange(N, NP, dtype=i32, device=dev))
        self.counts = (None if dev.type == "cpu" else
                       torch.zeros((len(ladder) + 1, 2), dtype=i32, device=dev))
        # the rerank's scratch: the full-width rounds' and the 16-byte
        # ranks'
        self.scratch = bk.rerank_scratch(B, N, dev)
        full = bk.Round(self.rank, self.n, self.ctl, self.unres, A, Bv,
                        sort_buffers(B, NP, dev), self.scratch, self.tied)
        self.loops = [bk.StageLoop(full, self.ctl, self.unres, self.rec, N,
                                   ladder[0], 0, bk.ENTRY_RECORD,
                                   self._counts(0))]
        # the compact tail stages: stage s refines (p, r1) of width
        # ladder[s - 1] until at most caps[s - 1] positions a row are tied
        self.tails = []
        for stage, (C, cap) in enumerate(zip(ladder, self.caps), 1):
            p = torch.empty((B, C), dtype=i32, device=dev)
            r1 = torch.empty((B, C), dtype=i32, device=dev)
            un = torch.empty((B, C), dtype=torch.bool, device=dev)
            self.tails.append((p, r1, un))
            tail = bk.Round(
                self.rankD, self.n, self.ctl, self.unres,
                torch.empty((B, C), dtype=i32, device=dev),
                torch.empty((B, C), dtype=i32, device=dev),
                sort_buffers(B, C, dev), bk.tail_scratch(B, C, dev), un, p, r1)
            self.loops.append(bk.StageLoop(tail, self.ctl, self.unres,
                                           self.rec, N, cap, stage, bk.ENTRY,
                                           self._counts(stage)))
        self.lock = threading.Lock()
        self.dropped = False        # set, under lock, when the cache drops it

    def _counts(self, stage: int):
        return None if self.counts is None else self.counts[stage]

    def fold(self) -> None:
        """Add the launches and rounds the card counted in the plan's
        graphs; the caller has synchronized the card."""
        with _FOLD_LOCK:
            for lp, c in zip(self.loops, self.counts.tolist()):
                _ROUNDS[lp.stage] += c[1] - lp.folded[1]
                lp.fold(c)

    def free(self) -> None:
        """Count what the card ran, then drop the graphs: waits for the
        card.  The graph lock is held throughout, so that no other thread
        builds a graph while the card is synchronized."""
        with bk.GRAPHS_LOCK:
            torch.cuda.synchronize(self.rank.device)
            self.fold()
            for lp in self.loops:
                lp.free()


#: the plans of CUDA streams by (device, stream, N), least recently used
#: first; past _PLANS_MAX an idle plan is dropped, which waits until its
#: card is idle (its graphs are destroyed)
_PLANS: OrderedDict = OrderedDict()
_PLANS_MAX = 8
_PLANS_LOCK = threading.Lock()
_FOLD_LOCK = threading.Lock()
#: the doubling rounds the card ran in each stage (0 the full width, 1, 2,
#: ... the compact tail stages) in every plan made so far, dropped ones
#: included, as far as their counts are folded in (under _FOLD_LOCK)
_ROUNDS = [0] * (len(_tail_ladder(1 << 20)) + 1)


def _plan(B: int, N: int, dev) -> _Plan:
    """A plan of width N with at least B rows on the current stream,
    locked: a new one on the CPU, else the cached one, made at the first
    call and replaced by one of B rows when B is more than it has.  Making
    a plan, and dropping the plans that it replaces or that overflow the
    cache (only a call that makes one drops any), is the span
    ``bwt_plan``."""
    if dev.type == "cpu":
        with tracing.span("bwt_plan", None, rows=B, n=N):
            plan = _Plan(B, N, dev)
        plan.lock.acquire()
        return plan
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream, N)
    while True:
        idle, busy = [], []
        with contextlib.ExitStack() as made:
            with _PLANS_LOCK:
                plan = _PLANS.get(key)
                if plan is None or plan.B < B:
                    made.enter_context(tracing.span("bwt_plan", None,
                                                    rows=B, n=N))
                    if plan is not None:    # too few rows: replaced
                        plan.dropped = True
                        busy.append(plan)
                    plan = _PLANS[key] = _Plan(B, N, dev)
                _PLANS.move_to_end(key)
                for k, old in list(_PLANS.items()):
                    if len(_PLANS) <= _PLANS_MAX:
                        break
                    # an idle plan only: one another call holds stays
                    if k != key and old.lock.acquire(blocking=False):
                        old.dropped = True
                        idle.append(_PLANS.pop(k))
            for old in busy:        # its call (same stream) ends soon
                old.lock.acquire()
                idle.append(old)
            for old in idle:
                old.free()
                old.lock.release()
        plan.lock.acquire()
        if not plan.dropped:
            return plan
        plan.lock.release()     # dropped by another call meanwhile: again


def _settle() -> None:
    """Add the launches the card counted in the cached plans' graphs to
    the kernels' counts (waits for the card)."""
    with _PLANS_LOCK:
        plans = list(_PLANS.values())
    if not plans:
        return
    with bk.GRAPHS_LOCK:
        for dev in {p.rank.device for p in plans}:
            torch.cuda.synchronize(dev)
        for p in plans:
            p.fold()


_build.SETTLERS.append(_settle)


def stage_rounds() -> list | None:
    """The doubling rounds the card has run so far in each stage, stage 0
    the full width and 1, 2, ... the compact tail stages, summed over
    every ``bwt_batched`` call on a card (plans dropped since included).
    Folds in the cached plans' counts first, which waits for the card once.
    None without a card, where the loops run on the host and count
    nothing."""
    if not torch.cuda.is_available():
        return None
    _settle()
    with _FOLD_LOCK:
        return list(_ROUNDS)


def bwt_batched(blocks: torch.Tensor, n: torch.Tensor):
    """blocks: uint8 (B, N); n: int32 (B,) true lengths (>= 1).

    Returns (last uint8 (B, N), orig_ptr int32 (B,), sa int32 (B, N)).
    Pad positions of ``last`` are 0.  The plan and the launches are the
    span ``bwt`` {rows, width}; the round hook's read follows it."""
    B, N = blocks.shape
    if N > (1 << 20):
        raise ValueError("rank packing assumes block size <= 2^20")
    dev = blocks.device
    n = n.to(torch.int32)
    plan = None
    try:
        with tracing.span("bwt", None, rows=B, width=N):
            plan = _plan(B, N, dev)
            if plan.B > B:          # dummy rows of one byte fill the plan
                blocks = torch.cat([blocks,
                                    blocks.new_zeros((plan.B - B, N))])
                n = torch.cat([n, n.new_ones(plan.B - B)])
            last, orig_ptr, sa = _bwt(plan, blocks, n)
        if ROUND_HOOK is not None:      # a device read: waits for the card
            with tracing.span("round_hook", None):
                _replay_rounds(plan.ctl, plan.rec, B)
    finally:
        if plan is not None:
            plan.lock.release()
    return last[:B], orig_ptr[:B], sa[:B]


def _bwt(plan, blocks, n):
    """bwt_batched on the plan's rows."""
    B, N = blocks.shape
    dev = blocks.device
    i32 = torch.int32
    idx = torch.arange(N, dtype=i32, device=dev)[None, :]
    valid = idx < n[:, None]
    nn = torch.clamp(n[:, None], min=1)

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
    return _rounds_and_order(plan, bi, bx, n, valid, idx, hs,
                             torch.gather(lo, 1, order64), order64)


def _rounds_and_order(plan, bi, bx, n, valid, idx, hs, lo_s, order64):
    """The initial ranks' rerank, the doubling loops on the plan's buffers,
    then the final order, the last column and origPtr."""
    B, N = plan.rank.shape
    i32 = torch.int32
    plan.n.copy_(n)
    bk.rerank(hs, lo_s, order64, plan.n, plan.rank, plan.tied, plan.unres,
              scratch=plan.scratch)
    bk.reset_control(plan.ctl)
    plan.rec.zero_()
    ladder = _tail_ladder(N)

    # ---------------- stage 1: full-width doubling passes ----------------
    bk.loop(plan.loops[0])

    # -------------- stages 2+: compact tail refinement --------------
    plan.rankD[:, :N].copy_(plan.rank)
    p_new, r_new = _compact_by_sort(
        torch.where(plan.tied, idx.expand(B, N), INF), plan.rank, ladder[0])
    for (p, r1, unresolved), cap, lp in zip(plan.tails, plan.caps,
                                            plan.loops[1:]):
        p.copy_(p_new)
        r1.copy_(r_new)
        # at stage entry every live buffer entry is (still) unresolved
        torch.ge(p, 0, out=unresolved)
        bk.loop(lp)
        if cap:
            p_new, r_new = _compact_by_sort(torch.where(unresolved, p, INF),
                                            r1, cap)
    rank = plan.rankD[:, :N]

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


def _replay_rounds(ctl, rec, B: int) -> None:
    """Feed ROUND_HOOK from the round record (one device read), for the
    call's B rows."""
    ctl, rec = ctl.cpu(), rec.cpu()
    for row in rec[:int(ctl[bk.ROWS])]:
        ROUND_HOOK(int(row[0]), int(row[1]), row[2:2 + B])
