"""The BWT's doubling rounds: wrappers of the CUDA kernels in
``csrc/bwt_rounds.cu``, their plain PyTorch versions, and the loop that
runs them.

Counterparts of the bodies and loop tests of the ``lax.while_loop`` loops of
``bzip2_tpu/ops/bwt.py`` (the full-width loop and the compact tail stages)
with their ``_gapped_rerank`` and ``_scatter_rank``; none has a Pallas
original.  The loop's state lives in ``ctl``, an int32 (3,) tensor on the
rows' device: ``ctl[GATE]`` (the last loop test), ``ctl[K]`` (the prefix
length the ranks resolve) and ``ctl[ROWS]`` (the rows of the round record
written).  A round is :func:`keys` (a full-width or a tail round's pair),
``sort_kernel.sort_pairs``, then :func:`rerank` (full width, and for the
16-byte initial ranks) or :func:`tail_rerank` (new ranks, tie flags and
per-row counts, written in place), which ends with the loop test
``k < N and any(unres > thresh)`` after doubling k (a :class:`LoopTest`,
run by the CTA that finishes last); :func:`gate` runs the test at a
stage's entry.

:func:`loop` runs one stage's :class:`StageLoop`: on a CUDA tensor the
entry test and one :class:`Round`, built at its first run into a CUDA
graph whose conditional WHILE node repeats the round while the test holds
(one C call captures it), are launched with no host sync; on the CPU it is
a Python while loop over the plain versions that reads the gate on the
host.  A wrapper runs its plain version only for a tensor on the CPU; for
a CUDA tensor it launches its kernel.  Inside a graph the entry gate
counts the stage's entries and the round's last kernel its rounds on the
card, and :meth:`StageLoop.fold` turns them into launches of the kernels
the graph holds: the gate once an entry, the round's kernels once a round
that ran.

The plain versions are the host-driven loop's bodies.  Neither route
writes the JAX package's pad mirror (rank[0:2048] copied past each row's
end so that a roll can stand in for the neighbour gather while k <= N -
max(n)); both read through the mirror's index map instead, because on a
row shorter than k (an exactly periodic one) that roll reads the pads' own
ranks, not rank[(i + k) mod n], and the reference's output depends on it.
"""
from __future__ import annotations

import ctypes as ct
import threading
from typing import NamedTuple, Optional

import torch

from .. import _build, tracing
from .sort_kernel import KERNEL as SORT
from .sort_kernel import TILE as SORT_TILE
from .sort_kernel import sort_pairs

INF = 0x7FFFFFFF
P20 = (1 << 20) - 1
#: width of the JAX package's pad mirror (bzip2_tpu/ops/bwt.py _MIRROR)
MIRROR = 2048
#: sorted entries a CTA reranks; csrc/bwt_rounds.cu's kTile
TILE = 4096
#: compact entries a CTA of the tail rerank takes; its kTailTile
TAIL_TILE = 2048
#: ctl's fields
GATE, K, ROWS = 0, 1, 2
#: gate modes: the loop test at a stage's entry; the same after recording
#: (stage, k, unres); after a round (k *= 2, record, test: the round's last
#: kernel runs it)
ENTRY, ENTRY_RECORD, AFTER_ROUND = 0, 1, 2

i32, i64 = torch.int32, torch.int64
_P = ct.c_void_p

#: the loop test's arguments after a round: ctl, rec, cnt, thresh, stage,
#: rec_rows, the graph's handle, has_cond
_TEST_ARGS = [_P] * 3 + [ct.c_int] * 3 + [ct.c_ulonglong, ct.c_int]
KEYS = _build.Kernel("bwt_keys", "bz2t_bwt_keys",
                     [_P] * 7 + [ct.c_int] * 4 + [_P])
RERANK = _build.Kernel("bwt_rerank", "bz2t_bwt_rerank",
                       [_P] * 8 + [ct.c_int] * 5 + _TEST_ARGS + [_P])
TAIL = _build.Kernel("bwt_tail_rerank", "bz2t_bwt_tail_rerank",
                     [_P] * 8 + [ct.c_int] * 3 + _TEST_ARGS + [_P])
GATE_K = _build.Kernel("bwt_gate", "bz2t_bwt_gate",
                       [_P] * 4 + [ct.c_int] * 6 + [ct.c_ulonglong, ct.c_int,
                                                    _P])
#: the calls that make and run the loop graphs (no kernel of their own)
CAPTURE = _build.Function("bwt_capture_stream", "bz2t_bwt_capture_stream",
                          [_P])
LOOP_BUILD = _build.Function(
    "bwt_loop_build", "bz2t_bwt_loop_build",
    [_P] * 5 + [ct.c_int] * 6 + [_P] * 6 + [ct.c_int] * 2 + [_P] * 4
    + [ct.c_int] * 2 + [_P] * 4)
LOOP_LAUNCH = _build.Function("bwt_loop_launch", "bz2t_bwt_loop_launch",
                              [_P, _P])
LOOP_FREE = _build.Function("bwt_loop_free", "bz2t_bwt_loop_free", [_P, _P])
#: cudaErrorStreamCaptureInvalidated: another thread synchronized the card
#: while a loop graph was captured; the build is made again
CAPTURE_INVALIDATED = 901
BUILD_TRIES = 4


def rounds_bound(N: int) -> int:
    """Doubling rounds from k = 16 until k >= N: the most any stage (and
    all stages together) can run."""
    r, k = 0, 16
    while k < N:
        k, r = 2 * k, r + 1
    return r


def reset_control(ctl) -> None:
    """ctl to gate 0, k = 16, no record rows, with no host copy."""
    ctl.zero_()
    ctl[K:K + 1].fill_(16)    # fill_, not item assignment: that syncs


def control(device) -> torch.Tensor:
    ctl = torch.empty(3, dtype=i32, device=device)
    reset_control(ctl)
    return ctl


# ------------------------------------------------------ plain versions --

def changed_plain(cols):
    """True where any column differs from its left neighbour (and at 0)."""
    B, S = cols[0].shape
    ch = torch.zeros((B, S), dtype=torch.bool, device=cols[0].device)
    ch[:, 0] = True
    for c in cols:
        ch[:, 1:] |= c[:, 1:] != c[:, :-1]
    return ch


def gapped_rerank_plain(key_cols):
    """Gapped rank (sorted index of the class's first member) and singleton
    flag of every sorted entry."""
    changed = changed_plain(key_cols)
    B, S = changed.shape
    j = torch.arange(S, dtype=i32, device=changed.device)[None, :]
    start = torch.cummax(torch.where(changed, j, 0), dim=1).values
    nxt = torch.cat([changed[:, 1:], torch.ones((B, 1), dtype=torch.bool,
                                                device=changed.device)], dim=1)
    return start, changed & nxt


def scatter_rank_plain(order, start, singleton, n):
    """Map gapped ranks back to position space.  order: (B, N), a
    permutation of 0..N-1 per row.  Returns (rank (B, N) int32, tied (B, N)
    bool, unres (B,) int32)."""
    B, N = order.shape
    v = (start << 1) | singleton.to(i32)
    packed = torch.empty((B, N), dtype=i32, device=order.device)
    packed.scatter_(1, order.to(i64), v)
    valid = torch.arange(N, device=order.device)[None, :] < n[:, None]
    tied = ((packed & 1) == 0) & valid
    return packed >> 1, tied, tied.sum(dim=1).to(i32)


def rerank_plain(ka, kb, order, n, S):
    """The rerank of the first S sorted entries of each row: two int64 key
    columns and their order (the 16-byte ranks), or, with order None, a
    round's sorted (A, B) pair (class key (A, B >> 20), position B & P20)."""
    ka, kb = ka[:, :S], kb[:, :S]
    if order is None:
        cols, order = [ka, kb >> 20], kb & P20
    else:
        cols, order = [ka, kb], order[:, :S]
    start, singleton = gapped_rerank_plain(cols)
    return scatter_rank_plain(order, start, singleton, n)


def neighbour_plain(rank, n, k: int):
    """rank[(i + k) mod n] as the JAX package reads it: through the pad
    mirror with a roll when k <= min(N - max(n), MIRROR), else by a
    gather.  The mirror holds rank[j] at n + j for j < min(MIRROR, N), so
    the roll reads rank[i + k - n] there and the pad's own rank further
    on (only for i + k >= 2n, i.e. k > n)."""
    B, N = rank.shape
    idx = torch.arange(N, dtype=i32, device=rank.device)[None, :]
    nc = n[:, None]
    roll = k <= torch.clamp(N - n.max(), max=MIRROR)
    t = idx + k
    mirrored = (t >= nc) & (t - nc < min(MIRROR, N))
    via_roll = torch.gather(rank, 1, torch.clamp(
        torch.where(mirrored, t - nc, t), max=N - 1).to(i64))
    via_gather = torch.gather(rank, 1, torch.remainder(
        t, torch.clamp(nc, min=1)).to(i64))
    return torch.where(roll, via_roll, via_gather)


def full_keys_plain(rank, n, k: int):
    """A full-width round's (A, B) pair: r1 = rank[i], r2 = the neighbour
    rank k on (``neighbour_plain``) packed as (r1 << 11 | r2 >> 9,
    (r2 & 511) << 20 | i), and (INF, 1 << 29 | i) at a pad."""
    B, N = rank.shape
    idx = torch.arange(N, dtype=i32, device=rank.device)[None, :]
    valid = idx < n[:, None]
    r2 = neighbour_plain(rank, n, k)
    r1 = torch.where(valid, rank, P20)
    r2 = torch.where(valid, r2, P20)
    A = torch.where(valid, (r1 << 11) | (r2 >> 9), INF)
    Bv = torch.where(valid, ((r2 & 511) << 20) | idx, (1 << 29) | idx)
    return A, Bv


def tail_keys_plain(rankD, p, r1, n, k: int):
    """A tail round's pair for the compact entries (p, r1): the neighbour
    rank gathered from rankD (B, N + 1) at (p + k) mod n; dead entries
    (p < 0) get (INF, 1 << 29 | j)."""
    B, C = p.shape
    N = rankD.shape[1] - 1
    jc = torch.arange(C, dtype=i32, device=p.device)[None, :]
    nn = torch.clamp(n[:, None], min=1)
    live = p >= 0
    q = torch.where(live, torch.remainder(p + k, nn), N)
    n1 = torch.where(live, torch.gather(rankD, 1, q.to(i64)), P20)
    r1c = torch.where(live, torch.clamp(r1, max=P20), P20)
    A = torch.where(live, (r1c << 11) | (n1 >> 9), INF)
    Bv = torch.where(live, ((n1 & 511) << 20) | p, (1 << 29) | jc)
    return A, Bv


def tail_rerank_plain(As, Bs, rankD):
    """A tail round after its sort: new ranks r1 + (sub-class start -
    segment start), written into rankD (in place) at the live positions.
    Returns (p, r1, unresolved (B, C) bool, unres (B,) int32).  (The kernel
    writes only the ranks that change; the two agree where rankD holds r1
    at each live entry's position, as the stage loops keep it.)"""
    B, C = As.shape
    jc = torch.arange(C, dtype=i32, device=As.device)[None, :]
    lives = As != INF
    ps = torch.where(lives, Bs & P20, -1)
    r1s = As >> 11
    changed_seg = changed_plain([r1s])
    changed_sub = changed_seg | changed_plain([As, Bs >> 20])
    seg_start = torch.cummax(torch.where(changed_seg, jc, 0), 1).values
    sub_start = torch.cummax(torch.where(changed_sub, jc, 0), 1).values
    new_r1 = torch.where(lives, r1s + (sub_start - seg_start), INF)
    nxt = torch.cat([changed_sub[:, 1:],
                     torch.ones((B, 1), dtype=torch.bool, device=As.device)],
                    dim=1)
    unresolved = ~(changed_sub & nxt) & lives
    # dead lanes all write N into the dump column: order is moot
    N = rankD.shape[1] - 1
    rankD.scatter_(1, torch.where(lives, ps, N).to(i64),
                   torch.where(lives, new_r1, N))
    return ps, new_r1, unresolved, unresolved.sum(dim=1).to(i32)


def loop_test_plain(k: int, unres, N: int, thresh: int) -> bool:
    """The while_loops' condition: k < N and some row has more than thresh
    positions still tied."""
    return k < N and bool((unres > thresh).any())


class LoopTest(NamedTuple):
    """The loop test a round's last kernel runs after the round (gate mode
    ``AFTER_ROUND``): the loop's ctl, its round record ((rows, B + 2) int32,
    or None), the threshold of unresolved positions and the stage
    recorded.  The loop's N is the round's."""
    ctl: torch.Tensor
    rec: Optional[torch.Tensor]
    thresh: int
    stage: int


def gate_plain(ctl, unres, rec, N: int, thresh: int, stage: int,
               mode: int) -> None:
    """The gate kernel's update of ctl (and rec, when given), in place."""
    k = int(ctl[K]) * (2 if mode == AFTER_ROUND else 1)
    row = int(ctl[ROWS])
    if mode != ENTRY and rec is not None and row < rec.shape[0]:
        rec[row, 0] = stage
        rec[row, 1] = k
        rec[row, 2:] = unres
        ctl[ROWS] = row + 1
    ctl[K] = k
    ctl[GATE] = int(loop_test_plain(k, unres, N, thresh))


# ------------------------------------------------------------ wrappers --

def _checks(*items) -> None:
    for t, name, dt, shape in items:
        _build.check(t, name, dt, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(t.shape)}")


def keys(rank, n, ctl, A, Bv, p=None, r1=None) -> None:
    """A round's (A, B) pair into A, Bv; ctl holds k.

    Full width (p None): rank (B, N) int32; A, Bv (B, ld) int32 with ld >=
    N, of which the first N columns are written.  Tail: rank is rankD
    (B, N + 1), p and r1 (B, C) int32 the compact entries, A, Bv (B, C)."""
    if rank.device.type == "cpu":
        k = int(ctl[K])
        if p is None:
            a, b = full_keys_plain(rank, n, k)
        else:
            a, b = tail_keys_plain(rank, p, r1, n, k)
        A[:, :a.shape[1]].copy_(a)
        Bv[:, :b.shape[1]].copy_(b)
        return
    B, ld = A.shape
    if p is None:
        N = rank.shape[1]
        C = N
        _checks((rank, "bwt_keys rank", i32, (B, N)))
    else:
        N = rank.shape[1] - 1
        C = p.shape[1]
        _checks((rank, "bwt_keys rankD", i32, (B, N + 1)),
                (p, "bwt_keys p", i32, (B, C)), (r1, "bwt_keys r1", i32, (B, C)))
        if ld != C:
            raise ValueError(f"bwt_keys: A of width {ld} for {C} entries")
    _checks((n, "bwt_keys n", i32, (B,)), (ctl, "bwt_keys ctl", i32, (3,)),
            (A, "bwt_keys A", i32, (B, ld)), (Bv, "bwt_keys B", i32, (B, ld)))
    if ld < C:
        raise ValueError(f"bwt_keys: A of width {ld} for {C} positions")
    KEYS(_build.ptr(rank), _build.ptr(p), _build.ptr(r1), _build.ptr(n),
         _build.ptr(ctl), _build.ptr(A), _build.ptr(Bv), B, N, C, ld,
         _build.stream_of(A))


def rerank_scratch(B: int, N: int, device) -> torch.Tensor:
    """The scratch of :func:`rerank`: each tile's last class start, then
    the count of CTAs done, zero (each launch with a test leaves it so)."""
    return torch.zeros(B * -(-N // TILE) + 1, dtype=i32, device=device)


def tail_scratch(B: int, C: int, device) -> torch.Tensor:
    """The scratch of :func:`tail_rerank`: a 64-bit status word a tile,
    then the tile tickets, the CTAs done, the launch epoch, a spare word
    and a sum a row; zero at first, and each launch leaves it ready for
    the next (tickets and sums zero, the epoch one up)."""
    return torch.zeros(2 * B * -(-C // TAIL_TILE) + 4 + B, dtype=i32,
                       device=device)


def _test_args(test: Optional[LoopTest], B: int) -> list:
    """The kernel arguments of the loop test after a round (none: no
    test)."""
    if test is None:
        return [None, None, None, 0, 0, 0, 0, 0]
    _checks((test.ctl, "bwt loop test ctl", i32, (3,)))
    rows = 0
    if test.rec is not None:
        rows = test.rec.shape[0]
        _checks((test.rec, "bwt loop test rec", i32, (rows, B + 2)))
    return [_build.ptr(test.ctl), _build.ptr(test.rec), None, test.thresh,
            test.stage, rows, 0, 0]


def _test_plain(test: Optional[LoopTest], unres, N: int) -> None:
    if test is not None:
        gate_plain(test.ctl, unres, test.rec, N, test.thresh, test.stage,
                   AFTER_ROUND)


def rerank(ka, kb, order, n, rank, tied, unres, scratch=None,
           test=None) -> None:
    """The rerank after a sort, into rank (B, N) int32, tied (B, N) bool and
    unres (B,) int32.  ka, kb, order: (B, N)
    int64 key columns and their order (the 16-byte ranks), or ka, kb a
    round's sorted (A, B) int32 pair (B, ld >= N) and order None.  scratch:
    ``rerank_scratch(B, N)``, or None to allocate it.  test: a
    :class:`LoopTest` to run after the rerank, or None."""
    B, N = rank.shape
    if ka.device.type == "cpu":
        r, t, u = rerank_plain(ka, kb, order, n, N)
        rank.copy_(r)
        tied.copy_(t)
        unres.copy_(u)
        _test_plain(test, unres, N)
        return
    wide = order is not None
    ld = ka.shape[1]
    dt = i64 if wide else i32
    _checks((ka, "bwt_rerank ka", dt, (B, ld)), (kb, "bwt_rerank kb", dt, (B, ld)),
            (n, "bwt_rerank n", i32, (B,)), (rank, "bwt_rerank rank", i32, (B, N)),
            (tied, "bwt_rerank tied", torch.bool, (B, N)),
            (unres, "bwt_rerank unres", i32, (B,)))
    if wide:
        _checks((order, "bwt_rerank order", i64, (B, ld)))
    if ld < N:
        raise ValueError(f"bwt_rerank: keys of width {ld} for {N} positions")
    if scratch is None:
        scratch = rerank_scratch(B, N, rank.device)
    _checks((scratch, "bwt_rerank scratch", i32, (B * -(-N // TILE) + 1,)))
    RERANK(_build.ptr(ka), _build.ptr(kb), _build.ptr(order), _build.ptr(n),
           _build.ptr(scratch), _build.ptr(rank),
           _build.ptr(tied), _build.ptr(unres), int(wide), B, N, N, ld,
           *_test_args(test, B), _build.stream_of(rank))


def tail_rerank(As, Bs, rankD, p, r1, unresolved, unres, scratch=None,
                test=None) -> None:
    """A tail round's rerank from its sorted (As, Bs) (B, C): p, r1,
    unresolved (B, C) and unres (B,) in place, rankD (B, N + 1) at the live
    positions, then test (a :class:`LoopTest`, or None).  rankD must hold
    r1 (As >> 11) at each live entry's position, as the stage loops keep
    it: the kernel writes only the ranks that change.  scratch:
    ``tail_scratch(B, C)`` (kept from launch to launch), or None."""
    if As.device.type == "cpu":
        ps, nr, un, u = tail_rerank_plain(As, Bs, rankD)
        p.copy_(ps)
        r1.copy_(nr)
        unresolved.copy_(un)
        unres.copy_(u)
        _test_plain(test, unres, rankD.shape[1] - 1)
        return
    B, C = As.shape
    N = rankD.shape[1] - 1
    _checks((As, "bwt_tail_rerank As", i32, (B, C)),
            (Bs, "bwt_tail_rerank Bs", i32, (B, C)),
            (rankD, "bwt_tail_rerank rankD", i32, (B, N + 1)),
            (p, "bwt_tail_rerank p", i32, (B, C)),
            (r1, "bwt_tail_rerank r1", i32, (B, C)),
            (unresolved, "bwt_tail_rerank unresolved", torch.bool, (B, C)),
            (unres, "bwt_tail_rerank unres", i32, (B,)))
    if scratch is None:
        scratch = tail_scratch(B, C, As.device)
    _checks((scratch, "bwt_tail_rerank scratch", i32,
             (2 * B * -(-C // TAIL_TILE) + 4 + B,)))
    TAIL(_build.ptr(As), _build.ptr(Bs), _build.ptr(scratch),
         _build.ptr(rankD), _build.ptr(p), _build.ptr(r1),
         _build.ptr(unresolved), _build.ptr(unres), B, N, C,
         *_test_args(test, B), _build.stream_of(As))


def gate(ctl, unres, rec, N: int, thresh: int, stage: int, mode: int) -> None:
    """The loop test on the rows' device (see the modes above); rec:
    (rows, B + 2) int32 round record, or None.  (Inside a loop graph the
    same kernel also sets the WHILE node's handle at the stage's entry and
    counts the entries: ``bz2t_bwt_loop_build``.)"""
    if ctl.device.type == "cpu":
        gate_plain(ctl, unres, rec, N, thresh, stage, mode)
        return
    B = unres.shape[0]
    _checks((ctl, "bwt_gate ctl", i32, (3,)), (unres, "bwt_gate unres", i32, (B,)))
    if rec is not None:
        _checks((rec, "bwt_gate rec", i32, (rec.shape[0], B + 2)))
    GATE_K(_build.ptr(ctl), _build.ptr(unres), _build.ptr(rec), None, B, N,
           thresh, stage, 0 if rec is None else rec.shape[0], mode, 0, 0,
           _build.stream_of(ctl))


# ---------------------------------------------------------------- loop --

#: idle capture streams by device index: private streams (a pooled torch
#: stream may be another thread's working stream, whose launches a capture
#: would take), each used by one build at a time
_CAPTURE: dict = {}
_CAPTURE_LOCK = threading.Lock()
#: held while a loop graph is built, launched or destroyed, and while this
#: package synchronizes the card (a synchronize would invalidate a capture
#: on another thread); reentrant, so a drop may hold it over all its steps
GRAPHS_LOCK = threading.RLock()


def _take_capture_stream(device):
    with _CAPTURE_LOCK:
        idle = _CAPTURE.setdefault(device.index, [])
        if idle:
            return idle.pop()
    out = ct.c_void_p()
    with torch.cuda.device(device):
        CAPTURE(ct.byref(out))
    return torch.cuda.ExternalStream(out.value, device=device)


class Round:
    """One doubling round on fixed buffers: a full-width round (p None:
    keys from rank, the sort, the rerank into rank and flags = tied) or a
    tail round (keys from rank = rankD, p and r1, the sort, the tail rerank
    into rankD, p, r1 and flags = unresolved), the rerank ending with the
    loop test it is called with.  Calling it launches the round through the
    wrappers (the CPU's loop, and a loop driven from the host); on a card
    :func:`loop` builds the same launches into a graph in one C call.
    bufs: ``sort_buffers`` of the sort's width (A's); scratch: the
    rerank's (``rerank_scratch`` or ``tail_scratch``)."""

    def __init__(self, rank, n, ctl, unres, A, Bv, bufs, scratch, flags,
                 p=None, r1=None):
        self.rank, self.n, self.ctl, self.unres = rank, n, ctl, unres
        self.A, self.Bv, self.bufs, self.scratch = A, Bv, bufs, scratch
        self.flags, self.p, self.r1 = flags, p, r1
        self.kernels = [KEYS, SORT, RERANK if p is None else TAIL]

    def __call__(self, test: LoopTest) -> None:
        keys(self.rank, self.n, self.ctl, self.A, self.Bv, p=self.p,
             r1=self.r1)
        As, Bs = sort_pairs(self.A, self.Bv, bufs=self.bufs)
        if self.p is None:
            rerank(As, Bs, None, self.n, self.rank, self.flags, self.unres,
                   scratch=self.scratch, test=test)
        else:
            tail_rerank(As, Bs, self.rank, self.p, self.r1, self.flags,
                        self.unres, scratch=self.scratch, test=test)

    def args(self) -> list:
        """The round's part of ``bz2t_bwt_loop_build``'s arguments, after
        the wrappers' checks."""
        B, ld = self.A.shape
        N = self.rank.shape[1] - (self.p is not None)
        C = N if self.p is None else self.p.shape[1]
        out, k0, k1 = self.bufs
        if self.p is None:
            _checks((self.rank, "bwt_loop rank", i32, (B, N)),
                    (self.flags, "bwt_loop tied", torch.bool, (B, N)),
                    (self.scratch, "bwt_loop scratch", i32,
                     (B * -(-N // TILE) + 1,)))
        else:
            _checks((self.rank, "bwt_loop rankD", i32, (B, N + 1)),
                    (self.p, "bwt_loop p", i32, (B, C)),
                    (self.r1, "bwt_loop r1", i32, (B, C)),
                    (self.flags, "bwt_loop unresolved", torch.bool, (B, C)),
                    (self.scratch, "bwt_loop scratch", i32,
                     (2 * B * -(-C // TAIL_TILE) + 4 + B,)))
            if ld != C:
                raise ValueError(f"bwt_loop: A of width {ld} for {C} entries")
        _checks((self.n, "bwt_loop n", i32, (B,)),
                (self.A, "bwt_loop A", i32, (B, ld)),
                (self.Bv, "bwt_loop B", i32, (B, ld)),
                (out, "bwt_loop sorted", i32, (2, B, ld)))
        if ld < C or ld & (ld - 1) or ld < 128:
            raise ValueError(f"bwt_loop: sort width {ld} for {C} entries")
        return [_build.ptr(self.rank), _build.ptr(self.p),
                _build.ptr(self.r1), _build.ptr(self.n), _build.ptr(self.A),
                _build.ptr(self.Bv), C, ld, _build.ptr(out[0]),
                _build.ptr(out[1]), _build.ptr(k0), _build.ptr(k1), ld,
                SORT_TILE, _build.ptr(self.scratch), _build.ptr(self.flags)]


class StageLoop:
    """One stage's doubling loop, as the JAX package's while_loop: the loop
    test (gate mode ``entry``), then ``body`` (a :class:`Round`, called with
    ``after``, the test it ends with) for as long as the test holds.  On a
    card :func:`loop` builds the entry test and one round into a CUDA graph
    with a conditional WHILE node at its first run and launches that graph
    at every run, so the buffers must outlive it (:meth:`free`).  counts:
    int32 (2,) on the card, where the graph's entry gate and round count
    the stage's entries and rounds (None on the CPU)."""

    def __init__(self, body, ctl, unres, rec, N: int, thresh: int,
                 stage: int, entry: int, counts=None):
        self.body, self.ctl, self.unres, self.rec = body, ctl, unres, rec
        self.N, self.thresh, self.stage, self.entry = N, thresh, stage, entry
        self.after = LoopTest(ctl, rec, thresh, stage)
        self.counts = counts
        self.graph = ct.c_void_p()
        self.exec = ct.c_void_p()
        self.folded = (0, 0)        # the counts already added as launches

    def test(self, mode: int) -> None:
        gate(self.ctl, self.unres, self.rec, self.N, self.thresh, self.stage,
             mode)

    def fold(self, counts) -> None:
        """Add the launches of the graph's kernels that the card counted
        since the last fold; counts: (entries, rounds) read from
        ``self.counts``.  The entry test runs once a launch, the round's
        kernels once a round that ran (its last kernel runs the test after
        it)."""
        entries, rounds = counts
        _build.count_launches([GATE_K], entries - self.folded[0])
        _build.count_launches(self.body.kernels, rounds - self.folded[1])
        self.folded = (entries, rounds)

    def build(self) -> None:
        """Build and instantiate the loop graph (waits for the card)."""
        B = self.unres.shape[0]
        _checks((self.ctl, "bwt_loop ctl", i32, (3,)),
                (self.unres, "bwt_loop unres", i32, (B,)),
                (self.counts, "bwt_loop counts", i32, (2,)),
                (self.rec, "bwt_loop rec", i32, (self.rec.shape[0], B + 2)))
        head = [_build.ptr(self.ctl), _build.ptr(self.unres),
                _build.ptr(self.rec), _build.ptr(self.counts), B, self.N,
                self.thresh, self.stage, self.rec.shape[0], self.entry]
        rnd = self.body.args()
        cap = _take_capture_stream(self.ctl.device)
        graph, ex = ct.c_void_p(), ct.c_void_p()
        try:
            with GRAPHS_LOCK:
                for _ in range(BUILD_TRIES):
                    rc = LOOP_BUILD.rc(ct.c_void_p(cap.cuda_stream), *head,
                                       *rnd, ct.byref(graph), ct.byref(ex))
                    if rc != CAPTURE_INVALIDATED:
                        break
                LOOP_BUILD.raise_for(rc)
        finally:
            with _CAPTURE_LOCK:
                _CAPTURE[self.ctl.device.index].append(cap)
        self.graph, self.exec = graph, ex

    def free(self) -> None:
        """Drop the graph (this waits until the card is idle)."""
        if self.graph:
            with GRAPHS_LOCK:
                LOOP_FREE(self.exec, self.graph)
            self.graph, self.exec = ct.c_void_p(), ct.c_void_p()


def loop(lp: StageLoop) -> None:
    """Run one stage's loop: on a CUDA tensor its graph (built at the first
    run) is launched on the current stream, with no host sync and no round
    past the test (its launches are counted on the card); on the CPU the
    loop runs on the host."""
    if lp.ctl.device.type == "cpu":
        lp.test(lp.entry)
        while int(lp.ctl[GATE]):
            lp.body(lp.after)
        return
    _checks((lp.ctl, "bwt_loop ctl", i32, (3,)))
    if not lp.exec:
        with tracing.span("bwt_graph", None, stage=lp.stage,
                          rows=lp.unres.shape[0]):
            lp.build()
    stream = ct.c_void_p(torch.cuda.current_stream(lp.ctl.device).cuda_stream)
    with GRAPHS_LOCK:
        LOOP_LAUNCH(lp.exec, stream)
