"""Inputs and a lockstep check of the BWT's round kernels
(bzip2_tpu_torch/ops/bwt_kernel.py), shared by the CPU tests
(tests/test_torch_bwt_kernels.py), the card tests (tests/test_torch_cuda.py)
and chip_smoke.py's phase 3.  Imports neither JAX nor the JAX package;
every case is made from a numpy seed."""
import numpy as np
import torch

from bzip2_tpu_torch.ops import bwt_kernel as bk

#: the wrappers ops/bwt.py calls through the bwt_kernel module
WRAPPERS = ("keys", "rerank", "tail_rerank", "gate")
#: wrapper -> the kernel it launches (its _build.KERNELS name)
KERNEL_OF = {"keys": "bwt_keys", "rerank": "bwt_rerank",
             "tail_rerank": "bwt_tail_rerank", "gate": "bwt_gate"}


def periodic_rows(rng, B: int, N: int) -> tuple:
    """A batch of B rows of width N that keeps the doubling loops busy:
    exactly periodic rows (periods 1, 2, 3, 7 and a random one up to 1,000),
    a constant row of n = N, rows of n = 1 and n = 2, random bytes and a
    periodic row with one byte changed, at lengths from 1 to N.  Returns
    (blocks uint8 (B, N), n int32 (B,))."""
    blocks = np.zeros((B, N), np.uint8)
    ns = np.zeros(B, np.int32)
    for i in range(B):
        kind = i % 8
        n = int(rng.integers(max(1, N // 4), N + 1))
        if kind == 0:
            n, row = N, np.full(N, 0x61, np.uint8)            # constant, n = N
        elif kind == 1:
            n, row = 1, np.array([7], np.uint8)
        elif kind == 2:
            n, row = 2, np.array([9, 9], np.uint8)
        elif kind == 3:
            row = rng.integers(0, 256, n).astype(np.uint8)
        else:
            period = (1, 2, 3, 7)[kind - 4] if kind < 7 else int(
                rng.integers(8, 1001))
            unit = rng.integers(0, 4, period).astype(np.uint8)
            row = np.tile(unit, n // period + 1)[:n]
            if kind == 7 and i % 2:
                row[n // 2] ^= 1                             # nearly periodic
        blocks[i, :n] = row[:n]
        ns[i] = n
    return blocks, ns


def tail_round_inputs(rng, B: int, C: int, N: int, kind: str) -> tuple:
    """A tail round's sorted pair as its sort leaves it: each row's live
    entries first, in (A, B) order, (r1 << 11 | n1 >> 9, (n1 & 511) << 20 |
    pos) at distinct positions pos < N, then dead entries (INF, 1 << 29 |
    j).  kind: "mixed" (a random live count, a few hundred segments),
    "dead" (no live entry), "one segment" (every entry live, one r1: a
    segment across every tile, split into sub-classes by n1) or "full"
    (every entry live).  rankD holds random ranks, r1 at each live
    entry's position (as the stage loops keep it) and N in the dump
    column.  Returns (As, Bs) int32 (B, C) and rankD int32 (B, N + 1)."""
    INF = bk.INF
    rankD = rng.integers(0, N, (B, N + 1))
    rankD[:, N] = N
    As = np.full((B, C), INF, np.int64)
    Bs = (1 << 29) | np.tile(np.arange(C, dtype=np.int64), (B, 1))
    for b in range(B):
        live = {"dead": 0, "one segment": C, "full": C}.get(
            kind, int(rng.integers(1, C + 1)))
        if kind == "one segment":
            r1 = np.full(live, 7, np.int64)
        else:
            r1 = np.sort(rng.integers(0, max(2, live // 50), live))
        # neighbour ranks from a range a few times narrower than the row:
        # sub-classes of every size, singletons among them
        n1 = rng.integers(0, max(2, live // int(rng.integers(1, 8))), live)
        pos = rng.permutation(N)[:live]
        A = (r1 << 11) | (n1 >> 9)
        Bv = ((n1 & 511) << 20) | pos
        o = np.lexsort((Bv, A))
        As[b, :live] = A[o]
        Bs[b, :live] = Bv[o]
        rankD[b, pos] = r1
    return tuple(torch.from_numpy(x.astype(np.int32))
                 for x in (As, Bs, rankD))


def loop_test_copy(test):
    """A loop test (bwt_kernel.LoopTest) on copies of its ctl and record;
    None for None."""
    if test is None:
        return None
    return test._replace(ctl=test.ctl.clone(),
                         rec=None if test.rec is None else test.rec.clone())


def loop_test_outputs(test) -> tuple:
    """What a loop test writes: its ctl and its record (none for None)."""
    if test is None:
        return ()
    return (test.ctl,) + (() if test.rec is None else (test.rec,))


def _sync(t) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _err(got, exp) -> int:
    """Largest absolute difference of two equal-shaped integer tensors."""
    if tuple(got.shape) != tuple(exp.shape) or got.dtype != exp.dtype:
        raise AssertionError(f"shape/type {tuple(got.shape)}/{got.dtype} vs "
                             f"{tuple(exp.shape)}/{exp.dtype}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - exp.to(torch.int64)).abs().max())


class RoundCheck:
    """Within ``with RoundCheck():``, ``ops/bwt.py``'s stage loops run on
    the host (``bwt_kernel.loop`` replaced by a Python while loop that reads
    the gate after a device sync), so each round's kernels launch one by
    one; each call to a round wrapper is also run through its plain
    version on copies of its inputs and the wrapper's writes are held
    against it, those of the loop test a rerank ends with (ctl and the
    round record) included.  ``calls`` counts the calls by wrapper, ``checked`` those
    compared (all of them), ``err`` the largest difference by wrapper,
    ``samples`` the inputs of the first call of each (wrapper, form), for
    timing."""

    def __init__(self):
        self.calls = dict.fromkeys(WRAPPERS, 0)
        self.checked = dict.fromkeys(WRAPPERS, 0)
        self.err = dict.fromkeys(WRAPPERS, 0)
        self.samples = {}
        self._orig = {}

    def __enter__(self):
        self._orig = {w: getattr(bk, w) for w in WRAPPERS + ("loop",)}
        for w in WRAPPERS + ("loop",):
            setattr(bk, w, getattr(self, "_" + w))
        return self

    def _loop(self, lp):
        lp.test(lp.entry)
        while self._open(lp.ctl, lp.unres):
            lp.body(lp.after)

    def __exit__(self, *exc):
        for w, f in self._orig.items():
            setattr(bk, w, f)

    def _open(self, ctl, probe) -> bool:
        _sync(probe)
        return bool(int(ctl[bk.GATE]))

    def _note(self, w, form, got, exp, sample) -> None:
        self.checked[w] += 1
        e = max(_err(g, x) for g, x in zip(got, exp))
        self.err[w] = max(self.err[w], e)
        if e:
            raise AssertionError(f"{KERNEL_OF[w]} ({form}) differs from its "
                                 f"plain version (max abs err {e})")
        self.samples.setdefault((w, form), sample)

    def _keys(self, rank, n, ctl, A, Bv, p=None, r1=None):
        self.calls["keys"] += 1
        _sync(A)
        k = int(ctl[bk.K])
        if p is None:
            form, exp = "full", bk.full_keys_plain(rank, n, k)
            sample = (rank.clone(), n.clone(), ctl.clone(), A.clone(),
                      Bv.clone(), None, None)
        else:
            form = "tail"
            exp = bk.tail_keys_plain(rank, p, r1, n, k)
            sample = (rank.clone(), n.clone(), ctl.clone(), A.clone(),
                      Bv.clone(), p.clone(), r1.clone())
        self._orig["keys"](rank, n, ctl, A, Bv, p=p, r1=r1)
        _sync(A)
        C = exp[0].shape[1]
        self._note("keys", form, (A[:, :C], Bv[:, :C]), exp, sample)

    def _rerank(self, ka, kb, order, n, rank, tied, unres, scratch=None,
                test=None):
        self.calls["rerank"] += 1
        _sync(rank)
        form = "wide" if order is not None else "full"
        exp = bk.rerank_plain(ka, kb, order, n, rank.shape[1])
        sample = (ka.clone(), kb.clone(),
                  None if order is None else order.clone(), n.clone(),
                  rank.clone(), tied.clone(), unres.clone(),
                  loop_test_copy(test))
        want = loop_test_copy(test)
        if want is not None:
            bk.gate_plain(want.ctl, exp[2], want.rec, rank.shape[1],
                          want.thresh, want.stage, bk.AFTER_ROUND)
        self._orig["rerank"](ka, kb, order, n, rank, tied, unres, scratch,
                             test)
        _sync(rank)
        self._note("rerank", form,
                   (rank, tied, unres) + loop_test_outputs(test),
                   exp + loop_test_outputs(want), sample)

    def _tail_rerank(self, As, Bs, rankD, p, r1, unresolved, unres,
                     scratch=None, test=None):
        self.calls["tail_rerank"] += 1
        _sync(As)
        rd = rankD.clone()
        sample = (As.clone(), Bs.clone(), rankD.clone(), p.clone(),
                  r1.clone(), unresolved.clone(), unres.clone(),
                  loop_test_copy(test))
        exp = bk.tail_rerank_plain(As, Bs, rd)
        want = loop_test_copy(test)
        if want is not None:
            bk.gate_plain(want.ctl, exp[3], want.rec, rankD.shape[1] - 1,
                          want.thresh, want.stage, bk.AFTER_ROUND)
        self._orig["tail_rerank"](As, Bs, rankD, p, r1, unresolved, unres,
                                  scratch, test)
        _sync(As)
        self._note("tail_rerank", "tail",
                   (p, r1, unresolved, unres, rankD)
                   + loop_test_outputs(test),
                   (*exp, rd) + loop_test_outputs(want), sample)

    def _gate(self, ctl, unres, rec, N, thresh, stage, mode):
        self.calls["gate"] += 1
        _sync(unres)
        c, r = ctl.clone(), None if rec is None else rec.clone()
        sample = (ctl.clone(), unres.clone(),
                  None if rec is None else rec.clone(), N, thresh, stage, mode)
        bk.gate_plain(c, unres, r, N, thresh, stage, mode)
        self._orig["gate"](ctl, unres, rec, N, thresh, stage, mode)
        _sync(unres)
        got, exp = (ctl,), (c,)
        if rec is not None:
            got, exp = (ctl, rec), (c, r)
        self._note("gate", f"mode{mode}", got, exp, sample)
