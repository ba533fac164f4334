"""The plain versions of the BWT's round kernels
(bzip2_tpu_torch/ops/bwt_kernel.py) against the pieces of
bzip2_tpu/ops/bwt.py they replace, the port's bwt_batched on the CPU (the
card's stage loops, run on the host) against the JAX bwt_batched, the round record against the host-driven
loop's trajectory, and the wrappers' dispatch and binding.  Every
comparison is exact."""
import ctypes as ct
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bzip2_tpu.ops import bwt as jbwt
from bzip2_tpu_torch import _build
from bzip2_tpu_torch.ops import bwt as tbwt
from bzip2_tpu_torch.ops import bwt_kernel as bk
from bzip2_tpu_torch.ops import sort_kernel as sk
from torch_bwt_cases import periodic_rows

_jax_bwt = jax.jit(lambda b, n: jbwt.bwt_batched(b, n, use_pallas=False))
NEW_KERNELS = ("bwt_keys", "bwt_rerank", "bwt_tail_rerank", "bwt_gate")


def _np(t):
    return np.asarray(t)


def _sorted_cols(rng, B, S, span):
    """Two sorted int32 key columns with many equal neighbours."""
    a = np.sort(rng.integers(0, span, (B, S)).astype(np.int32), axis=1)
    b = rng.integers(0, 3, (B, S)).astype(np.int32)
    return a, b


# ------------------------------------------- plain versions vs the JAX pieces --

@pytest.mark.parametrize("S,span", [(1, 1), (97, 5), (4096, 40), (5000, 2)])
def test_gapped_rerank_plain_matches_jax(rng, S, span):
    a, b = _sorted_cols(rng, 3, S, span)
    order = np.stack([rng.permutation(S).astype(np.int32) for _ in range(3)])
    js, jsg = jbwt._gapped_rerank(jnp.asarray(order),
                                  [jnp.asarray(a), jnp.asarray(b)])
    ts, tsg = bk.gapped_rerank_plain([torch.from_numpy(a), torch.from_numpy(b)])
    assert np.array_equal(_np(js), ts.numpy())
    assert np.array_equal(_np(jsg), tsg.numpy())


def _rerank_case(rng, B, N, span):
    """Sorted keys, their order, and lengths from 1 to N."""
    a, b = _sorted_cols(rng, B, N, span)
    order = np.stack([rng.permutation(N).astype(np.int32) for _ in range(B)])
    n = np.array([1, N, max(1, N // 3)][:B], np.int32)
    return a, b, order, n


@pytest.mark.parametrize("N,span", [(128, 3), (3000, 50), (8192, 8192)])
def test_scatter_and_rerank_plain_match_jax_on_valid_positions(rng, N, span):
    """scatter_rank_plain and rerank_plain (both forms) against the JAX
    _gapped_rerank + _scatter_rank: rank at valid positions, tied and unres
    everywhere."""
    a, b, order, n = _rerank_case(rng, 3, N, span)
    js, jsg = jbwt._gapped_rerank(jnp.asarray(order),
                                  [jnp.asarray(a), jnp.asarray(b)])
    valid = np.arange(N)[None] < n[:, None]
    jr, jt, ju = (_np(x) for x in jbwt._scatter_rank(
        jnp.asarray(order), js, jsg, jnp.asarray(valid), jnp.asarray(n), N))
    tn = torch.from_numpy(n)
    forms = {
        "scatter": bk.scatter_rank_plain(torch.from_numpy(order),
                                         torch.from_numpy(np.array(js)),
                                         torch.from_numpy(np.array(jsg)), tn),
        "wide": bk.rerank_plain(torch.from_numpy(a).to(torch.int64),
                                torch.from_numpy(b).to(torch.int64),
                                torch.from_numpy(order).to(torch.int64), tn, N),
        # a round's packed pair: class key (A, B >> 20), position B & P20
        "packed": bk.rerank_plain(torch.from_numpy(a),
                                  torch.from_numpy((b << 20) | order), None,
                                  tn, N),
    }
    for form, (r, t, u) in forms.items():
        assert np.array_equal(np.where(valid, jr, 0),
                              np.where(valid, r.numpy(), 0)), form
        assert np.array_equal(jt, t.numpy()), form
        assert np.array_equal(ju, u.numpy()) and u.dtype == torch.int32, form


@pytest.mark.parametrize("k", [16, 64, 1024, 2048, 4096])
@pytest.mark.parametrize("lens", [(5000, 30, 1), (6000, 6000, 6000),
                                  (100, 2000, 4095)])
def test_full_keys_plain_matches_jax_neighbour_ranks(rng, k, lens):
    """The full-width round's pair against the JAX full_body's packing of
    neighbour_ranks (roll through the pad mirror while k <= min(N - max n,
    2048), else a gather), at every position: rows shorter than k read the
    pads' own ranks there, as the reference does."""
    N = 6144
    n = np.array(lens, np.int32)
    order = np.stack([rng.permutation(N).astype(np.int32) for _ in range(3)])
    start = rng.integers(0, N, (3, N)).astype(np.int32)
    single = np.zeros((3, N), bool)
    idx = np.arange(N, dtype=np.int32)[None]
    valid = idx < n[:, None]
    # the JAX rank array, pad mirror and all, and the port's, without it
    jm = _np(jbwt._scatter_rank(jnp.asarray(order), jnp.asarray(start),
                                jnp.asarray(single), jnp.asarray(valid),
                                jnp.asarray(n), N)[0])
    rank = bk.scatter_rank_plain(torch.from_numpy(order),
                                 torch.from_numpy(start),
                                 torch.from_numpy(single),
                                 torch.from_numpy(n))[0]
    assert np.array_equal(np.where(valid, jm, 0), np.where(valid, rank, 0))
    if k <= min(N - n.max(), 2048):
        r2 = np.roll(jm, -k, axis=1)
    else:
        r2 = np.take_along_axis(jm, (idx + k) % np.maximum(n, 1)[:, None],
                                axis=1)
    r1 = np.where(valid, jm, bk.P20)
    r2 = np.where(valid, r2, bk.P20)
    A = np.where(valid, (r1 << 11) | (r2 >> 9), bk.INF)
    Bv = np.where(valid, ((r2 & 511) << 20) | idx, (1 << 29) | idx)
    ta, tb = bk.full_keys_plain(rank, torch.from_numpy(n), k)
    assert np.array_equal(A, ta.numpy()) and np.array_equal(Bv, tb.numpy())


def test_loop_test_plain_matches_jax_cond():
    unres = np.array([0, 5, 2048], np.int32)
    for k, N, thresh in [(16, 100, 4), (64, 64, 0), (32, 100, 2048),
                         (32, 100, 2047), (1 << 19, 1 << 20, 0)]:
        want = bool(jnp.logical_and(k < N, jnp.any(jnp.asarray(unres) > thresh)))
        assert bk.loop_test_plain(k, torch.from_numpy(unres), N, thresh) == want


# ------------------------------------------ bwt_batched vs the JAX package --

def _rows(kind: str, N: int, rng) -> tuple:
    """One batch of a kind: (blocks uint8 (B, N), n int32 (B,))."""
    if kind == "periodic mix":
        return periodic_rows(rng, 9, N)
    if kind == "constant":
        return np.full((2, N), 0x41, np.uint8), np.array([N, N - 5], np.int32)
    if kind == "n=1 and n=N":
        b = rng.integers(0, 256, (3, N)).astype(np.uint8)
        n = np.array([1, N, 1], np.int32)
    elif kind == "random bytes":
        b = rng.integers(0, 256, (2, N)).astype(np.uint8)
        n = np.array([N, N // 2 + 3], np.int32)
    else:                                   # mixed lengths of text
        words = b"the quick brown fox jumps over a lazy dog".split()
        text = np.frombuffer(b" ".join(
            words[i] for i in rng.integers(0, len(words), N))[:N], np.uint8)
        lens = [N, 1, 2, 17, N // 3, N - 1]
        b = np.zeros((len(lens), N), np.uint8)
        n = np.array(lens, np.int32)
        for i, m in enumerate(lens):
            b[i, :m] = np.roll(text, 7 * i)[:m]
    for i, m in enumerate(n):
        b[i, m:] = 0
    return b, n


def _jax_vs_port(b, n, compare_sa=True):
    ref = _jax_bwt(jnp.asarray(b), jnp.asarray(n))
    got = tbwt.bwt_batched(torch.from_numpy(b), torch.from_numpy(n))
    names = ("last", "orig_ptr", "sa")
    for r, g, name in zip(ref, got, names):
        if name != "sa" or compare_sa:
            assert np.array_equal(_np(r), g.numpy()), name
    return got


@pytest.mark.parametrize("kind", ["text mixed lengths", "random bytes",
                                  "periodic mix", "constant", "n=1 and n=N"])
def test_bwt_batched_matches_jax(rng, kind):
    """last and orig_ptr exactly; sa exactly where rotations are distinct
    (on rows with equal rotations the order inside a tie class is free, so
    sa is held to the last column instead)."""
    N = 4096
    b, n = _rows(kind, N, rng)
    ties = kind in ("periodic mix", "constant")
    last, _op, sa = _jax_vs_port(b, n, compare_sa=not ties)
    for i, m in enumerate(n):
        s = sa[i, :m].numpy().astype(np.int64)
        assert sorted(s.tolist()) == list(range(m))
        assert np.array_equal(last[i, :m].numpy(), b[i][(s - 1) % m])


def _long_run_rows(rng):
    """Two rows of N = 65,536 random bytes with runs of one byte (19,000
    and 9,000 long), which stay tied through the full-width stage."""
    N = 65536
    b = rng.integers(0, 256, (2, N)).astype(np.uint8)
    b[0, 20000:39000] = 0x61
    b[1, 1000:10000] = 0x62
    return b, np.array([N, N - 3], np.int32)


def test_bwt_batched_long_tail_segment_matches_jax(monkeypatch):
    """The first tail stage (C = 16,384) starts with one tied segment of
    14,905 entries, across four tiles of 4096 entries (eight of the tail
    rerank's 2048: the carry its look-back passes on), a later stage runs
    no round and the next closes after one; the port equals the JAX
    package."""
    b, n = _long_run_rows(np.random.default_rng(7))
    spans = []
    real = bk.tail_rerank_plain

    def spy(As, Bs, rankD):
        a = As.numpy()
        for row in a:
            live = np.flatnonzero(row != bk.INF)
            if live.size:
                cut = np.flatnonzero(np.diff(row[live] >> 11) != 0)
                first = live[np.concatenate([[0], cut + 1])] // 4096
                last = live[np.concatenate([cut, [live.size - 1]])] // 4096
                spans.append(int((last - first).max()) + 1)
        return real(As, Bs, rankD)
    monkeypatch.setattr(bk, "tail_rerank_plain", spy)
    seen = []
    monkeypatch.setattr(tbwt, "ROUND_HOOK",
                        lambda s, k, u: seen.append((s, k)))
    _jax_vs_port(b, n)
    assert max(spans) >= 3
    rounds = [sum(s == st for s, _k in seen) for st in range(1, 6)]
    assert 1 in rounds and 0 in rounds[:rounds.index(1)], rounds


@pytest.mark.parametrize("kind", ["text mixed lengths", "long runs",
                                  "golden"])
def test_tail_rounds_find_rank_at_r1(monkeypatch, rng, golden, kind):
    """Every tail round of bwt_batched finds rankD holding r1 (As >> 11) at
    each live entry's position, the precondition under which the tail
    rerank kernel skips the ranks that do not change; and some of them do
    not (the kernel's writes are fewer than the live entries)."""
    seen = []
    real = bk.tail_rerank_plain

    def spy(As, Bs, rankD):
        live = As != bk.INF
        pos = torch.where(live, Bs & bk.P20, rankD.shape[1] - 1).long()
        held = torch.gather(rankD, 1, pos) == torch.where(
            live, As >> 11, rankD.shape[1] - 1)
        out = real(As, Bs, rankD)
        seen.append((bool(held.all()), int(live.sum()),
                     int((live & (out[1] != As >> 11)).sum())))
        return out
    monkeypatch.setattr(bk, "tail_rerank_plain", spy)
    if kind == "long runs":
        b, n = _long_run_rows(rng)
    elif kind == "golden":
        N = 16384
        b = np.frombuffer(golden[2][0][9000:9000 + 2 * N], np.uint8).reshape(
            2, N).copy()
        n = np.array([N, 11000], np.int32)
    else:
        b, n = _rows(kind, 4096, rng)
    tbwt.bwt_batched(torch.from_numpy(b), torch.from_numpy(n))
    assert seen and all(h for h, _l, _c in seen)
    assert sum(c for _h, _l, c in seen) < sum(lv for _h, lv, _c in seen)


def test_bwt_batched_golden_text_matches_jax(golden):
    """Two golden-text blocks of different lengths at N = 16,384: real
    text reaches the tail stages."""
    ref = golden[2][0]
    N = 16384
    b = np.zeros((2, N), np.uint8)
    b[0] = np.frombuffer(ref[9000:9000 + N], np.uint8)
    b[1, :11000] = np.frombuffer(ref[30000:41000], np.uint8)
    _jax_vs_port(b, np.array([N, 11000], np.int32))


# --------------------------------------------------- the round record --

def _host_loop_trajectory(blocks, n):
    """The trajectory of the host-driven loop the device loops replaced:
    the same steps, each loop test decided on the host."""
    B, N = blocks.shape
    rows, i32 = [], torch.int32
    dev = blocks.device
    hook = tbwt.ROUND_HOOK
    seen = []
    tbwt.ROUND_HOOK = lambda s, k, u: seen.append((s, k, u.tolist()))
    try:
        tbwt.bwt_batched(blocks, n)       # for the initial ranks' row
    finally:
        tbwt.ROUND_HOOK = hook
    rows.append(seen[0])
    # replay with host loop tests from the same 16-byte ranks
    ladder = tbwt._tail_ladder(N)
    idx = torch.arange(N, dtype=i32)[None]
    valid = idx < n[:, None]
    # the 16-byte ranks, as bwt_batched computes them
    nn = torch.clamp(n[:, None], min=1)
    bi = torch.where(valid, blocks.to(i32), 0)
    ext = torch.arange(16, dtype=i32)[None]
    bx = torch.cat([bi, torch.zeros((B, 16), dtype=i32)], dim=1)
    bx.scatter_(1, (n[:, None] + ext).to(torch.int64),
                torch.gather(bi, 1, torch.remainder(ext, nn).to(torch.int64)))
    k1x = tbwt._pack4(bx, bx.roll(-1, 1), bx.roll(-2, 1), bx.roll(-3, 1))
    keys = [torch.where(valid, kx[:, :N], bk.INF)
            for kx in (k1x, k1x.roll(-4, 1), k1x.roll(-8, 1), k1x.roll(-12, 1))]
    hi = (keys[0].to(torch.int64) << 32) | (keys[1].to(torch.int64) + (1 << 31))
    lo = (keys[2].to(torch.int64) << 32) | (keys[3].to(torch.int64) + (1 << 31))
    o1 = torch.sort(lo, dim=1, stable=True).indices
    hs, o2 = torch.sort(torch.gather(hi, 1, o1), dim=1, stable=True)
    order = torch.gather(o1, 1, o2)
    rank, tied, unres = bk.rerank_plain(hs, torch.gather(lo, 1, order), order,
                                        n, N)
    k = 16
    while bk.loop_test_plain(k, unres, N, ladder[0]):
        A, Bv = bk.full_keys_plain(rank, n, k)
        As, Bs = tbwt._sort_cols(A, Bv)
        rank, tied, unres = bk.rerank_plain(As, Bs, None, n, N)
        k *= 2
        rows.append((0, k, unres.tolist()))
    rankD = torch.cat([rank, torch.full((B, 1), N, dtype=i32)], dim=1)
    p, r1 = tbwt._compact_by_sort(torch.where(tied, idx.expand(B, N), bk.INF),
                                  rank, ladder[0])
    for stage, cap in enumerate(ladder[1:] + [0], 1):
        unresolved = p >= 0
        while bk.loop_test_plain(k, unres, N, cap):
            A, Bv = bk.tail_keys_plain(rankD, p, r1, n, k)
            As, Bs = sk.sort_pairs(A, Bv)
            p, r1, unresolved, unres = bk.tail_rerank_plain(As, Bs, rankD)
            k *= 2
            rows.append((stage, k, unres.tolist()))
        if cap:
            p, r1 = tbwt._compact_by_sort(torch.where(unresolved, p, bk.INF),
                                          r1, cap)
    return rows, seen


@pytest.mark.parametrize("kind", ["text mixed lengths", "periodic mix"])
def test_round_record_matches_host_loop_trajectory(rng, kind):
    """ROUND_HOOK, fed from the round record at the end of the call, sees
    the rows the host-driven loop produced, in order; the record holds at
    most rounds_bound(N) rounds after the initial ranks."""
    b, n = _rows(kind, 4096, rng)
    want, seen = _host_loop_trajectory(torch.from_numpy(b), torch.from_numpy(n))
    assert seen == want
    assert 1 < len(seen) <= bk.rounds_bound(4096) + 1
    assert any(s > 0 for s, _k, _u in seen) == (kind != "periodic mix")


def test_rounds_bound():
    assert [bk.rounds_bound(N) for N in (16, 17, 32, 4096, 100_352, 901_120,
                                         1 << 20)] == [0, 1, 1, 8, 13, 16, 16]


# ------------------------------------------------------ dispatch/binding --

@pytest.mark.parametrize("wrapper", ["rerank", "tail_rerank"])
def test_cpu_rerank_ends_with_the_loop_test(rng, wrapper):
    """With a LoopTest, the CPU wrapper is its plain version followed by
    gate_plain(AFTER_ROUND) on the unres it wrote: k doubles, the record
    gets (stage, k, unres) and the gate the test's result; without one,
    ctl and the record stay as they were."""
    B, N, C = 3, 5000, 4096 + 7
    n = torch.tensor([N, 17, 2000], dtype=torch.int32)
    for with_test in (True, False):
        ctl = bk.control("cpu")
        ctl[bk.K] = 1024
        rec = torch.zeros((4, B + 2), dtype=torch.int32)
        test = bk.LoopTest(ctl, rec, 3, 2) if with_test else None
        unres = torch.full((B,), -9, dtype=torch.int32)
        if wrapper == "rerank":
            a, b2 = _sorted_cols(rng, B, N, 300)
            order = np.stack([rng.permutation(N) for _ in range(B)])
            kb = torch.from_numpy((b2 << 20) | order.astype(np.int32))
            rank = torch.zeros((B, N), dtype=torch.int32)
            tied = torch.zeros((B, N), dtype=torch.bool)
            bk.rerank(torch.from_numpy(a), kb, None, n, rank, tied, unres,
                      test=test)
            want = bk.rerank_plain(torch.from_numpy(a), kb, None, n, N)[2]
        else:
            a = np.sort(rng.integers(0, 40, (B, C)).astype(np.int32) << 11,
                        axis=1)
            a[:, C - 100:] = bk.INF
            kb = torch.from_numpy((rng.integers(0, 3, (B, C)).astype(np.int32)
                                   << 20) | rng.integers(0, N, (B, C))
                                  .astype(np.int32))
            rankD = torch.full((B, N + 1), N, dtype=torch.int32)
            outs = [torch.zeros((B, C), dtype=t) for t in
                    (torch.int32, torch.int32, torch.bool)]
            bk.tail_rerank(torch.from_numpy(a), kb, rankD, *outs, unres,
                           test=test)
            want = bk.tail_rerank_plain(torch.from_numpy(a), kb,
                                        rankD.clone())[3]
        assert torch.equal(unres, want)
        if with_test:
            go = int(bool((want > 3).any()))
            assert ctl.tolist() == [go, 2048, 1]
            assert rec[0].tolist() == [2, 2048] + want.tolist()
            assert not rec[1:].any()
        else:
            assert ctl.tolist() == [0, 1024, 0] and not rec.any()


def test_cpu_gate_updates_control_and_record():
    """The CPU gate doubles k after a round, appends (stage, k, unres) to
    the record and writes the loop test; the CPU keys wrapper writes the
    plain version's pair at ctl's k.  No kernel launches."""
    rng = np.random.default_rng(3)
    N = 256
    rank = torch.from_numpy(rng.integers(0, N, (2, N)).astype(np.int32))
    n = torch.tensor([N, 100], dtype=torch.int32)
    ctl = bk.control("cpu")
    A = torch.full((2, N), -5, dtype=torch.int32)
    Bv = A.clone()
    _build.reset_launches()
    bk.keys(rank, n, ctl, A, Bv)
    ea, eb = bk.full_keys_plain(rank, n, 16)
    assert torch.equal(A, ea) and torch.equal(Bv, eb)
    rec = torch.zeros((3, 4), dtype=torch.int32)
    bk.gate(ctl, torch.tensor([0, 9], dtype=torch.int32), rec, N, 4, 2,
            bk.AFTER_ROUND)
    assert ctl.tolist() == [1, 32, 1] and rec[0].tolist() == [2, 32, 0, 9]
    bk.gate(ctl, torch.tensor([0, 4], dtype=torch.int32), rec, N, 4, 2,
            bk.AFTER_ROUND)
    assert ctl.tolist() == [0, 64, 2] and rec[1].tolist() == [2, 64, 0, 4]
    bk.gate(ctl, torch.tensor([0, 5], dtype=torch.int32), rec, N, 4, 3,
            bk.ENTRY)
    assert ctl.tolist() == [1, 64, 2]       # an entry test records nothing
    assert all(_build.KERNELS[k].launches == 0 for k in NEW_KERNELS)


def test_loop_fold_counts_each_round_that_ran():
    """A loop graph's kernels count from the card's (entries, rounds): the
    entry test once a launch, the round's kernels once a round that ran
    (its rerank runs the test after it: no gate a round), none for a
    launch whose test failed at once."""
    ks = [_build.KERNELS[k] for k in ("sort_pairs",) + NEW_KERNELS]
    keys, rerank, gate = ks[1], ks[2], ks[4]
    body = bk.Round(*[None] * 9)            # a full-width round's kernels
    assert body.kernels == [keys, ks[0], rerank]
    lp = bk.StageLoop(body, bk.control("cpu"), None, None, 64, 0, 0,
                      bk.ENTRY)
    _build.reset_launches()
    lp.fold((1, 0))                 # launched; no round ran
    assert [k.launches for k in ks] == [0, 0, 0, 0, 1]
    lp.fold((3, 5))                 # two more launches, five rounds
    assert [k.launches for k in ks] == [5, 5, 5, 0, 3]
    lp.fold((3, 5))
    assert [k.launches for k in ks] == [5, 5, 5, 0, 3]
    tail = bk.Round(*[None] * 9, p=0)       # a tail round's kernels
    assert tail.kernels == [keys, ks[0], ks[3]]
    _build.reset_launches()


def test_cpu_loop_tests_once_an_entry_and_in_each_round(monkeypatch):
    """The CPU loop runs the gate once a stage's entry and the test after
    each round inside the round's rerank (as the card's kernels do): on one
    bwt_batched call, gate_plain sees six entries and one AFTER_ROUND test
    a round the record holds."""
    modes = []
    real = bk.gate_plain
    monkeypatch.setattr(bk, "gate_plain", lambda *a: (modes.append(a[-1]),
                                                      real(*a)))
    rows = []
    monkeypatch.setattr(tbwt, "ROUND_HOOK",
                        lambda s, k, u: rows.append((s, k)))
    b, n = _rows("text mixed lengths", 4096, np.random.default_rng(2))
    tbwt.bwt_batched(torch.from_numpy(b), torch.from_numpy(n))
    entries = [m for m in modes if m != bk.AFTER_ROUND]
    assert entries == [bk.ENTRY_RECORD] + [bk.ENTRY] * len(
        tbwt._tail_ladder(4096))
    assert modes.count(bk.AFTER_ROUND) == len(rows) - 1 > 0


@pytest.mark.parametrize("kind", ["text mixed lengths", "periodic mix"])
def test_dummy_rows_leave_the_rows_and_record_as_they_were(rng, kind):
    """A call padded with one-byte dummy rows (as a card plan with more
    rows pads a call) returns the same rows, and its round record, cut to
    the call's rows, is the unpadded call's."""
    b, n = _rows(kind, 4096, rng)
    B = b.shape[0]
    pb = np.concatenate([b, np.zeros((3, 4096), np.uint8)])
    pn = np.concatenate([n, np.ones(3, np.int32)])
    hook = tbwt.ROUND_HOOK
    seen = {"plain": [], "padded": []}
    try:
        for name, (x, m) in {"plain": (b, n), "padded": (pb, pn)}.items():
            tbwt.ROUND_HOOK = lambda s, k, u, _w=seen[name]: _w.append(
                (s, k, u[:B].tolist()))
            seen[name + " out"] = tbwt.bwt_batched(torch.from_numpy(x),
                                                   torch.from_numpy(m))
    finally:
        tbwt.ROUND_HOOK = hook
    assert seen["plain"] == seen["padded"]
    for g, w in zip(seen["padded out"], seen["plain out"]):
        assert torch.equal(g[:B], w)


def test_wrappers_refuse_non_cpu_tensors_without_plain(monkeypatch):
    """A tensor off the CPU never reaches a plain version: the wrapper goes
    to its kernel and raises on what the kernel does not take."""
    calls = []
    for name in ("full_keys_plain", "tail_keys_plain", "rerank_plain",
                 "tail_rerank_plain", "gate_plain"):
        monkeypatch.setattr(bk, name, lambda *a, _n=name, **k: calls.append(_n))
    meta = torch.device("meta")

    def z(*s, dt=torch.int32):
        return torch.zeros(s, dtype=dt, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        bk.keys(z(2, 64), z(2), z(3), z(2, 128), z(2, 128))
    with pytest.raises(ValueError, match="CUDA"):
        bk.keys(z(2, 65), z(2), z(3), z(2, 8), z(2, 8), p=z(2, 8), r1=z(2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        bk.rerank(z(2, 64), z(2, 64), None, z(2), z(2, 64),
                  z(2, 64, dt=torch.bool), z(2))
    with pytest.raises(ValueError, match="CUDA"):
        bk.tail_rerank(z(2, 8), z(2, 8), z(2, 65), z(2, 8), z(2, 8),
                       z(2, 8, dt=torch.bool), z(2))
    test = bk.LoopTest(z(3), None, 0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        bk.tail_rerank(z(2, 8), z(2, 8), z(2, 65), z(2, 8), z(2, 8),
                       z(2, 8, dt=torch.bool), z(2),
                       scratch=bk.tail_scratch(2, 8, meta), test=test)
    with pytest.raises(ValueError, match="CUDA"):
        bk.rerank(z(2, 64), z(2, 64), None, z(2), z(2, 64),
                  z(2, 64, dt=torch.bool), z(2), test=test)
    with pytest.raises(ValueError, match="CUDA"):
        bk.gate(z(3), z(2), None, 64, 0, 0, bk.ENTRY)
    with pytest.raises(ValueError, match="CUDA"):
        sk.sort_pairs(z(2, 128), z(2, 128))
    body = []
    with pytest.raises(ValueError, match="CUDA"):
        bk.loop(bk.StageLoop(lambda t: body.append(t), z(3), z(2), None, 64,
                             0, 0, bk.ENTRY))
    assert calls == [] and body == []


def test_new_source_built_and_registered():
    srcs = {s.rsplit("/", 1)[-1] for s in _build._sources()}
    assert "bwt_rounds.cu" in srcs
    for name, k in zip(NEW_KERNELS, (bk.KEYS, bk.RERANK, bk.TAIL, bk.GATE_K)):
        assert _build.KERNELS[name] is k


def _c_signatures() -> dict:
    """Each C entry point of csrc/*.cu: its parameters as 'ptr', 'i32' or
    'i64'."""
    sigs = {}
    for src in _build._sources():
        text = open(src).read()
        for name, params in re.findall(r"BZ2T_API int (\w+)\(([^)]*)\)", text):
            sigs[name] = ["ptr" if "*" in p else "i64" if "long long" in p
                          else "i32" for p in params.split(",")]
    return sigs


LOOP_FUNCTIONS = {f.name: f for f in (bk.CAPTURE, bk.LOOP_BUILD,
                                       bk.LOOP_LAUNCH, bk.LOOP_FREE)}


@pytest.mark.parametrize("name", NEW_KERNELS + ("sort_pairs",)
                         + tuple(LOOP_FUNCTIONS))
def test_kernel_argtypes_match_c_signature(name):
    """ctypes passes each argument as its argtype says: a pointer or a
    64-bit handle given as a 32-bit int would be cut."""
    k = _build.KERNELS.get(name) or LOOP_FUNCTIONS[name]
    kinds = ["ptr" if a is ct.c_void_p else f"i{8 * ct.sizeof(a)}"
             for a in k.argtypes]
    assert _c_signatures()[k.symbol] == kinds


def test_loop_graph_calls_are_not_counted_as_kernels():
    assert not set(LOOP_FUNCTIONS) & set(_build.KERNELS)
    assert all(not isinstance(f, _build.Kernel)
               for f in LOOP_FUNCTIONS.values())


def test_csrc_makes_no_blocking_cuda_call():
    """The kernel library queues work and returns: no stream or device
    synchronize, no synchronous copy, no allocation."""
    banned = re.compile(r"\b(cudaStreamSynchronize|cudaDeviceSynchronize|"
                        r"cudaEventSynchronize|cudaMemcpy|cudaMemset|"
                        r"cudaMalloc|cudaMallocHost|cudaFree)\s*\(")
    for src in _build._sources():
        assert not banned.search(open(src).read()), src


def test_a_count_read_first_adds_what_the_card_counted(monkeypatch):
    """Reading a kernel's launches runs the settlers first (the card's
    counts of a graph's kernels), and count_launches adds n a kernel; a
    wrapper's own launch counts one."""
    k = bk.GATE_K
    monkeypatch.setattr(k, "_fn", lambda *a: 0)
    monkeypatch.setattr(_build, "SETTLERS", [
        lambda: _build.count_launches([k], 2)])
    _build.reset_launches()
    assert k._launches == 0
    k()
    assert k._launches == 1
    assert k.launches == 3              # the read added the card's two
    _build.count_launches([k, k], 5)
    assert k._launches == 13
    monkeypatch.setattr(_build, "SETTLERS", [])
    _build.reset_launches()
