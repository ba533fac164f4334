"""The port's CUDA kernels against their plain PyTorch versions, and the
kernel build.  Imports no JAX, so on a machine with a card and no JAX it
runs alone:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tests marked ``cuda`` skip without a card.  Every comparison is exact."""
import bz2 as stdlib_bz2
import os

import numpy as np
import pytest
import torch

from bzip2_tpu_torch import _build
from bzip2_tpu_torch import decoder as dmod
from bzip2_tpu_torch.ops import bwt as tbwt
from bzip2_tpu_torch.ops import bwt_kernel as bk
from bzip2_tpu_torch.ops import decode as TD
from bzip2_tpu_torch.ops import huffman as hk
from bzip2_tpu_torch.ops import ibwt_kernel as ik
from bzip2_tpu_torch.ops import mtf_inverse_kernel as mik
from bzip2_tpu_torch.ops import mtf_kernel as mk
from bzip2_tpu_torch.ops import sort_kernel as sk
from bzip2_tpu_torch.ops import symbol_kernel as sym_k
from torch_bwt_cases import (KERNEL_OF, RoundCheck, periodic_rows,
                             tail_round_inputs)
from torch_decode_cases import (mtf_edge_rows, mtf_rows, parsed,
                                span_case, wrap_case)

INF = 0x7FFFFFFF
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pairs(rng, B, N):
    a = rng.integers(-(1 << 31), 1 << 31, (B, N), dtype=np.int64).astype(np.int32)
    b = ((rng.integers(0, 1 << 9, (B, N)).astype(np.int32) << 20)
         | np.arange(N, dtype=np.int32)[None])
    return a, b


# ------------------------------------------------------- build (CPU) --

def test_check_rejects_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        _build.check(torch.zeros(4, dtype=torch.int32), "x", torch.int32, 1)


def test_library_path_is_keyed_by_flags(monkeypatch):
    p1 = _build.library_path()
    assert os.path.dirname(p1) == _build.BUILD_DIR
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-g"])
    assert _build.library_path() != p1


def test_build_failure_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """One compile per .cu source, all started before any is waited for,
    then one link; the objects are removed."""
    log = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    f"echo \"$*\" >> {log}\n"
                    'while [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = -o ]; then touch "$2"; fi; shift\n'
                    "done\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    so = _build.build()
    assert os.path.exists(so) and os.listdir(tmp_path / "out") == [
        os.path.basename(so)]
    calls = log.read_text().splitlines()
    cu = sorted(f for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in calls[:-1]) == cu
    assert all(" -c " in c for c in calls[:-1])
    assert " -shared " in calls[-1] and calls[-1].count(".o") == len(cu)


def test_kernels_registered_with_counters():
    assert set(_build.KERNELS) == {"sort_pairs", "mtf_tile_last", "mtf_rank",
                                   "group_hist", "ibwt_walk",
                                   "huffman_lengths", "symbol_scan",
                                   "mtf_inverse", "bwt_keys", "bwt_rerank",
                                   "bwt_tail_rerank", "bwt_gate"}
    _build.reset_launches()
    assert all(k.launches == 0 for k in _build.KERNELS.values())


# ------------------------------------------------------ kernels (card) --

SORT_PATTERNS = ["random", "inf_tail", "equal_a", "two_values", "all_equal",
                 "sorted", "reversed", "extremes"]


def _sort_case(rng, rows, N, pattern, dev):
    """Inputs of one sort_pairs case, on the card."""
    a, b = _pairs(rng, rows, N)
    if pattern == "inf_tail":
        # the BWT's pad lanes: (INF, bit29 | pos) from the -9 block length on
        start = 900_000 if N > 900_000 else N // 2
        a[:, start:] = INF
        b[:, start:] = (1 << 29) | np.arange(start, N, dtype=np.int32)
    elif pattern == "equal_a":
        a[:] = 5
        b = np.stack([rng.permutation(N).astype(np.int32) for _ in range(rows)])
    elif pattern == "two_values":
        a = rng.integers(0, 2, (rows, N)).astype(np.int32)
        b = rng.integers(0, 2, (rows, N)).astype(np.int32)
    elif pattern == "all_equal":
        a = np.ones((rows, N), np.int32)
        b = np.ones((rows, N), np.int32)
    elif pattern == "extremes":
        ext = np.array([-(1 << 31), -1, 0, 1, INF], np.int32)
        a = rng.choice(ext, (rows, N))
        b = rng.choice(ext, (rows, N))
    at = torch.from_numpy(a).to(dev)
    bt = torch.from_numpy(b).to(dev)
    if pattern in ("sorted", "reversed"):
        at, bt = sk.sort_pairs_plain(at, bt)
        if pattern == "reversed":
            at, bt = at.flip(1).contiguous(), bt.flip(1).contiguous()
    return at, bt


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", SORT_PATTERNS)
@pytest.mark.parametrize("N", [128, 4096, 16384, 1 << 16, 1 << 18, 1 << 20])
@pytest.mark.parametrize("rows", [1, 3, 13])
def test_sort_pairs_kernel_matches_plain(cuda_device, rows, N, pattern):
    rng = np.random.default_rng([rows, N, SORT_PATTERNS.index(pattern)])
    at, bt = _sort_case(rng, rows, N, pattern, cuda_device)
    before = sk.KERNEL.launches
    ka, kb = sk.sort_pairs(at, bt)
    assert sk.KERNEL.launches == before + 1
    pa, pb = sk.sort_pairs_plain(at, bt)
    assert torch.equal(ka, pa) and torch.equal(kb, pb)


@pytest.mark.cuda
def test_sort_pairs_rejects_bad_dtype(cuda_device):
    t = torch.zeros((1, 256), dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        sk.sort_pairs(t, t)


@pytest.mark.cuda
@pytest.mark.parametrize("runs", [False, True])
def test_mtf_kernels_match_plain(cuda_device, runs):
    rng = np.random.default_rng(7)
    seq = rng.integers(0, 40, (3, 4096)).astype(np.int32)
    if runs:
        seq.sort(axis=1)
    ns = np.array([4096, 3000, 1])
    valid = np.arange(4096)[None, :] < ns[:, None]
    seqm = torch.from_numpy(np.where(valid, seq, mk.PAD_SYM).reshape(-1, 256)
                            ).to(cuda_device)
    last = mk.tile_last(seqm, 16)
    assert torch.equal(last, mk.tile_last_plain(seqm, 16))
    lx = mk.carries(last, 3).contiguous()
    assert torch.equal(mk.rank(seqm, lx), mk.rank_plain(seqm, lx))
    cpu = mk.mtf_ranks(torch.from_numpy(seq), torch.from_numpy(valid))
    dev = mk.mtf_ranks(torch.from_numpy(seq).to(cuda_device),
                       torch.from_numpy(valid).to(cuda_device))
    assert torch.equal(dev.cpu(), cpu)


def _assert_mtf_kernels_exact(seqm, B):
    """tile_last and rank on the card equal their plain versions, with one
    launch each."""
    T = seqm.shape[0] // B
    before = (mk.TILE_LAST.launches, mk.RANK.launches)
    tl = mk.tile_last(seqm, T)
    assert torch.equal(tl, mk.tile_last_plain(seqm, T))
    lx = mk.carries(tl, B).contiguous()
    got = mk.rank(seqm, lx)
    exp = mk.rank_plain(seqm, lx)
    assert (mk.TILE_LAST.launches, mk.RANK.launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert torch.equal(got, exp)
    return got


def _edge_rows():
    """Rows of 4 tiles: one symbol repeated (rank 0 throughout after its
    first position); all 256 symbols once, then the same order again
    (rank 255 at every position of the second pass); descending order;
    runs of every symbol; PAD_SYM tails inside and at the end of tiles."""
    ar = np.arange(256, dtype=np.int32)
    rows = [np.full(4 * 256, 9, np.int32),
            np.tile(ar, 4),
            np.tile(ar[::-1], 4),
            np.repeat(ar, 4),
            np.concatenate([np.tile(ar[:17], 20)[:300],
                            np.full(724, mk.PAD_SYM, np.int32)]),
            np.where(np.arange(1024) % 256 < 200, np.tile(ar, 4) % 7,
                     mk.PAD_SYM).astype(np.int32)]
    return np.stack(rows)


@pytest.mark.cuda
def test_mtf_kernels_edge_tiles(cuda_device):
    rows = _edge_rows()
    B = rows.shape[0]
    seqm = torch.from_numpy(rows.reshape(-1, 256)).to(cuda_device)
    got = _assert_mtf_kernels_exact(seqm, B).cpu().numpy().reshape(B, -1)
    assert not got[0, 1:].any()
    assert (got[1, 256:] == 255).all() and (got[2, 256:] == 255).all()
    assert not got[4, 300:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["random", "runs", "few"])
def test_mtf_kernels_main_shape(cuda_device, pattern):
    """13 rows x 3,520 tiles: the -9 batch's shape."""
    rng = np.random.default_rng(["random", "runs", "few"].index(pattern))
    B, T = 13, 3520
    if pattern == "random":
        seq = rng.integers(0, 256, (B, T * 256)).astype(np.int32)
    elif pattern == "runs":
        seq = np.repeat(rng.integers(0, 256, (B, T * 256 // 64)), 64, axis=1)
    else:
        seq = rng.integers(0, 3, (B, T * 256))
    seq = seq.astype(np.int32)
    seq[:, 900_000:] = mk.PAD_SYM
    seqm = torch.from_numpy(seq.reshape(-1, 256)).to(cuda_device)
    _assert_mtf_kernels_exact(seqm, B)


@pytest.mark.cuda
def test_mtf_kernels_real_level9_batch(cuda_device):
    """13 rows of real -9 blocks (chip_smoke.py's corpus), through the
    port's BWT, as mtf_rle2_batched hands them to the kernels."""
    import chip_smoke
    from bzip2_tpu_torch import engine
    from bzip2_tpu_torch.ops.bwt import bwt_batched
    data = chip_smoke.corpus(13 * 900_000, chip_smoke.SEED)
    blocks = engine.split_blocks(data, 9)[:13]
    N = engine._block_pad_size(9)
    arr, ns, uses, _ = engine.batch_arrays(blocks, 13, N)
    bt, nt, ut = engine.stage_from_numpy((arr, ns, uses), cuda_device)
    last, _, _ = bwt_batched(bt, nt)
    valid = torch.arange(N, device=cuda_device)[None, :] < nt[:, None]
    ui = ut.to(torch.int32)
    remap = torch.cumsum(ui, 1, dtype=torch.int32) - ui
    seq = torch.gather(remap, 1, last.to(torch.int64))
    seqm = torch.where(valid, seq, mk.PAD_SYM).reshape(-1, 256).contiguous()
    got = _assert_mtf_kernels_exact(seqm, 13)
    assert (got == 0).float().mean().item() > 0.3


@pytest.mark.cuda
def test_mtf_rank_rejects_misaligned_carries(cuda_device):
    seqm = torch.zeros((2, 256), dtype=torch.int32, device=cuda_device)
    lx = torch.zeros(2 * 256 + 1, dtype=torch.int32,
                     device=cuda_device)[1:].reshape(2, 256)
    with pytest.raises(ValueError, match="aligned"):
        mk.rank(seqm, lx)


@pytest.mark.cuda
def test_group_hist_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(8)
    mtfv = torch.from_numpy(rng.integers(0, 300, (3, 5001)).astype(np.int32))
    n_mtf = torch.tensor([5001, 2000, 1], dtype=torch.int32)
    got = mk.group_hist(mtfv.to(cuda_device), n_mtf.to(cuda_device))
    assert torch.equal(got.cpu(), mk.group_hist_plain(mtfv, n_mtf))


@pytest.mark.cuda
def test_engine_on_card_golden(cuda_device):
    from bzip2_tpu_torch import api, native
    from bzip2_tpu_torch.engine import Engine
    if not native.available():
        pytest.skip("needs the native heap builder")
    eng = Engine(batch_size=2, host_workers=0, device=cuda_device)
    api.register_block_encoder("torch-cuda", eng.encode_payloads)
    _build.reset_launches()
    for i, level in ((1, 1), (2, 2), (3, 3)):
        with open(os.path.join(GOLDEN, f"sample{i}.ref"), "rb") as fh:
            ref = fh.read()
        with open(os.path.join(GOLDEN, f"sample{i}.bz2"), "rb") as fh:
            assert api.compress(ref, level, backend="torch-cuda") == fh.read()
    data = bytes(np.random.default_rng(9).integers(0, 200, 150_000,
                                                   dtype=np.uint8))
    assert api.compress(data, 1, backend="torch-cuda") == \
        stdlib_bz2.compress(data, 1)
    assert all(_build.KERNELS[k].launches > 0 for k in
               ("sort_pairs", "mtf_tile_last", "mtf_rank", "group_hist"))


# ------------------------------------- Huffman lengths, fused (card) --

def _level9(n_bytes):
    import chip_smoke
    data = chip_smoke.corpus(n_bytes, chip_smoke.SEED)
    return data, stdlib_bz2.compress(data, 9)


def _assert_lengths_exact(freq, alpha):
    before = hk.KERNEL.launches
    got = hk.make_code_lengths_lanes(freq, alpha)
    assert hk.KERNEL.launches == before + 1
    exp = hk.make_code_lengths_lanes_plain(freq, alpha)
    assert got.dtype == exp.dtype and torch.equal(got, exp)
    return got


@pytest.mark.cuda
def test_huffman_lengths_kernel_real_level9_lanes(cuda_device):
    """The 78 lanes of the first refinement pass of a 13-block -9 batch."""
    from bzip2_tpu_torch import engine
    from bzip2_tpu_torch.ops.groupsearch import group_iter
    data, _ = _level9(13 * 900_000)
    blocks = engine.split_blocks(data, 9)[:13]
    arr, ns, uses, _ = engine.batch_arrays(blocks, 13,
                                           engine._block_pad_size(9))
    pre = engine.encode_pre(*engine.stage_from_numpy((arr, ns, uses),
                                                     cuda_device))
    _, freq6 = group_iter(pre[6], pre[5], pre[7])
    alpha6 = (pre[2] + 2).repeat_interleave(6).to(torch.int32)
    got = _assert_lengths_exact(freq6.reshape(78, 258).contiguous(), alpha6)
    from bzip2_tpu_torch import native
    nat = native.make_code_lengths_batch(freq6.reshape(78, 258).cpu().numpy(),
                                         alpha6.cpu().numpy())
    leaf = np.arange(258)[None, :] < alpha6.cpu().numpy()[:, None]
    assert np.array_equal(np.where(leaf, got.cpu().numpy(), 0), nat)


@pytest.mark.cuda
def test_huffman_lengths_kernel_retry_and_edge_lanes(cuda_device):
    """Skewed lanes that halve and retry, alpha 2 and 258, all-zero
    frequencies, a dominant symbol."""
    rng = np.random.default_rng(12)
    L = 16
    freq = np.zeros((L, 258), np.int32)
    alpha = rng.integers(5, 25, L).astype(np.int32)   # sums below 2^23
    for i in range(12):
        a = int(alpha[i])
        freq[i, :a] = (2 ** np.minimum(np.arange(a), 19)).astype(np.int32)
    alpha[12:] = [2, 258, 258, 2]
    freq[13] = rng.integers(0, 50_000, 258)
    freq[14, 0] = 900_000
    freq[15, :2] = [7, 0]
    got = _assert_lengths_exact(torch.from_numpy(freq).to(cuda_device),
                                torch.from_numpy(alpha).to(cuda_device))
    assert got[:12].max().item() == 17


@pytest.mark.cuda
def test_huffman_lengths_kernel_tied_keys(cuda_device):
    """Lanes where many packed keys tie: every frequency equal, two or three
    distinct values, zeros (which count as 1) among ones, and equal runs;
    the heap entries carry their keys, so ties must break as the
    reference's do."""
    rng = np.random.default_rng(31)
    L = 12
    freq = np.zeros((L, 258), np.int32)
    alpha = np.full(L, 258, np.int32)
    freq[0] = 5
    freq[1] = rng.integers(0, 2, 258)
    freq[2] = rng.integers(7, 9, 258)
    freq[3] = np.repeat([3, 1, 4, 1, 5, 9], 43)
    freq[4, :130] = 1000
    freq[5] = rng.integers(0, 3, 258) * 100
    alpha[6:] = [3, 17, 64, 129, 200, 257]
    freq[6:] = 2
    freq[9, ::2] = 0
    _assert_lengths_exact(torch.from_numpy(freq).to(cuda_device),
                          torch.from_numpy(alpha).to(cuda_device))


@pytest.mark.cuda
def test_fused_engine_on_card(cuda_device):
    """Engine(mode="fused") on 2 MB at -9: bit-exact, every block on the
    card, the Huffman kernel 4 times a batch."""
    from bzip2_tpu_torch import engine
    data, expect = _level9(2 << 20)
    eng = engine.Engine(mode="fused", host_workers=0, device=cuda_device)
    engine.reset_telemetry()
    _build.reset_launches()
    assert eng.compress(data, 9) == expect
    n = len(engine.split_blocks(data, 9))
    batches = -(-n // eng._batch_size_for(9))
    assert engine.SHARE["dev_blocks"] == n
    assert hk.KERNEL.launches == 4 * batches
    assert all(_build.KERNELS[k].launches > 0 for k in
               ("sort_pairs", "mtf_tile_last", "mtf_rank", "group_hist"))


@pytest.mark.cuda
def test_default_engine_on_card(cuda_device):
    """The default scheduler (two device workers, one host worker) on a
    4-block -9 input: bit-exact, every block encoded once."""
    from bzip2_tpu_torch import engine
    data, expect = _level9(4 * 880_000)
    eng = engine.Engine(batch_size=2, device=cuda_device)
    engine.reset_telemetry()
    assert eng.compress(data, 9) == expect
    share = engine.SHARE
    assert share["blocks"] == 4
    assert share["dev_blocks"] + share["host_blocks"] == 4


# ------------------------------------------------- decoder (card) --

def _golden(i):
    with open(os.path.join(GOLDEN, f"sample{i}.ref"), "rb") as fh:
        return fh.read()


def _realistic_level9(n_bytes=2_030_000):
    data = ((_golden(1) + _golden(2) + _golden(3)) * 8)[:n_bytes]
    return data, stdlib_bz2.compress(data, 9)


def _record_waves(monkeypatch):
    """Record the (tt, cur0, cap) of every walk ops.decode.ibwt launches."""
    waves = []
    real = TD.ibwt_walk

    def spy(tt, cur0, cap):
        waves.append((tt, cur0, cap))
        return real(tt, cur0, cap)

    monkeypatch.setattr(TD, "ibwt_walk", spy)
    return waves


def _assert_walks_match(waves):
    assert waves
    for tt, cur0, cap in waves:
        before = ik.WALK.launches
        got = ik.ibwt_walk(tt, cur0, cap)
        assert ik.WALK.launches == before + 1
        exp = ik.ibwt_walk_plain(tt, cur0, cap)
        for g, e in zip(got, exp):
            assert g.dtype == e.dtype and torch.equal(g, e)


@pytest.mark.cuda
def test_ibwt_walk_kernel_matches_plain_level9(cuda_device, monkeypatch):
    """Both waves at the -9 decoder's shapes: 8 blocks of up to 900,000,
    (8, 4096) lanes with cap 440, then (8, 1024) lanes with cap 6600."""
    from bzip2_tpu_torch import native
    _, comp = _realistic_level9()
    buf = np.frombuffer(comp, np.uint8)
    pbs, pos = [], 32
    while True:
        pb, _rc = native.parse_block(buf, pos, 9)
        if pb is None:
            break
        pbs.append(pb)
        pos = pb.end_bit
    waves = _record_waves(monkeypatch)
    dec = dmod.DeviceDecoder(device=cuda_device)
    dec._decode_batch(buf, 9, (pbs * 3)[:8])
    torch.cuda.synchronize()
    assert [(tuple(c.shape), cap) for _, c, cap in waves] == [
        ((8, 4096), 440), ((8, 1024), 6600)]
    _assert_walks_match(waves)


def _degenerate_lasts():
    from bzip2_tpu_torch.oracle import bwt as obwt
    rng = np.random.default_rng(21)
    blocks = [np.full(50_000, 7, np.uint8),                       # one symbol
              np.tile(np.frombuffer(b"ab", np.uint8), 25_000),    # period 2
              rng.integers(0, 4, 1000).astype(np.uint8),          # n < 4096
              rng.integers(0, 256, 3).astype(np.uint8)]
    N = 1 << 16
    last = np.zeros((len(blocks), N), np.int32)
    ns, origs = [], []
    for i, b in enumerate(blocks):
        col, orig = obwt.bwt(b)
        last[i, :b.size] = col
        ns.append(b.size)
        origs.append(orig)
    return (torch.from_numpy(last), torch.tensor(ns, dtype=torch.int32),
            torch.tensor(origs, dtype=torch.int32))


@pytest.mark.cuda
def test_ibwt_walk_kernel_matches_plain_degenerate(cuda_device, monkeypatch):
    last, ns, origs = _degenerate_lasts()
    exp = TD.ibwt(last, ns, origs)
    waves = _record_waves(monkeypatch)
    got = TD.ibwt(last.to(cuda_device), ns.to(cuda_device),
                  origs.to(cuda_device))
    _assert_walks_match(waves)
    for g, e in zip(got, exp):
        assert torch.equal(g.cpu(), e)


def _synthetic_walk(rng, B, N, W, cap, seg):
    """tt of B single-cycle successor maps over N positions, each position
    a splitter with chance 1/seg, random bytes; W start positions a row,
    about one in ten inactive (-1)."""
    tt = np.empty((B, N), np.int32)
    for b in range(B):
        order = rng.permutation(N)
        succ = np.empty(N, np.int64)
        succ[order] = np.roll(order, -1)
        split = rng.random(N) < 1.0 / seg
        tt[b] = (succ << 9) | (split[succ].astype(np.int64) << 8) | \
            rng.integers(0, 256, N)
    cur0 = rng.integers(0, N, (B, W)).astype(np.int32)
    cur0[rng.random((B, W)) < 0.1] = -1
    return torch.from_numpy(tt), torch.from_numpy(cur0), cap


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,W,cap,seg", [
    (8, 900_000, 4096, 440, 220),      # -9 wave 1
    (8, 900_000, 1024, 6600, 1800),    # -9 wave 2
    (8, 100_000, 4096, 50, 25),        # -1 wave 1
    (8, 100_000, 1024, 750, 200),      # -1 wave 2
    (2, 929_792, 4096, 440, 220),      # 16 x 58,112: a 16-CTA cluster's
    (2, 929_793, 1024, 440, 220),      # shared memory, and one past it
    (3, 1 << 20, 4096, 440, 220),      # the largest N ibwt accepts
    (3, 50_001, 300, 37, 20),          # odd N, W and cap: unaligned rows
])
def test_ibwt_walk_kernel_synthetic(cuda_device, B, N, W, cap, seg):
    rng = np.random.default_rng(N + W + cap)
    tt, cur0, cap = _synthetic_walk(rng, B, N, W, cap, seg)
    _assert_walks_match([(tt.to(cuda_device), cur0.to(cuda_device), cap)])


@pytest.mark.cuda
def test_ibwt_walk_kernel_matches_plain_level1(cuda_device, monkeypatch):
    """Both waves of a real -1 batch: 8 blocks of up to 100,000."""
    from bzip2_tpu_torch import native
    data = ((_golden(1) + _golden(2) + _golden(3)) * 8)[:1_000_000]
    buf = np.frombuffer(stdlib_bz2.compress(data, 1), np.uint8)
    pbs, pos = [], 32
    while len(pbs) < 8:
        pb, _rc = native.parse_block(buf, pos, 1)
        assert pb is not None
        pbs.append(pb)
        pos = pb.end_bit
    waves = _record_waves(monkeypatch)
    dmod.DeviceDecoder(device=cuda_device)._decode_batch(buf, 1, pbs)
    torch.cuda.synchronize()
    assert [tuple(c.shape) for _, c, _ in waves] == [(8, 4096), (8, 1024)]
    _assert_walks_match(waves)


def _spy_args(monkeypatch, module, name):
    """Record the arguments of every call of ``module.name``."""
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _assert_symbols_match(args):
    before = sym_k.SCAN.launches
    got = sym_k.symbol_scan(*args)
    assert sym_k.SCAN.launches == before + 1
    exp = sym_k.symbol_scan_plain(*args)
    assert got.dtype == exp.dtype == torch.int32 and torch.equal(got, exp)


def _assert_mtf_match(args, n_chunks=None):
    """The kernel at n_chunks (None: chunks_for's count) against the plain
    version at n_chunks (None: MTF_CHUNKS)."""
    before = mik.KERNEL.launches
    got = mik.mtf_inverse(*args, n_chunks=n_chunks)
    assert mik.KERNEL.launches == before + 1
    exp = mik.mtf_inverse_plain(
        *args, n_chunks=mik.MTF_CHUNKS if n_chunks is None else n_chunks)
    assert got.dtype == exp.dtype == torch.int32 and torch.equal(got, exp)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [False, True], ids=["flat", "rows"])
@pytest.mark.parametrize("level", [1, 9])
def test_decode_kernels_match_plain_real_batch(cuda_device, monkeypatch,
                                               level, rows):
    """The symbol scan and MTF^-1 kernels on the inputs of a real 8-block
    batch of the decoder (-9: three blocks, repeated; -1: eight), in flat
    and row addressing: equal to the plain versions at every lane and
    position; the decoder's own calls on the card never ran the plain
    loops."""
    n = 2_030_000 if level == 9 else 1_000_000
    buf, pbs = parsed(((_golden(1) + _golden(2) + _golden(3)) * 8)[:n],
                       level)
    pbs = (pbs * 3)[:8]
    name = "decode_symbols_rows" if rows else "decode_symbols"
    scans = _spy_args(monkeypatch, TD, name)
    mtfs = _spy_args(monkeypatch, TD, "mtf_inverse")
    plains = (_spy_args(monkeypatch, sym_k, "symbol_scan_plain"),
              _spy_args(monkeypatch, mik, "mtf_inverse_plain"))
    res = dmod.launch_batch(cuda_device, level,
                            dmod.batch_inputs(buf, pbs, rows=rows))
    blocks, _ = dmod.fetch_batch(res)
    assert all(b is not None for b in blocks)
    assert plains == ([], []) and len(scans) == len(mtfs) == 1
    assert scans[0][0].dim() == (2 if rows else 1)
    _assert_symbols_match(scans[0])
    _assert_mtf_match(mtfs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("M,n_chunks", [(3050, 1), (3050, 16), (3050, 512),
                                        (50, 512), (200_000, 512),
                                        (100_050, 7)])
def test_mtf_inverse_kernel_synthetic(cuda_device, M, n_chunks):
    rng = np.random.default_rng(M + n_chunks)
    _assert_mtf_match(tuple(torch.from_numpy(a).to(cuda_device) for a in
                            mtf_rows(rng, M, -(-M // n_chunks))), n_chunks)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [False, True], ids=["flat", "rows"])
def test_symbol_scan_kernel_wraps_at_the_buffer_end(cuda_device, rows):
    """Offsets in the buffer's last three bytes, random tables with long
    codes, valid and invalid lanes: the kernel equals the plain scan."""
    words, goff, gsel, gvalid, lens6, alpha = (
        torch.from_numpy(a).to(cuda_device) for a in wrap_case(rows))
    tables = TD.build_tables(lens6, alpha)
    _assert_symbols_match((words, goff, gsel, gvalid, *tables))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [False, True], ids=["flat", "rows"])
@pytest.mark.parametrize("G", [257, 300, 700])
def test_symbol_scan_kernel_staging_edges(cuda_device, rows, G):
    """The staged kernel at its edges: G groups a block not a multiple of
    a CTA's 256, blocks selecting one, two and six tables, invalid lanes
    outside every staged span (negative, past the buffer, in the last word
    so the window wraps, in another block's groups): equal to the plain
    scan at every lane."""
    words, goff, gsel, gvalid, lens6, alpha = (
        torch.from_numpy(a).to(cuda_device) for a in span_case(rows, G))
    tables = TD.build_tables(lens6, alpha)
    _assert_symbols_match((words, goff, gsel, gvalid, *tables))


@pytest.mark.cuda
@pytest.mark.parametrize("M,n_chunks", [(6_100, None), (6_100, 1),
                                        (6_100, 16), (100, 512), (100, None),
                                        (250_000, None)])
def test_mtf_inverse_kernel_edge_rows(cuda_device, M, n_chunks):
    """Rows of all movers, of none (RUNA/RUNB only), n_used 1 (nothing
    moves, reads away from the front) and r = 255 moves, at chunks_for's
    count, at 1 and 16 chunks and with more chunks than symbols."""
    rng = np.random.default_rng(M + (n_chunks or 0))
    _assert_mtf_match(tuple(torch.from_numpy(a).to(cuda_device)
                            for a in mtf_edge_rows(rng, M)), n_chunks)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 8])
def test_mtf_inverse_kernel_chunks_for_long_rows(cuda_device, B):
    """B rows of 900,050 symbols at the chunk count chunks_for picks (3,503
    chunks for one row) against the plain version at MTF_CHUNKS."""
    assert mik.chunks_for(B, 900_050) > mik.MTF_CHUNKS
    rng = np.random.default_rng(B)
    _assert_mtf_match(tuple(torch.from_numpy(a[:B]).to(cuda_device)
                            for a in mtf_rows(rng, 900_050, 1_758)))


@pytest.mark.cuda
def test_decoder_on_card(cuda_device):
    data, comp = _realistic_level9()
    small = stdlib_bz2.compress(_golden(1), 1)
    dmod.reset_telemetry()
    _build.reset_launches()
    dec = dmod.DeviceDecoder(device=cuda_device)
    assert dec.decompress(comp) == data
    assert dec.decompress_with_tail(small + comp + b"junk") == (
        _golden(1) + data, len(small) + len(comp))
    assert dmod.ANOMALIES == {"lane": 0, "batch": 0}
    assert dmod.SHARE == {"blocks": 7, "dev_blocks": 7}
    assert ik.WALK.launches == 2 * 3
    assert sym_k.SCAN.launches == mik.KERNEL.launches == 3


@pytest.mark.cuda
def test_decoder_wide_rle1_lanes_on_card(cuda_device):
    """Lanes whose RLE1^-1 output passes 1.25 N + 64 run RLE1^-1 again on
    the card at their own length: exact, no host heal."""
    rng = np.random.default_rng(5)
    runs = b"".join(bytes([int(v)]) * int(k) for v, k in zip(
        rng.integers(0, 256, 5000), rng.integers(20, 250, 5000)))
    data = (_golden(2) * 2)[:150_000] + runs + _golden(1)[:60_000]
    dmod.reset_telemetry()
    dec = dmod.DeviceDecoder(device=cuda_device)
    assert dec.decompress(stdlib_bz2.compress(data, 1)) == data
    assert dmod.ANOMALIES == {"lane": 0, "batch": 0}
    assert dmod.SHARE["dev_blocks"] == dmod.SHARE["blocks"] >= 2
    assert dmod.WIDE["lane"] >= 1


@pytest.mark.cuda
def test_decoder_real_heal_on_card(cuda_device, monkeypatch):
    """The budget-2 heal: the host decodes the flagged -9 blocks through
    native.decode_some, built on the card's host."""
    import functools
    data, comp = _realistic_level9()
    monkeypatch.setattr(TD, "ibwt", functools.partial(TD.ibwt, budget=2))
    dmod.reset_telemetry()
    assert dmod.DeviceDecoder(device=cuda_device).decompress(comp) == data
    assert dmod.ANOMALIES["lane"] > 0


# ------------------------------------------------ surfaces (card) --

@pytest.mark.cuda
def test_bz2compressor_round_trip_on_card(cuda_device):
    """BZ2Compressor on its default backend ("gpu", the default engine on
    the card) over 2 MB at -9 in 1 MiB chunks, as the CLI feeds it:
    bit-exact, every block encoded once, the encode kernels launched; then
    BZ2Decompressor reads it back."""
    import bzip2_tpu_torch
    from bzip2_tpu_torch import engine
    data, expect = _level9(2 << 20)
    engine.reset_telemetry()
    _build.reset_launches()
    comp = bzip2_tpu_torch.BZ2Compressor(9)
    out = b"".join(comp.compress(data[i:i + (1 << 20)])
                   for i in range(0, len(data), 1 << 20)) + comp.flush()
    assert out == expect
    n = len(engine.split_blocks(data, 9))
    assert engine.SHARE["blocks"] == n
    assert engine.SHARE["dev_blocks"] + engine.SHARE["host_blocks"] == n
    if engine.SHARE["dev_blocks"]:
        assert _build.KERNELS["sort_pairs"].launches > 0
    assert bzip2_tpu_torch.BZ2Decompressor().decompress(out) == data


@pytest.mark.cuda
def test_reference_codec_holds_card_stream(cuda_device):
    """A 1 MiB slice at -9: the card's stream (every block on the card) is
    decoded exactly by the port's pure-Python oracle, and the oracle's
    stream of the same slice equals the card's."""
    import bzip2_tpu_torch
    from bzip2_tpu_torch import api, engine
    data, expect = _level9(1 << 20)
    engine.reset_telemetry()
    card = bzip2_tpu_torch.compress(data, 9, host_workers=0)
    n = len(engine.split_blocks(data, 9))
    assert card == expect and engine.SHARE["dev_blocks"] == n == 2
    assert api.decompress(card, backend="oracle") == data
    assert api.compress(data, 9, backend="oracle") == card


@pytest.mark.cuda
def test_cli_decode_on_card(cuda_device, tmp_path):
    """bz2t -d in process on a 2 MB -9 stream: the default backend decodes
    on the card, every block on the device, the walk kernel launched."""
    from bzip2_tpu_torch import cli
    data, comp = _level9(2 << 20)
    p = tmp_path / "in.bin.bz2"
    p.write_bytes(comp)
    dmod.reset_telemetry()
    _build.reset_launches()
    assert cli.main(["-dk", str(p)]) == 0
    assert (tmp_path / "in.bin").read_bytes() == data
    n = dmod.SHARE["blocks"]
    assert n >= 3 and dmod.SHARE == {"blocks": n, "dev_blocks": n}
    assert dmod.ANOMALIES == {"lane": 0, "batch": 0}
    assert ik.WALK.launches > 0


# ---------------------------------------------------- mesh (card) --

def _mesh_encode(mesh, data, level):
    """data through encode_blocks_sharded on ``mesh``, framed."""
    from bzip2_tpu_torch import api, engine
    from bzip2_tpu_torch.parallel import mesh as M
    blocks = engine.split_blocks(data, level)
    N = engine._block_pad_size(level)
    words, nbits = M.encode_blocks_sharded(
        mesh, *engine.batch_arrays(blocks, len(blocks), N),
        engine._words_for(N))
    return api.frame([b.crc for b in blocks],
                     engine.payloads_from_words(words, nbits),
                     level), len(blocks)


@pytest.mark.cuda
def test_mesh_two_entries_on_card(cuda_device):
    """A two-entry mesh on cuda:0 at -1: the encode is bit-exact and
    launches every encode kernel (the fused encoder, huffman_lengths
    included); the sharded decode is exact, heals nothing and walks with
    the kernel."""
    from bzip2_tpu_torch.parallel import mesh as M
    data = ((_golden(1) + _golden(2) + _golden(3)) * 2)[:700_000]
    mesh = M.make_mesh(["cuda:0", "cuda:0"])
    _build.reset_launches()
    stream, n = _mesh_encode(mesh, data, 1)
    assert n == 7 and stream == stdlib_bz2.compress(data, 1)
    assert all(_build.KERNELS[k].launches > 0 for k in
               ("sort_pairs", "mtf_tile_last", "mtf_rank", "group_hist",
                "huffman_lengths"))
    M.reset_telemetry()
    _build.reset_launches()
    assert M.decode_blocks_sharded(mesh, stream) == data
    assert M.HEALS["lane"] == 0 and ik.WALK.launches > 0
    assert sym_k.SCAN.launches > 0 and mik.KERNEL.launches > 0
    assert set(M.STAGE_WALL) == set(dmod.STAGES)


@pytest.mark.cuda
def test_default_mesh_on_card(cuda_device):
    """make_mesh() takes every CUDA device; -9 encode and decode of two
    blocks on it are exact."""
    from bzip2_tpu_torch.parallel import mesh as M
    mesh = M.make_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i)
                                 for i in range(torch.cuda.device_count()))
    data, expect = _level9(1_200_000)
    stream, n = _mesh_encode(mesh, data, 9)
    assert n == 2 and stream == expect
    assert M.decode_blocks_sharded(mesh, stream) == data


# ------------------------------------------------- the BWT's rounds (card) --

def _bwt_batch(level: int, rows: int, dev) -> tuple:
    """The engine's first batch of ``rows`` blocks of the bench corpus at
    ``level``, on the card: (blocks uint8 (rows, N), n int32 (rows,))."""
    from bzip2_tpu_torch import engine
    from bzip2_tpu_torch.bench import make_corpus
    N = engine._block_pad_size(level)
    size = (rows + 1) * 100_000 * level
    while len(blocks := engine.split_blocks(make_corpus(size), level)) < rows:
        size *= 2
    arr, ns, _u, _c = engine.batch_arrays(blocks[:rows], rows, N)
    return (torch.from_numpy(arr).to(dev), torch.from_numpy(ns).to(dev))


def _bwt_case(case: str, dev) -> tuple:
    if case == "-9 batch":
        return _bwt_batch(9, 13, dev)
    if case == "-1 batch":
        return _bwt_batch(1, 95, dev)
    b, n = periodic_rows(np.random.default_rng(13), 13, 901_120)
    return torch.from_numpy(b).to(dev), torch.from_numpy(n).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["-9 batch", "-1 batch", "periodic"])
def test_bwt_round_kernels_match_plain(cuda_device, case):
    """Every round kernel equals its plain version on every call of a
    bwt_batched run whose gate is open (the first -9 encode batch,
    13 x 901,120; the -1 batch, 95 x 100,352; 13 periodic rows), and each
    is launched on each call of its wrapper."""
    blocks, n = _bwt_case(case, cuda_device)
    _build.reset_launches()
    with RoundCheck() as rc:
        tbwt.bwt_batched(blocks, n)
    for w, kname in KERNEL_OF.items():
        assert _build.KERNELS[kname].launches == rc.calls[w], w
    assert rc.checked["rerank"] >= 1 and rc.checked["gate"] >= 6
    if case == "periodic":
        assert rc.checked["keys"] >= 10
    else:
        assert rc.checked["tail_rerank"] >= 1
    assert max(rc.err.values()) == 0


@pytest.mark.cuda
def test_bwt_batched_card_equals_cpu(cuda_device):
    """The whole BWT on the card equals the CPU's (plain versions, same
    gated schedule) on periodic, constant, n = 1, n = N and random rows."""
    b, n = periodic_rows(np.random.default_rng(5), 16, 1 << 15)
    got = tbwt.bwt_batched(torch.from_numpy(b).to(cuda_device),
                           torch.from_numpy(n).to(cuda_device))
    exp = tbwt.bwt_batched(torch.from_numpy(b), torch.from_numpy(n))
    for g, e in zip(got, exp):
        assert torch.equal(g.cpu(), e)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["-9 batch", "periodic"])
def test_bwt_batched_makes_no_host_sync(cuda_device, case):
    """bwt_batched runs under set_sync_debug_mode("error") (no ROUND_HOOK),
    and queued behind a sleeping kernel it returns before the sleep ends."""
    blocks, n = _bwt_case(case, cuda_device)
    want = tbwt.bwt_batched(blocks, n)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tbwt.bwt_batched(blocks, n)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    asleep = torch.cuda.Event()
    torch.cuda._sleep(1 << 31)              # about a second at 1.75 GHz
    asleep.record()
    tbwt.bwt_batched(blocks, n)
    assert not asleep.query()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_bwt_batched_on_two_streams_at_once(cuda_device):
    """Two threads, each on its own stream (as the engine's two device
    workers), build and launch their loop graphs at the same time; each
    result equals the one made alone, and every round kernel is launched."""
    import threading
    cases = [_bwt_case("-9 batch", cuda_device), _bwt_case("periodic",
                                                            cuda_device)]
    want = [tbwt.bwt_batched(b, n) for b, n in cases]
    torch.cuda.synchronize()
    _build.reset_launches()
    got, errs = [None, None], []

    def work(i):
        try:
            s = torch.cuda.Stream()
            with torch.cuda.stream(s):
                for _ in range(3):
                    got[i] = tbwt.bwt_batched(*cases[i])
            s.synchronize()
        except BaseException as e:          # surfaced below
            errs.append(e)
    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert torch.equal(x, y)
    assert all(_build.KERNELS[k].launches > 0 for k in KERNEL_OF.values())


@pytest.mark.cuda
def test_bwt_round_hook_reads_the_card_record(cuda_device, monkeypatch):
    """ROUND_HOOK sees the card's round record: the initial ranks and each
    round that ran, k doubling from 16."""
    blocks, n = _bwt_case("periodic", cuda_device)
    rows = []
    monkeypatch.setattr(tbwt, "ROUND_HOOK",
                        lambda s, k, u: rows.append((s, k, u.tolist())))
    tbwt.bwt_batched(blocks, n)
    ks = [k for _s, k, _u in rows]
    assert ks == [16 << i for i in range(len(ks))]
    assert len(rows) == bk.rounds_bound(901_120) + 1
    assert all(s == 0 for s, _k, _u in rows)


BWT_COUNTED = ("sort_pairs",) + tuple(KERNEL_OF.values())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["-9 batch", "periodic"])
def test_bwt_graph_launches_count_the_rounds_that_ran(cuda_device, case):
    """The launches a call through the WHILE graphs counts (on the card, a
    round at a time) equal those of the same call with its loops driven
    from the host, kernel by kernel."""
    blocks, n = _bwt_case(case, cuda_device)
    tbwt.bwt_batched(blocks, n)             # the plan and its graphs
    _build.reset_launches()
    with RoundCheck():
        tbwt.bwt_batched(blocks, n)
    looped = {k: _build.KERNELS[k].launches for k in BWT_COUNTED}
    _build.reset_launches()
    tbwt.bwt_batched(blocks, n)
    graphs = {k: _build.KERNELS[k].launches for k in BWT_COUNTED}
    assert graphs == looped
    # the gate runs once a stage's entry: the round's rerank tests after it
    assert graphs["bwt_gate"] == len(tbwt._tail_ladder(blocks.shape[1])) + 1
    # periodic rows resolve in the full-width stage: no tail round runs
    assert all(v > 0 for k, v in graphs.items()
               if case == "-9 batch" or k != "bwt_tail_rerank")


@pytest.mark.cuda
def test_bwt_fewer_rows_run_in_the_plan_without_a_sync(cuda_device):
    """A call with fewer rows than its stream's plan for N runs in that
    plan (dummy rows fill it): no new plan, no host sync, and its rows
    equal the same rows of the full call."""
    blocks, n = _bwt_case("-9 batch", cuda_device)
    want = tbwt.bwt_batched(blocks, n)
    torch.cuda.synchronize()
    plans = dict(tbwt._PLANS)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tbwt.bwt_batched(blocks[:4].contiguous(), n[:4].contiguous())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert dict(tbwt._PLANS) == plans
    for g, w in zip(got, want):
        assert torch.equal(g, w[:4])


@pytest.mark.cuda
def test_bwt_plans_dropped_while_threads_capture_and_launch(cuda_device):
    """Two threads on their own streams call bwt_batched over more widths
    than the plan cache keeps, so that plans are made, replaced and
    dropped on one thread while the other captures and launches: every
    result equals the one made alone, and the run ends (a stop prints the
    threads' stacks and ends the process)."""
    from bzip2_tpu_torch.tools import bwt_stress
    out = bwt_stress.main(["--threads", "2", "--seconds", "15",
                           "--hang-after", "120"])
    assert out["calls"] > 40 and out["mismatches"] == 0 and not out["errors"]


# ----------------------------------- the tail round's end, one kernel (card) --

#: (kind, C, N, k before the round, thresh): C not a multiple of the
#: kernel's tile; a row set with every entry dead; one segment across
#: every tile; a round
#: after which the test closes (thresh above every row's count); k
#: reaching N (the test closes whatever the counts)
TAIL_EDGES = {
    "C not a multiple of the tile": ("mixed", 3 * 4096 + 17, 20_000, 1024,
                                     0),
    "every entry dead": ("dead", 2 * 4096, 9_000, 64, 0),
    "a segment across every tile": ("one segment", 8 * 4096, 40_000, 4096, 0),
    "the test closes": ("full", 4 * 4096 + 5, 20_000, 2048, 1 << 20),
    "k reaches N": ("one segment", 4096 + 1, 8_192, 4096, 0),
}


def _tail_round(dev, kind, C, N, k, thresh, seed=3):
    """A tail round's end on the card and its plain version on the CPU:
    (run, want, outs); run() launches the kernel with its loop test into
    outs, want the plain outputs (p, r1, unresolved, unres, rankD, ctl,
    rec) on the CPU."""
    rng = np.random.default_rng(seed)
    B = 3
    As, Bs, rankD = tail_round_inputs(rng, B, C, N, kind)
    ctl = torch.tensor([1, k, 1], dtype=torch.int32)
    rec = torch.zeros((3, B + 2), dtype=torch.int32)
    rd = rankD.clone()
    want = list(bk.tail_rerank_plain(As, Bs, rd)) + [rd]
    wctl, wrec = ctl.clone(), rec.clone()
    bk.gate_plain(wctl, want[3], wrec, N, thresh, 4, bk.AFTER_ROUND)
    want += [wctl, wrec]
    g = [t.to(dev) for t in (As, Bs, rankD, ctl, rec)]
    outs = [torch.full((B, C), -3, dtype=torch.int32, device=dev),
            torch.full((B, C), -3, dtype=torch.int32, device=dev),
            torch.ones((B, C), dtype=torch.bool, device=dev),
            torch.full((B,), -7, dtype=torch.int32, device=dev),
            g[2], g[3], g[4]]
    scratch = bk.tail_scratch(B, C, dev)
    test = bk.LoopTest(g[3], g[4], thresh, 4)

    def run():
        bk.tail_rerank(g[0], g[1], g[2], *outs[:4], scratch=scratch,
                       test=test)
    return run, want, outs, scratch, (g[2], g[3], g[4], rankD, ctl, rec)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TAIL_EDGES))
def test_bwt_tail_rerank_kernel_edges(cuda_device, case):
    """The one-pass tail rerank and the loop test in its last CTA equal
    tail_rerank_plain followed by gate_plain(AFTER_ROUND): p, r1, the
    unresolved flags, unres, rankD, ctl and the record."""
    kind, C, N, k, thresh = TAIL_EDGES[case]
    run, want, outs, _sc, _keep = _tail_round(cuda_device, kind, C, N, k,
                                              thresh)
    run()
    torch.cuda.synchronize()
    for g, w in zip(outs, want):
        assert torch.equal(g.cpu(), w)
    go = int(want[5][bk.GATE])
    assert go == (case not in ("the test closes", "k reaches N",
                               "every entry dead"))


@pytest.mark.cuda
def test_bwt_rerank_kernels_leave_their_scratch_ready(cuda_device):
    """unres is written, not added to: filled with garbage before each of
    two calls on one scratch, it equals the plain count after each; the
    tail kernel's last CTA leaves its tickets, CTAs done and row sums at
    zero and raises the epoch by one a launch; the full-width rerank with
    a test leaves its count of CTAs done at zero."""
    C = 3 * 4096 + 17
    run, want, outs, scratch, keep = _tail_round(
        cuda_device, "mixed", C, 20_000, 1024, 1 << 20)
    B, tiles = 3, -(-C // bk.TAIL_TILE)
    rankD, ctl, rec, rd0, ctl0, rec0 = keep
    for launch in (1, 2):
        outs[3].fill_(-7 * launch)
        rankD.copy_(rd0)
        ctl.copy_(ctl0)
        rec.copy_(rec0)
        run()
        torch.cuda.synchronize()
        assert torch.equal(outs[3].cpu(), want[3])
        ctrl = scratch[2 * B * tiles:].cpu().tolist()
        assert ctrl[:3] == [0, 0, launch] and ctrl[4:] == [0] * B
    rng = np.random.default_rng(4)
    N = 3 * 4096 + 9
    a = np.sort(rng.integers(0, 500, (B, N)).astype(np.int32), axis=1)
    kb = ((rng.integers(0, 3, (B, N)).astype(np.int32) << 20)
          | np.stack([rng.permutation(N) for _ in range(B)]).astype(np.int32))
    n = torch.tensor([N, 100, 4097], dtype=torch.int32)
    exp = bk.rerank_plain(torch.from_numpy(a), torch.from_numpy(kb), None, n,
                          N)
    sc = bk.rerank_scratch(B, N, cuda_device)
    ka, kbd = (torch.from_numpy(x).to(cuda_device) for x in (a, kb))
    nd = n.to(cuda_device)
    for launch in (1, 2):
        out = [torch.full((B, N), -3, dtype=torch.int32, device=cuda_device),
               torch.ones((B, N), dtype=torch.bool, device=cuda_device),
               torch.full((B,), 99 * launch, dtype=torch.int32,
                          device=cuda_device)]
        c = bk.control(cuda_device)
        bk.rerank(ka, kbd, None, nd, *out, scratch=sc,
                  test=bk.LoopTest(c, None, 0, 0))
        torch.cuda.synchronize()
        for g, w in zip(out, exp):
            assert torch.equal(g.cpu(), w)
        assert int(sc[-1]) == 0 and c.tolist() == [1, 32, 0]


@pytest.mark.cuda
def test_bwt_tail_round_graph_replayed_200_times(cuda_device):
    """One tail round's end captured in a CUDA graph and replayed 200 times
    on one scratch, its inputs restored and its outputs spoilt before each
    replay: every replay is exact (a stale status word, epoch or ticket
    would give wrong ranks), and the epoch counts the replays."""
    C = 8 * 4096
    run, want, outs, scratch, keep = _tail_round(
        cuda_device, "one segment", C, 40_000, 4096, 0)
    rankD, ctl, rec, rd0, ctl0, rec0 = keep
    run()                           # the warm-up launch, outside the graph
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        run()
    for i in range(200):
        for o in outs[:3]:
            o.fill_(-1 if o.dtype != torch.bool else True)
        outs[3].fill_(i)
        rankD.copy_(rd0)
        ctl.copy_(ctl0)
        rec.copy_(rec0)
        g.replay()
        torch.cuda.synchronize()
        for got, w in zip(outs, want):
            assert torch.equal(got.cpu(), w), i
    B, tiles = 3, C // bk.TAIL_TILE
    assert int(scratch[2 * B * tiles + 2]) == 201


@pytest.mark.cuda
def test_bwt_loop_graphs_200_calls_exact(cuda_device):
    """200 bwt_batched calls in a row on one plan, each through the stage
    loops' WHILE graphs (rows whose first tail stage starts with one
    segment across four tiles), every call equal to the first and to the
    CPU's."""
    N = 65536
    rng = np.random.default_rng(7)
    b = rng.integers(0, 256, (2, N)).astype(np.uint8)
    b[0, 20000:39000] = 0x61
    b[1, 1000:10000] = 0x62
    n = np.array([N, N - 3], np.int32)
    exp = tbwt.bwt_batched(torch.from_numpy(b), torch.from_numpy(n))
    bd, nd = torch.from_numpy(b).to(cuda_device), torch.from_numpy(n).to(
        cuda_device)
    for i in range(200):
        got = tbwt.bwt_batched(bd, nd)
        for g, w in zip(got, exp):
            assert torch.equal(g.cpu(), w), i
