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
from bzip2_tpu_torch.ops import decode as TD
from bzip2_tpu_torch.ops import huffman as hk
from bzip2_tpu_torch.ops import ibwt_kernel as ik
from bzip2_tpu_torch.ops import mtf_kernel as mk
from bzip2_tpu_torch.ops import sort_kernel as sk

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
                                   "huffman_lengths"}
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
    from bzip2_tpu.oracle import bwt as obwt
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
