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


def test_kernels_registered_with_counters():
    assert set(_build.KERNELS) == {"sort_pairs", "mtf_tile_last", "mtf_rank",
                                   "group_hist"}
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
    last = mk.tile_last(seqm)
    assert torch.equal(last, mk.tile_last_plain(seqm))
    lx = mk.carries(last, 3).contiguous()
    assert torch.equal(mk.rank(seqm, lx), mk.rank_plain(seqm, lx))
    cpu = mk.mtf_ranks(torch.from_numpy(seq), torch.from_numpy(valid))
    dev = mk.mtf_ranks(torch.from_numpy(seq).to(cuda_device),
                       torch.from_numpy(valid).to(cuda_device))
    assert torch.equal(dev.cpu(), cpu)


@pytest.mark.cuda
def test_group_hist_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(8)
    mtfv = torch.from_numpy(rng.integers(0, 300, (3, 5001)).astype(np.int32))
    n_mtf = torch.tensor([5001, 2000, 1], dtype=torch.int32)
    got = mk.group_hist(mtfv.to(cuda_device), n_mtf.to(cuda_device))
    assert torch.equal(got.cpu(), mk.group_hist_plain(mtfv, n_mtf))


@pytest.mark.cuda
def test_engine_on_card_golden(cuda_device):
    from bzip2_tpu import api, native
    from bzip2_tpu_torch.engine import Engine
    if not native.available():
        pytest.skip("needs the native heap builder")
    eng = Engine(batch_size=2, device=cuda_device)
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
    assert all(k.launches > 0 for k in _build.KERNELS.values())
