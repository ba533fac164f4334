"""Port's MTF ranks, MTF+RLE2 and group histograms vs the JAX functions
(Pallas kernels in interpret mode).  Tolerance 0: integer outputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bzip2_tpu.ops.mtf import mtf_rle2_batched as jax_mtf_rle2
from bzip2_tpu.ops.mtf_pallas import group_hist_pallas, mtf_ranks_pallas
from bzip2_tpu_torch.ops import mtf_kernel as mk
from bzip2_tpu_torch.ops.mtf import floor_log2, mtf_rle2_batched


def _seqs(rng, trial, B=2, N=2048):
    k = int(rng.integers(2, 40))
    seq = rng.integers(0, k, (B, N)).astype(np.int32)
    if trial % 2:
        seq.sort(axis=1)  # long runs
    ns = rng.integers(1, N + 1, B).astype(np.int32)
    valid = np.arange(N)[None, :] < ns[:, None]
    return seq, valid, ns


@pytest.mark.parametrize("trial", range(4))
def test_mtf_ranks_matches_jax_pallas(rng, trial):
    for _ in range(trial + 1):
        seq, valid, ns = _seqs(rng, trial)
    exp = np.asarray(mtf_ranks_pallas(jnp.asarray(seq), jnp.asarray(valid),
                                      interpret=True))
    got = mk.mtf_ranks(torch.from_numpy(seq), torch.from_numpy(valid)).numpy()
    for b in range(seq.shape[0]):
        assert np.array_equal(got[b, :ns[b]], exp[b, :ns[b]])
        assert not got[b, ns[b]:].any()     # invalid positions rank 0


def test_mtf_ranks_ragged_width_matches_oracle(rng):
    # widths that are not whole tiles are padded inside mtf_ranks
    from bzip2_tpu.oracle.mtf import mtf_ranks as oracle_ranks
    seq = rng.integers(0, 6, (1, 777)).astype(np.int32)
    got = mk.mtf_ranks(torch.from_numpy(seq),
                       torch.ones((1, 777), dtype=torch.bool)).numpy()[0]
    assert np.array_equal(got, oracle_ranks(seq[0], 256))


def test_tile_last_plain():
    # two rows of three tiles: slot 0 the seeds, slot t+1 tile t's last
    # occurrences as row indices, -2^30 where absent; the last tile of a
    # row is never anyone's carry
    seqm = np.full((6, 256), mk.PAD_SYM, np.int32)
    seqm[0, :5] = [3, 1, 3, 0, 255]
    seqm[1, 200] = 7
    seqm[2, 9] = 7
    seqm[4, 0] = 1
    got = mk.tile_last_plain(torch.from_numpy(seqm), 3).numpy()
    seeds = -(np.arange(256, dtype=np.int32) + 1)
    exp = np.full((6, 256), -(1 << 30), np.int32)
    exp[[0, 3]] = seeds
    exp[1, [3, 1, 0, 255]] = [2, 1, 3, 4]
    exp[2, 7] = 256 + 200
    exp[5, 1] = 256
    assert got.dtype == np.int32 and np.array_equal(got, exp)
    lx = mk.carries(torch.from_numpy(got), 2).numpy()
    assert np.array_equal(lx[0], seeds) and lx[2, 7] == 456 and lx[2, 3] == 2
    assert np.array_equal(lx[3], seeds) and lx[5, 1] == 256


@pytest.mark.parametrize("N", [2048, 8192])
def test_mtf_rle2_matches_jax(rng, N):
    B = 3
    last = np.zeros((B, N), np.uint8)
    ns = np.array([N, N // 2 + 7, 1], np.int32)
    uses = np.zeros((B, 256), bool)
    for b in range(B):
        alpha = rng.choice(256, int(rng.integers(1, 30)), replace=False)
        v = rng.choice(alpha, ns[b])
        if b == 0:
            v[: N // 2].sort()   # long zero runs -> RUNA/RUNB digits
        last[b, :ns[b]] = v
        uses[b, np.unique(v)] = True
    exp = jax_mtf_rle2(jnp.asarray(last), jnp.asarray(ns), jnp.asarray(uses),
                       tile=2048, use_pallas=False)
    got = mtf_rle2_batched(torch.from_numpy(last), torch.from_numpy(ns),
                           torch.from_numpy(uses))
    for e, g, name in zip(exp, got, ("mtfv", "n_mtf", "n_in_use")):
        assert np.array_equal(np.asarray(e), g.numpy()), name


def test_floor_log2_exact():
    m = np.concatenate([np.arange(1, 5000), (1 << np.arange(21)),
                        (1 << np.arange(1, 22)) - 1]).astype(np.int32)
    got = floor_log2(torch.from_numpy(m)).numpy()
    exp = np.array([int(x).bit_length() - 1 for x in m])
    assert np.array_equal(got, exp)


@pytest.mark.parametrize("M", [1003, 50 * 40])
def test_group_hist_matches_jax_pallas(rng, M):
    B = 2
    mtfv = rng.integers(0, 258, (B, M)).astype(np.int32)
    n_mtf = np.array([M, 517], np.int32)
    exp = np.asarray(group_hist_pallas(jnp.asarray(mtfv), jnp.asarray(n_mtf),
                                       interpret=True))
    got = mk.group_hist(torch.from_numpy(mtfv), torch.from_numpy(n_mtf)).numpy()
    assert np.array_equal(got, exp)

