"""Port's pair sort (bzip2_tpu_torch.ops.sort_kernel) vs the JAX Pallas
sort_pairs in interpret mode.  Tolerance 0: every value is an integer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bzip2_tpu.ops.sort_pallas import sort_pairs as jax_sort_pairs
from bzip2_tpu_torch.ops import sort_kernel as sk

INF = 0x7FFFFFFF


def _pairs(rng, B, N):
    a = rng.integers(-(1 << 31), 1 << 31, (B, N), dtype=np.int64).astype(np.int32)
    b = ((rng.integers(0, 1 << 9, (B, N)).astype(np.int32) << 20)
         | np.arange(N, dtype=np.int32)[None])
    return a, b


def _port(a, b):
    sa, sb = sk.sort_pairs(torch.from_numpy(a), torch.from_numpy(b))
    return sa.numpy(), sb.numpy()


@pytest.mark.parametrize("B,N", [(2, 1024), (1, 4096)])
def test_sort_pairs_matches_jax(rng, B, N):
    a, b = _pairs(rng, B, N)
    ja, jb = jax_sort_pairs(jnp.asarray(a), jnp.asarray(b), interpret=True)
    pa, pb = _port(a, b)
    assert np.array_equal(pa, np.asarray(ja))
    assert np.array_equal(pb, np.asarray(jb))


def test_sort_pairs_inf_sentinels_match_jax(rng):
    # INF-keyed entries sink to the end, ordered by their b plane
    a = rng.integers(0, 100, (2, 1024)).astype(np.int32)
    a[:, 500:] = INF
    b = np.broadcast_to(np.arange(1024, dtype=np.int32)[::-1], (2, 1024)).copy()
    ja, jb = jax_sort_pairs(jnp.asarray(a), jnp.asarray(b), interpret=True)
    pa, pb = _port(a, b)
    assert np.array_equal(pa, np.asarray(ja))
    assert np.array_equal(pb, np.asarray(jb))
    assert np.all(pa[:, 500:] == INF)
    assert np.array_equal(pb[0, 500:], np.sort(b[0, 500:]))


def test_sort_pairs_equal_pairs_and_extremes(rng):
    # pairs equal in both halves (dead compaction slots) and int32 extremes
    B, N = 2, 256
    a = rng.choice(np.array([-(1 << 31), -1, 0, 1, INF], np.int32), (B, N))
    b = rng.choice(np.array([-(1 << 31), 0, 7, INF], np.int32), (B, N))
    pa, pb = _port(a, b)
    for r in range(B):
        order = np.lexsort((b[r], a[r]))
        assert np.array_equal(pa[r], a[r][order])
        assert np.array_equal(pb[r], b[r][order])


@pytest.mark.parametrize("N", [64, 100, 3000, (1 << 20) * 2])
def test_sort_pairs_rejects_bad_width(N):
    t = torch.zeros((1, N), dtype=torch.int32)
    with pytest.raises(ValueError):
        sk.sort_pairs(t, t)


@pytest.mark.parametrize("n", [1 << e for e in range(7, 21)])
def test_sort_pairs_launch_plan(n):
    # the wrapper's buffers against the kernel's launch order: the tile sort
    # writes k0, the merge rounds but the last write k1, k0, ... in turn, and
    # the last round reads the int64 scratch while it writes the planes
    rows = 2
    out, k0, k1 = sk.sort_buffers(rows, n, torch.device("cpu"))
    assert out.shape == (2, rows, n) and out.dtype == torch.int32
    rounds = sk.merge_rounds(n)
    if n <= sk.TILE:
        # one launch, the tile sort, writes the planes; no key buffer
        assert rounds == 0 and k0 is None and k1 is None
        return
    assert 1 << rounds == n // sk.TILE
    writes = [k0] + [(k1, k0)[r % 2] for r in range(rounds - 1)]
    scratch = writes[-1]
    assert scratch is not out
    assert scratch.shape == (rows, n) and scratch.dtype == torch.int64
    assert {id(k0), id(k1)} == {id(out), id(scratch)}
    # the planes' memory holds a (rows, n) row of 64-bit keys exactly
    assert out.numel() * out.element_size() == rows * n * 8
