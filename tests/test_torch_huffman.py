"""The fused encoder's device pieces against JAX on the CPU: the Huffman
code lengths of many lanes (``make_code_lengths_lanes``, plain version),
the whole group search and the fused block encoder.  Inputs come from numpy
with a seed; every comparison is exact (integers)."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from bzip2_tpu import engine as jeng
from bzip2_tpu.constants import MAX_ALPHA_SIZE as A
from bzip2_tpu.ops import groupsearch as jgs
from bzip2_tpu.ops import huffman as jhuff
from bzip2_tpu.ops.bwt import bwt_batched as jbwt
from bzip2_tpu.ops.mtf import mtf_rle2_batched as jmtf
from bzip2_tpu_torch import _build
from bzip2_tpu_torch import engine as teng
from bzip2_tpu_torch import native as tnative
from bzip2_tpu_torch.ops import groupsearch as tgs
from bzip2_tpu_torch.ops import huffman as thuff

_jax_lens = jax.jit(jhuff.make_code_lengths_lanes)


def _t(x):
    return torch.from_numpy(np.array(x))


def _lanes(kind: str, rng, L=12):
    """The inputs of tests/test_ops.py::test_huffman_lanes_vs_oracle:
    uniform, heavy ties, and the in-domain skew that halves and retries."""
    freqs = np.zeros((L, A), np.int32)
    if kind == "skew":
        alphas = rng.integers(5, 25, L).astype(np.int32)
        for i in range(L):
            a = int(alphas[i])
            freqs[i, :a] = (2 ** np.minimum(np.arange(a), 19)).astype(np.int32)
    else:
        alphas = rng.integers(2, A + 1, L).astype(np.int32)
        hi = 1000 if kind == "uniform" else 4
        for i in range(L):
            freqs[i, :alphas[i]] = rng.integers(0, hi, alphas[i])
    return freqs, alphas


def _both(freqs, alphas):
    exp = np.asarray(_jax_lens(jnp.asarray(freqs), jnp.asarray(alphas)))
    got = thuff.make_code_lengths_lanes(_t(freqs), _t(alphas))
    assert got.dtype == torch.int32 and got.shape == (freqs.shape[0], A)
    assert np.array_equal(got.numpy(), exp)
    return got.numpy()


@pytest.mark.parametrize("kind", ["uniform", "ties", "skew"])
def test_code_lengths_match_jax(kind):
    freqs, alphas = _lanes(kind, np.random.default_rng(0xB21))
    got = _both(freqs, alphas)
    leaf = np.arange(A)[None, :] < alphas[:, None]
    assert np.where(leaf, got, 0).max() <= 17
    if kind == "skew":
        # without the retry these lanes would exceed 17
        assert np.where(leaf, got, 0).max() == 17


@pytest.mark.parametrize("kind", ["uniform", "ties", "skew"])
def test_code_lengths_match_native_heap(kind):
    """The leaves against the host's exact heap (the hybrid encoder's)."""
    freqs, alphas = _lanes(kind, np.random.default_rng(7))
    got = thuff.make_code_lengths_lanes_plain(_t(freqs), _t(alphas)).numpy()
    nat = tnative.make_code_lengths_batch(freqs, alphas)
    leaf = np.arange(A)[None, :] < alphas[:, None]
    assert np.array_equal(np.where(leaf, got, 0), nat)


def test_code_lengths_edge_lanes():
    """alpha = 2, alpha = 258, all-zero frequencies (weight 1 each), one
    dominant symbol, and a lane that reaches the retry path at full width."""
    rng = np.random.default_rng(3)
    freqs = np.zeros((6, A), np.int32)
    alphas = np.array([2, A, A, 2, A, 40], np.int32)
    freqs[0, :2] = [5, 0]
    freqs[1] = rng.integers(0, 50_000, A)
    freqs[3, :2] = [0, 0]
    freqs[4, 0] = 900_000
    freqs[4, 1:] = rng.integers(0, 3, A - 1)
    # Fibonacci frequencies make a deep chain (sum 3.5M: below 2^23,
    # as a block's is, so the keys fit int32)
    fib = [1, 1]
    while len(fib) < 31:
        fib.append(fib[-1] + fib[-2])
    freqs[5, :31] = fib
    got = _both(freqs, alphas)
    assert got[0, :2].tolist() == [1, 1] and got[3, :2].tolist() == [1, 1]
    assert (got[2] == 8).sum() == 254 and (got[2] == 9).sum() == 4
    first, too_long = thuff._attempt(
        torch.from_numpy(np.concatenate([[0], freqs[5].clip(1) << 8])
                         .astype(np.int32))[None], _t(alphas[5:6]))
    assert bool(too_long[0]) and first[0, :40].max() > 17
    assert got[5, :40].max() <= 17


def test_code_lengths_wrapper_checks_and_counts():
    freqs, alphas = _lanes("ties", np.random.default_rng(1), L=3)
    _build.reset_launches()
    thuff.make_code_lengths_lanes(_t(freqs), _t(alphas))
    assert thuff.KERNEL.launches == 0           # a CPU tensor: plain version
    with pytest.raises(ValueError, match="shapes"):
        thuff.make_code_lengths_lanes(_t(freqs[:, :100]), _t(alphas))
    with pytest.raises(ValueError, match="shapes"):
        thuff.make_code_lengths_lanes(_t(freqs), _t(alphas[:2]))
    empty = thuff.make_code_lengths_lanes(torch.zeros((0, A), dtype=torch.int32),
                                          torch.zeros(0, dtype=torch.int32))
    assert empty.shape == (0, A)


# ------------------------------------------------------- group search --

@pytest.fixture(scope="module")
def graft_mtf():
    """The graft example batch through JAX's BWT and MTF+RLE2 (numpy)."""
    blocks, ns, uses, crcs = graft._example_batch()

    def pre(b, n, u):
        last, orig_ptr, _ = jbwt(b, n, use_pallas=False)
        return jmtf(last, n, u, use_pallas=False)

    mtfv, n_mtf, n_in_use = jax.jit(pre)(jnp.asarray(blocks), jnp.asarray(ns),
                                         jnp.asarray(uses))
    return (blocks, ns, uses, crcs), tuple(np.asarray(x) for x in
                                           (mtfv, n_mtf, n_in_use))


def _random_mtf(seed: int):
    """A seeded batch of MTF/RLE2 streams: skewed symbols below each
    block's alpha, EOB last, lengths across the n_groups thresholds."""
    rng = np.random.default_rng(seed)
    n_mtf = np.array([150, 700, 3001], np.int32)
    n_in_use = np.array([3, 60, 255], np.int32)
    mtfv = np.zeros((3, 3200), np.int32)
    for b in range(3):
        a = int(n_in_use[b]) + 2
        p = 1.0 / np.arange(1, a) ** 1.3
        mtfv[b, :n_mtf[b] - 1] = rng.choice(a - 1, n_mtf[b] - 1, p=p / p.sum())
        mtfv[b, n_mtf[b] - 1] = a - 1
    return mtfv, n_mtf, n_in_use


def _group_search_both(mtfv, n_mtf, n_in_use):
    exp = jax.jit(lambda m, n, k: jgs.group_search_batched(
        m, n, k, use_pallas=False))(jnp.asarray(mtfv), jnp.asarray(n_mtf),
                                    jnp.asarray(n_in_use))
    got = tgs.group_search_batched(_t(mtfv), _t(n_mtf), _t(n_in_use))
    names = ("n_groups", "n_selectors", "selectors", "sel_mtf", "lens",
             "codes")
    for g, e, name in zip(got, exp, names):
        assert np.array_equal(g.numpy(), np.asarray(e)), name
    return got


def test_group_search_matches_jax_graft_example(graft_mtf):
    _, (mtfv, n_mtf, n_in_use) = graft_mtf
    got = _group_search_both(mtfv, n_mtf, n_in_use)
    assert got[4].dtype == torch.int32 and got[5].dtype == torch.int32


def test_group_search_matches_jax_random_batch():
    got = _group_search_both(*_random_mtf(11))
    assert got[0].tolist() == [2, 4, 6]


def test_encode_batch_device_matches_jax(graft_mtf):
    (blocks, ns, uses, crcs), _ = graft_mtf
    n_words = jeng._words_for(blocks.shape[1])
    jw, jn = jax.jit(lambda *a: jeng.encode_batch_device(
        *a, n_words=n_words, use_pallas=False))(
        jnp.asarray(blocks), jnp.asarray(ns), jnp.asarray(uses),
        jnp.asarray(crcs))
    args = teng.stage_from_numpy((blocks, ns, uses, crcs), "cpu")
    tw, tn = teng.encode_batch_device(*args, n_words)
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    assert np.array_equal(tw.numpy().astype(np.uint32), np.asarray(jw))


def test_group_iter_threads_keep_callers_tf32(rng):
    """Two threads in group_iter at once, TF32 set by the caller: the flag
    comes back as the caller left it, and both threads' products equal a
    single-threaded run."""
    B, G = 2, 30
    hist = np.zeros((B, G, A), np.float32)
    for b in range(B):
        for g in range(G):
            np.add.at(hist[b, g], rng.integers(0, 40, 50), 1)
    lens = _t(rng.integers(1, 18, (B, 6, A)).astype(np.int32))
    invalid = torch.zeros((B, 6), dtype=torch.bool)
    hist_t = _t(hist)
    ref = tgs.group_iter(hist_t, lens, invalid)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        outs, errors = [], []

        def work():
            try:
                for _ in range(20):
                    outs.append(tgs.group_iter(hist_t, lens, invalid))
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=work) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors and len(outs) == 40
        assert torch.backends.cuda.matmul.allow_tf32 is True
        for s, f in outs:
            assert torch.equal(s, ref[0]) and torch.equal(f, ref[1])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
