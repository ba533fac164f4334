"""Port's group search, code assignment and bit packing vs the JAX
functions.  Tolerance 0: every output is an integer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bzip2_tpu.constants import MAX_ALPHA_SIZE as A
from bzip2_tpu.ops import bitpack as jbp
from bzip2_tpu.ops import groupsearch as jgs
from bzip2_tpu.ops import huffman as jhuff
from bzip2_tpu_torch.ops import bitpack as tbp
from bzip2_tpu_torch.ops import groupsearch as tgs
from bzip2_tpu_torch.ops import huffman as thuff


def _t(x):
    return torch.from_numpy(np.array(x))


def _hist(rng, B=2, G=40):
    """Zipf-like group histograms with counts summing to 50 per group."""
    hist = np.zeros((B, G, A), np.int32)
    for b in range(B):
        p = 1.0 / np.arange(1, 40) ** 1.2
        syms = rng.choice(39, (G, 50), p=p / p.sum())
        for g in range(G):
            np.add.at(hist[b, g], syms[g], 1)
    return hist


def test_n_groups_matches_jax():
    n_mtf = np.array([1, 199, 200, 599, 600, 1199, 1200, 2399, 2400, 900001],
                     np.int32)
    exp = np.asarray(jgs.n_groups_batched(jnp.asarray(n_mtf)))
    assert np.array_equal(tgs.n_groups_batched(_t(n_mtf)).numpy(), exp)


@pytest.mark.parametrize("seed", range(3))
def test_initial_tables_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B = 3
    alpha = rng.integers(3, A + 1, B).astype(np.int32)
    freq = np.zeros((B, A), np.int32)
    for b in range(B):
        freq[b, :alpha[b]] = rng.integers(0, 3000, alpha[b]) * (
            rng.random(alpha[b]) < 0.7)
    n_mtf = freq.sum(axis=1).astype(np.int32)
    n_groups = np.asarray(jgs.n_groups_batched(jnp.asarray(n_mtf)))
    exp = jgs.initial_tables_batched(jnp.asarray(freq), jnp.asarray(n_mtf),
                                     jnp.asarray(alpha), jnp.asarray(n_groups))
    got = tgs.initial_tables_batched(_t(freq), _t(n_mtf), _t(alpha),
                                     _t(n_groups))
    assert np.array_equal(got.numpy(), np.asarray(exp))


def _group_iter_both(hist, lens, invalid):
    js, jf = jgs.group_iter(jnp.asarray(hist).astype(jnp.bfloat16),
                            jnp.asarray(lens), jnp.asarray(invalid))
    ts, tf = tgs.group_iter(_t(hist).to(torch.float32), _t(lens), _t(invalid))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tf.numpy(), np.asarray(jf))
    return ts.numpy(), tf.numpy()


def test_group_iter_matches_jax(rng):
    hist = _hist(rng)
    lens = rng.integers(1, 18, (2, 6, A)).astype(np.int32)
    invalid = np.array([[False] * 4 + [True] * 2, [False] * 6])
    sel, freq = _group_iter_both(hist, lens, invalid)
    assert (sel[0] < 4).all()
    # frequencies are exact sums of the chosen groups' histograms
    assert freq.sum() == hist.sum()


def test_group_iter_tie_takes_first_minimum(rng):
    hist = _hist(rng, B=1, G=8)
    lens = np.full((1, 6, A), 17, np.int32)
    lens[0, 2] = 5          # tables 2 and 4 tie at the minimum
    lens[0, 4] = 5
    sel, _ = _group_iter_both(hist, lens, np.zeros((1, 6), bool))
    assert (sel == 2).all()


def test_group_iter_large_costs_exact(rng):
    # costs above 256 and frequencies in the thousands: a bf16 product
    # would round them
    G = 400
    hist = np.zeros((1, G, A), np.int32)
    hist[0, :, 0] = 50
    lens = np.full((1, 6, A), 17, np.int32)
    lens[0, 1, 0] = 16
    sel, freq = _group_iter_both(hist, lens, np.zeros((1, 6), bool))
    assert (sel == 1).all() and freq[0, 1, 0] == 50 * G


@pytest.mark.parametrize("tf32", [False, True])
def test_group_iter_keeps_callers_tf32_setting(rng, tf32):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        hist = _hist(rng, B=1, G=8)
        lens = rng.integers(1, 18, (1, 6, A)).astype(np.int32)
        _group_iter_both(hist, lens, np.zeros((1, 6), bool))
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_selector_mtf_matches_jax(rng):
    B, G = 2, 700
    sel = rng.integers(0, 6, (B, G)).astype(np.int32)
    sel[1, :300] = 3
    n_sel = np.array([G, 411], np.int32)
    exp = jgs.selector_mtf(jnp.asarray(sel), jnp.asarray(n_sel))
    got = tgs.selector_mtf(_t(sel), _t(n_sel))
    assert np.array_equal(got.numpy(), np.asarray(exp))


def test_assign_codes_matches_jax(rng):
    from bzip2_tpu import native
    if not native.available():
        pytest.skip("needs the native heap builder")
    L = 6
    alpha = rng.integers(3, A + 1, L).astype(np.int32)
    freq = rng.integers(0, 5000, (L, A)).astype(np.int32)
    lens = native.make_code_lengths_batch(freq, alpha)
    exp = jhuff.assign_codes_lanes(jnp.asarray(lens), jnp.asarray(alpha))
    got = thuff.assign_codes_lanes(_t(lens), _t(alpha))
    assert np.array_equal(got.numpy(), np.asarray(exp))


def test_pack_fields_matches_jax(rng):
    B, F = 3, 500
    lens = rng.integers(0, 33, (B, F)).astype(np.int32)
    lens[:, :4] = 32
    vals = (rng.integers(0, 1 << 32, (B, F), dtype=np.uint64)
            & ((np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1))
            ).astype(np.uint32)
    vals[:, 0] = 0xFFFFFFFF
    n_words = (int(lens.sum(axis=1).max()) + 31) // 32 + 2
    jw, jn = jbp.pack_fields(jnp.asarray(vals), jnp.asarray(lens), n_words)
    tw, tn = tbp.pack_fields(_t(vals.astype(np.int64)), _t(lens), n_words)
    assert np.array_equal(tw.numpy().astype(np.uint32), np.asarray(jw))
    assert np.array_equal(tn.numpy(), np.asarray(jn))
