"""Inputs of the decoder's symbol-scan and MTF^-1 kernels, shared by the
CPU tests (tests/test_torch_decode_kernels.py), the card tests
(tests/test_torch_cuda.py) and chip_smoke.py's phase 3.  Imports neither
JAX nor the JAX package; every case is made from a numpy seed or a
stream that the standard library's bz2 writes."""
import bz2 as stdlib_bz2

import numpy as np


def parsed(data: bytes, level: int) -> tuple:
    """The stream of ``data`` at ``level`` and its blocks, light-parsed."""
    from bzip2_tpu_torch import native
    buf = np.frombuffer(stdlib_bz2.compress(data, level), np.uint8)
    pbs, pos = [], 32
    while True:
        pb, _rc = native.parse_block(buf, pos, level)
        if pb is None:
            break
        pbs.append(pb)
        pos = pb.end_bit
    return buf, pbs


def mtf_rows(rng, M: int, K: int) -> tuple:
    """Synthetic MTF^-1 rows: n_used from 1 to 256; RUNA/RUNB runs; EOB;
    symbols at the top of the used list; garbage past EOB, negative and
    the pad's 10,000; n_mtf at 0, 1, the chunk edge K and M (MTF^-1 reads
    every position, whatever n_mtf says).  Returns (syms, used_list,
    n_used, n_mtf) as numpy int32 arrays."""
    n_used = np.array([1, 2, 3, 17, 100, 255, 256, 256], np.int32)
    B = n_used.size
    syms = np.empty((B, M), np.int32)
    for b, nu in enumerate(n_used):
        s = rng.integers(0, nu + 2, M)
        runs = rng.random(M) < 0.3
        s[runs] = rng.integers(0, 2, runs.sum())
        s[rng.random(M) < 0.1] = nu                     # the list's top
        syms[b] = s
    syms[6, -50:] = rng.integers(n_used[6] + 2, 400, 50)  # past EOB
    syms[7, ::97] = 257                                 # r clamps to 255
    syms[7, 1::89] = -3
    syms[5, 2::101] = 10_000
    used = np.zeros((B, 256), np.int32)
    for b, nu in enumerate(n_used):
        used[b, :nu] = np.sort(rng.choice(256, nu, replace=False))
    n_mtf = np.array([0, 1, K, K + 1, M, M - 1, M, 2], np.int32)
    return syms, used, n_used, n_mtf


def wrap_case(rows: bool) -> tuple:
    """Symbol-scan inputs whose offsets sit in the buffer's last three
    bytes (and past it, and negative): random words, flat (WT,) or rows
    (B, WT), and Kraft-complete code lengths with long codes.  Returns
    (words, goff, gsel, gvalid, lens6, alpha) as numpy arrays."""
    from bzip2_tpu_torch.oracle.huffman import make_code_lengths
    rng = np.random.default_rng(41)
    B, WT, G = 3, 7, 16
    lens6 = np.zeros((B, 6, 258), np.int32)
    alpha = np.array([258, 40, 9], np.int32)
    for b in range(B):
        for t in range(6):
            freq = (rng.pareto(0.6, alpha[b]) * 10).astype(np.int64) + 1
            lens6[b, t, : alpha[b]] = make_code_lengths(freq, alpha[b], 20)
    words = rng.integers(0, 1 << 32, (B, WT) if rows else (WT,),
                         dtype=np.uint64).astype(np.int64)
    nbits = 32 * WT
    goff = rng.integers(nbits - 24, nbits, (B, G)).astype(np.int32)
    # the last bit; byte 4 WT - 3; clamped to the last byte and to byte 0
    goff[:, :5] = [nbits - 1, nbits - 24, nbits + 100, -5, 0]
    gsel = rng.integers(0, 6, (B, G)).astype(np.int32)
    gvalid = rng.random((B, G)) < 0.7
    gvalid[:, :2] = True
    return words, goff, gsel, gvalid, lens6, alpha


def mtf_edge_rows(rng, M: int) -> tuple:
    """MTF^-1 rows at the edges of the kernel's movers-only walk: every
    symbol a mover (n_used 256, r up to 255); no mover at all (RUNA/RUNB
    only, which read the front); n_used 1, where no symbol can move and
    every non-RUNA/RUNB symbol reads the list away from the front; n_used
    256 with r = 255 and r = 0 interleaved.  Returns (syms, used_list,
    n_used, n_mtf) as numpy int32 arrays."""
    n_used = np.array([256, 40, 1, 256], np.int32)
    syms = np.stack([rng.integers(2, 257, M),
                     rng.integers(0, 2, M),
                     rng.integers(0, 5, M),
                     np.where(rng.random(M) < 0.5, 256,
                              rng.integers(0, 2, M))]).astype(np.int32)
    used = np.zeros((4, 256), np.int32)
    for b, nu in enumerate(n_used):
        used[b, :nu] = rng.permutation(256)[:nu]
    return syms, used, n_used, np.full(4, M, np.int32)


def span_case(rows: bool, G: int = 300, seed: int = 43) -> tuple:
    """Symbol-scan inputs at the edges of the staged kernel (a CTA per 256
    groups of one block): G groups a block, not a multiple of 256; valid
    groups at increasing offsets, each block's groups selecting a different
    subset of its six tables (block 0 one table, block 1 two, block 2 all
    six); invalid lanes, a sixth of them, at offsets outside any staged
    span (negative, past the buffer, in the last three bytes, so the
    window wraps, in another block's groups).  Flat (WT,) words or rows
    (3, WT).  Returns (words, goff, gsel, gvalid, lens6, alpha) as numpy
    arrays."""
    from bzip2_tpu_torch.oracle.huffman import make_code_lengths
    rng = np.random.default_rng(seed)
    B = 3
    alpha = np.array([258, 60, 20], np.int32)
    lens6 = np.zeros((B, 6, 258), np.int32)
    for b in range(B):
        for t in range(6):
            freq = (rng.pareto(0.8, alpha[b]) * 10).astype(np.int64) + 1
            lens6[b, t, : alpha[b]] = make_code_lengths(freq, alpha[b], 20)
    steps = rng.integers(40, 400, (B, G))
    starts = np.cumsum(steps, axis=1) - steps[:, :1]
    span = int(starts[:, -1].max()) + 2000
    WT = (span if rows else B * span) // 32 + 2
    nbits = 32 * WT
    goff = (starts + (0 if rows else np.arange(B)[:, None] * span)).astype(
        np.int64)
    gsel = np.stack([np.zeros(G, np.int64), rng.choice([2, 5], G),
                     rng.integers(0, 6, G)]).astype(np.int32)
    gvalid = rng.random((B, G)) >= 1 / 6
    bad = ~gvalid
    far = rng.choice([-7, nbits - 1, nbits - 20, nbits + 64, 0, nbits // 2],
                     (B, G))
    goff = np.where(bad, far, goff).astype(np.int32)
    words = rng.integers(0, 1 << 32, (B, WT) if rows else (WT,),
                         dtype=np.uint64).astype(np.int64)
    return words, goff, gsel, gvalid, lens6, alpha
