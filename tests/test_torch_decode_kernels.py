"""The plain versions of the decoder's symbol-scan and MTF^-1 kernels
(bzip2_tpu_torch/ops/symbol_kernel.py, ops/mtf_inverse_kernel.py) against
bzip2_tpu/ops/decode.py, on the CPU, and the wrappers' dispatch and
binding.  Inputs are real -1 and -9 batches parsed by the port's light
parse, or made from a numpy seed; every comparison is exact int32
equality, at every lane and position (valid or not)."""
import ctypes as ct
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bzip2_tpu.ops import decode as JD
from bzip2_tpu_torch import _build
from bzip2_tpu_torch.decoder import batch_inputs
from bzip2_tpu_torch.ops import decode as TD
from bzip2_tpu_torch.ops import mtf_inverse_kernel as mik
from bzip2_tpu_torch.ops import symbol_kernel as sym_k
from torch_decode_cases import (mtf_edge_rows, mtf_rows, parsed,
                                span_case, wrap_case)


def _t(a):
    return torch.from_numpy(np.require(np.asarray(a), requirements=["C", "W"]))


def _eq(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    assert np.array_equal(got.astype(np.int64), exp.astype(np.int64))


def _batch(data: bytes, level: int, rows: bool) -> tuple:
    """The decoder's inputs of one batch of every block of the stream."""
    buf, pbs = parsed(data, level)
    assert len(pbs) >= 2
    return batch_inputs(buf, pbs, rows=rows)


@pytest.fixture(scope="module")
def batches(golden):
    """The -1 batch (two blocks of 180 KB of golden text) and the -9 batch
    (1 MB of the golden mix: a 900k block and a short one) that
    tests/test_torch_decode.py builds, in flat and row addressing."""
    one = golden[2][0][:180_000]
    nine = ((golden[1][0] + golden[2][0] + golden[3][0]) * 3)[:1_000_000]
    return {(lv, rows): _batch(d, lv, rows) for lv, d in ((1, one), (9, nine))
            for rows in (False, True)}


def _jax_tables(lens6, head):
    return tuple(np.asarray(a) for a in JD.build_tables(
        jnp.asarray(lens6), jnp.asarray(head[0])))


def _scan_both(words, goff, gsel, gvalid, tables):
    """The port's plain scan and the JAX package's decode on one input."""
    got = sym_k.symbol_scan_plain(_t(words), _t(goff), _t(gsel), _t(gvalid),
                                  *(_t(a) for a in tables))
    jfn = JD.decode_symbols_rows if words.ndim == 2 else JD.decode_symbols
    exp = jfn(jnp.asarray(words.astype(np.uint32)), jnp.asarray(goff),
              jnp.asarray(gsel), jnp.asarray(gvalid),
              *(jnp.asarray(a) for a in tables))
    return got, np.asarray(exp)


# ------------------------------------------------------ symbol scan --

@pytest.mark.parametrize("rows", [False, True], ids=["flat", "rows"])
@pytest.mark.parametrize("level", [1, 9])
def test_symbol_scan_plain_matches_jax(batches, level, rows):
    words, goff, gsel, gvalid, lens6, _, head = batches[(level, rows)]
    assert not gvalid.all()            # padded groups of the shorter block
    got, exp = _scan_both(words, goff, gsel, gvalid, _jax_tables(lens6, head))
    assert got.dtype == torch.int32
    _eq(got, exp)


@pytest.mark.parametrize("rows", [False, True], ids=["flat", "rows"])
def test_symbol_scan_wraps_at_the_buffer_end(rows):
    """Offsets in the last three bytes of the buffer (and past it, and
    negative) read windows that wrap to the buffer's first bytes (the
    batch's, or the row's), valid lanes and invalid ones alike."""
    words, goff, gsel, gvalid, lens6, alpha = wrap_case(rows)
    tables = _jax_tables(lens6, alpha[None])
    got, exp = _scan_both(words, goff, gsel, gvalid, tables)
    _eq(got, exp)
    # the wrap itself: lane (b, 1) starts at byte 4 WT - 3, so its first
    # window is that byte, the two after it and the buffer's first byte
    lut1 = tables[0]
    for b in range(goff.shape[0]):
        w = words[b] if rows else words
        byts = w.astype(">u4").view(np.uint8)
        win = int.from_bytes(bytes(byts[-3:]) + bytes(byts[:1]), "big")
        e1 = int(lut1[b, gsel[b, 1], win >> 20])
        if e1 > 0:
            assert int(got[b, 50]) == e1 >> 5


@pytest.mark.parametrize("rows", [False, True], ids=["flat", "rows"])
def test_symbol_scan_plain_matches_jax_span_case(rows):
    """The staged kernel's edge inputs (tests/test_torch_cuda.py holds the
    kernel to the plain scan on them): G not a multiple of a CTA's 256
    groups, per-block table subsets, invalid lanes outside every span."""
    words, goff, gsel, gvalid, lens6, alpha = span_case(rows)
    assert goff.shape[1] % 256 and not gvalid.all()
    assert [set(np.unique(r)) for r in gsel] == [{0}, {2, 5}, set(range(6))]
    got, exp = _scan_both(words, goff, gsel, gvalid,
                          _jax_tables(lens6, alpha[None]))
    _eq(got, exp)


def _lens_batch(rng, B, max_len):
    """B blocks of six random Kraft-complete code-length tables with codes
    up to max_len bits."""
    from bzip2_tpu_torch.oracle.huffman import make_code_lengths
    alpha = rng.integers(3, 259, B).astype(np.int32)
    lens6 = np.zeros((B, 6, 258), np.int32)
    for b in range(B):
        for t in range(6):
            freq = (rng.pareto(0.5, alpha[b]) * 50).astype(np.int64) + 1
            lens6[b, t, : alpha[b]] = make_code_lengths(freq, alpha[b],
                                                        max_len)
    return lens6, alpha


@pytest.mark.parametrize("case", ["level1", "level9", "random20"])
def test_build_tables_entries_fit_15_bits(batches, case):
    """The symbol scan stages lut1 as uint16: every lut1 and lut2 entry
    (len | sym << 5, 0 an escape) is in [0, 2^15), on the recorded batches'
    tables and on random code lengths up to 20 bits."""
    if case == "random20":
        lens6, alpha = _lens_batch(np.random.default_rng(19), 6, 20)
        assert lens6.max() > 12               # escapes to lut2 exist
    else:
        _, _, _, _, lens6, _, head = batches[(int(case[5:]), False)]
        alpha = head[0]
    for t in TD.build_tables(_t(lens6), _t(alpha))[:2]:
        assert t.dtype == torch.int32
        assert int(t.min()) >= 0 and int(t.max()) < 1 << 15


def test_byte_windows_wrap_per_row():
    words = np.array([[0x01020304, 0x05060708], [0x11121314, 0x15161718]],
                     np.int64)
    wb = sym_k._byte_windows(_t(words)).numpy()
    assert wb[0, 5] == 0x06070801 and wb[0, 7] == 0x08010203
    assert wb[1, 6] == 0x17181112
    _eq(wb, JD._byte_windows(jnp.asarray(words.astype(np.uint32))))


# ------------------------------------------------------------ MTF^-1 --

@pytest.mark.parametrize("level", [1, 9])
def test_mtf_inverse_plain_matches_jax_real(batches, level):
    """Every position of a real batch's symbols, the invalid lanes'
    garbage included, through the plain MTF^-1 and the JAX package's."""
    words, goff, gsel, gvalid, lens6, used_list, head = batches[(level, False)]
    tables = _jax_tables(lens6, head)
    syms = np.asarray(JD.decode_symbols(
        jnp.asarray(words.astype(np.uint32)), jnp.asarray(goff),
        jnp.asarray(gsel), jnp.asarray(gvalid),
        *(jnp.asarray(a) for a in tables)))
    args = (syms, used_list, head[1], head[2])
    exp = JD.mtf_inverse(*(jnp.asarray(a) for a in args))
    got = mik.mtf_inverse_plain(*(_t(a) for a in args))
    assert got.dtype == torch.int32
    _eq(got, exp)


def _mtf_sequential(syms, used, n_used):
    """Independent reference: one sequential MTF of the whole row under
    the decoder's per-symbol rule."""
    out = np.empty_like(syms)
    for b in range(syms.shape[0]):
        lst = list(used[b])
        for i, s in enumerate(syms[b]):
            r = min(max(int(s) - 1, 0), 255)
            v = lst[r]
            out[b, i] = v
            if 2 <= s <= n_used[b]:
                del lst[r]
                lst.insert(0, v)
    return out


@pytest.mark.parametrize("n_chunks", [1, 16, 512])
def test_mtf_inverse_plain_matches_jax_synthetic(n_chunks):
    M = 61 * 50
    args = mtf_rows(np.random.default_rng(23), M, -(-M // n_chunks))
    exp = np.asarray(JD.mtf_inverse(*(jnp.asarray(a) for a in args),
                                    n_chunks=n_chunks))
    got = mik.mtf_inverse_plain(*(_t(a) for a in args), n_chunks=n_chunks)
    _eq(got, exp)
    _eq(got, _mtf_sequential(*args[:3]))


# ------------------------------------------------- dispatch and binding --

def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_wrappers_run_plain_on_cpu(batches, monkeypatch):
    """ops/decode's decode_symbols, decode_symbols_rows and mtf_inverse run
    the plain versions on CPU tensors and launch no kernel."""
    scans = _spy(monkeypatch, sym_k, "symbol_scan_plain")
    mtfs = _spy(monkeypatch, mik, "mtf_inverse_plain")
    _build.reset_launches()
    for rows in (False, True):
        words, goff, gsel, gvalid, lens6, used_list, head = \
            batches[(1, rows)]
        fn = TD.decode_symbols_rows if rows else TD.decode_symbols
        tables = TD.build_tables(_t(lens6), _t(head[0]))
        syms = fn(_t(words), _t(goff), _t(gsel), _t(gvalid), *tables)
        vals = TD.mtf_inverse(syms, _t(used_list), _t(head[1]),
                              _t(head[2]))
        assert vals.shape == syms.shape and vals.dtype == torch.int32
    assert scans == ["symbol_scan_plain"] * 2
    assert mtfs == ["mtf_inverse_plain"] * 2
    assert _build.KERNELS["symbol_scan"].launches == 0
    assert _build.KERNELS["mtf_inverse"].launches == 0


def test_wrappers_refuse_non_cpu_tensors_without_plain(monkeypatch):
    """A tensor off the CPU never reaches the plain loop: the wrapper goes
    to its kernel and raises on what the kernel does not take."""
    scans = _spy(monkeypatch, sym_k, "symbol_scan_plain")
    mtfs = _spy(monkeypatch, mik, "mtf_inverse_plain")
    meta = torch.device("meta")
    z = lambda *s, dt=torch.int32: torch.zeros(s, dtype=dt, device=meta)  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        TD.decode_symbols(z(9, dt=torch.int64), z(2, 3), z(2, 3),
                          z(2, 3, dt=torch.bool), z(2, 6, 4096),
                          z(2, 6, 132 * 256), z(2, 6))
    with pytest.raises(ValueError, match="CUDA"):
        TD.mtf_inverse(z(2, 150), z(2, 256), z(2), z(2))
    assert scans == [] and mtfs == []
    with pytest.raises(ValueError, match="words"):
        TD.decode_symbols_rows(z(9, dt=torch.int64), z(2, 3), z(2, 3),
                               z(2, 3, dt=torch.bool), z(2, 6, 4096),
                               z(2, 6, 132 * 256), z(2, 6))


def test_new_sources_built_and_registered():
    srcs = [os.path.basename(s) for s in _build._sources()]
    assert {"mtf_inverse.cu", "symbol_scan.cu"} <= set(srcs)
    for name, mod_kernel in (("mtf_inverse", mik.KERNEL),
                             ("symbol_scan", sym_k.SCAN)):
        assert _build.KERNELS[name] is mod_kernel
        assert mod_kernel.launches >= 0
    _build.reset_launches()
    assert _build.KERNELS["mtf_inverse"].launches == 0
    assert _build.KERNELS["symbol_scan"].launches == 0


def _c_signatures() -> dict:
    """Each C entry point of csrc/*.cu: its parameters as 'ptr', 'i32' or
    'i64'."""
    sigs = {}
    for src in _build._sources():
        text = open(src).read()
        for name, params in re.findall(r"BZ2T_API int (\w+)\(([^)]*)\)", text):
            kinds = []
            for p in params.split(","):
                p = " ".join(p.split())
                kinds.append("ptr" if "*" in p else "i64" if "long long" in p
                             else "i32")
            sigs[name] = kinds
    return sigs


@pytest.mark.parametrize("name", ["sort_pairs", "mtf_tile_last", "mtf_rank",
                                  "group_hist", "ibwt_walk", "huffman_lengths",
                                  "symbol_scan", "mtf_inverse"])
def test_kernel_argtypes_match_c_signature(name):
    """ctypes passes each argument as its argtype says: a pointer or a
    64-bit count given as a 32-bit int would be cut.  (test_torch_cuda,
    imported above, imports every kernel's module.)"""
    k = _build.KERNELS[name]
    kinds = ["ptr" if a is ct.c_void_p else f"i{8 * ct.sizeof(a)}"
             for a in k.argtypes]
    assert _c_signatures()[k.symbol] == kinds


# ------------------------------------------------- the card's chunking --

@pytest.mark.parametrize("M", [1, 2, 50, 255, 256, 3050, 100_050, 557_150,
                               900_050])
def test_chunks_for_covers_every_row(M):
    """For 1..95 rows, chunks_for's C: 1 <= C <= M, K = ceil(M / C) symbols
    a chunk, no chunk empty ((C - 1) K < M <= C K), no more warps than the
    card's slots unless one chunk a row, the same on every call; super_for
    picks ceil(sqrt(C))."""
    for B in range(1, 96):
        C = mik.chunks_for(B, M)
        assert C == mik.chunks_for(B, M)
        K = -(-M // C)
        assert 1 <= C <= M and (C - 1) * K < M <= C * K
        assert C == 1 or B * (C - 1) < mik.CARD_WARPS
        assert C == 1 or K >= mik.MIN_CHUNK
        W = mik.super_for(C)
        assert W * W >= C > (W - 1) * (W - 1)


@pytest.mark.parametrize("case", ["level1", "level9", "rows", "edges"])
def test_mtf_inverse_plain_at_card_chunks_matches_jax(batches, case):
    """Chunk independence on the CPU: the plain MTF^-1 at the chunk count
    the CUDA path takes (chunks_for) equals the JAX package's at its
    default 512 chunks, on the recorded batches and on synthetic rows."""
    rng = np.random.default_rng(29)
    if case.startswith("level"):
        words, goff, gsel, gvalid, lens6, used_list, head = batches[
            (int(case[5:]), False)]
        syms = np.asarray(JD.decode_symbols(
            jnp.asarray(words.astype(np.uint32)), jnp.asarray(goff),
            jnp.asarray(gsel), jnp.asarray(gvalid),
            *(jnp.asarray(a) for a in _jax_tables(lens6, head))))
        args = (syms, used_list, head[1], head[2])
    elif case == "rows":
        args = mtf_rows(rng, 20_050, 40)
    else:
        args = mtf_edge_rows(rng, 6_100)
    C = mik.chunks_for(*args[0].shape)
    assert C != mik.MTF_CHUNKS
    got = mik.mtf_inverse_plain(*(_t(a) for a in args), n_chunks=C)
    _eq(got, JD.mtf_inverse(*(jnp.asarray(a) for a in args)))


def test_mtf_edge_rows_plain_matches_sequential():
    """The kernel's edge rows (all movers, none, n_used 1, r = 255) through
    the plain MTF^-1 at 1 and 16 chunks against the sequential MTF."""
    args = mtf_edge_rows(np.random.default_rng(31), 1_030)
    exp = _mtf_sequential(*args[:3])
    for C in (1, 16):
        _eq(mik.mtf_inverse_plain(*(_t(a) for a in args), n_chunks=C), exp)


def test_mtf_inverse_default_chunks_on_cpu(monkeypatch):
    """On the CPU, n_chunks None takes MTF_CHUNKS, as JAX does; a count
    given is passed on."""
    seen = []
    real = mik.mtf_inverse_plain

    def spy(*a):
        seen.append(a[4])
        return real(*a)

    monkeypatch.setattr(mik, "mtf_inverse_plain", spy)
    args = [_t(a) for a in mtf_rows(np.random.default_rng(3), 300, 10)]
    mik.mtf_inverse(*args)
    mik.mtf_inverse(*args, n_chunks=7)
    assert seen == [mik.MTF_CHUNKS, 7]
    with pytest.raises(ValueError):
        mik.mtf_inverse(*args, n_chunks=0)
