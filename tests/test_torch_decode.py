"""The port's decode ops (bzip2_tpu_torch/ops/decode.py) against their JAX
counterparts in bzip2_tpu/ops/decode.py, on the CPU.  Inputs are real
streams parsed by the native light parse, or made from a numpy seed; every
comparison is exact (integer outputs, tolerance 0)."""
import bz2 as stdlib_bz2
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bzip2_tpu import crc as hostcrc
from bzip2_tpu import native, rle1
from bzip2_tpu.oracle import bwt as obwt
from bzip2_tpu.ops import decode as JD
from bzip2_tpu_torch.ops import decode as TD
from bzip2_tpu_torch.ops import ibwt_kernel as ik


def _t(a):
    return torch.from_numpy(np.require(np.asarray(a), requirements=["C", "W"]))


def _eq(got, exp):
    assert np.array_equal(np.asarray(got), np.asarray(exp))


def _parse(comp: bytes, level: int) -> tuple:
    """Every block of a one-member stream, by the native light parse."""
    buf = np.frombuffer(comp, np.uint8)
    pbs, pos = [], 32
    while True:
        pb, _rc = native.parse_block(buf, pos, level)
        if pb is None:
            break
        pbs.append(pb)
        pos = pb.end_bit
    assert pbs, "fixture produced no blocks"
    return buf, pbs


def _inputs(buf, pbs) -> dict:
    """The decoder's per-batch numpy inputs (the flat word buffer starts at
    byte 0, so group offsets are absolute)."""
    B = len(pbs)
    G = max(pb.n_groups_used for pb in pbs)
    wt = buf.size // 4 + 2
    wb = np.zeros(wt * 4, np.uint8)
    wb[: buf.size] = buf
    d = {"words": wb.view(">u4").astype(np.uint32),
         "goff": np.zeros((B, G), np.int32), "gsel": np.zeros((B, G), np.int32),
         "gvalid": np.zeros((B, G), bool),
         "lens6": np.stack([pb.lens for pb in pbs]).astype(np.int32),
         "alpha": np.array([pb.n_used + 2 for pb in pbs], np.int32),
         "used_list": np.zeros((B, 256), np.int32),
         "n_used": np.array([pb.n_used for pb in pbs], np.int32),
         "n_mtf": np.array([pb.n_mtf for pb in pbs], np.int32),
         "orig": np.array([pb.orig_ptr for pb in pbs], np.int32)}
    for i, pb in enumerate(pbs):
        g = pb.n_groups_used
        d["goff"][i, :g] = pb.group_offsets
        d["gsel"][i, :g] = pb.selectors[:g]
        d["gvalid"][i, :g] = True
        ul = np.flatnonzero(pb.used)
        d["used_list"][i, : ul.size] = ul
    return d


@pytest.fixture(scope="module")
def level1(golden):
    """Two -1 blocks of golden text, parsed, with the torch stages run."""
    data = golden[2][0][:180_000]
    d = _inputs(*_parse(stdlib_bz2.compress(data, 1), 1))
    lut = TD.build_tables(_t(d["lens6"]), _t(d["alpha"]))
    syms = TD.decode_symbols(_t(d["words"].astype(np.int64)), _t(d["goff"]),
                             _t(d["gsel"]), _t(d["gvalid"]), *lut)
    vals = TD.mtf_inverse(syms, _t(d["used_list"]), _t(d["n_used"]),
                          _t(d["n_mtf"]))
    last, n_out = TD.rle2_expand(syms, vals, _t(d["n_used"]), _t(d["n_mtf"]),
                                 100_000)
    return dict(d, data=data, syms=syms, vals=vals, last=last, n_out=n_out)


# ------------------------------------------------------------- tables --

@pytest.mark.parametrize("level", [1, 9])
def test_build_tables_matches_jax(golden, level):
    data = ((golden[1][0] + golden[2][0] + golden[3][0]) * 3)[:1_000_000]
    d = _inputs(*_parse(stdlib_bz2.compress(data, level), level))
    exp = JD.build_tables(jnp.asarray(d["lens6"]), jnp.asarray(d["alpha"]))
    got = TD.build_tables(_t(d["lens6"]), _t(d["alpha"]))
    for g, e in zip(got, exp):
        _eq(g, e)


def test_build_tables_random_lengths():
    # Kraft-complete tables from random lengths (long codes included)
    from bzip2_tpu.oracle.huffman import make_code_lengths
    rng = np.random.default_rng(31)
    lens6 = np.zeros((2, 6, 258), np.int32)
    alpha = np.array([258, 40], np.int32)
    for b in range(2):
        for t in range(6):
            freq = (rng.pareto(0.6, alpha[b]) * 10).astype(np.int64) + 1
            lens6[b, t, : alpha[b]] = make_code_lengths(freq, alpha[b], 20)
    exp = JD.build_tables(jnp.asarray(lens6), jnp.asarray(alpha))
    got = TD.build_tables(_t(lens6), _t(alpha))
    for g, e in zip(got, exp):
        _eq(g, e)


# ------------------------------------------------------------ symbols --

def test_decode_symbols_matches_jax(level1):
    d = level1
    lut = JD.build_tables(jnp.asarray(d["lens6"]), jnp.asarray(d["alpha"]))
    exp = JD.decode_symbols(jnp.asarray(d["words"]), jnp.asarray(d["goff"]),
                            jnp.asarray(d["gsel"]), jnp.asarray(d["gvalid"]),
                            *lut)
    _eq(level1["syms"], exp)


def test_byte_windows_matches_jax():
    words = np.random.default_rng(5).integers(0, 1 << 32, (3, 17),
                                              dtype=np.uint64).astype(np.uint32)
    _eq(TD._byte_windows(_t(words.astype(np.int64))),
        JD._byte_windows(jnp.asarray(words)))


# ----------------------------------------------------------- MTF^-1 --

@pytest.mark.parametrize("n_chunks", [8, 512])
def test_mtf_inverse_matches_jax(level1, n_chunks):
    d = level1
    args = (d["syms"].numpy(), d["used_list"], d["n_used"], d["n_mtf"])
    exp = JD.mtf_inverse(*(jnp.asarray(a) for a in args), n_chunks=n_chunks)
    got = TD.mtf_inverse(*(_t(a) for a in args), n_chunks=n_chunks)
    _eq(got, exp)


def test_mtf_inverse_random_symbols():
    rng = np.random.default_rng(11)
    B, M = 3, 3001
    n_used = np.array([256, 7, 2], np.int32)
    syms = np.stack([rng.integers(0, nu + 2, M) for nu in n_used]).astype(np.int32)
    used = np.zeros((B, 256), np.int32)
    for b, nu in enumerate(n_used):
        used[b, :nu] = np.sort(rng.choice(256, nu, replace=False))
    n_mtf = np.array([M, 1000, 1], np.int32)
    args = (syms, used, n_used, n_mtf)
    exp = JD.mtf_inverse(*(jnp.asarray(a) for a in args), n_chunks=16)
    _eq(TD.mtf_inverse(*(_t(a) for a in args), n_chunks=16), exp)


# --------------------------------------------------------------- RLE2 --

def test_rle2_expand_matches_jax(level1):
    d = level1
    exp_last, exp_n = JD.rle2_expand(
        jnp.asarray(d["syms"].numpy()), jnp.asarray(d["vals"].numpy()),
        jnp.asarray(d["n_used"]), jnp.asarray(d["n_mtf"]), 100_000)
    _eq(d["last"], exp_last)
    _eq(d["n_out"], exp_n)


def test_rle2_expand_run_digits():
    # long RUNA/RUNB digit runs between literals, and a short n_mtf
    rng = np.random.default_rng(12)
    M = 4000
    syms = np.where(rng.random((2, M)) < 0.7, rng.integers(0, 2, (2, M)),
                    rng.integers(2, 6, (2, M))).astype(np.int32)
    vals = rng.integers(0, 256, (2, M)).astype(np.int32)
    n_used = np.array([4, 3], np.int32)
    n_mtf = np.array([M, 50], np.int32)
    N = 1 << 16
    args = (syms, vals, n_used, n_mtf)
    exp = JD.rle2_expand(*(jnp.asarray(a) for a in args), N)
    got = TD.rle2_expand(*(_t(a) for a in args), N)
    for g, e in zip(got, exp):
        _eq(g, e)


# ---------------------------------------------------------------- IBWT --

def test_ibwt_small_oracle_blocks():
    """The last two blocks repeat (one symbol, period 2): their successor
    map has many cycles, so the splitter walk, which assumes one, returns
    wrong bytes with ok set, in the reference as in the port; the decoder's
    block CRC sends such a block to the host (test_torch_decoder)."""
    rng = np.random.default_rng(13)
    blks = [rng.integers(0, 5, int(rng.integers(2, 400))).astype(np.uint8)
            for _ in range(4)]
    blks.append(np.full(37, 7, np.uint8))
    blks.append(np.tile(np.array([1, 2], np.uint8), 50))
    N = 512
    lastp = np.zeros((6, N), np.int32)
    ns, origs = [], []
    for i, b in enumerate(blks):
        last, orig = obwt.bwt(b)
        lastp[i, :b.size] = last
        ns.append(b.size)
        origs.append(orig)
    ns, origs = np.array(ns, np.int32), np.array(origs, np.int32)
    exp_out, exp_ok = JD.ibwt(jnp.asarray(lastp), jnp.asarray(ns),
                              jnp.asarray(origs), n_walkers=16)
    out, ok = TD.ibwt(_t(lastp), _t(ns), _t(origs), n_walkers=16)
    _eq(ok, exp_ok)
    _eq(out, exp_out)
    assert ok.all()
    for i, b in enumerate(blks):
        assert (out[i, :b.size].numpy() == b).all() == (i < 4)


@pytest.mark.parametrize("budget", [32, 2])
def test_ibwt_4096_walkers_matches_jax(level1, budget):
    d = level1
    args = (d["last"].numpy(), d["n_out"].numpy(), d["orig"])
    exp_out, exp_ok = JD.ibwt(*(jnp.asarray(a) for a in args),
                              n_walkers=4096, budget=budget)
    out, ok = TD.ibwt(*(_t(a) for a in args), n_walkers=4096, budget=budget)
    _eq(ok, exp_ok)
    if budget == 32:
        assert ok.all()
    else:
        assert not ok.any(), "budget 2 must overflow wave 2 on 90k blocks"
    for b in np.flatnonzero(np.asarray(exp_ok)):
        _eq(out[b], np.asarray(exp_out)[b])


class _LaxSpy(types.SimpleNamespace):
    """Stands in for ``jax.lax`` inside the JAX decode module and records
    every ``while_loop`` (the walk waves): the packed successor array the
    loop body closes over, the start state and the final state."""

    def __init__(self, real):
        super().__init__(**{k: getattr(real, k) for k in dir(real)
                            if not k.startswith("__")})
        real_loop = real.while_loop
        self.waves = []

        def while_loop(cond, body, init):
            out = real_loop(cond, body, init)
            cells = dict(zip(body.__code__.co_freevars, body.__closure__))
            self.waves.append((np.asarray(cells["tt"].cell_contents),
                               np.asarray(init[0]), init[3].shape[2],
                               [np.asarray(x) for x in out[:4]]))
            return out

        self.while_loop = while_loop


@pytest.mark.parametrize("budget", [32, 2])
def test_ibwt_walk_plain_matches_jax_wave(level1, monkeypatch, budget):
    spy = _LaxSpy(JD.lax)
    monkeypatch.setattr(JD, "lax", spy)
    JD.ibwt(jnp.asarray(level1["last"].numpy()),
            jnp.asarray(level1["n_out"].numpy()), jnp.asarray(level1["orig"]),
            n_walkers=4096, budget=budget)
    assert len(spy.waves) == 2
    for tt, cur0, cap, exp in spy.waves:
        got = ik.ibwt_walk_plain(_t(tt), _t(cur0), cap)
        for g, e in zip(got, exp):
            assert g.dtype == (torch.uint8 if e.dtype == np.uint8 else torch.int32)
            _eq(g, e)
        # the wrapper takes the plain version for a CPU tensor
        for g, w in zip(got, ik.ibwt_walk(_t(tt), _t(cur0), cap)):
            assert torch.equal(g, w)


def test_ibwt_walk_rejects_bad_shapes():
    tt = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        ik.ibwt_walk(tt, torch.zeros((3, 4), dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        ik.ibwt_walk(tt, torch.zeros((2, 4), dtype=torch.int32), 0)


# ---------------------------------------------------------- RLE1^-1 --

def _rle1_cases(rng):
    cases = [b"a" * 101, b"a" * 4, b"a" * 5, b"a" * 104, b"x",
             bytes([97] * 4 + [98] * 255 + [99] * 1000)]
    for _ in range(8):
        L = int(rng.integers(1, 3000))
        raw = rng.integers(0, 5, L).astype(np.uint8)
        raw[rng.random(L) < 0.3] = 97
        cases.append(raw.tobytes())
    return cases


@pytest.mark.parametrize("NOUT", [4096, 1024])
def test_rle1_inverse_matches_jax(NOUT):
    cases = _rle1_cases(np.random.default_rng(14))
    x = np.zeros((len(cases), 4096), np.int32)
    n = np.zeros(len(cases), np.int32)
    for i, raw in enumerate(cases):
        enc = rle1.encode_blocks(raw, 9)[0].data
        x[i, :enc.size] = enc
        n[i] = enc.size
    exp = JD.rle1_inverse(jnp.asarray(x), jnp.asarray(n), NOUT)
    got = TD.rle1_inverse(_t(x), _t(n), NOUT)
    for g, e in zip(got, exp):
        _eq(g, e)
    out, olen, fits = got
    for i, raw in enumerate(cases):
        assert bool(fits[i]) == (len(raw) <= NOUT)
        if fits[i]:
            assert out[i, :olen[i]].to(torch.uint8).numpy().tobytes() == raw


# -------------------------------------------------------------- CRC --

def test_crc32_device_matches_jax_and_host():
    rng = np.random.default_rng(15)
    lens = np.array([0, 1, 63, 64, 1000, 4096], np.int32)
    data = np.zeros((lens.size, 4096), np.int32)
    for i, L in enumerate(lens):
        data[i, :L] = rng.integers(0, 256, L)
    exp = np.asarray(JD.crc32_device(jnp.asarray(data), jnp.asarray(lens),
                                     n_lanes=16))
    got = TD.crc32_device(_t(data), _t(lens), n_lanes=16)
    _eq(got, exp.astype(np.int64))
    for i, L in enumerate(lens):
        assert int(got[i]) == hostcrc.crc32(data[i, :L].astype(np.uint8).tobytes())


def test_crc_constants_match_jax():
    b, p = TD._crc_constants()
    _eq(b, JD._CRC_BASIS)
    _eq(p, JD._CRC_POW)
