"""The port's mesh layer (bzip2_tpu_torch/parallel/mesh.py) and its
row-addressed symbol decode against the JAX package's, on the CPU: the
same numpy inputs go to the JAX function on the 8 virtual CPU devices of
tests/conftest.py and to the port on a mesh of CPU entries.  Every
comparison is exact (the codec is integer-only, tolerance 0)."""
import bz2 as stdlib_bz2
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bzip2_tpu import crc as jcrc
from bzip2_tpu.ops import decode as JD
from bzip2_tpu.parallel import mesh as JM
from bzip2_tpu_torch import api as tapi
from bzip2_tpu_torch import crc as tcrc
from bzip2_tpu_torch import decoder as tdec
from bzip2_tpu_torch import engine as teng
from bzip2_tpu_torch import native as tnative
from bzip2_tpu_torch.ops import decode as TD
from bzip2_tpu_torch.parallel import mesh as TM
from test_torch_fuzz import _randomised_stream

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _t(a):
    return torch.from_numpy(np.require(np.asarray(a), requirements=["C", "W"]))


@pytest.fixture(autouse=True)
def _telemetry():
    TM.reset_telemetry()
    yield


def _cpu_mesh(k):
    return TM.make_mesh(["cpu"] * k)


# ------------------------------------------------- decode_symbols_rows ---

def _parsed(comp: bytes, level: int):
    buf = np.frombuffer(comp, np.uint8)
    pbs, pos = [], 32
    while True:
        pb, _rc = tnative.parse_block(buf, pos, level)
        if pb is None:
            break
        pb.start_bit = pos
        pbs.append(pb)
        pos = pb.end_bit
    assert len(pbs) >= 2, "fixture must hold several blocks"
    return buf, pbs


def test_decode_symbols_rows_matches_jax(golden):
    """The rows of a real multi-block stream, built as
    tests/test_device_decode.py builds them (the JAX mesh's pow2 row
    width), through JAX's decode_symbols_rows and the port's; then the
    port's exact-width rows (decoder.batch_inputs) and its flat
    decode_symbols agree
    on every valid symbol."""
    comp = stdlib_bz2.compress(golden[2][0][:180_000], 1)
    buf, pbs = _parsed(comp, 1)
    B = len(pbs)
    G = max(pb.n_groups_used for pb in pbs)
    lens6 = np.stack([pb.lens for pb in pbs]).astype(np.int32)
    alpha = np.array([pb.n_used + 2 for pb in pbs], np.int32)
    gsel = np.zeros((B, G), np.int32)
    gvalid = np.zeros((B, G), bool)
    for i, pb in enumerate(pbs):
        gsel[i, :pb.n_groups_used] = pb.selectors[:pb.n_groups_used]
        gvalid[i, :pb.n_groups_used] = True
    need = max(((pb.end_bit + 31) // 32 + 1) - pb.sym_start_bit // 32
               for pb in pbs)
    wt = 1 << max(6, need - 1).bit_length()
    words_r = np.zeros((B, wt), np.uint32)
    goff_r = np.zeros((B, G), np.int32)
    for i, pb in enumerate(pbs):
        wbase = pb.sym_start_bit // 32
        span = buf[wbase * 4: min(((pb.end_bit + 31) // 32 + 1) * 4,
                                  buf.size)]
        row = np.zeros(wt * 4, np.uint8)
        row[: span.size] = span
        words_r[i] = row.view(">u4")
        goff_r[i, :pb.n_groups_used] = pb.group_offsets - wbase * 32

    jt = JD.build_tables(jnp.asarray(lens6), jnp.asarray(alpha))
    exp = np.asarray(JD.decode_symbols_rows(
        jnp.asarray(words_r), jnp.asarray(goff_r), jnp.asarray(gsel),
        jnp.asarray(gvalid), *jt))
    tt = TD.build_tables(_t(lens6), _t(alpha))
    got = TD.decode_symbols_rows(_t(words_r.astype(np.int64)), _t(goff_r),
                                 _t(gsel), _t(gvalid), *tt)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), exp)

    valid = np.repeat(gvalid, 50, axis=1)
    words, goff, gsel2, gvalid2, lens2, _ul, head = (
        _t(a) for a in tdec.batch_inputs(buf, pbs, rows=True))
    assert words.dtype == torch.int64
    assert words.shape[1] == need, "a row holds exactly the used words"
    rows = TD.decode_symbols_rows(words, goff, gsel2, gvalid2,
                                  *TD.build_tables(lens2, head[0]))
    flat_w = np.zeros((buf.size // 4 + 2) * 4, np.uint8)
    flat_w[: buf.size] = buf
    goff_f = np.zeros((B, G), np.int32)
    for i, pb in enumerate(pbs):
        goff_f[i, :pb.n_groups_used] = pb.group_offsets
    flat = TD.decode_symbols(_t(flat_w.view(">u4").astype(np.int64)),
                             _t(goff_f), _t(gsel), _t(gvalid), *tt)
    assert np.array_equal(rows.numpy()[valid], exp[valid])
    assert np.array_equal(flat.numpy()[valid], exp[valid])


# ------------------------------------------------------------ the mesh ---

def test_make_mesh_needs_cuda_unless_cpu_is_named():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.make_mesh(["cuda:0"])
    m = TM.make_mesh(["cpu"] * 4)
    assert m.size == 4
    assert all(d == torch.device("cpu") for d in m.devices)
    with pytest.raises(ValueError):
        TM.make_mesh([])


@pytest.mark.parametrize("B,size", [(16, 1), (16, 3), (16, 8), (19, 2),
                                    (2, 3), (0, 2)])
def test_shard_bounds_lay_blocks_out_as_p_blocks(B, size):
    """P("blocks") over a batch padded to a multiple of the mesh: entry i
    holds rows [i*k, (i+1)*k) of the padded batch, k = ceil(B/size); the
    real blocks are the first B rows."""
    k = -(-B // size)
    want = [(min(i * k, B), min((i + 1) * k, B)) for i in range(size)]
    got = TM.shard_bounds(B, size)
    assert got == want
    assert sum(e - s for s, e in got) == B
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def _level1_batch(rng):
    """The 16-block level-1 input of tests/test_mesh.py, padded to the
    port's MTF tile."""
    data = rng.integers(97, 105, 16 * 95_000, dtype=np.uint8).tobytes()
    blocks = teng.split_blocks(data, 1)
    N = -(-max(b.data.size for b in blocks) // teng.MTF_TILE) * teng.MTF_TILE
    return data, blocks, teng.batch_arrays(blocks, len(blocks), N), N


@pytest.fixture(scope="module")
def level1_jax():
    """JAX's encode_blocks_sharded on the 8 virtual devices, once."""
    rng = np.random.default_rng(0xB21)
    data, blocks, arrays, N = _level1_batch(rng)
    words, nbits = JM.encode_blocks_sharded(
        JM.make_mesh(jax.devices()), *arrays, teng._words_for(N))
    return data, blocks, arrays, N, np.asarray(words), np.asarray(nbits)


@pytest.mark.parametrize("entries", [1, 3, 8])
def test_encode_blocks_sharded_matches_jax(level1_jax, entries):
    data, blocks, arrays, N, jwords, jnbits = level1_jax
    assert len(blocks) == 16
    words, nbits = TM.encode_blocks_sharded(_cpu_mesh(entries), *arrays,
                                            teng._words_for(N))
    assert words.dtype == np.uint32 and nbits.dtype == np.int64
    assert np.array_equal(nbits, jnbits.astype(np.int64))
    assert words.shape == (16, int((nbits.max() + 31) // 32)), \
        "words are cut to the longest block's used words"
    for j, nbit in enumerate(int(x) for x in nbits):
        used = (nbit + 31) // 32
        assert np.array_equal(words[j, :used], jwords[j, :used])
        assert not words[j, used:].any()
    assert tapi.frame([b.crc for b in blocks],
                      teng.payloads_from_words(words, nbits),
                      1) == stdlib_bz2.compress(data, 1)


def test_encode_blocks_sharded_empty_entries_launch_nothing(rng):
    """Two blocks on a three-entry mesh: the third entry's shard is empty and
    it runs nothing (a spy on the fused encoder sees two calls of one
    block); the output equals the one-entry mesh's."""
    data = rng.integers(97, 105, 2 * 95_000, dtype=np.uint8).tobytes()
    blocks = teng.split_blocks(data, 1)
    assert len(blocks) == 2
    N = -(-max(b.data.size for b in blocks) // teng.MTF_TILE) * teng.MTF_TILE
    arrays = teng.batch_arrays(blocks, 2, N)
    calls = []
    real = TM.encode_batch_device

    def spy(blocks_t, *a, **k):
        calls.append(blocks_t.shape[0])
        return real(blocks_t, *a, **k)

    TM.encode_batch_device = spy
    try:
        w3, n3 = TM.encode_blocks_sharded(_cpu_mesh(3), *arrays,
                                          teng._words_for(N))
    finally:
        TM.encode_batch_device = real
    assert sorted(calls) == [1, 1]
    w1, n1 = TM.encode_blocks_sharded(_cpu_mesh(1), *arrays,
                                      teng._words_for(N))
    assert np.array_equal(n3, n1) and np.array_equal(w3, w1)


# -------------------------------------------------------------- decode ---

def test_decode_blocks_sharded_level1(rng):
    """Stock level-1 stream on a three-entry mesh: the data, and the JAX
    function's bytes; a two-member stream; a flipped byte raises."""
    data = rng.integers(97, 105, 12 * 95_000, dtype=np.uint8).tobytes()
    comp = stdlib_bz2.compress(data, 1)
    mesh = _cpu_mesh(3)
    got = TM.decode_blocks_sharded(mesh, comp, 1)
    assert got == data
    assert got == JM.decode_blocks_sharded(JM.make_mesh(jax.devices()),
                                           comp, 1)
    assert set(TM.STAGE_WALL) == set(tdec.STAGES)
    assert TM.HEALS["lane"] == 0
    comp2 = stdlib_bz2.compress(b"second member " * 1000, 1)
    assert TM.decode_blocks_sharded(mesh, comp + comp2) == \
        data + b"second member " * 1000
    bad = bytearray(comp)
    bad[len(bad) // 2] ^= 0x40
    with pytest.raises(ValueError):
        TM.decode_blocks_sharded(mesh, bytes(bad), 1)


@pytest.mark.parametrize("stream", [
    b"", b"BZh0" + bytes(20), stdlib_bz2.compress(b"abc", 1)[:-3]])
def test_decode_blocks_sharded_malformed_raises(stream):
    """An empty stream, a bad header and a truncated end raise ValueError,
    in JAX and in the port."""
    with pytest.raises(ValueError):
        TM.decode_blocks_sharded(_cpu_mesh(2), stream)
    with pytest.raises(ValueError):
        JM.decode_blocks_sharded(JM.make_mesh(jax.devices()[:2]), stream)


def test_decode_blocks_sharded_mixed_levels_and_empty():
    mesh = _cpu_mesh(2)
    assert TM.decode_blocks_sharded(mesh, stdlib_bz2.compress(b"", 9)) == b""
    mixed = stdlib_bz2.compress(b"one", 1) + stdlib_bz2.compress(b"two", 2)
    with pytest.raises(ValueError, match="mixed levels"):
        TM.decode_blocks_sharded(mesh, mixed)


def _level9_input():
    """~1.04 real -9 blocks of mixed text (tests/test_mesh.py's input)."""
    data = b"".join(open(os.path.join(GOLDEN, f"sample{i}.ref"), "rb").read()
                    for i in (2, 1)) * 4
    return data[: (100_000 * 9 - 19) + 40_000]


def test_level9_heal_fires_and_real_budget_does_not(monkeypatch):
    """A squeezed walk budget overflows wave 2 on a real ~900k block: its
    lane heals on the host and the output stays exact.  With the real
    budget the same stream decodes with no heal."""
    data = _level9_input()
    comp = stdlib_bz2.compress(data, 9)
    mesh = _cpu_mesh(2)
    real = TD.ibwt
    monkeypatch.setattr(TD, "ibwt", functools.partial(real, budget=2))
    assert TM.decode_blocks_sharded(mesh, comp, 9) == data
    # the full ~900k block overflows wave 2; the 40k tail block still fits
    assert TM.HEALS["lane"] == 1, "the squeezed budget must force a heal"
    monkeypatch.setattr(TD, "ibwt", real)
    TM.reset_telemetry()
    assert TM.decode_blocks_sharded(mesh, comp, 9) == data
    assert TM.HEALS["lane"] == 0, "the real budget must not heal at -9"


def test_device_error_propagates(monkeypatch, golden):
    """An error on one entry raises from decode_blocks_sharded once every
    entry has stopped; nothing re-decodes the stream on the host."""
    comp = stdlib_bz2.compress((golden[2][0] * 2)[:300_000], 1)

    def broken(last, *a, **k):
        raise RuntimeError("walk failed")

    monkeypatch.setattr(TD, "ibwt", broken)
    heal = []
    monkeypatch.setattr(TM.native, "decode_some",
                        lambda *a, **k: heal.append(a))
    with pytest.raises(RuntimeError, match="walk failed"):
        TM.decode_blocks_sharded(_cpu_mesh(3), comp)
    assert heal == []


def test_randomised_member_raises_dedicated_error(rng):
    raw = bytes(rng.integers(32, 127, 20_000, dtype=np.uint8))
    stream = _randomised_stream(raw)
    assert stdlib_bz2.decompress(stream) == raw
    with pytest.raises(TM.RandomisedBlockError):
        TM.decode_blocks_sharded(_cpu_mesh(2), stream)
    assert issubclass(TM.RandomisedBlockError, ValueError)
    with pytest.raises(ValueError, match="randomised"):
        JM.decode_blocks_sharded(JM.make_mesh(jax.devices()[:2]), stream)


def test_combined_crc_fold_is_associative(rng):
    """The stream CRC fold over shards composes as the serial fold, and
    the port's fold equals the reference's."""
    crcs = [int(x) for x in rng.integers(0, 2**32, 13, dtype=np.uint64)]
    serial = tcrc.combine_block_crcs(crcs)
    assert serial == jcrc.combine_block_crcs(crcs)
    a, b = crcs[:7], crcs[7:]
    fa, fb = tcrc.combine_block_crcs(a), tcrc.combine_block_crcs(b)
    k = len(b) % 32
    assert serial == (((fa << k) | (fa >> (32 - k))) & 0xFFFFFFFF) ^ fb
