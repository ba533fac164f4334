"""The port's host parallel decode (bzip2_tpu_torch.parallel.decode): the
cases of tests/test_parallel_decode.py, each held against
bzip2_tpu.parallel.decode on the same seeded input, by output bytes or
error class."""
import bz2
import io

import numpy as np
import pytest

from bzip2_tpu import api as japi
from bzip2_tpu.parallel import decode as jpdec
from bzip2_tpu_torch import api as tapi
from bzip2_tpu_torch import cli as tcli
from bzip2_tpu_torch.parallel import decode as pdec


def _outcome(fn, *args, **kw):
    """fn's bytes, or the name of the BZ2Error it raised."""
    try:
        return fn(*args, **kw)
    except (japi.BZ2Error, tapi.BZ2Error) as e:
        return type(e).__name__


@pytest.fixture(scope="module")
def members():
    rng = np.random.default_rng(42)
    outs = []
    raws = []
    for i in range(60):
        n = int(rng.integers(0, 30000))
        raw = bytes(rng.integers(97, 105, n, dtype=np.uint8))
        raws.append(raw)
        outs.append(bz2.compress(raw, 1 + i % 9))
    return b"".join(outs), b"".join(raws)


def test_find_offsets(members):
    comp, raw = members
    offs = pdec.find_member_offsets(comp)
    assert offs == jpdec.find_member_offsets(comp)
    assert offs[0] == 0 and len(offs) == 60
    # every offset starts with a stream header
    for o in offs:
        assert comp[o:o + 3] == b"BZh"
    assert pdec.find_member_offsets(b"BZh9") == [0]


def test_parallel_matches_sequential(members):
    comp, raw = members
    assert pdec.decompress_parallel(comp) == raw
    assert pdec.decompress_parallel(comp, max_workers=4) == raw
    assert tapi.decompress(comp, multi_stream=True, backend="native") == raw
    assert jpdec.decompress_parallel(comp) == raw


def test_trailing_garbage(members):
    comp, raw = members
    assert pdec.decompress_parallel(comp + b"\x00garbage") == raw
    assert jpdec.decompress_parallel(comp + b"\x00garbage") == raw


def test_false_split_heals(members, monkeypatch):
    comp, raw = members
    real = pdec.find_member_offsets(comp)
    bogus = sorted(real + [real[5] + 7])  # split inside a member
    monkeypatch.setattr(pdec, "find_member_offsets", lambda d: list(bogus))
    assert pdec.decompress_parallel(comp) == raw


def test_corrupt_member_raises(members):
    comp, raw = members
    bad = bytearray(comp)
    bad[len(comp) // 2] ^= 0xFF
    got = _outcome(pdec.decompress_parallel, bytes(bad))
    assert got == _outcome(jpdec.decompress_parallel, bytes(bad))
    assert got in ("DataError", "DataErrorMagic", "UnexpectedEOF")


# ---------------- block-grain parallel decode (single stream) ----------------

def test_blocks_parallel_single_stream():
    rng = np.random.default_rng(7)
    raw = bytes(rng.integers(97, 107, 1_200_000, dtype=np.uint8))
    comp = bz2.compress(raw, 1)   # ~13 blocks at level 1
    assert pdec.decompress_blocks_parallel(comp) == raw
    assert pdec.decompress_blocks_parallel(comp, max_workers=3) == raw
    assert pdec.decompress_parallel(comp) == raw


@pytest.mark.parametrize("level,n", [(9, 300_000), (2, 250_000)])
def test_blocks_parallel_levels_and_small(level, n):
    rng = np.random.default_rng(8 + level)
    raw = bytes(rng.integers(32, 127, n, dtype=np.uint8))
    comp = bz2.compress(raw, level)
    assert pdec.decompress_blocks_parallel(comp) == raw
    # too short to hold a block: the host decoder's verdict, as reference
    for tiny in (comp[:8], b"BZh0" + comp[4:20], b"xyz"):
        assert _outcome(pdec.decompress_blocks_parallel, tiny) == \
            _outcome(jpdec.decompress_blocks_parallel, tiny)


def test_blocks_parallel_corrupt():
    rng = np.random.default_rng(9)
    raw = bytes(rng.integers(97, 107, 500_000, dtype=np.uint8))
    comp = bytearray(bz2.compress(raw, 1))
    comp[len(comp) // 2] ^= 0x10
    with pytest.raises(tapi.BZ2Error):
        pdec.decompress_blocks_parallel(bytes(comp))
    assert _outcome(pdec.decompress_blocks_parallel, bytes(comp)) == \
        _outcome(jpdec.decompress_blocks_parallel, bytes(comp))


def test_bit_magic_scan_finds_blocks():
    rng = np.random.default_rng(10)
    raw = bytes(rng.integers(97, 107, 700_000, dtype=np.uint8))
    comp = bz2.compress(raw, 1)
    offs = pdec.find_bit_magics(comp, pdec.BLOCK_MAGIC)
    assert np.array_equal(offs, jpdec.find_bit_magics(comp, jpdec.BLOCK_MAGIC))
    assert len(offs) >= 7 and offs[0] == 32


def test_blocks_parallel_fuzz_bitflips():
    """Corruption anywhere must yield the reference's verdict: the bytes or
    the same error class, never a crash or hang."""
    rng = np.random.default_rng(11)
    raw = bytes(rng.integers(97, 107, 400_000, dtype=np.uint8))
    comp = bz2.compress(raw, 1)
    for _ in range(40):
        bad = bytearray(comp)
        pos = int(rng.integers(0, len(bad)))
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        got = _outcome(pdec.decompress_blocks_parallel, bytes(bad))
        assert got == _outcome(jpdec.decompress_blocks_parallel, bytes(bad))
        assert got == raw or isinstance(got, str)


def test_members_parallel_fuzz_bitflips():
    rng = np.random.default_rng(12)
    raws = [bytes(rng.integers(97, 107, 30_000, dtype=np.uint8))
            for _ in range(6)]
    comp = b"".join(bz2.compress(r, 1) for r in raws)
    joined = b"".join(raws)
    for _ in range(30):
        bad = bytearray(comp)
        pos = int(rng.integers(0, len(bad)))
        bad[pos] ^= 1 << int(rng.integers(0, 8))
        got = _outcome(pdec.decompress_parallel, bytes(bad))
        assert got == _outcome(jpdec.decompress_parallel, bytes(bad))
        # a flip in a later member's header legally truncates there
        # (trailing-garbage tolerance, bzip2.c:531-542)
        assert isinstance(got, str) or got == joined or (
            joined.startswith(got) and len(got) % 30_000 == 0)


def test_block_parallel_segment_healing():
    """Injected false block-magic candidates must be healed per segment
    (re-decoding only the failed span, seeded with the running combined
    CRC)."""
    rng = np.random.default_rng(7)
    raw = bytes(rng.integers(97, 112, 520_000, dtype=np.uint8))
    comp = bz2.compress(raw, 1)
    starts = [int(o) for o in pdec.find_bit_magics(comp, pdec.BLOCK_MAGIC)
              if o >= 32]
    eos = [int(o) for o in pdec.find_bit_magics(comp, pdec.EOS_MAGIC)
           if o >= 32]
    assert len(starts) >= 5
    # bogus candidates in the middle of several blocks' payloads
    fakes = [starts[1] + 5000, starts[2] + 777, starts[4] + 12345]
    cand = sorted(starts + fakes)
    out = pdec.decompress_blocks_parallel(comp, _candidates=(cand, eos))
    assert out == raw
    # a fake past the last block start (heals through the EOS tail)
    cand2 = sorted(starts + [starts[-1] + 4321])
    assert pdec.decompress_blocks_parallel(
        comp, _candidates=(cand2, eos)) == raw
    # fake EOS candidate before the real one
    assert pdec.decompress_blocks_parallel(
        comp, _candidates=(starts, [starts[-1] + 99] + eos)) == raw


def test_parallel_decode_10k_members():
    members = [b"m%05d!" % i for i in range(10_000)]
    stream = b"".join(bz2.compress(m, 1) for m in members)
    assert pdec.decompress_parallel(stream) == b"".join(members)


def test_rotl_matches_reference():
    for x, k in ((0x80000001, 1), (0x12345678, 0), (0xFFFFFFFF, 33),
                 (1, 31)):
        assert pdec._rotl(x, k) == jpdec._rotl(x, k)


def test_cli_native_decode_uses_parallel_path(tmp_path, monkeypatch):
    """CLI -d --backend=native on a >1MB regular file routes through
    decompress_parallel."""
    rng = np.random.default_rng(8)
    raw = bytes(rng.integers(97, 120, 2_200_000, dtype=np.uint8))
    comp = tmp_path / "big.bin.bz2"
    comp.write_bytes(bz2.compress(raw, 9))
    called = {}
    real = pdec.decompress_parallel

    def spy(data, *a, **k):
        called["yes"] = True
        return real(data, *a, **k)

    monkeypatch.setattr(pdec, "decompress_parallel", spy)
    out = io.BytesIO()
    with open(comp, "rb") as fin:
        ok, saw = tcli._decompress_stream(fin, out, True, False, "native")
    assert ok and saw and called.get("yes")
    assert out.getvalue() == raw
