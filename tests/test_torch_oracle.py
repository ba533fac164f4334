"""The port's NumPy reference codec (bzip2_tpu_torch.oracle) and the
"oracle" backend of its surfaces, against bzip2_tpu's on the same seeded
inputs.

Each function of the port's oracle gives the reference oracle's result
exactly (its errors too), and so does ``BitWriter.write_codes``.
``api.compress(backend="oracle")`` equals stock bz2; ``api.decompress``,
``stream.Decompressor``, ``BZ2TFile`` and the CLI with the oracle backend
give the reference oracle path's bytes, errors and counters.  A call that
names no backend never reaches the oracle, and neither does one whose
card or native runtime fails.  Inputs stay under about 100 kB, since the
oracle takes seconds a megabyte.
"""
import bz2 as stdlib_bz2
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from bzip2_tpu import api as japi
from bzip2_tpu import bitstream as jbits
from bzip2_tpu import rle1 as jrle1
from bzip2_tpu import stream as jstream
from bzip2_tpu.oracle import block as jblock
from bzip2_tpu.oracle import bwt as jbwt
from bzip2_tpu.oracle import groups as jgroups
from bzip2_tpu.oracle import huffman as jhuff
from bzip2_tpu.oracle import mtf as jmtf
from bzip2_tpu_torch import api as tapi
from bzip2_tpu_torch import bitstream as tbits
from bzip2_tpu_torch import cli as tcli
from bzip2_tpu_torch import decoder as dmod
from bzip2_tpu_torch import file as tfile
from bzip2_tpu_torch import native
from bzip2_tpu_torch import rle1 as trle1
from bzip2_tpu_torch import stream as tstream
from bzip2_tpu_torch.oracle import block as tblock
from bzip2_tpu_torch.oracle import bwt as tbwt
from bzip2_tpu_torch.oracle import groups as tgroups
from bzip2_tpu_torch.oracle import huffman as thuff
from bzip2_tpu_torch.oracle import mtf as tmtf

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden"


def _inputs():
    """Seeded blocks: random bytes, a small alphabet, text, runs, an
    exactly periodic block and one byte."""
    rng = np.random.default_rng(0x0AC1E)
    text = (GOLDEN / "sample1.ref").read_bytes()
    runs = b"".join(bytes([int(c)]) * int(k) for c, k in zip(
        rng.integers(0, 256, 120), rng.integers(1, 300, 120)))
    return {
        "random": rng.integers(0, 256, 12_000, dtype=np.uint8).tobytes(),
        "small": rng.integers(0, 4, 20_000, dtype=np.uint8).tobytes(),
        "text": text[:30_000],
        "runs": runs,
        "periodic": b"abc" * 4_000,
        "one": b"q",
    }


INPUTS = _inputs()
NAMES = sorted(INPUTS)


def _block(name):
    """The first RLE1 block of input ``name`` (the port's split, which
    tests/test_torch_host.py holds against the reference's)."""
    return trle1.encode_blocks(INPUTS[name], 1)[0]


def _stage(name):
    """(block, BWT last column, origPtr, mtfv, freq, nInUse) of ``name``,
    from the reference oracle."""
    blk = _block(name)
    last, optr = jbwt.bwt(blk.data)
    mtfv, freq, k = jmtf.mtf_rle2_encode(last, blk.in_use)
    return blk, last, optr, mtfv, freq, k


def _same(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray))
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


def _outcome(fn, *args):
    """fn's result, or its error's class name and message."""
    try:
        return fn(*args)
    except (ValueError, EOFError, japi.BZ2Error, tapi.BZ2Error) as e:
        return type(e).__name__, str(e)


# ------------------------------------------------------------ huffman --

def _freq_cases():
    rng = np.random.default_rng(11)
    fib = [1, 1]
    while len(fib) < 40:
        fib.append(fib[-1] + fib[-2])
    return {
        "random258": (rng.integers(0, 5000, 258), 258),
        "zeros": (np.zeros(40, np.int64), 40),
        "alpha3": (np.array([7, 0, 1]), 3),
        "sparse": (rng.integers(0, 3, 120) * rng.integers(0, 900, 120), 120),
        # Fibonacci weights make a tree deeper than 17: halve and retry
        "fibonacci": (np.array(fib[::-1]), 40),
    }


FREQS = _freq_cases()


@pytest.mark.parametrize("case", sorted(FREQS))
def test_make_code_lengths_matches(case):
    freq, alpha = FREQS[case]
    got = thuff.make_code_lengths(freq, alpha)
    _same(got, jhuff.make_code_lengths(freq, alpha))
    assert got.max() <= 17


@pytest.mark.parametrize("case", sorted(FREQS))
def test_assign_codes_and_decode_table_match(case):
    freq, alpha = FREQS[case]
    lens = jhuff.make_code_lengths(freq, alpha)
    _same(thuff.assign_codes(lens, alpha), jhuff.assign_codes(lens, alpha))
    _same(thuff.build_decode_table(lens, alpha),
          jhuff.build_decode_table(lens, alpha))


@pytest.mark.parametrize("lens", [[0, 1, 1], [1, 1, 1], [2, 2, 2],
                                  [1, 24, 24], [3, 3, 1, 2]],
                         ids=["zero", "over", "under", "toolong", "ok"])
def test_build_decode_table_errors_match(lens):
    lens = np.array(lens)
    got = _outcome(thuff.build_decode_table, lens, lens.size)
    exp = _outcome(jhuff.build_decode_table, lens, lens.size)
    if isinstance(exp, tuple) and isinstance(exp[0], str):
        assert got == (exp[0], exp[1]) and exp[0] == "BadTableError"
    else:
        _same(got, exp)
    assert issubclass(thuff.BadTableError, ValueError)


# ---------------------------------------------------------------- mtf --

@pytest.mark.parametrize("name", NAMES)
def test_mtf_ranks_matches(name):
    blk, last, *_ = _stage(name)
    used = np.flatnonzero(blk.in_use)
    remap = np.zeros(256, np.int64)
    remap[used] = np.arange(used.size)
    seq = remap[last]
    for tile in (512, 37):
        _same(tmtf.mtf_ranks(seq, used.size, tile),
              jmtf.mtf_ranks(seq, used.size, tile))


def test_run_digits_matches():
    z = np.array([1, 2, 3, 4, 7, 8, 255, 256, 1000, 99_999, 1 << 20])
    _same(tmtf.run_digits(z), jmtf.run_digits(z))


@pytest.mark.parametrize("name", NAMES)
def test_mtf_rle2_encode_matches(name):
    blk, last, *_ = _stage(name)
    _same(tmtf.mtf_rle2_encode(last, blk.in_use),
          jmtf.mtf_rle2_encode(last, blk.in_use))


@pytest.mark.parametrize("name", NAMES)
def test_mtf_rle2_decode_matches(name):
    blk, last, _, mtfv, _, _ = _stage(name)
    used = np.flatnonzero(blk.in_use)
    syms = [int(v) for v in mtfv[:-1]]          # EOB stripped
    got = tmtf.mtf_rle2_decode(syms, used.size, used, 100_000)
    _same(got, jmtf.mtf_rle2_decode(syms, used.size, used, 100_000))
    assert np.array_equal(got, last)
    # a block budget the symbols overflow, and a position past the list
    for bad, cap in ((syms, max(last.size - 1, 0)),
                     (syms + [used.size + 1], 100_000)):
        assert _outcome(tmtf.mtf_rle2_decode, bad, used.size, used, cap) \
            == _outcome(jmtf.mtf_rle2_decode, bad, used.size, used, cap)


# ---------------------------------------------------------------- bwt --

@pytest.mark.parametrize("name", NAMES)
def test_bwt_and_ibwt_match(name):
    blk, last, optr, *_ = _stage(name)
    _same(tbwt.rotation_sort(blk.data), jbwt.rotation_sort(blk.data))
    _same(tbwt.bwt(blk.data), jbwt.bwt(blk.data))
    got = tbwt.ibwt(last, optr)
    _same(got, jbwt.ibwt(last, optr))
    assert np.array_equal(got, blk.data)


def test_bwt_of_empty_block_matches():
    e = np.zeros(0, np.uint8)
    _same(tbwt.rotation_sort(e), jbwt.rotation_sort(e))
    _same(tbwt.bwt(e), jbwt.bwt(e))
    _same(tbwt.ibwt(e, 0), jbwt.ibwt(e, 0))


# ------------------------------------------------------------- groups --

def test_n_groups_for_matches():
    for n in (0, 1, 199, 200, 599, 600, 1199, 1200, 2399, 2400, 900_000):
        assert tgroups.n_groups_for(n) == jgroups.n_groups_for(n)


@pytest.mark.parametrize("name", NAMES)
def test_group_search_matches(name):
    _, _, _, mtfv, freq, k = _stage(name)
    alpha = k + 2
    ng = jgroups.n_groups_for(mtfv.size)
    _same(tgroups.initial_tables(freq, mtfv.size, alpha, ng),
          jgroups.initial_tables(freq, mtfv.size, alpha, ng))
    got = tgroups.group_search(mtfv, freq, alpha)
    _same(got, jgroups.group_search(mtfv, freq, alpha))
    coded = tgroups.mtf_selectors(got[1], got[0])
    _same(coded, jgroups.mtf_selectors(got[1], got[0]))
    _same(tgroups.unmtf_selectors(coded - 1, got[0]),
          jgroups.unmtf_selectors(coded - 1, got[0]))
    assert np.array_equal(tgroups.unmtf_selectors(coded - 1, got[0]), got[1])


# -------------------------------------------------------------- block --

@pytest.mark.parametrize("name", NAMES)
def test_encode_block_matches(name):
    blk = _block(name)
    ref = jrle1.encode_blocks(INPUTS[name], 1)[0]
    got = tblock.encode_block(blk)
    _same(got, jblock.encode_block(ref))
    assert got[1] > 0 and got[0].size == (got[1] + 7) // 8


def _first_block_reader(mod, comp):
    r = mod.BitReader(np.frombuffer(comp, np.uint8))
    r.pos = 32 + 48                     # stream header, then block magic
    return r


@pytest.mark.parametrize("name", NAMES)
def test_decode_block_body_matches(name):
    comp = stdlib_bz2.compress(INPUTS[name], 1)
    rg = _first_block_reader(tbits, comp)
    re_ = _first_block_reader(jbits, comp)
    got = tblock.decode_block_body(rg, 1)
    _same(got, jblock.decode_block_body(re_, 1))
    assert rg.pos == re_.pos
    assert got[1].tobytes() == INPUTS[name][:got[1].size]


@pytest.mark.parametrize("where", [15, 19, 40, 300, -20])
def test_decode_block_body_errors_match(where):
    """A byte flipped in the origPtr, the symbol map, the tables or the
    payload: the same outcome, DataError with the same message or the same
    bytes (the CRC is checked by the caller)."""
    comp = bytearray(stdlib_bz2.compress(INPUTS["text"], 1))
    comp[where] ^= 0xA5
    comp = bytes(comp)
    got = _outcome(tblock.decode_block_body, _first_block_reader(tbits, comp),
                   1)
    exp = _outcome(jblock.decode_block_body, _first_block_reader(jbits, comp),
                   1)
    if isinstance(exp, tuple) and isinstance(exp[0], str):
        assert got == exp
    else:
        _same(got, exp)
    assert issubclass(tblock.DataError, ValueError)


# --------------------------------------------------------- write_codes --

@pytest.mark.parametrize("lead", [0, 3, 31])
def test_write_codes_matches(lead):
    rng = np.random.default_rng(lead)
    lens = rng.integers(1, 24, 3000)
    codes = (rng.integers(0, 1 << 23, 3000) & ((1 << lens) - 1)).astype(
        np.uint32)
    out = []
    for mod in (tbits, jbits):
        w = mod.BitWriter()
        w.write((1 << lead) - 1, lead)
        w.write_codes(codes, lens)
        w.write_codes(codes[:0], lens[:0])
        w.write(5, 3)
        out.append(w.getvalue())
    assert np.array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1] == lead + int(lens.sum()) + 3


# ----------------------------------------------------------------- api --

def _mixed():
    rng = np.random.default_rng(9)
    text = (GOLDEN / "sample2.ref").read_bytes()
    return text[:60_000] + rng.integers(0, 256, 20_000,
                                        dtype=np.uint8).tobytes()


@pytest.mark.parametrize("level", [1, 9])
def test_api_compress_oracle_equals_stock(level):
    data = _mixed()
    assert tapi.compress(data, level, backend="oracle") == \
        stdlib_bz2.compress(data, level)


def test_api_compress_oracle_periodic_block_equals_stock():
    data = b"bba" * 30_000
    got = tapi.compress(data, 1, backend="oracle")
    assert got == stdlib_bz2.compress(data, 1)
    assert got == japi.compress(data, 1, backend="oracle")


def test_oracle_entry_is_registered_with_the_corrector():
    """The "oracle" entry is the registry's, wrapped like the others: its
    payloads on a periodic block are the corrector's, stock's."""
    enc = tapi.block_encoder("oracle")
    assert tapi._BLOCK_ENCODERS["oracle"] is enc
    blocks = trle1.encode_blocks(b"ab" * 300, 1)
    raw = [tblock.encode_block(b) for b in blocks]
    from bzip2_tpu_torch import periodic
    fixed = periodic.patch_payloads(raw, blocks, 1)
    got = enc(blocks, 1)
    assert [n for _, n in got] == [n for _, n in fixed]
    assert all(np.array_equal(a, b) for (a, _), (b, _) in zip(got, fixed))


def _decode_cases():
    data = _mixed()
    one = stdlib_bz2.compress(data[:40_000], 1)
    two = one + stdlib_bz2.compress(INPUTS["runs"], 9)
    bad_crc = bytearray(one)
    bad_crc[10] ^= 0x01                 # the first block's stored CRC
    cases = {f"golden{i}": (GOLDEN / f"sample{i}.bz2").read_bytes()
             for i in (1, 2, 3)}
    cases.update({
        "two_members_garbage": two + b"trailing garbage",
        "truncated": one[:len(one) // 2],
        "flipped_crc": bytes(bad_crc),
        "bad_magic": b"BZx9" + one[4:],
        "empty_stream": stdlib_bz2.compress(b"", 9),
        "empty_input": b"",
    })
    return cases


DECODE_CASES = _decode_cases()


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
@pytest.mark.parametrize("multi", [False, True])
def test_api_decompress_oracle_matches_reference(case, multi):
    blob = DECODE_CASES[case]
    got = _outcome(tapi.decompress_with_tail, blob, multi, "oracle")
    exp = _outcome(japi.decompress_with_tail, blob, multi, "oracle")
    assert got == exp
    if case.startswith("golden"):
        i = case[-1]
        assert got == ((GOLDEN / f"sample{i}.ref").read_bytes(), len(blob))
    expected = {"truncated": "UnexpectedEOF", "flipped_crc": "DataError",
                "bad_magic": "DataErrorMagic", "empty_input": "DataErrorMagic"}
    if case in expected:
        assert got[0] == expected[case]


def _push_all(d, blob, piece):
    rows = []
    for i in range(0, len(blob), piece):
        out = d.decompress(blob[i:i + piece])
        rows.append((out, d.total_in, d.total_out, d.unused_data, d.eof))
    return rows


def test_decompressor_oracle_counters_match_reference():
    """100-byte pieces of two members and trailing bytes: each piece's
    output, total_in, total_out, unused_data and eof are the reference
    oracle's."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 6, 6_000, dtype=np.uint8).tobytes()
    blob = stdlib_bz2.compress(a, 1) + stdlib_bz2.compress(b"second", 9) + \
        b"tail"
    got = _push_all(tstream.Decompressor(backend="oracle"), blob, 100)
    exp = _push_all(jstream.Decompressor(backend="oracle"), blob, 100)
    assert got == exp
    assert b"".join(r[0] for r in got) == a and got[-1][4]
    assert got[-1][3] == blob[len(stdlib_bz2.compress(a, 1)):]


@pytest.mark.parametrize("piece", [1 << 16, 2000])
def test_decompressor_oracle_errors_match_reference(piece):
    one = DECODE_CASES["flipped_crc"]
    for blob in (one, b"not a bzip2 stream", b"BZh9" + b"\x00" * 40):
        got = _outcome(_push_all, tstream.Decompressor(backend="oracle"),
                       blob, piece)
        exp = _outcome(_push_all, jstream.Decompressor(backend="oracle"),
                       blob, piece)
        assert got == exp and isinstance(got[0], str)


# ------------------------------------------------- file and command line --

@pytest.fixture()
def no_card_no_native_decode(monkeypatch):
    """Spies that fail a test on any call to the card's decoder or engine,
    or to the native decoders."""
    def forbidden(what):
        def fail(*a, **k):
            raise AssertionError(f"{what} was called")
        return fail

    monkeypatch.setattr(dmod, "default_decoder", forbidden("default_decoder"))
    monkeypatch.setattr(native, "decode_some", forbidden("decode_some"))
    monkeypatch.setattr(native, "decompress", forbidden("decompress"))
    from bzip2_tpu_torch import engine as teng
    monkeypatch.setattr(teng.Engine, "encode_payloads",
                        forbidden("Engine.encode_payloads"))


def test_bz2tfile_oracle_round_trip(tmp_path, no_card_no_native_decode):
    data = _mixed()[:50_000]
    p = tmp_path / "o.bz2"
    with tfile.BZ2TFile(p, "wb", compresslevel=2, backend="oracle") as f:
        f.write(data[:20_000])
        f.write(data[20_000:])
    assert p.read_bytes() == stdlib_bz2.compress(data, 2)
    with tfile.BZ2TFile(p, "rb", backend="oracle") as f:
        assert f.read() == data


def test_cli_main_oracle_encode_and_decode(tmp_path,
                                           no_card_no_native_decode):
    data = _mixed()[:50_000]
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    assert tcli.main(["--backend=oracle", "-zkf", "-9", str(src)]) == 0
    comp = (tmp_path / "in.bin.bz2").read_bytes()
    assert comp == stdlib_bz2.compress(data, 9)
    src.unlink()
    assert tcli.main(["--backend=oracle", "-dkf",
                      str(tmp_path / "in.bin.bz2")]) == 0
    assert src.read_bytes() == data


def _cli(pkg, args, stdin):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("BZIP2", None)
    env.pop("BZIP", None)
    p = subprocess.run([sys.executable, "-m", f"{pkg}.cli"] + args,
                       input=stdin, capture_output=True, env=env, timeout=300)
    return p.returncode, p.stdout


def test_cli_oracle_filter_matches_reference():
    """python -m bzip2_tpu_torch.cli --backend=oracle as a filter, beside
    the reference's: the same stream (stock's), then the same bytes back,
    also from two members with trailing garbage."""
    data = _mixed()[:30_000]
    enc = [_cli(pkg, ["--backend=oracle", "-z", "-3"], data)
           for pkg in ("bzip2_tpu_torch", "bzip2_tpu")]
    assert enc[0] == enc[1] == (0, stdlib_bz2.compress(data, 3))
    blob = enc[0][1] + stdlib_bz2.compress(b"more", 1) + b"junk"
    dec = [_cli(pkg, ["--backend=oracle", "-d", "-q"], blob)
           for pkg in ("bzip2_tpu_torch", "bzip2_tpu")]
    assert dec[0] == dec[1] == (0, data + b"more")


# ------------------------------------------------ no name, no oracle --

@pytest.fixture()
def oracle_spies(monkeypatch):
    calls = []

    def spy(name, real):
        def f(*a, **k):
            calls.append(name)
            return real(*a, **k)
        return f

    monkeypatch.setattr(tblock, "encode_block",
                        spy("encode_block", tblock.encode_block))
    monkeypatch.setattr(tblock, "decode_block_body",
                        spy("decode_block_body", tblock.decode_block_body))
    return calls


def test_oracle_spies_count(oracle_spies):
    data = b"spied " * 100
    comp = tapi.compress(data, 1, backend="oracle")
    assert tapi.decompress(comp, backend="oracle") == data
    assert oracle_spies == ["encode_block", "decode_block_body"]


def test_no_backend_without_cuda_never_reaches_the_oracle(monkeypatch,
                                                          oracle_spies):
    """With nothing named the card encodes and decodes: without CUDA each
    raises, and nothing falls back to the oracle."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delitem(tapi._BLOCK_ENCODERS, "gpu", raising=False)
    monkeypatch.setattr(tapi, "_default_backend", "gpu")
    monkeypatch.setattr(dmod, "_default", None)
    data = INPUTS["text"]
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.compress(data, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.decompress(stdlib_bz2.compress(data, 1))
    c = tstream.Compressor(1)
    c.compress(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        c.flush()
    d = tstream.Decompressor()
    assert d.decompress(stdlib_bz2.compress(data, 1)) == data
    assert oracle_spies == []


def test_failed_native_runtime_never_reaches_the_oracle(monkeypatch,
                                                        oracle_spies):
    """With the native runtime failed, the host backend and the host
    readers raise; none produces a stream or bytes through the oracle."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", True)
    data = INPUTS["text"]
    comp = stdlib_bz2.compress(data, 1)
    with pytest.raises(RuntimeError, match="native"):
        tapi.compress(data, 1, backend="native")
    with pytest.raises(RuntimeError, match="native"):
        tapi.decompress(comp, backend="native")
    with pytest.raises(RuntimeError, match="native"):
        tstream.Decompressor().decompress(comp)
    c = tstream.Compressor(1, backend="native")
    c.compress(data)
    with pytest.raises(RuntimeError, match="native"):
        c.flush()
    assert oracle_spies == []
