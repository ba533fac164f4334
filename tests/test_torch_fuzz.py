"""Single-bit-flip fuzzing of the port's decoders (the suite of
tests/test_fuzz.py:31-66): on every flip the port's host decode
(api.decompress, backend "native") gives bzip2_tpu's verdict, the same
bytes or the same error class; on a subset of flips the device decoder on
the CPU (bzip2_tpu_torch.decompress(device="cpu")) returns the exact
input or raises a BZ2Error, never wrong bytes or another exception."""
import bz2 as stdlib_bz2
import functools

import numpy as np
import pytest

import bzip2_tpu_torch
from bzip2_tpu import api as japi
from bzip2_tpu_torch import api as tapi

device_decompress = functools.partial(bzip2_tpu_torch.decompress,
                                      device="cpu")


def _verdict(fn, blob):
    try:
        return ("ok", fn(blob))
    except (japi.BZ2Error, tapi.BZ2Error) as e:
        return ("err", type(e).__name__)


def _host_verdicts_match(blob):
    got = _verdict(functools.partial(tapi.decompress, backend="native"), blob)
    exp = _verdict(functools.partial(japi.decompress, backend="native"), blob)
    assert got == exp
    return got


def _device_exact_or_error(blob, data):
    st, val = _verdict(device_decompress, blob)
    assert st == "err" or val == data


def _flip(comp, bitpos):
    comp[bitpos >> 3] ^= 0x80 >> (bitpos & 7)


def test_bitflip_fuzz(rng):
    data = bytes(rng.integers(0, 256, 4000, dtype=np.uint8))
    comp = bytearray(stdlib_bz2.compress(data, 1))
    nbits = len(comp) * 8
    positions = rng.choice(nbits, size=min(nbits, 250), replace=False)
    for k, bitpos in enumerate(positions):
        _flip(comp, bitpos)
        try:
            st, val = _host_verdicts_match(bytes(comp))
            # a flip that still decodes must decode to the original
            # (CRC collisions are the only escape)
            assert st == "err" or val == data
            if k % 10 == 0:
                _device_exact_or_error(bytes(comp), data)
        finally:
            _flip(comp, bitpos)


def test_bitflip_exhaustive_tiny():
    data = b"tiny stream for exhaustive flips"
    comp = bytearray(stdlib_bz2.compress(data, 1))
    for bitpos in range(len(comp) * 8):
        _flip(comp, bitpos)
        st, val = _host_verdicts_match(bytes(comp))
        if st == "ok":
            # header-level flips may alter the level only
            assert val == data or bitpos < 32
        if bitpos % 16 == 5:
            st, val = _verdict(device_decompress, bytes(comp))
            assert st == "err" or val == data or bitpos < 32
        _flip(comp, bitpos)


@pytest.mark.parametrize("flips", [2, 3])
def test_multi_bit_flips_level9(flips):
    """Several flips at once in a -9 stream of text: the host verdicts
    agree, the device decoder is exact or raises."""
    rng = np.random.default_rng(0xF1 + flips)
    words = [b"abcde", b"fg", b"hijklm", b"nop", b"q", b"rstuv"]
    data = b" ".join(words[i] for i in rng.integers(0, 6, 160_000))[:600_000]
    comp = stdlib_bz2.compress(data, 9)
    for _ in range(3):
        bad = bytearray(comp)
        for bitpos in rng.choice(len(comp) * 8, size=flips, replace=False):
            _flip(bad, bitpos)
        st, val = _host_verdicts_match(bytes(bad))
        assert st == "err" or val == data
        _device_exact_or_error(bytes(bad), data)


def _randomised_stream(raw: bytes) -> bytes:
    """A one-block level-1 legacy randomised stream, synthesized with the
    reference's NumPy block encoder, as tests/test_fuzz.py does."""
    from bzip2_tpu import constants as C
    from bzip2_tpu import rle1
    from bzip2_tpu.bitstream import BitWriter, splice
    from bzip2_tpu.oracle.block import encode_block
    from bzip2_tpu.rand_table import derandomise_mask

    (blk,) = rle1.encode_blocks(raw, 1)
    rdata = blk.data ^ derandomise_mask(blk.data.size).astype(np.uint8)
    in_use = np.zeros(256, bool)
    in_use[np.unique(rdata)] = True
    bits, nbits = encode_block(rle1.RLE1Block(
        data=rdata, crc=blk.crc, in_use=in_use, raw_span=blk.raw_span))
    bits = bits.copy()
    bits[80 // 8] |= 0x80 >> (80 % 8)  # the randomised bit (bit 80)
    w = BitWriter()
    for v in (C.HDR_B, C.HDR_Z, C.HDR_h, C.HDR_0 + 1):
        w.write(v, 8)
    eos = BitWriter()
    eos.write(C.EOS_MAGIC, 48)
    eos.write(blk.crc, 32)
    return splice([w.getvalue(), (bits, nbits), eos.getvalue()])[0].tobytes()


def test_randomised_block_decode(rng):
    """A legacy randomised block (no encoder emits one since 0.9.5): the
    host decoder and the device decoder (which hands it to the host) both
    decode it."""
    raw = bytes(rng.integers(32, 127, 60_000, dtype=np.uint8))
    stream = _randomised_stream(raw)
    assert stdlib_bz2.decompress(stream) == raw
    assert tapi.decompress(stream, backend="native") == raw
    assert device_decompress(stream) == raw
