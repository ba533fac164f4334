"""The port's device decoder (bzip2_tpu_torch.decompress, decoder.py) on
the CPU against the input bytes and the host decoder's errors, on the
streams that tests/test_device_decode.py holds the JAX DeviceDecoder to."""
import bz2 as stdlib_bz2
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bzip2_tpu_torch
from bzip2_tpu import api as japi
from bzip2_tpu_torch import decoder as dmod
from bzip2_tpu_torch import native
from bzip2_tpu_torch.api import (BZ2Error, DataError, DataErrorMagic,
                                 UnexpectedEOF)
from bzip2_tpu_torch.ops import decode as TD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
decompress = functools.partial(bzip2_tpu_torch.decompress, device="cpu")
with_tail = functools.partial(bzip2_tpu_torch.decompress_with_tail,
                              device="cpu")


@pytest.fixture(autouse=True)
def _telemetry():
    dmod.reset_telemetry()
    yield


def test_level1_roundtrip(golden):
    data = golden[1][0]
    assert decompress(stdlib_bz2.compress(data, 1)) == data
    assert dmod.SHARE == {"blocks": 1, "dev_blocks": 1}
    assert set(dmod.STAGE_WALL) == set(dmod.STAGES)


@pytest.mark.parametrize("batch_size", [8, 2])
def test_multiblock_multimember(golden, batch_size):
    data = (golden[2][0] * 3)[:450_000]
    comp = stdlib_bz2.compress(data, 1)
    comp1 = stdlib_bz2.compress(b"hello device world", 1)
    dec = dmod.DeviceDecoder(batch_size=batch_size, device="cpu")
    assert dec.decompress(comp) == data
    assert dec.decompress(comp1 + comp) == b"hello device world" + data
    assert dmod.SHARE == {"blocks": 11, "dev_blocks": 11}
    assert dmod.ANOMALIES == {"lane": 0, "batch": 0}


def test_tail_and_multistream(golden):
    data = golden[1][0]
    comp = stdlib_bz2.compress(data, 1)
    out, consumed = with_tail(comp + b"garbagegarbage", multi_stream=True)
    assert out == data and consumed == len(comp)
    comp2 = stdlib_bz2.compress(b"tail member", 1)
    # the default, as for the reference's api: the first member only
    assert with_tail(comp + comp2) == (data, len(comp))
    assert with_tail(comp + comp2, multi_stream=False) == (data, len(comp))
    out, consumed = with_tail(comp + comp2, multi_stream=True)
    assert out == data + b"tail member" and consumed == len(comp) + len(comp2)
    # "BZh" with a bad level digit after a member is trailing garbage
    assert with_tail(comp + b"BZh0xxxx", multi_stream=True) == (data, len(comp))
    assert decompress(comp + comp2, multi_stream=True) == data + b"tail member"


def test_empty_member_and_stock_eos():
    for level in (1, 9):
        comp = stdlib_bz2.compress(b"", level)
        assert with_tail(comp) == (b"", len(comp))


def test_port_encoder_output(golden):
    data = golden[3][0]
    comp = bzip2_tpu_torch.compress(data, 1, batch_size=2, device="cpu")
    assert decompress(comp) == data


def _native_outcome(data):
    """The reference host decoder's bytes, or the name of its error."""
    try:
        return japi.decompress(data, backend="native")
    except japi.BZ2Error as e:
        return type(e).__name__


def _port_outcome(data):
    try:
        return decompress(data)
    except BZ2Error as e:
        return type(e).__name__


def test_corrupt_input_gives_host_errors(golden):
    data = golden[2][0][:150_000]
    comp = stdlib_bz2.compress(data, 1)
    for pos in (10, 100, 1000, len(comp) // 2, len(comp) - 5):
        bad = bytearray(comp)
        bad[pos] ^= 0x10
        assert _port_outcome(bytes(bad)) == _native_outcome(bytes(bad)), pos
    for bad, err in ((b"not a bzip2 stream at all", DataErrorMagic),
                     (b"", DataErrorMagic), (b"BZh", DataErrorMagic),
                     (b"BZh9" + b"\x00" * 20, DataError),
                     (comp[:-3], UnexpectedEOF),
                     (comp[: len(comp) // 2], UnexpectedEOF)):
        with pytest.raises(err):
            decompress(bad)
        assert _native_outcome(bad) == err.__name__


def _realistic_level9_stream(golden, n_bytes=2_030_000):
    data = ((golden[1][0] + golden[2][0] + golden[3][0]) * 8)[:n_bytes]
    return data, stdlib_bz2.compress(data, 9)


def test_level9_realistic_zero_anomalies(golden):
    data, comp = _realistic_level9_stream(golden)
    assert decompress(comp) == data
    assert dmod.ANOMALIES == {"lane": 0, "batch": 0}
    assert dmod.SHARE == {"blocks": 3, "dev_blocks": 3}


def _runs_text(seed: int, n_runs: int) -> bytes:
    """Runs of 20-250 equal bytes: RLE1 packs each into five bytes, so a
    block's output is far longer than 1.25 times its RLE1 input."""
    rng = np.random.default_rng(seed)
    return b"".join(bytes([int(v)]) * int(k) for v, k in zip(
        rng.integers(0, 256, n_runs), rng.integers(20, 250, n_runs)))


@pytest.mark.parametrize("batch_size", [8, 2])
def test_wide_rle1_lanes_decode_on_the_device(golden, batch_size):
    """Blocks whose RLE1^-1 output passes the batch's NOUT (1.25 N + 64)
    run RLE1^-1 again at their own length on the device: no host heal,
    every block from the device path, beside blocks that fit."""
    data = (golden[2][0] * 2)[:150_000] + _runs_text(5, 5000) + \
        golden[1][0][:60_000]
    comp = stdlib_bz2.compress(data, 1)
    dec = dmod.DeviceDecoder(batch_size=batch_size, device="cpu")
    assert dec.decompress(comp) == data
    assert dmod.ANOMALIES == {"lane": 0, "batch": 0}
    assert dmod.SHARE["dev_blocks"] == dmod.SHARE["blocks"] >= 2
    assert dmod.WIDE["lane"] >= 1


def test_level9_real_heal(golden, monkeypatch):
    """The real heal path: with the walk budget squeezed, wave 2 overflows
    on the ~900k blocks, the lanes flag ok False and the host heals exactly
    those blocks through native.decode_some."""
    data, comp = _realistic_level9_stream(golden)
    monkeypatch.setattr(TD, "ibwt", functools.partial(TD.ibwt, budget=2))
    assert decompress(comp) == data
    assert dmod.ANOMALIES["lane"] > 0 and dmod.ANOMALIES["batch"] == 0
    assert dmod.SHARE["blocks"] == 3
    assert dmod.SHARE["dev_blocks"] == 3 - dmod.ANOMALIES["lane"]


def test_periodic_block_healed_by_crc():
    """An exactly periodic block's successor map has many cycles; the
    splitter walk (reference and port) returns wrong bytes with ok set,
    and the block CRC sends the block to the host."""
    data = b"ab" * 30_000
    assert decompress(stdlib_bz2.compress(data, 1)) == data
    assert dmod.ANOMALIES == {"lane": 1, "batch": 0}
    assert dmod.SHARE == {"blocks": 1, "dev_blocks": 0}


def test_randomised_block_goes_to_host(monkeypatch, golden):
    """A block the light parse marks randomised (legacy) hands the member's
    remainder to the host decoder."""
    data = golden[1][0]
    comp = stdlib_bz2.compress(data, 1)
    real = native.parse_block

    def randomised(*a):
        pb, rc = real(*a)
        if pb is not None:
            pb.randomised = 1
        return pb, rc

    monkeypatch.setattr(native, "parse_block", randomised)
    assert decompress(comp) == data
    assert dmod.SHARE["blocks"] == 0


def test_device_error_propagates_without_host_fallback(golden, monkeypatch):
    """A failing device stage raises to the caller; the stream is never
    re-decoded by the whole-stream host decoder (a spy on native.decompress
    sees no call, on a failing decode and on a good one)."""
    calls = []
    real = native.decompress

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(native, "decompress", spy)
    comp = stdlib_bz2.compress(golden[1][0], 1)
    assert decompress(comp) == golden[1][0]
    assert dmod.DeviceDecoder(device="cpu").decompress(comp) == golden[1][0]

    def broken(*a, **k):
        raise RuntimeError("device stage failed")

    monkeypatch.setattr(TD, "mtf_inverse", broken)
    with pytest.raises(RuntimeError, match="device stage failed"):
        decompress(comp)
    assert calls == []


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bzip2_tpu_torch.decompress(stdlib_bz2.compress(b"x", 1))


def test_peek48():
    buf = np.frombuffer(bytes([0x31, 0x41, 0x59, 0x26, 0x53, 0x59, 0x80]),
                        np.uint8)
    assert dmod.DeviceDecoder._peek48(buf, 0) == 0x314159265359
    shifted = np.frombuffer((0x314159265359 << 4).to_bytes(7, "big"), np.uint8)
    assert dmod.DeviceDecoder._peek48(shifted, 4) == 0x314159265359
    assert dmod.DeviceDecoder._peek48(buf, 9) == -1


def test_decoder_imports_no_jax():
    code = ("import sys, bzip2_tpu_torch, bzip2_tpu_torch.decoder, "
            "bzip2_tpu_torch.ops.decode, bzip2_tpu_torch.ops.ibwt_kernel; "
            "assert 'jax' not in sys.modules, 'jax imported'; print('ok')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
