"""The port's streaming, file and bzopen surfaces (bzip2_tpu_torch.stream,
.file, .compat) against bzip2_tpu's on the same seeded inputs and against
stock bzip2: the cases of tests/test_surface.py (streaming, file layer,
counters) and tests/test_compat.py.  The port encodes on backend "native"
(the engine with use_device=False) or on a "gpu" entry that is an engine
on the CPU; the reference on its "native" backend.  Every comparison is of
bytes, exactly."""
import bz2 as stdlib_bz2
import io
import os

import numpy as np
import pytest
import torch

import bzip2_tpu
import bzip2_tpu_torch
from bzip2_tpu import api as japi
from bzip2_tpu import compat as jcompat
from bzip2_tpu import stream as jstream
from bzip2_tpu_torch import api as tapi
from bzip2_tpu_torch import compat as tcompat
from bzip2_tpu_torch import decoder as dmod
from bzip2_tpu_torch import engine as teng
from bzip2_tpu_torch import native
from bzip2_tpu_torch import stream as tstream


@pytest.fixture()
def cpu_gpu_entry(monkeypatch):
    """Backend "gpu" as an engine on the CPU (every block on its device
    path), for this test only."""
    eng = teng.Engine(batch_size=2, host_workers=0, device="cpu")
    monkeypatch.setitem(tapi._BLOCK_ENCODERS, "gpu",
                        tapi._corrected(eng.encode_payloads))
    monkeypatch.setattr(tapi, "_default_backend", "gpu")
    return eng


def _chunked(comp, data, chunk):
    return b"".join(comp.compress(data[i:i + chunk])
                    for i in range(0, len(data), chunk)) + comp.flush()


# ----------------------------------------------------------- streaming ----

def test_chunked_compress_equals_oneshot(rng):
    data = rng.integers(0, 200, 700_000, dtype=np.uint8)
    # bias toward runs so boundaries get interesting
    data = np.repeat(data, rng.integers(1, 5, data.size))[:700_000].tobytes()
    one = stdlib_bz2.compress(data, 1)
    assert japi.compress(data, 1, backend="native") == one
    for chunk in (7, 1024, 65536, 300_000):
        got = _chunked(tstream.Compressor(1, backend="native"), data, chunk)
        assert got == one, f"chunk={chunk}"
    assert _chunked(jstream.Compressor(1, backend="native"), data,
                    65536) == one


def test_compressor_empty():
    out = tstream.Compressor(9, backend="native").flush()
    assert out == jstream.Compressor(9, backend="native").flush()
    assert out == stdlib_bz2.compress(b"", 9)
    assert stdlib_bz2.decompress(out) == b""


@pytest.mark.parametrize("backend", ["gpu", None])
def test_compressor_gpu_entry_on_cpu(rng, cpu_gpu_entry, backend):
    """Compressor(backend="gpu"), and one with no backend, take the
    registry's "gpu" entry; here an engine on the CPU, so every emitted
    block went through the device path."""
    data = rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes()
    teng.reset_telemetry()
    got = _chunked(tstream.Compressor(1, backend=backend), data, 1 << 20)
    assert got == stdlib_bz2.compress(data, 1)
    assert got == _chunked(jstream.Compressor(1, backend="native"), data,
                           1 << 20)
    assert teng.SHARE == {"blocks": 2, "dev_blocks": 2, "host_blocks": 0,
                          "declines": 0}


@pytest.mark.parametrize("backend,root", [
    ("native", b"ab"), ("native", b"abcab"), ("native", b"\x00\x01\x00"),
    ("gpu", b"abcab")])
def test_compressor_exactly_periodic_blocks(backend, root, request):
    """Blocks that are exactly periodic take the origPtr corrector; the
    stream must still be stock bzip2's, block by emitted block."""
    if backend == "gpu":
        request.getfixturevalue("cpu_gpu_entry")
    data = root * ((230_000 if backend == "native" else 120_000)
                   // len(root))
    got = _chunked(tstream.Compressor(1, backend=backend), data, 100_000)
    assert got == stdlib_bz2.compress(data, 1)


def test_decompressor_streaming(rng):
    data = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
    comp = stdlib_bz2.compress(data, 1)
    d, r = tstream.Decompressor(), jstream.Decompressor()
    out = b""
    for i in range(0, len(comp), 777):
        piece = d.decompress(comp[i:i + 777])
        assert piece == r.decompress(comp[i:i + 777])
        assert (d.total_in, d.total_out) == (r.total_in, r.total_out)
        out += piece
    assert out == data and d.eof and d.unused_data == b""


def test_decompressor_unused_data():
    a = stdlib_bz2.compress(b"alpha", 1)
    d = tstream.Decompressor()
    out = d.decompress(a + b"TRAILING")
    assert out == b"alpha" and d.eof and d.unused_data == b"TRAILING"
    # further input accumulates into unused_data
    assert d.decompress(b"more") == b"" and d.unused_data == b"TRAILINGmore"


@pytest.mark.parametrize("backend", [None, "native", "gpu"])
def test_decompressor_backends_read_on_host(backend, rng, monkeypatch):
    """Every backend reads through native.decode_some, never the device
    decoder."""
    calls = []
    real = native.decode_some

    def spy(*a):
        calls.append(a[1])
        return real(*a)

    def no_device(*a, **k):
        raise AssertionError("the device decoder was used")

    monkeypatch.setattr(native, "decode_some", spy)
    monkeypatch.setattr(dmod, "default_decoder", no_device)
    data = rng.integers(0, 9, 5_000, dtype=np.uint8).tobytes()
    comp = stdlib_bz2.compress(data, 1)
    d = tstream.Decompressor(backend=backend)
    out = b""
    for i in range(0, len(comp), 100):
        out += d.decompress(comp[i:i + 100])
    assert out == data and d.eof and calls


def test_decompressor_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        tstream.Decompressor(backend="bogus")


def test_corrupt_stream_errors_match_reference(rng):
    comp = stdlib_bz2.compress(rng.integers(0, 256, 50_000,
                                            dtype=np.uint8).tobytes(), 1)
    for bad in (b"not a bzip2 stream", comp[:40] + b"\xff" * 40 + comp[80:]):
        with pytest.raises(japi.BZ2Error) as ref:
            jstream.Decompressor().decompress(bad)
        with pytest.raises(tapi.BZ2Error) as got:
            tstream.Decompressor().decompress(bad)
        assert type(got.value).__name__ == type(ref.value).__name__


def test_stream_counters():
    data = b"counter test " * 40_000
    c = tstream.Compressor(1, backend="native")
    out = c.compress(data) + c.flush()
    assert out == stdlib_bz2.compress(data, 1)
    assert c.total_in == len(data) and c.total_out == len(out)
    d = tstream.Decompressor()
    raw = d.decompress(out + b"JUNK")
    assert raw == data and d.eof
    assert d.total_in == len(out) and d.total_out == len(data)
    assert d.unused_data == b"JUNK"


# ----------------------------------------------------------- file layer ----

def test_file_round_trip(tmp_path, rng):
    data = rng.integers(0, 256, 150_000, dtype=np.uint8).tobytes()
    p, q = tmp_path / "f.bz2", tmp_path / "ref.bz2"
    for opener, path in ((bzip2_tpu_torch.open, p), (bzip2_tpu.open, q)):
        with opener(path, "wb", compresslevel=1, backend="native") as f:
            for i in range(0, len(data), 10_000):
                f.write(data[i:i + 10_000])
    assert p.read_bytes() == q.read_bytes() == stdlib_bz2.compress(data, 1)
    # stdlib can read ours
    assert stdlib_bz2.open(p).read() == data
    # we can read stdlib's
    p2 = tmp_path / "g.bz2"
    p2.write_bytes(stdlib_bz2.compress(data, 5))
    with bzip2_tpu_torch.open(p2, "rb") as f:
        assert f.read() == data
    # partial reads
    with bzip2_tpu_torch.open(p, "rb") as f:
        head = f.read(100)
        rest = f.read()
        assert head + rest == data
        assert f.tell() == len(data)


def test_file_multimember(tmp_path):
    p = tmp_path / "m.bz2"
    p.write_bytes(stdlib_bz2.compress(b"one,", 1) + stdlib_bz2.compress(b"two", 2)
                  + b"\x00\x00")
    with bzip2_tpu_torch.open(p) as f, bzip2_tpu.open(p) as g:
        assert f.read() == g.read() == b"one,two"


def test_file_truncated_raises_as_reference(tmp_path, rng):
    comp = stdlib_bz2.compress(rng.integers(0, 256, 120_000,
                                            dtype=np.uint8).tobytes(), 1)
    p = tmp_path / "t.bz2"
    p.write_bytes(comp[:len(comp) // 2])
    with pytest.raises(tapi.UnexpectedEOF):
        bzip2_tpu_torch.BZ2File(p).read()
    with pytest.raises(japi.UnexpectedEOF):
        bzip2_tpu.BZ2File(p).read()


def test_file_text_mode(tmp_path):
    p = tmp_path / "t.bz2"
    with bzip2_tpu_torch.open(p, "wt", encoding="utf-8",
                              backend="native") as f:
        f.write("héllo\nwörld\n")
    with bzip2_tpu_torch.open(p, "rt", encoding="utf-8") as f:
        assert f.read() == "héllo\nwörld\n"
    with bzip2_tpu.open(p, "rt", encoding="utf-8") as f:
        assert f.read() == "héllo\nwörld\n"
    with pytest.raises(ValueError, match="text-mode"):
        bzip2_tpu_torch.open(p, "rb", encoding="utf-8")


def test_file_fileobj(cpu_gpu_entry):
    """A file object, written on the default backend ("gpu", an engine on
    the CPU here)."""
    bio = io.BytesIO()
    with bzip2_tpu_torch.open(bio, "wb", compresslevel=1) as f:
        f.write(b"through a file object")
    assert bio.getvalue() == stdlib_bz2.compress(b"through a file object", 1)
    bio.seek(0)
    with bzip2_tpu_torch.open(bio, "rb") as f:
        assert f.read() == b"through a file object"


def test_bz2file_gpu_backend_reads_through_decode_some(tmp_path, rng,
                                                       monkeypatch):
    """BZ2File(..., backend="gpu") reads with native.decode_some (the
    reference's "tpu" file silently took its pure-Python oracle)."""
    data = rng.integers(0, 256, 120_000, dtype=np.uint8).tobytes()
    p = tmp_path / "r.bz2"
    p.write_bytes(stdlib_bz2.compress(data, 1))
    calls = []
    real = native.decode_some
    monkeypatch.setattr(native, "decode_some",
                        lambda *a: calls.append(1) or real(*a))
    with bzip2_tpu_torch.BZ2File(p, "rb", backend="gpu") as f:
        assert f.read() == data
    assert calls


def test_default_backend_needs_cuda(monkeypatch, rng):
    """With nothing named, encoding and the one-shot decode are the card's:
    without CUDA they raise, and nothing falls back to the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.delitem(tapi._BLOCK_ENCODERS, "gpu", raising=False)
    monkeypatch.setattr(tapi, "_default_backend", "gpu")
    monkeypatch.setattr(dmod, "_default", None)
    data = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    with pytest.raises(RuntimeError, match="CUDA"):
        tstream.Compressor(1).compress(data * 200) + tstream.Compressor(
            1).flush()
    c = tstream.Compressor(1)
    c.compress(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        c.flush()
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.compress(data, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.decompress(stdlib_bz2.compress(data, 1))
    with pytest.raises(ValueError, match="backend"):
        tapi.compress(data, 1, backend="bogus")
    with pytest.raises(ValueError, match="backend"):
        tapi.decompress(stdlib_bz2.compress(data, 1), backend="bogus")


def test_package_exports_surfaces():
    assert bzip2_tpu_torch.BZ2Compressor is tstream.Compressor
    assert bzip2_tpu_torch.BZ2Decompressor is tstream.Decompressor
    for n in ("BZ2Error", "DataError", "DataErrorMagic", "UnexpectedEOF",
              "get_default_backend", "set_default_backend"):
        assert getattr(bzip2_tpu_torch, n) is getattr(tapi, n)
    assert tapi.get_default_backend() == "gpu"


# -------------------------------------------------------------- compat ----

@pytest.fixture()
def native_default(monkeypatch):
    """The bzopen family names no backend; encode on the host here."""
    monkeypatch.setattr(tapi, "_default_backend", "native")


def test_compat_write_read_roundtrip(tmp_path, native_default):
    payload = b"hello zlib compat layer\n" * 500
    files = {}
    for name, mod in (("port", tcompat), ("ref", jcompat)):
        p = str(tmp_path / f"{name}.bz2")
        f = mod.bzopen(p, "w7")
        assert f is not None
        assert mod.bzwrite(f, payload) == len(payload)
        assert mod.bzflush(f) == mod.BZ_OK
        mod.bzclose(f)
        files[name] = open(p, "rb").read()
    assert files["port"] == files["ref"] == stdlib_bz2.compress(payload, 7)

    f = tcompat.bzopen(str(tmp_path / "port.bz2"), "rb")
    out = b""
    while True:
        chunk = tcompat.bzread(f, 1000)
        assert chunk is not None
        if not chunk:
            break
        out += chunk
    tcompat.bzclose(f)
    assert out == payload


def test_compat_mode_parsing():
    assert tcompat.bzopen("/nonexistent/x", "q") is None   # no r/w
    assert tcompat.bzopen(None, "r") is None
    assert tcompat.bzopen("/nonexistent/x", "w0") is None  # bad level
    # read wins when both given (reference bzlib.c:1482-1483)
    f = tcompat.bzopen(os.devnull, "rw")
    assert f is not None and not f._writing
    tcompat.bzclose(f)
    for mode in ("rb", "w9", "rs", "x", "", "wr5"):
        got = tcompat._parse_mode(mode)
        assert got == jcompat._parse_mode(mode), mode


def test_compat_bzdopen(tmp_path):
    p = str(tmp_path / "y.bz2")
    open(p, "wb").write(stdlib_bz2.compress(b"abc" * 100, 1))
    fd = os.open(p, os.O_RDONLY)
    f = tcompat.bzdopen(fd, "rs")   # small-mode flag accepted
    assert tcompat.bzread(f, 10_000) == b"abc" * 100
    tcompat.bzclose(f)
    assert tcompat.bzdopen(-1, "r") is None


def test_compat_errors(tmp_path):
    p = str(tmp_path / "bad.bz2")
    open(p, "wb").write(b"not a bzip2 file at all")
    for mod in (tcompat, jcompat):
        f = mod.bzopen(p, "r")
        assert mod.bzread(f, 100) is None
        msg, code = mod.bzerror(f)
        assert code == mod.BZ_DATA_ERROR_MAGIC and "MAGIC" in msg
        mod.bzclose(f)
        # wrong-direction use
        g = mod.bzopen(p, "r")
        assert mod.bzwrite(g, b"x") == -1
        assert mod.bzerror(g)[1] == mod.BZ_PARAM_ERROR
        mod.bzclose(g)
    assert tcompat.bzlibVersion() == bzip2_tpu_torch.__version__
    assert tcompat.bzerror(None) == jcompat.bzerror(None)
