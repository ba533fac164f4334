"""The port's own host modules: isolation from the JAX package, and each
copy against its reference in bzip2_tpu on seeded inputs.

Isolation: no module of bzip2_tpu_torch (nor chip_smoke.py) imports
bzip2_tpu, jax, or the root bench.py or tools/ (the port has its own), by
an AST scan, and a fresh interpreter that imports every module of the port
and runs its CPU compress and decompress holds none of them.  Parity:
constants, CRC, RLE1 split, Huffman lengths, the periodic origPtr replay,
the block parse, the magic scans, the heal decoder, the whole-stream
decoder, the bit reader and the stream framing give the reference's
results exactly.
"""
import ast
import bz2 as stdlib_bz2
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import bzip2_tpu_torch
from bzip2_tpu import api as japi
from bzip2_tpu import bitstream as jbits
from bzip2_tpu import constants as jconst
from bzip2_tpu import crc as jcrc
from bzip2_tpu import hostmem as jhostmem
from bzip2_tpu import native as jnative
from bzip2_tpu import periodic as jper
from bzip2_tpu import rle1 as jrle1
from bzip2_tpu import tracing as jtracing
from bzip2_tpu.parallel import decode as jpdec
from bzip2_tpu_torch import api as tapi
from bzip2_tpu_torch import bitstream as tbits
from bzip2_tpu_torch import constants as tconst
from bzip2_tpu_torch import crc as tcrc
from bzip2_tpu_torch import hostmem as thostmem
from bzip2_tpu_torch import native as tnative
from bzip2_tpu_torch import periodic as tper
from bzip2_tpu_torch import rle1 as trle1
from bzip2_tpu_torch import tracing as ttracing
from bzip2_tpu_torch.parallel import decode as tpdec

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(ROOT))
                    for p in (ROOT / "bzip2_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py"]


#: top-level modules the port must not import: the JAX package, JAX, and
#: the reference's bench and tools (the port has its own)
FORBIDDEN = {"bzip2_tpu", "jax", "bench", "tools"}


def _imports_bzip2_tpu(tree: ast.AST) -> list:
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return bad


# ------------------------------------------------------------ isolation --

@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_no_bzip2_tpu(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    assert _imports_bzip2_tpu(tree) == []


def test_ast_scan_finds_a_reference_import():
    tree = ast.parse("import bzip2_tpu.api\nfrom bzip2_tpu import native\n"
                     "from bzip2_tpu_torch import api\nfrom . import rle1\n"
                     "import jax.numpy\nfrom bench import make_corpus\n"
                     "from tools import scale_bench\nfrom ..bench import log\n"
                     "from bzip2_tpu_torch.tools import bwt_stats\n")
    assert _imports_bzip2_tpu(tree) == ["bzip2_tpu.api", "bzip2_tpu",
                                        "jax.numpy", "bench", "tools"]


def test_fresh_interpreter_holds_no_reference_module():
    code = """
import bz2, json, pkgutil, sys, importlib
import bzip2_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(bzip2_tpu_torch.__path__,
                                              "bzip2_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
data = b"isolation " * 3000 + bytes(range(256)) * 40
comp = bzip2_tpu_torch.compress(data, 1, batch_size=2, device="cpu")
assert comp == bz2.compress(data, 1)
assert bzip2_tpu_torch.decompress(comp, device="cpu") == data
from bzip2_tpu_torch import api, parallel, stream
c = stream.Compressor(1, backend="native")
assert c.compress(data) + c.flush() == comp
assert api.decompress(comp, backend="native") == data
assert parallel.decode.decompress_parallel(comp * 2) == data * 2
print(json.dumps({"mods": mods, "loaded": sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "bzip2_tpu", "bench", "tools"))}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert {"bzip2_tpu_torch.api", "bzip2_tpu_torch.native",
            "bzip2_tpu_torch.parallel.decode", "bzip2_tpu_torch.decoder",
            "bzip2_tpu_torch.engine", "bzip2_tpu_torch.tracing",
            "bzip2_tpu_torch.hostmem", "bzip2_tpu_torch.ops.huffman",
            "bzip2_tpu_torch.stream", "bzip2_tpu_torch.file",
            "bzip2_tpu_torch.compat", "bzip2_tpu_torch.recover",
            "bzip2_tpu_torch.cli", "bzip2_tpu_torch.bench",
            *(f"bzip2_tpu_torch.tools.{t}" for t in (
                "scale_bench", "mesh_bench", "scaling_bench", "probe_stages",
                "profile_device", "bwt_stats", "gather_probe", "sais_probe",
                "sanitize"))} <= set(out["mods"])


def test_native_builds_from_the_port_source():
    from bzip2_tpu_torch.native import build
    assert tnative.available()
    so = build.library_path()
    assert os.path.exists(so)
    # the copy is the reference's file but for the chain-chase dispatch,
    # which the port fixed (tests/test_torch_native.py)
    port = pathlib.Path(build.SRC).read_text()
    ref = (ROOT / "bzip2_tpu" / "native" / "bz2tpu_host.cpp").read_text()
    head, tail = "template <int KN>\n", "// RLE1-expand one chased block"

    def outside(src):
        i, j = src.index(head), src.index(tail)
        return src[:i] + src[j:]

    assert outside(port) == outside(ref)
    assert "#if DEC_K" in ref and "#if DEC_K" not in port
    assert pathlib.Path(so).parent == ROOT / "build" / "bzip2_tpu_torch" / "host"
    # every export the port binds is one of the reference's
    bound = {n for n in dir(tnative) if not n.startswith("_")
             and callable(getattr(tnative, n))}
    assert "decompress" in bound
    assert bound - {"ensure_built", "ParsedBlock"} <= set(dir(jnative))


# --------------------------------------------------------------- parity --

def _inputs():
    """Seeded inputs: random bytes, text, long and short runs, empty."""
    rng = np.random.default_rng(0x4057)
    text = (ROOT / "tests" / "golden" / "sample1.ref").read_bytes()
    runs = b"".join(bytes([int(c)]) * int(k) for c, k in zip(
        rng.integers(0, 256, 400), rng.integers(1, 300, 400)))
    return {
        "random": rng.integers(0, 256, 120_000, dtype=np.uint8).tobytes(),
        "text": text,
        "runs": runs,
        "runs4": (b"aaaab" * 5000) + b"x" * 1000 + b"yyyy",
        "empty": b"",
        "one": b"z",
    }


INPUTS = _inputs()


def test_constants_match():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names and names == [n for n in dir(tconst) if n.isupper()]
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n
    for level in range(1, 10):
        assert tconst.nblock_max(level) == jconst.nblock_max(level)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_crc_matches(name):
    data = INPUTS[name]
    assert tcrc.crc32(data) == jcrc.crc32(data)
    assert tnative.crc32(data) == jcrc.crc32(data)
    inc = tcrc.CRC32()
    inc.update(data[:77])
    inc.update_repeated(0x61, 1000)
    ref = jcrc.CRC32()
    ref.update(data[:77])
    ref.update_repeated(0x61, 1000)
    assert inc.digest() == ref.digest()
    assert tcrc.crc32_slow(data[:500]) == jcrc.crc32_slow(data[:500])


def test_combined_crc_matches():
    crcs = np.random.default_rng(5).integers(0, 1 << 32, 50, dtype=np.uint64)
    crcs = [int(c) for c in crcs]
    for k in (0, 1, 2, 50):
        assert tcrc.combine_block_crcs(crcs[:k]) == \
            jcrc.combine_block_crcs(crcs[:k])


@pytest.mark.parametrize("name,level,nmax", [
    ("random", 1, None), ("text", 1, None), ("runs", 1, None),
    ("runs4", 1, 5000), ("random", 9, 20_000), ("empty", 1, None),
    ("one", 9, None)])
def test_rle1_encode_blocks_matches(name, level, nmax):
    data = INPUTS[name]
    got = trle1.encode_blocks(data, level, nmax)
    exp = jrle1.encode_blocks(data, level, nmax)
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert np.array_equal(g.data, e.data)
        assert np.array_equal(g.in_use, e.in_use)
        assert g.crc == e.crc and g.raw_span == e.raw_span
    raw = np.frombuffer(data, np.uint8)
    for g in got[:2]:
        assert np.array_equal(trle1.decode(g.data),
                              raw[g.raw_span[0]:g.raw_span[1]])


@pytest.mark.parametrize("max_freq", [3, 500, 3500])
def test_make_code_lengths_batch_matches(max_freq):
    rng = np.random.default_rng(max_freq)
    L = 12
    freqs = rng.integers(0, max_freq, (L, 258)).astype(np.int32)
    freqs[0, 5:] = 0
    alphas = rng.integers(3, 259, L).astype(np.int32)
    got = tnative.make_code_lengths_batch(freqs, alphas)
    assert np.array_equal(got, jnative.make_code_lengths_batch(freqs, alphas))
    assert got.max() <= 17


@pytest.mark.parametrize("block", [b"ab" * 300, b"abcab" * 700,
                                   b"xyz" * 2000, b"q" * 4 + b"r"])
def test_fallback_origptr_matches(block):
    d = np.frombuffer(block, np.uint8)
    assert tnative.fallback_origptr(d) == jnative.fallback_origptr(d)
    assert tper.exact_period(d) == jper.exact_period(d)
    assert tper.stock_dynamics_origptr(d) == jper.stock_dynamics_origptr(d)


def _block_starts(comp: bytes) -> list:
    starts = tpdec.find_bit_magics(comp, tconst.BLOCK_MAGIC)
    return [int(s) for s in starts]


@pytest.mark.parametrize("level", [1, 9])
def test_parse_block_matches(level):
    data = (INPUTS["text"] * 40)[:250_000] + INPUTS["random"][:60_000]
    comp = stdlib_bz2.compress(data, level)
    buf = np.frombuffer(comp, np.uint8)
    pos, n = 32, 0
    while True:
        got, grc = tnative.parse_block(buf, pos, level)
        exp, erc = jnative.parse_block(buf, pos, level)
        assert grc == erc
        if exp is None:
            break
        for f in jnative.ParsedBlock.__slots__:
            if f == "start_bit":
                continue
            assert np.array_equal(getattr(got, f), getattr(exp, f)), f
        pos, n = exp.end_bit, n + 1
    assert n == len(jrle1.encode_blocks(data, level))


@pytest.mark.parametrize("magic", ["block", "eos"])
def test_find_bit_magics_matches(magic):
    m = tconst.BLOCK_MAGIC if magic == "block" else tconst.EOS_MAGIC
    comp = stdlib_bz2.compress(INPUTS["text"] * 5, 1) + \
        stdlib_bz2.compress(INPUTS["random"], 2)
    got = tpdec.find_bit_magics(comp, m)
    assert np.array_equal(got, jpdec.find_bit_magics(comp, m))
    assert got.size >= 2
    assert tpdec.find_bit_magics(b"abc", m).size == 0


def test_decode_some_matches():
    data = INPUTS["text"] * 3
    comp = stdlib_bz2.compress(data, 1)
    buf = np.frombuffer(comp, np.uint8)
    starts = _block_starts(comp)
    got = tnative.decode_some(buf, starts[0], 1, 0)
    assert got == jnative.decode_some(buf, starts[0], 1, 0)
    assert got[0] == data and got[4] == 1
    # a truncated stream: the complete blocks, then "need more input"
    part = tnative.decode_some(buf[:len(comp) // 2], starts[0], 1, 0)
    assert part == jnative.decode_some(buf[:len(comp) // 2], starts[0], 1, 0)
    assert part[4] == 0 and data.startswith(part[0])
    bad = np.array(buf, copy=True)
    bad[len(comp) // 3] ^= 0x10
    got = tnative.decode_some(bad, starts[0], 1, 0)
    assert got == jnative.decode_some(bad, starts[0], 1, 0)
    assert got[0] is None and got[5] == tnative.BZT_DATA_ERROR


def _host_outcome(mod, blob, multi):
    try:
        return mod.decompress_with_tail(blob, multi, backend="native")
    except mod.BZ2Error as e:
        return type(e).__name__


def test_native_decompress_matches():
    """The whole-stream decoder: bytes, consumed length and error codes,
    single and multi-member, with trailing garbage, truncated and
    corrupt."""
    data = INPUTS["text"] * 3
    one = stdlib_bz2.compress(data, 1)
    two = one + stdlib_bz2.compress(INPUTS["runs"], 9)
    bad = bytearray(one)
    bad[len(one) // 3] ^= 0x10
    cases = [one, two, two + b"junk", one[:len(one) // 2], bytes(bad),
             b"not bzip2", b"", stdlib_bz2.compress(b"", 9)]
    for blob in cases:
        for multi in (False, True):
            got = tnative.decompress(blob, multi_stream=multi)
            assert got == jnative.decompress(blob, multi_stream=multi)
            assert _host_outcome(tapi, blob, multi) == _host_outcome(
                japi, blob, multi)
            if got[2] == tnative.BZT_OK:
                assert tapi.decompress_with_tail(blob, multi,
                                                 "native") == got[:2]
    assert tnative.decompress(two, True)[:2] == (data + INPUTS["runs"],
                                                 len(two))
    assert tnative.decompress(bytes(bad))[2] == tnative.BZT_DATA_ERROR


@pytest.mark.parametrize("name", ["random", "text", "one"])
def test_bitreader_matches(name):
    data = INPUTS[name]
    rng = np.random.default_rng(len(data))
    for start in (0, 3, 13):
        got, exp = tbits.BitReader(data, start), jbits.BitReader(data, start)
        for n in rng.integers(0, 33, 60):
            try:
                v = exp.read(int(n))
            except EOFError:
                with pytest.raises(EOFError):
                    got.read(int(n))
                break
            assert got.peek(int(n)) == v or int(n) == 0
            assert got.read(int(n)) == v
            assert got.pos == exp.pos
            assert got.byte_align_remainder() == exp.byte_align_remainder()


def test_bitstream_matches():
    rng = np.random.default_rng(7)
    parts = []
    for _ in range(5):
        w, r = tbits.BitWriter(), jbits.BitWriter()
        for v, n in zip(rng.integers(0, 1 << 20, 40), rng.integers(1, 21, 40)):
            w.write(int(v) & ((1 << int(n)) - 1), int(n))
            r.write(int(v) & ((1 << int(n)) - 1), int(n))
        gv, ev = w.getvalue(), r.getvalue()
        assert np.array_equal(gv[0], ev[0]) and gv[1] == ev[1]
        parts.append(gv)
    g, e = tbits.splice(parts), jbits.splice(parts)
    assert np.array_equal(g[0], e[0]) and g[1] == e[1]


def test_api_errors_keep_reference_codes():
    for n in ("BZ2Error", "DataError", "DataErrorMagic", "UnexpectedEOF"):
        assert getattr(tapi, n).code == getattr(japi, n).code
    assert issubclass(tapi.DataErrorMagic, tapi.DataError)
    assert issubclass(tapi.UnexpectedEOF, tapi.BZ2Error)


@pytest.fixture(scope="module")
def cpu_engine():
    from bzip2_tpu_torch.engine import Engine
    return Engine(batch_size=2, device="cpu")


@pytest.mark.parametrize("name,level", [("text", 1), ("runs", 2),
                                        ("empty", 9), ("one", 1)])
def test_api_compress_matches_reference(cpu_engine, name, level):
    data = INPUTS[name]
    tapi.register_block_encoder("torch-cpu", cpu_engine.encode_payloads)
    japi.register_block_encoder("torch-cpu", cpu_engine.encode_payloads)
    got = tapi.compress(data, level, backend="torch-cpu")
    assert got == stdlib_bz2.compress(data, level)
    assert got == japi.compress(data, level, backend="torch-cpu")


def test_api_compress_without_backend_raises():
    prev = tapi.get_default_backend()
    try:
        tapi.set_default_backend(None)
        with pytest.raises(ValueError, match="backend"):
            tapi.compress(b"x", 1)
        with pytest.raises(ValueError, match="level"):
            bzip2_tpu_torch.compress(b"x", 0, device="cpu")
    finally:
        tapi.set_default_backend(prev)


# ------------------------------------------------- tracing and hostmem --

@pytest.mark.parametrize("mod", [jtracing, ttracing], ids=["ref", "port"])
def test_tracing_vlog_gating(mod, capsys):
    prev = mod.get_verbosity()
    try:
        mod.set_verbosity(9)
        assert mod.get_verbosity() == 4
        mod.set_verbosity(2)
        mod.vlog(2, "block %d: %s", 7, "shown")
        mod.vlog(3, "hidden")
        mod.set_verbosity(-1)
        assert mod.get_verbosity() == 0
        mod.vlog(1, "hidden too")
    finally:
        mod.set_verbosity(prev)
    assert capsys.readouterr().err == "block 7: shown\n"


def _metrics_run(mod):
    mod.enable_metrics(True)
    try:
        mod.record("block", index=3, out_bits=99)
        with mod.span("batch[0:2]"):
            pass
        out = mod.collect()
        assert mod.collect() == []
    finally:
        mod.enable_metrics(False)
    mod.record("block", index=4)            # disabled: not recorded
    assert mod.collect() == []
    return [{k: v for k, v in r.items() if k not in ("t", "seconds")}
            for r in out], [r.get("seconds", 0.0) >= 0.0 for r in out]


def test_tracing_records_match_reference():
    got = _metrics_run(ttracing)
    assert got == _metrics_run(jtracing)
    assert got[0] == [{"kind": "block", "index": 3, "out_bits": 99},
                      {"kind": "span", "name": "batch[0:2]"}]


def test_span_logs_at_its_level(capsys):
    prev = ttracing.get_verbosity()
    try:
        ttracing.set_verbosity(3)
        with ttracing.span("stage"):
            pass
    finally:
        ttracing.set_verbosity(prev)
    assert capsys.readouterr().err.startswith("    [stage] ")


def test_profile_trace_writes_a_trace_file(tmp_path):
    import torch
    with ttracing.profile_trace(str(tmp_path / "tr")):
        (torch.arange(1000) * 3).sum()
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert trace["traceEvents"]


def test_package_exports_tracing():
    assert bzip2_tpu_torch.set_verbosity is ttracing.set_verbosity
    assert bzip2_tpu_torch.profile_trace is ttracing.profile_trace
    assert bzip2_tpu_torch.enable_metrics is ttracing.enable_metrics
    assert bzip2_tpu_torch.collect_metrics is ttracing.collect


def test_hostmem_matches_reference():
    assert thostmem.set_malloc_retention() is jhostmem.set_malloc_retention()
    assert thostmem.set_malloc_retention() is True
    for name in ("_M_MMAP_THRESHOLD", "_M_TRIM_THRESHOLD", "_MADV_HUGEPAGE",
                 "_HUGE"):
        assert getattr(thostmem, name) == getattr(jhostmem, name)
    thostmem.warm_heap(4 << 20)
    buf = np.zeros(3 << 20, np.uint8)
    thostmem.advise_hugepages(buf.ctypes.data, buf.size)
    assert not buf.any()


def test_hostmem_reads_warm_heap_env():
    code = ("import bzip2_tpu_torch.hostmem as h; "
            "print(h._done_retention)")
    env = dict(os.environ, PYTHONPATH=str(ROOT), BZ2TPU_WARM_HEAP="1048576")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "True"


@pytest.mark.parametrize("name,level", [("text", 1), ("runs", 1),
                                        ("runs4", 1), ("random", 9),
                                        ("one", 1)])
def test_native_encode_block_matches(name, level):
    for blk in trle1.encode_blocks(INPUTS[name], level)[:2]:
        got = tnative.encode_block(blk.data, blk.in_use, blk.crc)
        assert got == jnative.encode_block(blk.data, blk.in_use, blk.crc)
        assert got[1] > 0 and len(got[0]) == (got[1] + 7) // 8


def test_native_encode_block_rejects_empty_block():
    with pytest.raises(RuntimeError, match="native encode failed"):
        tnative.encode_block(np.zeros(0, np.uint8), np.zeros(256, bool), 0)
