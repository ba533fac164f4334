"""The port's engine end to end on the CPU: stage by stage against the JAX
hybrid stages, and whole streams against the golden files and stock
bzip2.  Every comparison is exact."""
import bz2 as stdlib_bz2
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from bzip2_tpu import api as japi
from bzip2_tpu import engine as jeng
from bzip2_tpu import native as jnative
from bzip2_tpu.constants import MAX_ALPHA_SIZE as A
from bzip2_tpu.constants import N_ITERS
from bzip2_tpu.ops.groupsearch import group_iter as jax_group_iter
from bzip2_tpu_torch import api, native, periodic, rle1
from bzip2_tpu_torch import engine as teng

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="hybrid engine needs the native runtime")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def compress():
    """api.compress through a port Engine on the CPU (2-lane batches, two
    device workers, every block on the device)."""
    eng = teng.Engine(batch_size=2, host_workers=0, device="cpu")
    api.register_block_encoder("torch-cpu", eng.encode_payloads)
    return lambda data, level: api.compress(data, level, backend="torch-cpu")


@pytest.fixture(scope="module")
def jax_stages():
    """The JAX hybrid flow on the graft example batch, kept as numpy."""
    blocks, ns, uses, crcs = graft._example_batch()
    pre = jax.jit(lambda b, n, u: jeng.encode_pre(b, n, u, use_pallas=False))(
        jnp.asarray(blocks), jnp.asarray(ns), jnp.asarray(uses))
    pre_np = tuple(np.asarray(x) for x in pre)
    hist_bf, lens, invalid = pre[6], pre[5], pre[7]
    alpha6 = np.repeat(pre_np[2] + 2, 6).astype(np.int32)
    B = blocks.shape[0]
    for _ in range(N_ITERS):
        sel, freq6 = jax_group_iter(hist_bf, lens, invalid)
        lens = jnp.asarray(jnative.make_code_lengths_batch(
            np.asarray(freq6).reshape(B * 6, A), alpha6).reshape(B, 6, A))
    n_words = jeng._words_for(blocks.shape[1])
    words, nbits = jax.jit(lambda *a: jeng.encode_post(*a, n_words=n_words))(
        pre[0], pre[1], pre[2], jnp.asarray(uses), jnp.asarray(crcs), pre[3],
        pre[4], sel, lens)
    return {"inputs": (blocks, ns, uses, crcs), "pre": pre_np,
            "selectors": np.asarray(sel), "lens": np.asarray(lens),
            "words": np.asarray(words), "nbits": np.asarray(nbits),
            "n_words": n_words}


def test_encode_pre_matches_jax(jax_stages):
    blocks, ns, uses, _ = jax_stages["inputs"]
    got = teng.encode_pre(*teng.stage_from_numpy((blocks, ns, uses), "cpu"))
    exp = teng.stage_from_numpy(jax_stages["pre"], "cpu")
    names = ("mtfv", "n_mtf", "n_in_use", "orig_ptr", "n_groups", "lens0",
             "hist", "table_invalid")
    for g, e, name in zip(got, exp, names):
        assert g.dtype == e.dtype, name
        assert torch.equal(g, e), name


def test_stage_from_numpy_dtypes(jax_stages):
    pre = teng.stage_from_numpy(jax_stages["pre"], "cpu")
    assert jax_stages["pre"][6].dtype.name == "bfloat16"
    assert pre[6].dtype == torch.float32            # hist_bf
    assert pre[7].dtype == torch.bool
    (crc,) = teng.stage_from_numpy((np.array([0xFFFFFFFF], np.uint32),), "cpu")
    assert crc.dtype == torch.int64 and crc.item() == 0xFFFFFFFF
    with pytest.raises(TypeError):
        teng.stage_from_numpy((np.zeros(2, np.complex64),), "cpu")


def test_encode_post_from_jax_stage(jax_stages):
    """JAX encode_pre + JAX refinement -> stage_from_numpy -> port post."""
    _, _, uses, crcs = jax_stages["inputs"]
    pre = teng.stage_from_numpy(jax_stages["pre"], "cpu")
    in_use, crc, sel, lens = teng.stage_from_numpy(
        (uses, crcs, jax_stages["selectors"], jax_stages["lens"]), "cpu")
    words, nbits = teng.encode_post(pre[0], pre[1], pre[2], in_use, crc,
                                    pre[3], pre[4], sel, lens,
                                    jax_stages["n_words"])
    assert np.array_equal(nbits.numpy(), jax_stages["nbits"])
    assert np.array_equal(words.numpy().astype(np.uint32), jax_stages["words"])


def test_group_iter_from_jax_stage(jax_stages):
    pre = jax_stages["pre"]
    js, jf = jax_group_iter(jnp.asarray(pre[6]), jnp.asarray(pre[5]),
                            jnp.asarray(pre[7]))
    t = teng.stage_from_numpy(pre, "cpu")
    from bzip2_tpu_torch.ops.groupsearch import group_iter
    ts, tf = group_iter(t[6], t[5], t[7])
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(tf.numpy(), np.asarray(jf))


@pytest.mark.parametrize("i,level", [(1, 1), (2, 2), (3, 3)])
def test_engine_golden_bit_exact(compress, golden, i, level):
    ref, gold = golden[i]
    assert compress(ref, level) == gold


def test_engine_one_and_a_half_blocks(compress, rng):
    data = rng.integers(0, 200, 150_000, dtype=np.uint8).tobytes()
    teng.reset_telemetry()
    out = compress(data, 1)
    assert out == stdlib_bz2.compress(data, 1)
    assert japi.decompress(out) == data
    assert teng.SHARE["dev_blocks"] == 2
    assert set(teng.STAGE_WALL) == {"pre(bwt+mtf+hist)", "4xiter+heap",
                                    "post+fetch"}


def test_engine_tiny_and_periodic(compress):
    for data in [b"x", b"ab" * 300, b"z" * 100_000, bytes(255) * 4, b"aa",
                 b"xyz" * 2000]:
        assert compress(data, 1) == stdlib_bz2.compress(data, 1)


def test_engine_padded_tail_batch(rng, monkeypatch):
    # 3 blocks at batch size 2: the tail batch runs with its one lane, no
    # dummy lane
    lanes = []
    real = teng.Engine.encode_batch

    def spy(self, level, arr, ns, uses, crcs):
        lanes.append((arr.shape[0], int(ns.min())))
        return real(self, level, arr, ns, uses, crcs)

    monkeypatch.setattr(teng.Engine, "encode_batch", spy)
    eng = teng.Engine(batch_size=2, pipeline=1, host_workers=0, device="cpu")
    data = rng.integers(0, 256, 250_000, dtype=np.uint8).tobytes()
    teng.reset_telemetry()
    assert eng.compress(data, 1) == stdlib_bz2.compress(data, 1)
    assert teng.SHARE["dev_blocks"] == 3
    assert [n for n, _ in lanes] == [2, 1]
    assert all(m > 1 for _, m in lanes)       # no 1-byte dummy block


def test_enable_gpu_backend_registers_default():
    import bzip2_tpu_torch
    prev = api.get_default_backend()
    try:
        bzip2_tpu_torch.enable_gpu_backend(batch_size=2, device="cpu")
        assert api.get_default_backend() == "gpu"
        data = b"backend registration round trip" * 10 + b"!"
        assert api.compress(data, 1) == stdlib_bz2.compress(data, 1)
    finally:
        api.set_default_backend(prev)


def test_package_compress_entry_point(rng):
    import bzip2_tpu_torch
    prev = api.get_default_backend()
    data = rng.integers(0, 200, 150_000, dtype=np.uint8).tobytes()
    teng.reset_telemetry()
    out = bzip2_tpu_torch.compress(data, 1, batch_size=2, host_workers=0,
                                   device="cpu")
    assert out == stdlib_bz2.compress(data, 1)
    assert teng.SHARE == {"blocks": 2, "dev_blocks": 2, "host_blocks": 0,
                          "declines": 0}
    assert len(teng.split_blocks(data, 1)) == 2
    assert api.get_default_backend() == prev


def _init_spy(monkeypatch):
    """Record the arguments of every Engine built, with the process's
    engine table emptied for the test."""
    made = []
    real = teng.Engine.__init__

    def spy(self, **kw):
        made.append(kw)
        real(self, **kw)

    monkeypatch.setattr(teng.Engine, "__init__", spy)
    monkeypatch.setattr(teng, "_ENGINES", {})
    return made


def test_compress_reuses_one_engine_per_arguments(monkeypatch, rng):
    """Two compress calls with the same arguments share one Engine, and its
    scheduler rates carry over: rates that make the host look far faster
    make the second call's device decline."""
    import bzip2_tpu_torch
    made = _init_spy(monkeypatch)
    data = rng.integers(0, 200, 250_000, dtype=np.uint8).tobytes()
    expect = stdlib_bz2.compress(data, 1)
    kw = dict(batch_size=1, pipeline=1, host_workers=1, device="cpu")
    assert bzip2_tpu_torch.compress(data, 1, **kw) == expect
    (eng,) = teng._ENGINES.values()
    eng._sched.update(host_done=100, host_time=0.01, dev_wall=10.0)
    teng.reset_telemetry()
    assert bzip2_tpu_torch.compress(data, 1, **dict(reversed(kw.items()))) \
        == expect
    assert made == [kw]
    assert teng.SHARE["declines"] > 0
    assert eng._sched["host_done"] > 100
    prev = api.get_default_backend()
    try:
        bzip2_tpu_torch.enable_gpu_backend(**kw)
        assert made == [kw]
        assert api.compress(data, 1) == expect
    finally:
        api.set_default_backend(prev)
    other = teng.engine_for(**dict(kw, batch_size=2))
    assert other is not eng and len(made) == 2
    assert teng.engine_for(**kw) is eng


def test_default_engine_and_register_backend(monkeypatch):
    """As the reference's: register_backend registers "gpu" without building
    an engine; the first call builds the default engine, and every later
    call and default_engine() return that one."""
    made = _init_spy(monkeypatch)
    monkeypatch.setattr(api, "_BLOCK_ENCODERS", {})
    monkeypatch.setattr(teng, "_resolve_device", lambda d: torch.device("cpu"))
    teng.register_backend()
    assert made == [] and list(api._BLOCK_ENCODERS) == ["gpu"]
    data = b"the default engine " * 700
    for _ in range(2):
        assert api.compress(data, 1, backend="gpu") == \
            stdlib_bz2.compress(data, 1)
    assert made == [{}]
    eng = teng.default_engine()
    assert eng is teng.engine_for() is teng._ENGINES[()]
    assert (eng.mode, eng.pipeline, eng.host_workers) == ("hybrid", 2, 1)
    assert len(made) == 1


ADVERSARIAL_ROOTS = [(b"aaba", 2), (b"aaba", 4), (b"babb", 3), (b"aabab", 3),
                     (b"baabb", 2), (b"aaab", 3)]


@pytest.fixture(scope="module")
def host_engine():
    """A raw block encoder that is quick on tiny inputs: the engine in
    host-only mode, whose native sorter, like the device's, needs the
    corrector on these roots."""
    return teng.Engine(use_device=False, device="cpu")


@pytest.mark.parametrize("level", [1, 9])
@pytest.mark.parametrize("root,m", ADVERSARIAL_ROOTS)
def test_registry_entry_on_periodic_blocks_equals_stock(monkeypatch,
                                                        host_engine, root, m,
                                                        level):
    """A registry entry called directly (as a stream compressor calls it)
    gives stock's payloads on exactly periodic blocks: the corrector is in
    the entry, not only in compress."""
    monkeypatch.setattr(api, "_BLOCK_ENCODERS", {})
    api.register_block_encoder("gpu", host_engine.encode_payloads)
    data = root * m
    blocks = rle1.encode_blocks(data, level)
    expect = stdlib_bz2.compress(data, level)
    # the raw payloads differ from stock: there is something to correct
    assert api.frame(blocks, host_engine.encode_payloads(blocks, level),
                     level) != expect
    payloads = api._BLOCK_ENCODERS["gpu"](blocks, level)
    assert api.frame(blocks, payloads, level) == expect


@pytest.mark.parametrize("entry", ["api.compress", "compress_with",
                                   "Engine.compress", "package compress"])
def test_corrector_runs_once_per_compress(monkeypatch, host_engine, entry):
    import bzip2_tpu_torch
    calls = []
    real = periodic.patch_payloads

    def spy(payloads, blocks, level):
        calls.append(len(blocks))
        return real(payloads, blocks, level)

    monkeypatch.setattr(periodic, "patch_payloads", spy)
    monkeypatch.setattr(api, "_BLOCK_ENCODERS", {})
    api.register_block_encoder("spy", host_engine.encode_payloads)
    data = bytes(range(256)) * 1000
    run = {"api.compress": lambda: api.compress(data, 1, backend="spy"),
           "compress_with": lambda: api.compress_with(
               host_engine.encode_payloads, data, 1),
           "Engine.compress": lambda: host_engine.compress(data, 1),
           "package compress": lambda: bzip2_tpu_torch.compress(
               data, 1, use_device=False, device="cpu")}[entry]
    assert run() == stdlib_bz2.compress(data, 1)
    assert calls == [3]


def test_batch_arrays_pads_dummy_lanes():
    blocks = teng.split_blocks(b"abcabd" * 10, 1)
    # the engine asks for exactly its blocks' lanes: no dummy lane
    arr, ns, uses, crcs = teng.batch_arrays(blocks, len(blocks), 64)
    assert arr.shape == (1, 64) and ns.tolist() == [blocks[0].data.size]
    assert uses[0].tolist() == blocks[0].in_use.tolist()
    # a wider batch pads with 1-byte blocks of 0x00
    arr, ns, uses, crcs = teng.batch_arrays(blocks, 3, 64)
    assert arr.shape == (3, 64) and arr.dtype == np.uint8
    assert ns.tolist() == [blocks[0].data.size, 1, 1]
    assert arr[0, :ns[0]].tobytes() == blocks[0].data.tobytes()
    assert not arr[1:].any() and crcs[0] == blocks[0].crc and not crcs[1:].any()
    assert uses[1:, 0].all() and uses[1:].sum() == 2


def test_engine_requires_cuda_when_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        teng.Engine(device="cuda")


def test_engine_requires_native(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        teng.Engine(device="cpu")
    with pytest.raises(RuntimeError, match="native"):
        teng.Engine(mode="fused", device="cpu")


def test_port_imports_no_jax():
    code = ("import sys, bzip2_tpu_torch, bzip2_tpu_torch.engine, "
            "bzip2_tpu_torch.ops.bwt; "
            "assert 'jax' not in sys.modules, 'jax imported'; print('ok')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
