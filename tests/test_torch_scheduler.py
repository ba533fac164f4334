"""The port's Engine modes and its work-stealing scheduler on the CPU:
fused mode, every pipeline x host_workers combination, the ragged tail,
the adaptive handoff, host-only mode and the failure paths (the port of
tests/test_engine_failures.py:65-95, plus a device error with two device
workers).  Streams are compared with stock bzip2 and the golden files;
scheduler assertions are invariants, never which worker took which
block."""
import bz2 as stdlib_bz2
import sys
import threading

import numpy as np
import pytest
import torch

import bzip2_tpu_torch
from bzip2_tpu_torch import _build, native, tracing
from bzip2_tpu_torch import engine as teng

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="the engine needs the native runtime")


@pytest.fixture(scope="module")
def five_blocks():
    """A seeded level-1 input of 5 RLE1 blocks."""
    data = np.random.default_rng(0x5EED).integers(
        0, 256, 440_000, dtype=np.uint8).tobytes()
    assert len(teng.split_blocks(data, 1)) == 5
    return data, stdlib_bz2.compress(data, 1)


def _lane_spy(monkeypatch):
    """Record the lane count of every batch handed to Engine.encode_batch."""
    lanes = []
    real = teng.Engine.encode_batch

    def spy(self, level, arr, ns, uses, crcs):
        lanes.append(arr.shape[0])
        return real(self, level, arr, ns, uses, crcs)

    monkeypatch.setattr(teng.Engine, "encode_batch", spy)
    return lanes


def test_engine_defaults_match_the_reference():
    eng = teng.Engine(device="cpu")
    assert (eng.mode, eng.pipeline, eng.host_workers, eng.use_device,
            eng.batch_size) == ("hybrid", 2, 1, True, None)
    with pytest.raises(ValueError, match="mode"):
        teng.Engine(mode="bogus", device="cpu")


def test_fused_engine_golden_and_stock(golden, rng, monkeypatch):
    eng = teng.Engine(mode="fused", batch_size=2, pipeline=1, host_workers=0,
                      device="cpu")
    lanes = _lane_spy(monkeypatch)
    for i in (1, 2):
        ref, gold = golden[i]
        assert eng.compress(ref, i) == gold
    # 3 blocks at batch size 2: the tail batch has one lane, no dummy
    data = rng.integers(0, 230, 250_000, dtype=np.uint8).tobytes()
    teng.reset_telemetry()
    assert eng.compress(data, 1) == stdlib_bz2.compress(data, 1)
    assert lanes[-2:] == [2, 1]
    assert teng.SHARE == {"blocks": 3, "dev_blocks": 3, "host_blocks": 0,
                          "declines": 0}
    assert set(teng.STAGE_WALL) == {"fused+fetch"}


@pytest.mark.parametrize("pipeline", [1, 2])
@pytest.mark.parametrize("host_workers", [0, 1])
def test_scheduler_combinations_bit_exact(five_blocks, pipeline,
                                          host_workers):
    data, expect = five_blocks
    eng = teng.Engine(batch_size=2, pipeline=pipeline,
                      host_workers=host_workers, device="cpu")
    teng.reset_telemetry()
    assert eng.compress(data, 1) == expect
    share = dict(teng.SHARE)
    assert share["blocks"] == 5
    assert share["dev_blocks"] + share["host_blocks"] == 5
    if host_workers == 0:
        assert share["host_blocks"] == 0


def test_adaptive_handoff_declines(five_blocks):
    """Rates that make the host pool look far faster than the device: the
    device declines its batches and the host workers encode the stream."""
    data, expect = five_blocks
    eng = teng.Engine(batch_size=2, pipeline=2, host_workers=1, device="cpu")
    eng._sched.update(host_done=100, host_time=0.01, dev_wall=10.0)
    teng.reset_telemetry()
    assert eng.compress(data, 1) == expect
    assert teng.SHARE["declines"] > 0
    assert teng.SHARE["dev_blocks"] + teng.SHARE["host_blocks"] == 5


def test_host_worker_error_propagates(monkeypatch, rng):
    eng = teng.Engine(use_device=False, device="cpu")

    def boom(*a, **k):
        raise RuntimeError("injected native failure")

    monkeypatch.setattr(native, "encode_block", boom)
    data = rng.integers(97, 120, 150_000, dtype="uint8").tobytes()
    with pytest.raises(RuntimeError, match="injected native failure"):
        eng.compress(data, 1)


def test_second_device_batch_error_propagates(monkeypatch, five_blocks):
    """With two device workers, an error in the second batch leaves
    compress; nothing finishes the stream on the host."""
    data, _ = five_blocks
    eng = teng.Engine(batch_size=2, pipeline=2, host_workers=0, device="cpu")
    real = teng.Engine.encode_batch
    calls = {"n": 0}
    lock = threading.Lock()

    def flaky(self, *a):
        with lock:
            calls["n"] += 1
            n = calls["n"]
        if n == 2:
            raise RuntimeError("injected device failure")
        return real(self, *a)

    monkeypatch.setattr(teng.Engine, "encode_batch", flaky)
    teng.reset_telemetry()
    with pytest.raises(RuntimeError, match="injected device failure"):
        bzip2_tpu_torch.api.compress_with(eng.encode_payloads, data, 1)
    assert teng.SHARE["host_blocks"] == 0


@pytest.mark.parametrize("case", ["empty", "one", "ab", "run", "random"])
def test_host_only_mode_various_inputs(rng, case):
    data = {"empty": b"", "one": b"x", "ab": b"ab" * 300, "run": b"z" * 100_000,
            "random": rng.integers(0, 256, 350_000, dtype="uint8").tobytes()
            }[case]
    eng = teng.Engine(use_device=False, device="cpu")
    assert eng.compress(data, 1) == stdlib_bz2.compress(data, 1)


def test_host_only_requires_native(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        eng = teng.Engine(use_device=False, device="cpu")
        eng.compress(b"some data that makes a block", 1)


def test_host_only_touches_no_device(monkeypatch, five_blocks):
    """use_device=False launches no kernel and makes no device tensor: the
    default device "cuda" is not even checked, and the device path is
    never entered."""
    data, expect = five_blocks

    def no_device(*a, **k):
        raise AssertionError("the device path was entered")

    monkeypatch.setattr(teng.Engine, "encode_batch", no_device)
    monkeypatch.setattr(teng, "stage_from_numpy", no_device)
    _build.reset_launches()
    teng.reset_telemetry()
    cuda_before = torch.cuda.is_initialized()
    out = bzip2_tpu_torch.compress(data, 1, use_device=False)
    assert out == expect
    assert all(k.launches == 0 for k in _build.KERNELS.values())
    assert torch.cuda.is_initialized() == cuda_before
    assert teng.SHARE == {"blocks": 5, "dev_blocks": 0, "host_blocks": 5,
                          "declines": 0}


def test_scheduler_records_blocks_and_batches(five_blocks):
    data, expect = five_blocks
    eng = teng.Engine(batch_size=2, pipeline=2, host_workers=0, device="cpu")
    tracing.enable_metrics(True)
    try:
        assert eng.compress(data, 1) == expect
        recs = tracing.collect()
    finally:
        tracing.enable_metrics(False)
    blocks = sorted(r["index"] for r in recs if r["kind"] == "block")
    spans = sorted(r["name"] for r in recs if r["kind"] == "span")
    assert blocks == [0, 1, 2, 3, 4]
    assert spans == ["batch[0:2]", "batch[2:4]", "batch[4:5]"]
    assert all(r["out_bits"] > 0 for r in recs if r["kind"] == "block")


def test_telemetry_updates_lose_nothing_under_contention():
    """More threads than cores bump SHARE and STAGE_WALL with a short switch
    interval: a lost read-modify-write would show in the totals."""
    n_threads, n_adds = 16, 20000
    teng.reset_telemetry()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(n_adds):
                teng._share_add("dev_blocks")
                teng._stage_add("post+fetch", 1.0)

        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert teng.SHARE["dev_blocks"] == n_threads * n_adds
    assert teng.STAGE_WALL["post+fetch"] == float(n_threads * n_adds)
    teng.reset_telemetry()


def test_package_entry_points_pass_engine_arguments(monkeypatch):
    seen = {}
    real = teng.Engine.__init__

    def spy(self, **kw):
        seen.update(kw)
        real(self, **kw)

    monkeypatch.setattr(teng.Engine, "__init__", spy)
    monkeypatch.setattr(teng, "_ENGINES", {})
    kw = dict(mode="fused", pipeline=1, host_workers=0, use_device=True,
              batch_size=1, device="cpu")
    data = b"engine arguments " * 50
    assert bzip2_tpu_torch.compress(data, 1, **kw) == stdlib_bz2.compress(data, 1)
    assert seen == kw
    prev = bzip2_tpu_torch.api.get_default_backend()
    try:
        seen.clear()
        bzip2_tpu_torch.enable_gpu_backend(**dict(kw, use_device=False))
        assert seen == dict(kw, use_device=False)
        assert bzip2_tpu_torch.api.compress(data, 1) == \
            stdlib_bz2.compress(data, 1)
    finally:
        bzip2_tpu_torch.api.set_default_backend(prev)
