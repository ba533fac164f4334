"""The port's program spans (``tracing.span``, ``enable_spans``,
``spans``): the span tree of one hybrid compress on the CPU with two
device workers, the store off, the shared clock with ``torch.profiler``,
and the four benchmark readers that read the spans, on probes written by
hand."""
import bz2 as stdlib_bz2
import contextvars
import json
import os
import threading

import numpy as np
import pytest
import torch

import bzip2_tpu_torch
from bzip2_tpu_torch import native, tracing
from bzip2_tpu_torch import engine as teng

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ["bzip2-9.compress-text", "bzip2-1.compress-text",
         "logrotate-9.compress-logs"]
needs_native = pytest.mark.skipif(not native.available(),
                                  reason="the engine needs the native runtime")

#: a batch's children in order (one hybrid batch: four group-search rounds)
BATCH_CHILDREN = (["pack", "stage_in", "pre", "wait"]
                  + ["group_iter", "wait", "heap", "lens_in"] * 4
                  + ["post", "wait", "wait"])


@pytest.fixture(autouse=True)
def _spans_off():
    yield
    tracing.enable_spans(False)


@pytest.fixture(scope="module")
def three_blocks():
    data = np.random.default_rng(0x5BA4).integers(
        0, 256, 250_000, dtype=np.uint8).tobytes()
    assert len(teng.split_blocks(data, 1)) == 3
    return data, stdlib_bz2.compress(data, 1)


def _compress_both_workers(data, monkeypatch):
    """One hybrid compress on the CPU, one block a batch, two device
    workers; the first two batches wait for each other, so each worker
    runs one."""
    met = threading.Barrier(2, timeout=60)
    seen = []
    real = teng.Engine.encode_batch

    def both(self, level, *arrays):
        seen.append(threading.get_ident())
        if len(seen) <= 2:
            met.wait()
        return real(self, level, *arrays)

    monkeypatch.setattr(teng.Engine, "encode_batch", both)
    return bzip2_tpu_torch.compress(data, 1, device="cpu", host_workers=0,
                                    batch_size=1, pipeline=2)


def _children(spans):
    kids: dict = {}
    for s in sorted(spans, key=lambda s: (s["t0_ns"], s["id"])):
        kids.setdefault(s["parent"], []).append(s)
    return kids


@needs_native
def test_span_tree_of_a_hybrid_compress(three_blocks, monkeypatch):
    data, expect = three_blocks
    tracing.enable_spans(True)
    assert _compress_both_workers(data, monkeypatch) == expect
    spans = tracing.spans()
    kids = _children(spans)
    (root,) = kids[None]
    assert root["name"] == "compress"
    assert (root["bytes"], root["level"]) == (len(data), 1)
    assert [s["name"] for s in kids[root["id"]]] == ["split", "encode",
                                                     "patch", "frame"]
    split, encode = kids[root["id"]][:2]
    assert split["bytes"] == len(data) and encode["blocks"] == 3
    batches = [s for s in kids[encode["id"]] if s["name"] == "batch"]
    cuts = [s for s in kids[encode["id"]] if s["name"] == "payloads"]
    assert len(batches) == len(cuts) == 3 == len(kids[encode["id"]]) - 3
    assert sorted(s["first"] for s in batches) == [0, 1, 2]
    assert {s["rows"] for s in batches} == {1}
    assert {s["worker"] for s in batches} == {0, 1}
    # worker 1 runs on a thread of its own, under the caller's encode span
    assert len({s["tid"] for s in batches}) == 2
    for b in batches:
        # the payload cut follows its batch on the batch's thread, after
        # the scheduler's bookkeeping, outside the batch's span
        (cut,) = [c for c in cuts if c["first"] == b["first"]]
        assert (cut["rows"], cut["tid"]) == (b["rows"], b["tid"])
        assert cut["t0_ns"] >= b["t1_ns"]
        got = kids[b["id"]]
        assert [s["name"] for s in got] == BATCH_CHILDREN
        waits = [s["what"] for s in got if s["name"] == "wait"]
        assert waits == ["n_in_use"] + ["freq"] * 4 + ["nbits", "words"]
        assert {s["tid"] for s in got} == {b["tid"]}
        (pre,) = [s for s in got if s["name"] == "pre"]
        (bwt,) = kids[pre["id"]]
        assert (bwt["name"], bwt["rows"], bwt["width"]) == ("bwt", 1,
                                                             100_352)
        assert [s["name"] for s in kids.get(bwt["id"], [])] == ["bwt_plan"]
        assert all(s["rows"] == 6 for s in got if s["name"] == "heap")
        assert got[1]["bytes"] == 100_352 + 4 + 256 + 4     # stage_in
    # one call id for every span, worker threads' included
    assert {s["call"] for s in spans} == {root["id"]}
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["t0_ns"] <= s["t1_ns"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= p["t1_ns"]
    for sibs in kids.values():
        for a, b in zip(sibs, sibs[1:]):
            if a["tid"] == b["tid"]:
                assert a["t1_ns"] <= b["t0_ns"]


@needs_native
def test_stage_walls_come_from_the_spans(three_blocks):
    """STAGE_WALL's three stages add up to the batches' spans from the
    first ``stage_in`` to the last ``wait`` of each batch."""
    data, expect = three_blocks
    teng.reset_telemetry()
    tracing.enable_spans(True)
    eng = teng.Engine(batch_size=1, pipeline=1, host_workers=0, device="cpu")
    assert eng.compress(data, 1) == expect
    kids = _children(tracing.spans())
    want = 0
    for s in tracing.spans():
        if s["name"] == "batch":
            got = kids[s["id"]]
            want += got[-1]["t1_ns"] - got[1]["t0_ns"]
    assert set(teng.STAGE_WALL) == {"pre(bwt+mtf+hist)", "4xiter+heap",
                                    "post+fetch"}
    assert sum(teng.STAGE_WALL.values()) == pytest.approx(want / 1e9,
                                                          abs=1e-6)


@needs_native
def test_spans_off_store_empty_and_records_unchanged(three_blocks,
                                                     monkeypatch):
    data, expect = three_blocks
    tracing.enable_spans(False)
    results = []
    for on in (False, True):
        tracing.enable_metrics(True)
        try:
            tracing.enable_spans(on)
            assert _compress_both_workers(data, monkeypatch) == expect
            results.append((tracing.collect(), tracing.spans()))
        finally:
            tracing.enable_metrics(False)
    (off, off_spans), (on, on_spans) = results
    assert off_spans == [] and len(on_spans) > 3 * len(BATCH_CHILDREN)
    # a batch's record times its span, which ends before the payload cut
    secs = {r["name"]: r["seconds"] for r in on if r["kind"] == "span"}
    for b in (s for s in on_spans if s["name"] == "batch"):
        name = f"batch[{b['first']}:{b['first'] + b['rows']}]"
        assert secs[name] == (b["t1_ns"] - b["t0_ns"]) / 1e9
    # the record stream is the JAX package's, spans on or off
    for recs in (off, on):
        spans = sorted(r["name"] for r in recs if r["kind"] == "span")
        assert spans == ["batch[0:1]", "batch[1:2]", "batch[2:3]"]
        for r in recs:
            keys = {"span": ["kind", "t", "name", "seconds"],
                    "block": ["kind", "t", "index", "crc", "raw_bytes",
                              "rle1_bytes", "out_bits"]}[r["kind"]]
            assert list(r) == keys
    assert sorted(r["index"] for r in off if r["kind"] == "block") \
        == [0, 1, 2]


@needs_native
def test_round_hook_read_is_a_span_inside_pre(three_blocks, monkeypatch):
    """With ``ops.bwt.ROUND_HOOK`` set, its device read is the span
    ``round_hook``, the last child of the batch's ``pre``, after the
    ``bwt`` span of the plan and the launches."""
    from bzip2_tpu_torch.ops import bwt
    data, expect = three_blocks
    seen = []
    monkeypatch.setattr(bwt, "ROUND_HOOK", lambda *row: seen.append(row))
    tracing.enable_spans(True)
    eng = teng.Engine(batch_size=3, pipeline=1, host_workers=0, device="cpu")
    assert eng.compress(data, 1) == expect
    kids = _children(tracing.spans())
    (pre,) = [s for s in tracing.spans() if s["name"] == "pre"]
    assert [s["name"] for s in kids[pre["id"]]] == ["bwt", "round_hook"]
    bwt_span = kids[pre["id"]][0]
    assert (bwt_span["rows"], bwt_span["width"]) == (3, 100_352)
    assert [s["name"] for s in kids[bwt_span["id"]]] == ["bwt_plan"]
    assert seen


def test_span_off_reads_no_clock(monkeypatch):
    tracing.enable_spans(False)

    def no_clock():
        raise AssertionError("clock read")

    monkeypatch.setattr(tracing.time, "time_ns", no_clock)
    sp = tracing.span("x", None, bytes=1)
    assert sp is tracing.span("y", None)        # one shared no-op
    with sp:
        pass
    assert tracing.spans() == []


def test_timed_span_off_reads_the_clock_and_records_nothing():
    tracing.enable_spans(False)
    with tracing.span("x", None, timed=True) as sp:
        pass
    assert 0 <= sp.t1_ns - sp.t0_ns == round(sp.seconds * 1e9)
    assert tracing.spans() == []


def test_enable_spans_clears_and_spans_does_not_drain():
    tracing.enable_spans(True)
    with tracing.span("a", None):
        pass
    assert [s["name"] for s in tracing.spans()] == ["a"]
    assert [s["name"] for s in tracing.spans()] == ["a"]
    tracing.enable_spans(True)
    assert tracing.spans() == []


def test_threads_nest_by_context():
    """A thread run in a copy of the caller's context nests under the
    caller's open span; a thread started bare is a root of its own."""
    tracing.enable_spans(True)

    def child(name):
        with tracing.span(name, None):
            pass

    with tracing.span("root", None):
        ts = [threading.Thread(target=contextvars.copy_context().run,
                               args=(child, "copied")),
              threading.Thread(target=child, args=("bare",))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
            assert not t.is_alive()
    got = {s["name"]: s for s in tracing.spans()}
    assert got["copied"]["parent"] == got["root"]["id"]
    assert got["copied"]["call"] == got["root"]["id"]
    assert got["bare"]["parent"] is None
    assert got["bare"]["call"] == got["bare"]["id"]


def test_span_encloses_its_profiler_range():
    """Under torch.profiler a span opens the range ``bz.<name>``, on the
    same clock: its t0_ns / t1_ns enclose the range within 1 ms (the span
    is read inside the range), on the caller's thread and on a worker's.
    A span with spans off opens none."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    tracing.enable_spans(True)

    def work(name):
        with tracing.span(name, None):
            (torch.arange(1000) * 3).sum()

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        work("main_side")
        t = threading.Thread(target=contextvars.copy_context().run,
                             args=(work, "worker_side"))
        t.start()
        t.join(30)
        assert not t.is_alive()
        spans = {s["name"]: s for s in tracing.spans()}
        tracing.enable_spans(False)
        work("off_side")
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("bz.")}
    assert set(ranges) == {"bz.main_side", "bz.worker_side"}
    for name, s in spans.items():
        e = ranges["bz." + name]
        assert s["t0_ns"] - 1_000_000 <= e.start_ns() <= e.end_ns()
        assert e.end_ns() <= s["t1_ns"] + 1_000_000


# ------------------------------------------------------------ readers
def _reader(name):
    from portbench import cells
    return cells.reader(name, ROOT)


MS = 1_000_000


def _probe(spans, device=(), window=(0, 1000 * MS), mib=2.0):
    from portbench import trace
    p = trace.Probe()
    p.window_ns = window
    p.device = list(device)
    p.mib_started = mib
    p.counters["spans"] = spans
    return p


def _call(cid, t0, t1, kids=()):
    """One compress call's spans: the root and (name, tid, t0, t1, attrs)
    children, times in ms."""
    out = [{"name": "compress", "id": cid, "parent": None, "call": cid,
            "tid": 1, "t0_ns": t0 * MS, "t1_ns": t1 * MS}]
    for k, (name, tid, a, b, attrs) in enumerate(kids, 1):
        out.append({"name": name, "id": cid * 100 + k, "parent": cid,
                    "call": cid, "tid": tid, "t0_ns": a * MS,
                    "t1_ns": b * MS, **attrs})
    return out


def test_reader_split_span_ms_per_MiB():
    r = _reader("split_span_ms_per_MiB.compress")
    spans = (_call(1, 10, 400, [("split", 1, 10, 40, {"bytes": 2 ** 20})])
             + _call(2, 500, 900, [("split", 1, 500, 520,
                                    {"bytes": 2 ** 20})])
             # began before the window: not counted
             + _call(3, -50, 5, [("split", 1, -50, -10, {"bytes": 2 ** 20})]))
    assert r.read(_probe(spans)) == pytest.approx(25.0)
    assert r.read(_probe(_call(1, 10, 20))) is None
    assert r.read(_probe([])) is None


def test_reader_split_wide_pct():
    r = _reader("split_wide_pct.compress")
    spans = (_call(1, 10, 400, [("split", 1, 10, 40,
                                 {"bytes": 2 ** 20, "wide_bytes": 2 ** 20})])
             + _call(2, 500, 900, [("split", 1, 500, 520,
                                    {"bytes": 2 ** 20,
                                     "wide_bytes": 2 ** 19})])
             # began before the window: not counted
             + _call(3, -50, 5, [("split", 1, -50, -10,
                                  {"bytes": 2 ** 20, "wide_bytes": 0})]))
    assert r.read(_probe(spans)) == pytest.approx(75.0)
    # a split without the wide path records no wide_bytes: nothing to read
    assert r.read(_probe(_call(1, 10, 400, [("split", 1, 10, 40,
                                              {"bytes": 2 ** 20})]))) is None
    assert r.read(_probe(_call(1, 10, 20))) is None
    assert r.read(_probe([])) is None


def test_reader_heap_span_ms_per_MiB():
    r = _reader("heap_span_ms_per_MiB.compress")
    spans = _call(1, 10, 1200, [("heap", 2, 100, 103, {"rows": 78}),
                                ("heap", 3, 104, 105, {"rows": 78}),
                                # the call began in the window: counted
                                ("heap", 2, 1100, 1104, {"rows": 78})])
    assert r.read(_probe(spans)) == pytest.approx(4.0)
    assert r.read(_probe(spans, mib=0.0)) is None
    assert r.read(_probe(_call(1, 10, 20))) is None


def test_reader_batch_wait_ms_per_MiB():
    r = _reader("batch_wait_ms_per_MiB.compress")
    spans = _call(1, 10, 400, [("wait", 2, 100, 110, {"what": "freq"}),
                               ("wait", 3, 105, 111, {"what": "words"}),
                               ("heap", 2, 111, 150, {"rows": 6})])
    assert r.read(_probe(spans, mib=4.0)) == pytest.approx(4.0)
    assert r.read(_probe(_call(1, 10, 20))) is None


def test_reader_idle_launch_pct():
    r = _reader("idle_launch_pct.compress")
    # worker 2: batch 100-300 ms, blocked 150-200 (wait) and 220-240
    # (heap); worker 3: batch 250-350, blocked 260-350
    spans = _call(1, 10, 500, [("batch", 2, 100, 300, {}),
                               ("wait", 2, 150, 200, {}),
                               ("heap", 2, 220, 240, {}),
                               ("batch", 3, 250, 350, {}),
                               ("wait", 3, 260, 350, {})])
    # the card busy 0-120 ms and 280-1000 ms
    dev = [("k", 0, 120 * MS), ("k", 280 * MS, 1000 * MS)]
    # staging: 100-150, 200-220, 240-300 (w2), 250-260 (w3); idle there:
    # 120-150, 200-220, 240-280 = 90 ms of the 1000 ms window
    assert r.read(_probe(spans, dev)) == pytest.approx(9.0)
    assert r.read(_probe(spans, ())) is None           # no device trace
    assert r.read(_probe([], dev)) is None
    assert r.read(_probe(_call(1, 10, 20), dev)) is None


def _stage_rounds_of(monkeypatch, *readings):
    """``ops.bwt.stage_rounds`` replaced by one that returns ``readings``
    in turn."""
    from bzip2_tpu_torch.ops import bwt
    it = iter(readings)
    monkeypatch.setattr(bwt, "stage_rounds", lambda: next(it))


def test_reader_bwt_full_rounds_per_call(monkeypatch):
    r = _reader("bwt_full_rounds_per_call.compress")
    shape = {"rows": 13, "width": 900_000}
    spans = (_call(1, 10, 400, [("bwt", 2, 100, 150, shape),
                                ("bwt", 3, 120, 170, shape)])
             + _call(2, 500, 1100, [("bwt", 2, 1050, 1090, shape)])
             # began before the window: not counted
             + _call(3, -50, 5, [("bwt", 2, -40, -10, shape)]))
    _stage_rounds_of(monkeypatch, [10, 5, 0, 7, 0, 1],
                     [16, 9, 0, 12, 0, 2])
    p = _probe(spans)
    r.start(p)
    assert r.read(p) == pytest.approx(2.0)
    # no bwt span, or no counter on either side: nothing to read
    for readings, got in (([0] * 6, [3] * 6), (None, None)):
        _stage_rounds_of(monkeypatch, readings, got)
        p = _probe(_call(1, 10, 400, [("split", 1, 10, 40,
                                       {"bytes": 1})]))
        r.start(p)
        assert r.read(p) is None
    _stage_rounds_of(monkeypatch, None, None)
    p = _probe(spans)
    r.start(p)
    assert r.read(p) is None


def test_reader_bwt_full_rounds_without_stage_rounds(monkeypatch):
    """Against a program with no ``stage_rounds`` (the tree before it),
    the reader starts and reads None without raising, spans or not."""
    from bzip2_tpu_torch.ops import bwt
    r = _reader("bwt_full_rounds_per_call.compress")
    monkeypatch.delattr(bwt, "stage_rounds")
    p = _probe(_call(1, 10, 400, [("bwt", 2, 100, 150, {})]))
    r.install(p)
    r.start(p)
    assert r.read(p) is None


def _bwt_trace(ranges, kernels, mib=2.0):
    """A probe of ``pb.bwt`` ranges (tid, t0, t1) and device events
    (launching tid, launch time, device start, device end[, name]), times
    in ms; an event's tid None: launched under no CPU op (link 0)."""
    from portbench import trace
    p = trace.Probe()
    p.window_ns = (0, 1000 * MS)
    p.mib_started = mib
    p.counters["ranges"] = [("pb.bwt", tid, a * MS, b * MS)
                            for tid, a, b in ranges]
    for i, (tid, t, a, b, *name) in enumerate(kernels, 1):
        if tid is not None:
            p.cpu_ops[i] = (tid, t * MS)
        p.kernel_links.append((i if tid is not None else 0, a * MS, b * MS))
        p.device.append((name[0] if name else "k", a * MS, b * MS))
    return p


#: a kernel of a stage's WHILE body, as the profiler names it
BODY = "(anonymous namespace)::full_keys_kernel(int const*, int const*)"


def test_reader_bwt_device_ms_per_MiB():
    r = _reader("bwt_device_ms_per_MiB.compress")
    # tid 2's second range is the warm-up's; tid 3's last began after the
    # window closed, in a call begun inside it: counted
    ranges = [(2, 100, 150), (2, -20, -5), (3, 990, 1020), (3, 1030, 1040)]
    kernels = [(2, 110, 120, 130),      # counted: 10 ms
               (2, -10, -8, -2),        # the warm-up's
               (3, 1000, 1000, 1004),   # counted: 4 ms
               (3, 1035, 1036, 1037),   # counted: 1 ms
               (2, 160, 170, 200),      # outside every range
               (4, 110, 110, 140),      # another thread
               # a graph body's kernel, tied to no launch: counted by name
               (None, 0, 300, 302, BODY),
               (None, 0, -30, -25, BODY),   # the warm-up's
               # the MTF's rank kernel, tied to no launch: not the BWT's
               (None, 0, 400, 450,
                "void (anonymous namespace)::rank_kernel<4>(int const*)")]
    assert r.read(_bwt_trace(ranges, kernels)) == pytest.approx(8.5)
    assert r.read(_bwt_trace(ranges, kernels, mib=0.0)) is None
    assert r.read(_bwt_trace([], kernels)) is None
    assert r.read(_bwt_trace(ranges, [])) is None
    assert {bool(r.OWN.search(n)) for n in (
        "(anonymous namespace)::gate_kernel((anonymous namespace)::LoopT",
        "void (anonymous namespace)::rerank_scan_kernel<true>(void const*",
        "(anonymous namespace)::sort_merge_kernel(unsigned long const*",
        "(anonymous namespace)::tail_rerank_kernel(int const*, int const*")
    } == {True}


def test_reader_bwt_device_wraps_bwt_batched_in_a_range(monkeypatch):
    """``install`` runs the engine's ``bwt_batched`` inside the profiler
    range ``pb.bwt`` and returns what it returns."""
    from torch.profiler import ProfilerActivity, profile
    from portbench import trace
    monkeypatch.setattr(teng, "bwt_batched",
                        lambda blocks, n: (torch.arange(4) * 2).sum())
    _reader("bwt_device_ms_per_MiB.compress").install(trace.Probe())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert int(teng.bwt_batched(None, None)) == 12
    assert "pb.bwt" in {e.name() for e in
                        prof.profiler.kineto_results.events()}


@pytest.mark.parametrize("name", ["split_span_ms_per_MiB.compress",
                                  "heap_span_ms_per_MiB.compress",
                                  "batch_wait_ms_per_MiB.compress",
                                  "idle_launch_pct.compress",
                                  "bwt_full_rounds_per_call.compress"])
def test_reader_without_program_spans(name, monkeypatch):
    """Against a program with no span store (the tree before it), the
    reader installs, starts and reads None without raising."""
    from portbench import trace
    r = _reader(name)
    monkeypatch.delattr(tracing, "enable_spans")
    monkeypatch.delattr(tracing, "spans")
    p = trace.Probe()
    p.window_ns = (0, 10)
    p.device = [("k", 0, 5)]
    p.mib_started = 1.0
    r.install(p)
    r.start(p)
    assert r.read(p) is None


def test_readers_start_empties_the_store():
    r = _reader("split_span_ms_per_MiB.compress")
    p = _probe(None)
    del p.counters["spans"]
    r.install(p)
    with tracing.span("compress", None):
        pass
    r.start(p)
    assert tracing.spans() == []


def test_every_per_layer_metric_has_a_reader():
    """BENCHMARK.json's thirteen per-layer metrics, each found by name,
    and the five program-span metrics in the three compress cells."""
    from portbench import cells
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    names = [m["name"] for m in bench["per_layer"]]
    assert len(names) == 13
    for n in names:
        assert callable(cells.reader(n, ROOT).read)
    spans = [m for m in bench["per_layer"] if m["source"] == "program_span"
             and m["name"] != "rows_per_batch.compress"]
    assert len(spans) == 5
    for m in spans:
        assert m["workloads"] == CELLS and m["moves"] == "compress_MBps"


# ------------------------------------------------------------ span_idle
def _tool():
    from bzip2_tpu_torch.tools import span_idle
    return span_idle


def _sp(sid, name, parent, tid, a, b):
    return {"name": name, "id": sid, "parent": parent, "call": 1,
            "tid": tid, "t0_ns": a * MS, "t1_ns": b * MS}


def test_span_idle_names_idle_by_leaf():
    """Idle instants go to the first name of ORDER whose self time covers
    them; the part of ``pre`` after its ``round_hook`` is its own name;
    idle under no span below ``compress`` is listed with its long gaps."""
    t = _tool()
    spans = [_sp(1, "compress", None, 1, 0, 100),
             _sp(2, "split", 1, 1, 0, 10),
             _sp(3, "encode", 1, 1, 10, 90),
             _sp(4, "batch", 3, 2, 10, 80),
             _sp(5, "pre", 4, 2, 10, 40),
             _sp(6, "round_hook", 5, 2, 25, 30),
             _sp(7, "wait", 4, 2, 40, 70),
             # another worker's heap overlaps the first one's wait
             _sp(8, "heap", 3, 3, 60, 75)]
    busy = [[12 * MS, 28 * MS], [45 * MS, 55 * MS]]
    got = t.idle_by_span(spans, busy, 0, 100 * MS)
    named = dict(got["idle_by_leaf_s"])
    assert named == pytest.approx({
        "split": 0.010, "heap": 0.015, "pre": 0.002,
        "pre_after_hook": 0.010, "round_hook": 0.002, "wait": 0.010,
        "batch": 0.005, "encode": 0.010, "compress": 0.010,
        t.NO_SPAN: 0.010})
    assert got["idle_s"] == pytest.approx(0.074)
    assert sum(named.values()) - named[t.NO_SPAN] == pytest.approx(0.074)
    assert got["idle_outside_spans_pct"] == pytest.approx(10.0)
    assert got["gaps_over_1ms"] == [[10.0, "encode", None]]


def test_span_idle_names_idle_under_the_bwt_first():
    """Idle under one worker's ``bwt`` and another's ``pre`` self time
    goes to ``bwt``, which comes first in ORDER."""
    t = _tool()
    assert t.ORDER.index("bwt") < t.ORDER.index("pre")
    spans = [_sp(1, "pre", None, 2, 0, 30), _sp(2, "bwt", 1, 2, 0, 20),
             _sp(3, "pre", None, 3, 10, 40)]
    got = dict(t.idle_by_span(spans, [], 0, 40 * MS)["idle_by_leaf_s"])
    assert got["bwt"] == pytest.approx(0.020)
    assert got["pre"] == pytest.approx(0.020)


def test_span_idle_self_times_without_a_hook():
    t = _tool()
    spans = [_sp(1, "pre", None, 1, 0, 10), _sp(2, "bwt_plan", 1, 1, 2, 4)]
    got = t.self_times(spans)
    assert got == {"pre": [[0, 2 * MS], [4 * MS, 10 * MS]],
                   "bwt_plan": [[2 * MS, 4 * MS]]}


def test_span_idle_launch_share_is_the_readers():
    """The tool's idle-launch share is ``idle_launch_pct.compress``'s
    arithmetic: both read the same on the same spans and device trace."""
    t = _tool()
    r = _reader("idle_launch_pct.compress")
    spans = _call(1, 10, 500, [("batch", 2, 100, 300, {}),
                               ("wait", 2, 150, 200, {}),
                               ("heap", 2, 220, 240, {}),
                               ("batch", 3, 250, 350, {}),
                               ("wait", 3, 260, 350, {})])
    dev = [("k", 0, 120 * MS), ("k", 280 * MS, 1000 * MS)]
    busy = [[a, b] for _n, a, b in dev]
    assert t.idle_launch_pct(spans, busy, 0, 1000 * MS) == pytest.approx(
        r.read(_probe(spans, dev))) == pytest.approx(9.0)


def test_span_idle_interval_arithmetic():
    t = _tool()
    assert t.union([[5, 7], [0, 2], [1, 3], [7, 8], [9, 9]]) == [[0, 3],
                                                                 [5, 8]]
    assert t.subtract([[0, 10], [20, 30]], [[2, 3], [8, 22], [29, 40]]) \
        == [[0, 2], [3, 8], [22, 29]]
    assert t.intersect([[0, 10], [20, 30]], [[5, 25]]) == [[5, 10],
                                                            [20, 25]]
    assert t.total([[0, 3], [5, 8]]) == 6
