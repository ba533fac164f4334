"""The card's idle time under the program's spans: where a closed loop of
compress calls leaves the card idle, named by what the host was doing.

    python -m bzip2_tpu_torch.tools.span_idle [FILE] [--level 9]
        [--seconds 51] [--object-mib 16] [--round-hook]
        [--host-workers 0] [--device cuda|cpu]

One client compresses FILE (default: ``--object-mib`` MiB of the bench
corpus) cut into objects of ``--object-mib`` MiB, one after another and
round the pool, through ``bzip2_tpu_torch.compress(obj, level,
host_workers=..., device=...)``: after one warm-up call (checked against
``bz2.compress``), for ``--seconds`` seconds with the program's spans on
(``tracing.enable_spans``) and the whole loop under ``torch.profiler``
(every thread).  The window runs from the first timed call's start to the
last one's end.  ``--round-hook`` sets ``ops.bwt.ROUND_HOOK`` (a counter),
as a traced benchmark run does: one device read a ``bwt_batched`` call,
the span ``round_hook`` inside ``pre``.

The idle time (the window less the union of the card's kernel and copy
intervals) is named by the spans' self times (a span's interval less its
children's, on any thread): an idle instant goes to the first name of
``ORDER`` whose self time covers it (host work, then plan and graph
builds, launches, device waits, then the spans that enclose others).  The
part of ``pre`` after its ``round_hook`` child is ``pre_after_hook``: the
hook's read has drained the card's queue, so the launches that follow run
against an idle card.  What no span below ``compress`` covers is listed
as such, with its gaps over 1 ms.  One JSON line: the card, the calls and
MB/s, window, busy and idle seconds, ``idle_by_leaf_s``,
``idle_outside_spans_pct`` (idle under no span below ``compress``, % of
the window), the host's self seconds of each span name, the idle share
under a ``batch`` span but no ``wait`` or ``heap`` span
(``idle_launch_pct``, the benchmark's ``idle_launch_pct.compress``
arithmetic), the ``wait`` spans' ms a MiB, and the ``bwt_plan`` and
``bwt_graph`` spans of the warm-up (count, seconds).  On the CPU the
device figures are "not measured (cpu)".
"""
from __future__ import annotations

import argparse
import bz2
import json
import time

from ..bench import card_line, log, make_corpus, resolve_device

#: the names that idle instants go to, first match wins; a span name not
#: listed comes after them
ORDER = ("split", "frame", "patch", "heap", "pack", "payloads", "host_block",
         "bwt_plan", "bwt_graph", "stage_in", "lens_in", "pre",
         "pre_after_hook", "group_iter", "post", "round_hook", "wait",
         "batch", "encode", "compress")
NO_SPAN = "no span below compress"


# ------------------------------------------------------------ intervals
def union(iv) -> list:
    """Sorted, merged copy of [start, end) intervals."""
    out: list = []
    for a, b in sorted(iv):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def subtract(x: list, y: list) -> list:
    """x minus y, both merged."""
    out, j = [], 0
    for a, b in x:
        while j < len(y) and y[j][1] <= a:
            j += 1
        cur, k = a, j
        while k < len(y) and y[k][0] < b:
            if y[k][0] > cur:
                out.append([cur, y[k][0]])
            cur = max(cur, y[k][1])
            k += 1
        if cur < b:
            out.append([cur, b])
    return out


def intersect(x: list, y: list) -> list:
    """x and y, both merged."""
    return subtract(x, subtract(x, y))


def total(iv) -> int:
    return sum(b - a for a, b in iv)


# ------------------------------------------------------------ analysis
def self_times(spans: list) -> dict:
    """{name: merged self intervals} of every span, ``pre`` split at the
    end of its ``round_hook`` child."""
    kids: dict = {}
    for s in spans:
        kids.setdefault(s["parent"], []).append(s)
    out: dict = {}
    for s in spans:
        ch = kids.get(s["id"], [])
        own = subtract([[s["t0_ns"], s["t1_ns"]]],
                       union([[c["t0_ns"], c["t1_ns"]] for c in ch]))
        hook = [c["t1_ns"] for c in ch if c["name"] == "round_hook"]
        if s["name"] == "pre" and hook:
            cut = [[max(hook), s["t1_ns"]]]
            out.setdefault("pre_after_hook", []).extend(intersect(own, cut))
            own = subtract(own, cut)
        out.setdefault(s["name"], []).extend(own)
    return {k: union(v) for k, v in out.items()}


def idle_by_span(spans: list, busy: list, lo: int, hi: int) -> dict:
    """The idle time of the window [lo, hi) (ns) less ``busy`` (merged
    device intervals), named by the spans (see the module's docstring).
    Seconds, and the gaps over 1 ms under no span below ``compress`` (ms,
    longest first, with the names of the spans that end before and start
    after each)."""
    idle = subtract([[lo, hi]], union(busy))
    selfs = self_times(spans)
    names = list(ORDER) + sorted(set(selfs) - set(ORDER))
    rest, named = idle, []
    for name in names:
        cov = intersect(rest, selfs.get(name, []))
        if cov:
            named.append([name, total(cov) / 1e9])
            rest = subtract(rest, cov)
    below = union([[s["t0_ns"], s["t1_ns"]] for s in spans
                   if s["parent"] is not None])
    gaps = subtract(idle, below)
    named.append([NO_SPAN, total(gaps) / 1e9])
    big = sorted((g for g in gaps if g[1] - g[0] > 1_000_000),
                 key=lambda g: g[0] - g[1])
    ends = sorted((s["t1_ns"], s["name"]) for s in spans)
    starts = sorted((s["t0_ns"], s["name"]) for s in spans)
    listed = []
    for a, b in big[:8]:
        before = [n for t, n in ends if t <= a]
        after = [n for t, n in starts if t >= b]
        listed.append([(b - a) / 1e6, before[-1] if before else None,
                       after[0] if after else None])
    return {"idle_s": total(idle) / 1e9, "idle_by_leaf_s": named,
            "idle_outside_spans_pct": 100.0 * total(gaps) / (hi - lo),
            "gaps_over_1ms": listed}


def idle_launch_pct(spans: list, busy: list, lo: int, hi: int) -> float:
    """% of the window [lo, hi) in which the card is idle and some thread
    is inside a ``batch`` span but under no ``wait`` or ``heap`` span."""
    by_tid: dict = {}
    for s in spans:
        if s["name"] in ("batch", "wait", "heap"):
            part = "batch" if s["name"] == "batch" else "blocked"
            by_tid.setdefault(s["tid"], {"batch": [], "blocked": []})[
                part].append([s["t0_ns"], s["t1_ns"]])
    staging: list = []
    for iv in by_tid.values():
        staging += subtract(union(iv["batch"]), union(iv["blocked"]))
    idle = subtract([[lo, hi]], union(busy))
    return 100.0 * total(intersect(idle, union(staging))) / (hi - lo)


def device_intervals(prof) -> list:
    """The card's kernel and copy intervals (ns) of a finished profiler."""
    from torch.autograd import DeviceType

    return [[e.start_ns(), e.end_ns()]
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.name().startswith("bz.")]


# ------------------------------------------------------------ the loop
def _loop(objects, level: int, seconds: float, kw: dict) -> tuple:
    """Compress the pool round and round for ``seconds``: (calls, bytes,
    window start, window end), on ``time.time_ns()``."""
    import bzip2_tpu_torch

    calls = nbytes = 0
    lo = time.time_ns()
    stop = lo + int(seconds * 1e9)
    while calls == 0 or time.time_ns() < stop:
        obj = objects[calls % len(objects)]
        bzip2_tpu_torch.compress(obj, level, **kw)
        calls += 1
        nbytes += len(obj)
    return calls, nbytes, lo, time.time_ns()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("file", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--level", type=int, default=9)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--object-mib", type=float, default=16.0)
    ap.add_argument("--host-workers", type=int, default=0)
    ap.add_argument("--round-hook", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    from .. import tracing
    from ..ops import bwt

    dev = resolve_device(args.device)
    card = card_line(dev)
    log(f"card: {card}", "span_idle")
    size = int(args.object_mib * 2 ** 20)
    if args.file is None:
        data = make_corpus(size)
    else:
        with open(args.file, "rb") as fh:
            data = fh.read()
    objects = [data[i:i + size] for i in range(0, len(data), size)]
    kw = {"host_workers": args.host_workers, "device": str(dev)}
    rounds = [0]
    if args.round_hook:
        bwt.ROUND_HOOK = lambda stage, k, unres: rounds.__setitem__(
            0, rounds[0] + 1)
    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        tracing.enable_spans(True)
        import bzip2_tpu_torch
        if bzip2_tpu_torch.compress(objects[0], args.level, **kw) \
                != bz2.compress(objects[0], args.level):
            raise SystemExit("span_idle: the warm-up call is not exact")
        warm = tracing.spans()
        with profile(activities=acts, experimental_config=(
                _ExperimentalConfig(profile_all_threads=True))) as prof:
            if cuda:
                torch.cuda.synchronize(dev)
            tracing.enable_spans(True)
            calls, nbytes, lo, hi = _loop(objects, args.level, args.seconds,
                                          kw)
            spans = tracing.spans()
    finally:
        tracing.enable_spans(False)
        bwt.ROUND_HOOK = None
    window = (hi - lo) / 1e9
    counts: dict = {}
    for s in spans:
        counts[s["name"]] = counts.get(s["name"], 0) + 1
    res = {"card": card, "level": args.level, "calls": calls,
           "MBps": nbytes / 1e6 / window, "window_s": window,
           "round_hook": args.round_hook, "hook_reads": rounds[0],
           "self_s": {k: total(v) / 1e9
                      for k, v in sorted(self_times(spans).items())},
           "wait_ms_per_MiB": sum(s["t1_ns"] - s["t0_ns"] for s in spans
                                  if s["name"] == "wait")
           / 1e6 / (nbytes / 2 ** 20),
           "warmup_builds": {n: [sum(1 for s in warm if s["name"] == n),
                                 sum(s["t1_ns"] - s["t0_ns"] for s in warm
                                     if s["name"] == n) / 1e9]
                             for n in ("bwt_plan", "bwt_graph")},
           "span_counts": counts}
    if cuda:
        busy = union([iv for iv in device_intervals(prof)
                      if iv[1] > lo and iv[0] < hi])
        busy = [[max(a, lo), min(b, hi)] for a, b in busy]
        res["busy_s"] = total(busy) / 1e9
        res.update(idle_by_span(spans, busy, lo, hi))
        res["idle_launch_pct"] = idle_launch_pct(spans, busy, lo, hi)
    else:
        for k in ("busy_s", "idle_s", "idle_by_leaf_s",
                  "idle_outside_spans_pct", "idle_launch_pct"):
            res[k] = "not measured (cpu)"
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
