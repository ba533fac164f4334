"""What a traced run (``--trace 1``) records, and the arithmetic that turns
it into per-layer metrics.

* Host spans: the benchmark's own wrappers around calls into the port
  (``Probe.wrap``), each a (name, thread, start, end, bytes) record on the
  host clock (``time.time_ns``, the base torch.profiler's events use).
* The device trace: ``torch.profiler`` over the window, every thread of
  the process (``profile_all_threads``), from which the kernel and copy
  intervals give the busy union, the top device operations and the idle
  gaps, and a kernel's launch is tied to the host span that launched it.
* Counters: what the port itself counts (its tracing records, the BWT's
  round hook, the decoder's tables), read by the metric readers.

The busy union is a frozen copy of ``busy_share`` in
``bzip2_tpu_torch/tools/profile_device.py`` (the union of the device's
kernel and copy intervals); the roofline constant is
``chip_smoke.py``'s (phase 3: bytes over 3.35 TB/s).
"""
from __future__ import annotations

import bisect
import threading
import time

#: H100 SXM device memory rate, bytes a second (NVIDIA's data sheet; copied
#: from chip_smoke.py's HBM_BYTES_PER_MS = 3.35e9)
HBM_BYTES_PER_S = 3.35e12

#: host activities the idle gaps are named by, first match wins; what no
#: span covers is "between_calls"
GAP_ORDER = ("split", "frame", "heap", "parse", "batch", "call")


# ---------------------------------------------------------------- intervals
def union(iv: list) -> list:
    """Sorted, merged copy of [start, end) intervals."""
    out: list = []
    for a, b in sorted(iv):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def total(iv: list) -> float:
    return float(sum(b - a for a, b in iv))


def clip(iv: list, lo, hi) -> list:
    return [[max(a, lo), min(b, hi)] for a, b in iv if b > lo and a < hi]


def intersect(x: list, y: list) -> list:
    """Intersection of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append([a, b])
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(x: list, y: list) -> list:
    """x minus y, both merged."""
    out = []
    j = 0
    for a, b in x:
        cur = a
        while j < len(y) and y[j][1] <= cur:
            j += 1
        k = j
        while k < len(y) and y[k][0] < b:
            if y[k][0] > cur:
                out.append([cur, y[k][0]])
            cur = max(cur, y[k][1])
            k += 1
        if cur < b:
            out.append([cur, b])
    return out


# ---------------------------------------------------------------- probe
class Probe:
    """Host spans, counters and (after the window) the device trace of one
    traced run.  Metric readers install wrappers on it before the warm-up
    and read from it once the window has closed."""

    def __init__(self):
        self.spans: list = []           # (name, tid, t0_ns, t1_ns, nbytes)
        self._lock = threading.Lock()
        self._wrapped: set = set()
        self.counters: dict = {}
        self.window_ns = (0, 0)
        self.device: list = []          # (name, t0_ns, t1_ns)
        self.cpu_ops: dict = {}         # correlation id -> (tid, t0_ns)
        self.kernel_links: list = []    # (linked id, t0_ns, t1_ns)
        self.mib_started = 0.0          # MiB of the calls begun in the window
        self.calls_started = 0

    def wrap(self, owner, attr: str, name: str, size=None,
             annotate: bool = False) -> None:
        """Replace ``owner.attr`` by a wrapper that records a host span
        ``name`` a call (``size(args, result)`` its bytes); with
        ``annotate`` the call also runs inside a ``torch.profiler`` range
        ``pb.<name>``, so the kernels it launches can be found.  A second
        wrap of the same attribute is a no-op."""
        key = (id(owner), attr)
        if key in self._wrapped:
            return
        self._wrapped.add(key)
        fn = getattr(owner, attr)
        spans, lock = self.spans, self._lock

        def wrapped(*args, **kw):
            t0 = time.time_ns()
            if annotate:
                import torch
                with torch.profiler.record_function("pb." + name):
                    out = fn(*args, **kw)
            else:
                out = fn(*args, **kw)
            t1 = time.time_ns()
            nb = size(args, out) if size is not None else 0
            with lock:
                spans.append((name, threading.get_ident(), t0, t1, nb))
            return out

        setattr(owner, attr, wrapped)

    def in_window(self, t_ns) -> bool:
        return self.window_ns[0] <= t_ns < self.window_ns[1]

    def window_spans(self, name: str) -> list:
        return [s for s in self.spans if s[0] == name and self.in_window(s[2])]

    def span_seconds(self, name: str) -> float:
        return sum(s[3] - s[2] for s in self.window_spans(name)) / 1e9

    def seconds_from_window(self, name: str) -> float:
        """Seconds of the spans ``name`` that began at the window's start
        or later: those of the calls begun in the window, each to its
        end."""
        return sum(s[3] - s[2] for s in self.spans
                   if s[0] == name and s[2] >= self.window_ns[0]) / 1e9

    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy(self) -> list:
        """The merged device intervals inside the window."""
        return union(clip([[a, b] for _n, a, b in self.device],
                          *self.window_ns))

    def busy_s(self) -> float:
        return total(self.busy()) / 1e9

    def kernel_seconds_in(self, name: str) -> float | None:
        """Device seconds of the kernels launched inside the profiler
        ranges ``pb.<name>`` that began in the window, on the launching
        thread; None where the trace ties no kernel to a range."""
        ranges: dict = {}
        for n, tid, a, b in self.counters.get("ranges", []):
            if n == "pb." + name and self.in_window(a):
                ranges.setdefault(tid, []).append((a, b))
        if not ranges:
            return None
        for v in ranges.values():
            v.sort()
        starts = {tid: [a for a, _ in v] for tid, v in ranges.items()}
        tot, hit = 0, 0
        for link, a, b in self.kernel_links:
            op = self.cpu_ops.get(link)
            if op is None or op[0] not in ranges:
                continue
            tid, t = op
            i = bisect.bisect_right(starts[tid], t) - 1
            if i >= 0 and t < ranges[tid][i][1]:
                tot += b - a
                hit += 1
        return tot / 1e9 if hit else None


class Session:
    """torch.profiler over a window, every thread of the process; on exit
    fills the probe's device intervals, the CPU ops' launch records and
    the ``pb.*`` ranges."""

    def __init__(self, probe: Probe):
        self.probe = probe
        self.prof = None

    def __enter__(self):
        import torch
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.cuda else [])
        self.prof = profile(activities=acts, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        self._collect()
        return False

    def _collect(self) -> None:
        from torch.autograd import DeviceType

        p = self.probe
        res = self.prof.profiler.kineto_results
        ranges = []
        for e in res.events():
            if e.device_type() == DeviceType.CPU:
                name = e.name()
                if name.startswith("pb."):
                    ranges.append((name, e.start_thread_id(), e.start_ns(),
                                   e.end_ns()))
                else:
                    p.cpu_ops[e.correlation_id()] = (e.start_thread_id(),
                                                     e.start_ns())
            elif not e.name().startswith("pb."):
                # a pb.* range's mirror on the device timeline is no work
                a, b = e.start_ns(), e.end_ns()
                p.device.append((e.name(), a, b))
                p.kernel_links.append((e.linked_correlation_id(), a, b))
        # the pb.* ranges' own ids: a kernel launched directly inside one
        # links to the range itself
        for e in res.events():
            if e.device_type() == DeviceType.CPU and e.name().startswith("pb."):
                p.cpu_ops[e.correlation_id()] = (e.start_thread_id(),
                                                 e.start_ns())
        p.counters["ranges"] = ranges
        win = [r for r in ranges if r[0] == "pb.window"]
        if win:
            p.window_ns = (win[0][2], win[0][3])


def breakdown(probe: Probe, top: int = 10) -> dict:
    """The device operations that took most time in the window, and the
    window's idle time named by what the clients' host spans were doing
    (first of GAP_ORDER that covers an idle instant), in seconds."""
    lo, hi = probe.window_ns
    by_name: dict = {}
    for n, a, b in probe.device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            by_name[n] = by_name.get(n, 0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = subtract([[lo, hi]], probe.busy())
    gaps = []
    for cat in GAP_ORDER:
        cov = intersect(idle, union([[a, b] for n, _t, a, b, _s in
                                     probe.spans if n == cat]))
        if cov:
            gaps.append((cat, total(cov) / 1e9))
            idle = subtract(idle, cov)
    gaps.append(("between_calls", total(idle) / 1e9))
    gaps = sorted(gaps, key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v / 1e9] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}
