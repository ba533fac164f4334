# Copied from bzip2_tpu/tracing.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""Tracing / observability (reference §5: verbosity levels 0-4 plumbed to
VPrintf on stderr, bzlib_private.h:97-108 + per-block diagnostics in
compress.c:259-262,304-308,544-550 and bzip2.c:381-405).

The same 0-4 verbosity contract (CLI ``-v`` repeats), structured per-block
metrics, a ``torch.profiler`` trace hook, and the program's spans.

  set_verbosity(2)                # or CLI -vv
  vlog(2, "block %d: ...", i)     # stderr, level-gated
  with profile_trace("/tmp/tr"):  # torch.profiler trace around a region
      engine.compress(...)
  m = collect()                   # drain structured per-block metrics
  enable_spans(True)              # record the program's spans
  s = spans()                     # a copy of them (not drained)

A span (``span``) is a region of the program on ``time.time_ns()``, the
clock ``torch.profiler``'s events carry, so spans and the device trace's
kernel and copy intervals can be intersected.  Each record holds ``name``,
``id``, ``parent`` (the enclosing span's id, None at a root), ``call`` (the
id of the outermost span it is nested in: one ``compress`` call's spans,
worker threads' included, share it), ``tid``, ``t0_ns``, ``t1_ns`` and the
counts given at its boundary (``bytes``, ``rows``, ...).  Nesting follows
a ``contextvars`` variable, so a thread started in a copy of its caller's
context (``contextvars.copy_context().run``) nests its spans under the
caller's open span.  Spans are off by default; off, a span that is not
``timed`` and not logged costs one flag check.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import sys
import threading
import time

_verbosity = 0
_metrics: list = []
_metrics_lock = threading.Lock()
_metrics_enabled = False


def set_verbosity(v: int) -> None:
    """0 silent .. 4 very verbose (reference cap, bzip2.c:1936)."""
    global _verbosity
    _verbosity = max(0, min(4, int(v)))


def get_verbosity() -> int:
    return _verbosity


def vlog(level: int, fmt: str, *args) -> None:
    """Level-gated stderr diagnostic (reference VPrintf semantics)."""
    if _verbosity >= level:
        sys.stderr.write((fmt % args if args else fmt) + "\n")
        sys.stderr.flush()


def enable_metrics(on: bool = True) -> None:
    global _metrics_enabled
    _metrics_enabled = on
    if on:
        with _metrics_lock:
            _metrics.clear()


def record(kind: str, **fields) -> None:
    """Append one structured metric record (per block / per batch)."""
    if _metrics_enabled:
        with _metrics_lock:
            _metrics.append({"kind": kind, "t": time.time(), **fields})


def collect() -> list:
    """Drain and return all recorded metrics."""
    with _metrics_lock:
        out = list(_metrics)
        _metrics.clear()
    return out


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` trace around a region: host activity, plus the
    card's kernels and copies when CUDA is available.  Writes one Chrome
    trace (``trace_<pid>_<ns>.json``, viewable in Perfetto or
    chrome://tracing) into ``log_dir`` when the region ends."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


_spans_on = False
_spans: list = []
_spans_lock = threading.Lock()
_span_ids = itertools.count(1)
#: (id, call) of the innermost open span of the running context
_open: contextvars.ContextVar = contextvars.ContextVar("bz_open_span",
                                                       default=None)
#: what a span that records nothing and reads no clock returns
_OFF = contextlib.nullcontext()


def enable_spans(on: bool = True) -> None:
    """Switch the span store on or off; either way it is emptied."""
    global _spans_on
    with _spans_lock:
        _spans.clear()
    _spans_on = bool(on)


def spans() -> list:
    """A copy of the span records so far (the store is not drained)."""
    with _spans_lock:
        return list(_spans)


def _profiler_range(name: str):
    """An open ``torch.profiler`` range ``bz.<name>`` when a profiler is
    active, else None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd.profiler._is_profiler_enabled:
        return None
    r = torch._C._profiler._RecordFunctionFast("bz." + name)
    r.__enter__()
    return r


class _Span:
    """One open region; ``t0_ns`` / ``t1_ns`` are its boundaries and
    ``seconds`` its length once it has ended."""

    __slots__ = ("name", "level", "log_as", "attrs", "t0_ns", "t1_ns",
                 "_rec", "_token", "_range")

    def __init__(self, name, level, log_as, attrs):
        self.name, self.level, self.log_as = name, level, log_as
        self.attrs = attrs
        self._rec = self._range = None

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def __enter__(self):
        if _spans_on:
            cur = _open.get()
            sid = next(_span_ids)
            call = sid if cur is None else cur[1]
            self._rec = {"name": self.name, "id": sid,
                         "parent": None if cur is None else cur[0],
                         "call": call, "tid": threading.get_ident()}
            self._token = _open.set((sid, call))
            self._range = _profiler_range(self.name)
        # the clock is read inside the profiler range: the span times the
        # region, not the range's own cost
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        rec = self._rec
        if rec is not None:
            _open.reset(self._token)
            rec["t0_ns"], rec["t1_ns"] = self.t0_ns, self.t1_ns
            rec.update(self.attrs)
            with _spans_lock:
                if _spans_on:
                    _spans.append(rec)
        if self.level is not None:
            name = self.log_as or self.name
            vlog(self.level, "    [%s] %.3fs", name, self.seconds)
            record("span", name=name, seconds=self.seconds)
        return False


def span(name: str, level: int | None = 3, /, *, log_as: str | None = None,
         timed: bool = False, **attrs):
    """Timed region ``name`` with the counts ``attrs`` measured at its
    boundary.  With spans on it is recorded (see the module's docstring)
    and, while a ``torch.profiler`` is active, runs inside a profiler range
    ``bz.<name>``.  ``level`` (the JAX package's contract): it is also
    logged at that verbosity and recorded as a ``span`` metric under
    ``log_as`` or ``name``; None for a program span alone (``name`` and
    ``level`` are positional, so ``level=`` is an attribute).  ``timed``: the
    clock is read even with spans off, for a caller that reads the span's
    ``t0_ns``, ``t1_ns`` or ``seconds``.  A program span with spans off
    returns a shared no-op."""
    if not _spans_on and level is None and not timed:
        return _OFF
    return _Span(name, level, log_as, attrs)
