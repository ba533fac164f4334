# Copied from bzip2_tpu/tracing.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""Tracing / observability (reference §5: verbosity levels 0-4 plumbed to
VPrintf on stderr, bzlib_private.h:97-108 + per-block diagnostics in
compress.c:259-262,304-308,544-550 and bzip2.c:381-405).

The same 0-4 verbosity contract (CLI ``-v`` repeats), structured per-block
metrics, and a ``torch.profiler`` trace hook.

  set_verbosity(2)                # or CLI -vv
  vlog(2, "block %d: ...", i)     # stderr, level-gated
  with profile_trace("/tmp/tr"):  # torch.profiler trace around a region
      engine.compress(...)
  m = collect()                   # drain structured per-block metrics
"""
from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def span(name: str, level: int = 3):
    """Timed region: logs at the given verbosity and records a metric."""
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        vlog(level, "    [%s] %.3fs", name, dt)
        record("span", name=name, seconds=dt)
