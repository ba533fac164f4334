# Copied from bzip2_tpu/hostmem.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""Host memory policy for performance-critical paths.

Hosts that service first-touch page faults slowly (the reference measured
about 90 us a page on its VM class) run fresh memory far slower than
reused pages.  Two mitigations:

* ``set_malloc_retention()`` — raise glibc's mmap/trim thresholds so large
  numpy buffers live on the heap and freed memory is retained for reuse
  instead of being returned to the kernel (and re-faulted next batch).
* ``warm_heap(nbytes)`` — pre-fault an arena once so steady-state
  allocations never fault.  Optional for library users
  (``BZ2TPU_WARM_HEAP`` env, bytes).

The reference has no analogue (a single 7.6 MB allocation per stream,
bzlib.c:172-175); this is framework host-runtime infrastructure.
"""
from __future__ import annotations

import ctypes
import os

_done_retention = False

_M_MMAP_THRESHOLD = -3
_M_TRIM_THRESHOLD = -1


def set_malloc_retention() -> bool:
    """Keep big allocations on the (already-faulted) heap; never trim."""
    global _done_retention
    if _done_retention:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(_M_TRIM_THRESHOLD, 1 << 30)
        _done_retention = True
        return True
    except OSError:
        return False


_MADV_HUGEPAGE = 14
_HUGE = 2 << 20


def advise_hugepages(addr: int, nbytes: int) -> None:
    """MADV_HUGEPAGE the 2MB-aligned interior of [addr, addr+nbytes): where
    a transparent-huge-page fault costs about as much as a 4K one, hinting
    before first touch makes fresh memory much faster (and cuts TLB misses
    for big random-access tables)."""
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        a = (addr + _HUGE - 1) & ~(_HUGE - 1)
        end = (addr + nbytes) & ~(_HUGE - 1)
        if end > a:
            libc.madvise(ctypes.c_void_p(a), ctypes.c_size_t(end - a),
                         _MADV_HUGEPAGE)
    except OSError:
        pass


def warm_heap(nbytes: int) -> None:
    """Pre-fault ~nbytes of heap (hinted to THP, then touched; with
    retention set the pages stay resident for reuse)."""
    import numpy as np

    set_malloc_retention()
    buf = np.empty(nbytes, np.uint8)
    advise_hugepages(buf.ctypes.data, nbytes)
    buf[::4096] = 1
    del buf


_env = os.environ.get("BZ2TPU_WARM_HEAP")
if _env:
    try:
        warm_heap(int(_env))
    except (ValueError, MemoryError):
        pass
