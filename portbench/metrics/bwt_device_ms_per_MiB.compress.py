"""Device milliseconds of the BWT a MiB compressed: the card time of every
kernel and copy of ``bwt_batched`` (``ops/bwt.py``: the 16-byte key sort,
the stages' CUDA graphs of keys, ``sort_pairs`` and rerank, the
compactions and the final order) over the MiB of the calls begun in the
window (``probe.mib_started``).

An event counts if it began at the window's start or later (the warm-up
has ended by then, so it is the work of the calls begun in the window,
each to its end) and either is a kernel of ``csrc/bwt_rounds.cu`` or
``csrc/sort_pairs.cu``, which only the BWT launches, or was launched inside
the ``torch.profiler`` range ``pb.bwt`` that the benchmark wraps around
``bwt_batched``.  The names are needed because the kernels inside a graph's
WHILE node carry the correlation id of the graph's capture, made in the
warm-up, so no launch inside the range claims them.  In a traced run the
round hook's two small reads fall inside the range too (microseconds a
call).

The trace holds only the first round of each launch of a stage's WHILE
node: on an H100 it showed 16 of the 32 full-width rounds that 16 calls of
logs ran, and every tail round (one a launch there).  So the full-width
stage's second and later rounds are not in this number; their count is
``bwt_full_rounds_per_call.compress``."""
import bisect
import re

#: the kernels of bwt_rounds.cu and sort_pairs.cu, by their CUDA names
OWN = re.compile(r"::(full_keys|tail_keys|rerank_scan|rerank_scatter|"
                 r"tail_rerank|gate|sort_tile|sort_merge)_kernel[<(]")


def install(probe):
    import torch
    from bzip2_tpu_torch import engine

    inner = engine.bwt_batched

    def bwt_batched(blocks, n):
        with torch.profiler.record_function("pb.bwt"):
            return inner(blocks, n)

    engine.bwt_batched = bwt_batched


def read(probe):
    lo = probe.window_ns[0]
    ranges: dict = {}
    for name, tid, a, b in probe.counters.get("ranges", []):
        if name == "pb.bwt" and a >= lo:
            ranges.setdefault(tid, []).append((a, b))
    if not ranges or not probe.mib_started:
        return None
    for v in ranges.values():
        v.sort()
    starts = {tid: [a for a, _ in v] for tid, v in ranges.items()}

    def launched_inside(link) -> bool:
        op = probe.cpu_ops.get(link)
        if op is None or op[0] not in ranges:
            return False
        tid, t = op
        i = bisect.bisect_right(starts[tid], t) - 1
        return i >= 0 and t < ranges[tid][i][1]

    # probe.device and probe.kernel_links hold one entry per device event,
    # side by side
    ns = sum(b - a for (name, a, b), (link, _a, _b)
             in zip(probe.device, probe.kernel_links)
             if a >= lo and (OWN.search(name) or launched_inside(link)))
    return ns / 1e6 / probe.mib_started if ns else None
