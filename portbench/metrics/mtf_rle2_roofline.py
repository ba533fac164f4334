"""Share of its roofline that the encoder's MTF + RLE2 step reaches
(``ops/mtf.py``: ``mtf_ranks.cu``, the ``cummax`` carries, the scatters).

Numerator: the least time the step needs for these blocks, each BWT
output byte read once and each MTF value (2 bytes: 258 symbols) and each
block's count (4 bytes) written once, over 3.35 TB/s; the bytes come from
the blocks' lengths and the step's output counts, not from any kernel's
tiling.  Denominator: the device time of every kernel launched inside
``mtf_rle2_batched``, which the benchmark wraps in a ``torch.profiler``
range (``pb.mtf_rle2``).  Calls that began in the window."""
import time


def install(probe):
    import torch
    from bzip2_tpu_torch import engine

    acc = probe.counters.setdefault("mtf_bytes", [])
    inner = engine.mtf_rle2_batched

    def mtf_rle2_batched(last_col, n, in_use):
        t0 = time.time_ns()
        with torch.profiler.record_function("pb.mtf_rle2"):
            out = inner(last_col, n, in_use)
        # summed on the device, read once the window has closed
        acc.append((t0, n.to(torch.int64).sum(), out[1].to(torch.int64).sum(),
                    int(n.shape[0])))
        return out

    engine.mtf_rle2_batched = mtf_rle2_batched


def read(probe):
    from portbench.trace import HBM_BYTES_PER_S

    rows = [a for a in probe.counters.get("mtf_bytes", [])
            if probe.in_window(a[0])]
    secs = probe.kernel_seconds_in("mtf_rle2")
    if not rows or not secs:
        return None
    nbytes = sum(int(r[1]) + 2 * int(r[2]) + 4 * r[3] for r in rows)
    return 100.0 * nbytes / HBM_BYTES_PER_S / secs
