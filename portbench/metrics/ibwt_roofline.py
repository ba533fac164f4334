"""Share of its roofline that the decoder's inverse BWT reaches
(``ops.decode.ibwt``: ``ibwt_walk.cu``'s walk and tail kernels and the
torch ops around them).  Numerator: each last-column byte read once and
each output byte written once (two bytes a block byte, from the blocks'
lengths) over 3.35 TB/s.  Denominator: the device time of every kernel
launched inside ``ibwt``, which the benchmark wraps in a
``torch.profiler`` range (``pb.ibwt``).  Calls that began in the
window."""
import time


def install(probe):
    import torch
    from bzip2_tpu_torch.ops import decode

    acc = probe.counters.setdefault("ibwt_bytes", [])
    inner = decode.ibwt

    def ibwt(last, n_out, orig_ptr, *args, **kw):
        t0 = time.time_ns()
        with torch.profiler.record_function("pb.ibwt"):
            out = inner(last, n_out, orig_ptr, *args, **kw)
        acc.append((t0, n_out.to(torch.int64).sum()))
        return out

    decode.ibwt = ibwt


def read(probe):
    from portbench.trace import HBM_BYTES_PER_S

    rows = [a for a in probe.counters.get("ibwt_bytes", [])
            if probe.in_window(a[0])]
    secs = probe.kernel_seconds_in("ibwt")
    if not rows or not secs:
        return None
    nbytes = 2 * sum(int(r[1]) for r in rows)
    return 100.0 * nbytes / HBM_BYTES_PER_S / secs
