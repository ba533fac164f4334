"""Per-stage probe of one hybrid encode batch (counterpart of
``tools/probe_stages.py``).

    python -m bzip2_tpu_torch.tools.probe_stages [--device cuda|cpu]
        [--level 9] [--blocks B] [--reps 2]

First the transfers: 4 MB host to device and back through pinned memory,
and a tiny reduce fetched to the host.  Then one real batch of ``B``
corpus blocks (default the engine's batch: 13 at -9) through the hybrid
stages: ``encode_pre``, each of the four ``group_iter`` passes with its
host heap (``native.make_code_lengths_batch``) and ``encode_post`` with
the fetch, ``--reps`` times with the first byte changed each time.  Device
times are CUDA events (the host clock on the CPU); the heap and the fetch
are host-clock walls.  The reference's pallas/xla switch has no
counterpart: the port has one kernel for each stage.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..bench import card_line, log, make_corpus, resolve_device


def _say(msg: str) -> None:
    log(f"{time.strftime('%H:%M:%S')} {msg}", "probe")


class Clock:
    """Elapsed ms between marks: CUDA events on a card, else the host
    clock."""

    def __init__(self, dev):
        import torch

        self.cuda = dev.type == "cuda"
        self.torch = torch

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def ms(self, a, b) -> float:
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b)
        return (b - a) * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--level", type=int, default=9)
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--transfer-bytes", type=int, default=4 << 20)
    args = ap.parse_args(argv)

    import torch

    from .. import constants as C
    from .. import native, rle1
    from ..engine import (Engine, _block_pad_size, _fetch, _words_for,
                          batch_arrays, encode_post, encode_pre,
                          stage_from_numpy)
    from ..ops.groupsearch import group_iter

    dev = resolve_device(args.device)
    clk = Clock(dev)
    _say(f"card: {card_line(dev)}")
    res: dict = {}

    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, args.transfer_bytes, dtype=np.uint8))
    back = torch.empty_like(x)
    if dev.type == "cuda":
        x, back = x.pin_memory(), back.pin_memory()
    for rep in range(2):            # the first pays the first-use costs
        a = clk.mark()
        xd = x.to(dev, non_blocking=True)
        b = clk.mark()
        back.copy_(xd, non_blocking=True)
        c = clk.mark()
        v = int(xd.to(torch.int32).sum().item())
        d = clk.mark()
        res["h2d_ms"], res["d2h_ms"], res["reduce_ms"] = (
            clk.ms(a, b), clk.ms(b, c), clk.ms(c, d))
        _say(f"rep{rep}: h2d {args.transfer_bytes} B {res['h2d_ms']:.4f} ms, "
             f"d2h {res['d2h_ms']:.4f} ms, tiny reduce+fetch "
             f"{res['reduce_ms']:.4f} ms (v={v})")

    level = args.level
    eng = Engine(host_workers=0, device=dev)
    bsz = args.blocks or eng._batch_size_for(level)
    N = _block_pad_size(level)
    data = make_corpus((bsz + 1) * 100_000 * level)
    blocks = rle1.encode_blocks(data, level)[:bsz]
    arr, ns, uses, crcs = batch_arrays(blocks, bsz, N)
    _say(f"batch {bsz} x {N} at -{level}")
    A = C.MAX_ALPHA_SIZE
    for rep in range(args.reps):
        arr[0, 0] = (int(arr[0, 0]) + 1) % 256     # a new input each rep
        t0 = time.perf_counter()
        a = clk.mark()
        bt, nt, ut, ct = stage_from_numpy((arr, ns, uses, crcs), dev)
        (mtfv, n_mtf, n_in_use, orig_ptr, n_groups, lens, hist,
         inval) = encode_pre(bt, nt, ut)
        b = clk.mark()
        alpha6 = np.repeat(n_in_use.cpu().numpy() + 2, 6).astype(np.int32)
        res["pre_ms"] = clk.ms(a, b)
        _say(f"rep{rep} encode_pre (bwt+mtf+hist): {res['pre_ms']:.3f} ms")
        iters = []
        selectors = None
        for it in range(C.N_ITERS):
            a = clk.mark()
            selectors, freq6 = group_iter(hist, lens, inval)
            b = clk.mark()
            freq = freq6.cpu().numpy().reshape(bsz * 6, A)
            th = time.perf_counter()
            lens_np = native.make_code_lengths_batch(freq, alpha6)
            heap = (time.perf_counter() - th) * 1e3
            lens = torch.from_numpy(lens_np.reshape(bsz, 6, A)).to(dev)
            iters.append((clk.ms(a, b), heap))
            _say(f"rep{rep} iter{it}: group_iter {iters[-1][0]:.3f} ms, "
                 f"host heap {heap:.3f} ms")
        res["iters_ms"] = iters
        a = clk.mark()
        words, nbits = encode_post(mtfv, n_mtf, n_in_use, ut, ct, orig_ptr,
                                   n_groups, selectors, lens, _words_for(N))
        b = clk.mark()
        tf = time.perf_counter()
        _fetch(words, nbits)
        res["post_ms"] = clk.ms(a, b)
        res["fetch_ms"] = (time.perf_counter() - tf) * 1e3
        res["total_ms"] = (time.perf_counter() - t0) * 1e3
        _say(f"rep{rep} encode_post: {res['post_ms']:.3f} ms, fetch "
             f"{res['fetch_ms']:.3f} ms, TOTAL {res['total_ms']:.3f} ms "
             "(host clock)")
    return res


if __name__ == "__main__":
    main()
