"""Random-gather rounds on the card: the cost model of a pointer-doubling
(list-ranking) inverse BWT (counterpart of ``tools/gather_probe.py``).

    python -m bzip2_tpu_torch.tools.gather_probe [--device cuda|cpu]
        [--rows 8] [--n 1048576] [--reps 3]

On ``rows`` seeded random permutations of ``n`` (the decoder's walk
tables at -9: 8 blocks of up to 2^20), times with CUDA events (the host
clock on the CPU) a full list ranking, 20 doubling rounds of two
``torch.gather``s each (``r += r[p]; p = p[p]``), and 10 chained gathers
``r = r[p]``; each on ``--reps`` fresh inputs after one untimed call.
Prints ms a call, ns a gathered element and the bytes a gather moves over
its time.  The walk kernel itself (``csrc/ibwt_walk.cu``) follows one
chain per thread; ``chip_smoke.py`` phase 3's chase probe times that
dependent-load latency, which this probe does not replace.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..bench import card_line, log, resolve_device


def ranking(torch, p, r):
    for _ in range(20):
        r = r + torch.gather(r, 1, p)
        p = torch.gather(p, 1, p)
    return p, r


def gathers(torch, p, r):
    for _ in range(10):
        r = torch.gather(r, 1, p)
    return r


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import torch

    from .probe_stages import Clock

    dev = resolve_device(args.device)
    log(f"card: {card_line(dev)}", "gather")
    B, N = args.rows, args.n
    rng = np.random.default_rng(0)
    args_list = []
    for _ in range(args.reps):
        p = np.stack([rng.permutation(N) for _ in range(B)])
        args_list.append((torch.from_numpy(p).to(dev),
                          torch.ones((B, N), dtype=torch.int32, device=dev)))
    clk = Clock(dev)
    res = {}
    # bytes an element: a gather of r reads an int64 index and an int32
    # source and writes an int32 (16 B); one of p moves 3 int64 (24 B)
    for name, fn, n_gathers, nbytes in (
            ("20-round ranking", ranking, 40, 20 * (16 + 24)),
            ("10 gathers", gathers, 10, 10 * 16)):
        fn(torch, *args_list[0])
        ms = []
        for p, r in args_list:
            a = clk.mark()
            fn(torch, p, r)
            b = clk.mark()
            ms.append(clk.ms(a, b))
        best = min(ms)
        per = best * 1e6 / (n_gathers * B * N)
        rate = nbytes * B * N / (best * 1e-3) / 1e9
        res[name] = {"ms": ms, "ns_per_element": per, "gb_per_s": rate}
        log(f"{name} ({B}x{N}): {' '.join(f'{x:.3f}' for x in ms)} ms; "
            f"{per:.4f} ns a gathered element, {rate:.1f} GB/s moved",
            "gather")
    return res


if __name__ == "__main__":
    main()
