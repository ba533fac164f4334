"""Many BWT plans on several threads at once: a stress run of the loop
graphs and plan cache of ``ops.bwt`` on the card.

    python -m bzip2_tpu_torch.tools.bwt_stress [--mode bwt|compress]
        [--threads 3] [--seconds 90] [--hang-after 240]

``--mode bwt``: each thread works on a CUDA stream of its own and calls
``ops.bwt.bwt_batched`` over (rows, width) shapes in turn, more widths than
the plan cache keeps, so that plans are made, launched and dropped on one
thread while the others capture and launch theirs.  The rows are short
periodic, constant and small-alphabet random rows of mixed lengths, so
every stage's loop runs rounds.  Every result must equal the one the first
pass made alone on one thread.

``--mode compress``: each thread calls ``bzip2_tpu_torch.compress`` on
bench-corpus slices of several sizes and levels (whole and partial
batches) with the engine's default scheduler (two device workers and host
workers), device workers only, or the fused mode, in turn; every stream
must equal ``bz2.compress``'s.

``--hang-after`` seconds after the start faulthandler prints every
thread's stack and the process exits (code 1): a run that stops is caught
with its stacks.  Prints one line a thread and a last line
``{"calls": ..., "mismatches": ..., "seconds": ...}``.
"""
from __future__ import annotations

import argparse
import bz2
import faulthandler
import json
import sys
import threading
import time

import numpy as np

WIDTHS = (4096, 6144, 8192, 12288, 16384, 24576, 32768, 49152, 65536,
          98304)
ROWS = (1, 2, 3, 5)
#: --mode compress: (bytes, level) of the slices, and the engine settings
SLICES = ((16 << 20, 9), (5 << 20, 9), (2_500_000, 1), (3 << 20, 5),
          (7 << 20, 3), (1 << 20, 7))
ENGINES = ({}, {"host_workers": 0}, {"mode": "fused", "host_workers": 0})


def make_rows(rng, B: int, N: int):
    """(B, N) uint8 rows and their lengths: periodic, constant and
    small-alphabet random rows, lengths from 1 to N."""
    arr = np.zeros((B, N), np.uint8)
    ns = np.zeros(B, np.int32)
    for j in range(B):
        n = int(rng.integers(1, N + 1)) if j % 3 else N
        kind = j % 4
        if kind == 0:
            p = int(rng.integers(1, 8))
            row = np.resize(rng.integers(0, 256, p, dtype=np.uint8), n)
        elif kind == 1:
            row = np.full(n, 0x61, np.uint8)
        else:
            row = rng.integers(0, 3, n, dtype=np.uint8)
        arr[j, :n] = row
        ns[j] = n
    return arr, ns


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("bwt", "compress"), default="bwt")
    ap.add_argument("--threads", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=90.0)
    ap.add_argument("--hang-after", type=float, default=240.0)
    ap.add_argument("--seed", type=int, default=20261017)
    args = ap.parse_args(argv)
    faulthandler.enable()
    faulthandler.dump_traceback_later(args.hang_after, exit=True)

    import torch

    from ..ops import bwt

    if not torch.cuda.is_available():
        raise SystemExit("bwt_stress needs a CUDA card")
    dev = torch.device("cuda")
    if args.mode == "compress":
        step, shapes = _compress_cases()
    else:
        step, shapes = _bwt_cases(torch, bwt, dev, args.seed)
    torch.cuda.synchronize()
    print(f"[stress] {args.mode}: {len(shapes)} cases, {args.threads} "
          f"threads, {args.seconds} s", flush=True)

    stop = time.perf_counter() + args.seconds
    calls = [0] * args.threads
    bad: list = []
    errors: list = []

    def work(i: int) -> None:
        try:
            s = torch.cuda.Stream(dev)
            order = shapes[i * 7 % len(shapes):] + shapes[:i * 7 % len(shapes)]
            j = 0
            with torch.cuda.stream(s):
                while time.perf_counter() < stop:
                    case = order[j % len(order)]
                    j += 1
                    if not step(case, s):
                        bad.append((i, case))
                    calls[i] += 1
        except BaseException as e:          # reported below
            errors.append((i, repr(e)))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(args.threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    secs = time.perf_counter() - t0
    faulthandler.cancel_dump_traceback_later()
    for i, c in enumerate(calls):
        print(f"[stress] thread {i}: {c} calls", flush=True)
    out = {"calls": sum(calls), "mismatches": len(bad), "errors": errors,
           "seconds": round(secs, 3), "plans": len(bwt._PLANS)}
    print(json.dumps(out), flush=True)
    if bad or errors:
        sys.exit(1)
    return out


def _bwt_cases(torch, bwt, dev, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    shapes = [(B, N) for N in WIDTHS for B in ROWS]
    inputs, want = {}, {}
    for B, N in shapes:
        arr, ns = make_rows(rng, B, N)
        inputs[B, N] = (torch.from_numpy(arr).to(dev),
                        torch.from_numpy(ns).to(dev))
        want[B, N] = bwt.bwt_batched(*inputs[B, N])

    def step(case, s) -> bool:
        got = bwt.bwt_batched(*inputs[case])
        s.synchronize()
        return all(torch.equal(g, w) for g, w in zip(got, want[case]))
    return step, shapes


def _compress_cases() -> tuple:
    import bzip2_tpu_torch

    from ..bench import make_corpus
    corpus = make_corpus(max(size for size, _lv in SLICES))
    want = {(size, lv): bz2.compress(corpus[:size], lv)
            for size, lv in SLICES}
    cases = [(size, lv, e) for size, lv in SLICES
             for e in range(len(ENGINES))]

    def step(case, _s) -> bool:
        size, lv, e = case
        out = bzip2_tpu_torch.compress(corpus[:size], lv, **ENGINES[e])
        return out == want[size, lv]
    return step, cases


if __name__ == "__main__":
    main()
