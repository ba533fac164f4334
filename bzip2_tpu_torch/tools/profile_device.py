"""Per-stage device walls on real batches (counterpart of
``tools/profile_device.py``).

    python -m bzip2_tpu_torch.tools.profile_device [STAGE ...]
        [--device cuda|cpu] [--level 9] [--reps 3] [--blocks B]
        [--bytes N]

STAGE is any of ``bwt mtf pre iter post decode encode`` (default
``encode``); several run in one process.  The stage families time
``ops.bwt.bwt_batched``, ``ops.mtf.mtf_rle2_batched``, ``encode_pre``,
``group_iter`` (with the host heap it pairs with) and ``encode_post`` on
``--reps`` disjoint batches of ``B`` corpus blocks (default the engine's
batch at the level), each after one untimed call; ``decode`` times the
device decoder on the stream of ``N`` corpus bytes (default 25 MiB)
encoded by the host engine, and ``encode`` the engine with no host worker
on ``--reps`` slices of ``N / 3`` bytes.  Walls end in a device sync.  On
a card each family's last call also runs under ``torch.profiler``, and its
device busy share (the union of its kernel and copy intervals over the
wall) is printed, and for the ``bwt`` and ``pre`` families the host syncs
one call makes (the warnings ``torch.cuda.set_sync_debug_mode("warn")``
raises in it).
"""
from __future__ import annotations

import argparse
import time

from ..bench import card_line, log, make_corpus, resolve_device

STAGES = ("bwt", "mtf", "pre", "iter", "post", "decode", "encode")


def _say(msg: str) -> None:
    log(msg, "prof")


def busy_share(dev, fn) -> str:
    """``fn()`` once under torch.profiler: the union of the device's kernel
    and copy intervals over the wall; "not measured (cpu)" on the CPU."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if dev.type != "cuda":
        fn()
        return "not measured (cpu)"
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return (f"device busy {busy / 1e3:.3f} ms of {wall / 1e3:.3f} ms "
            f"({100 * busy / wall:.1f}%, {len(spans)} device events)")


def host_syncs(dev, fn) -> str:
    """``fn()`` once under ``torch.cuda.set_sync_debug_mode("warn")``: the
    number of synchronizing calls PyTorch reports in it; "not measured
    (cpu)" on the CPU."""
    import warnings

    import torch

    if dev.type != "cuda":
        fn()
        return "not measured (cpu)"
    torch.cuda.synchronize(dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    # only the per-call warning: the mode's one-time "prototype" notice
    # also names synchronization
    n = sum("called a synchronizing CUDA operation" in str(w.message)
            for w in caught)
    return f"{n} host syncs a call"


def batches(level: int, n_batches: int, bsz: int) -> list:
    """``n_batches`` disjoint (arr, ns, uses, crcs) batches of ``bsz``
    corpus blocks."""
    from .. import rle1
    from ..engine import _block_pad_size, batch_arrays

    N = _block_pad_size(level)
    data = make_corpus((n_batches * bsz + 2) * 100_000 * level)
    blocks = rle1.encode_blocks(data, level)
    return [batch_arrays(blocks[b * bsz:(b + 1) * bsz], bsz, N)
            for b in range(n_batches)
            if len(blocks[b * bsz:(b + 1) * bsz]) == bsz]


def _time(dev, fn, argsets: list, label: str, syncs: bool = False) -> dict:
    import torch

    def call(args):
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    call(argsets[0])        # first-use costs
    walls = []
    for args in argsets:
        t0 = time.perf_counter()
        call(args)
        walls.append(time.perf_counter() - t0)
    share = busy_share(dev, lambda: call(argsets[-1]))
    nsync = host_syncs(dev, lambda: fn(*argsets[-1])) if syncs else None
    _say(f"{label}: {' '.join(f'{w * 1e3:.3f}' for w in walls)} ms (min "
         f"{min(walls) * 1e3:.3f}); {share}"
         + ("" if nsync is None else f"; {nsync}"))
    return {"walls_s": walls, "busy": share, "syncs": nsync}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", default=["encode"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--level", type=int, default=9)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--bytes", type=int, default=25 << 20)
    args = ap.parse_args(argv)
    bad = [s for s in args.stages if s not in STAGES]
    if bad:
        raise SystemExit(f"unknown stage {bad}; choose from {STAGES}")

    import numpy as np
    import torch

    from .. import constants as C
    from .. import native
    from ..decoder import STAGE_WALL, DeviceDecoder, reset_telemetry
    from ..engine import (Engine, _words_for, encode_post, encode_pre,
                          engine_for, stage_from_numpy)
    from ..ops.bwt import bwt_batched
    from ..ops.groupsearch import group_iter
    from ..ops.mtf import mtf_rle2_batched

    dev = resolve_device(args.device)
    level = args.level
    _say(f"card: {card_line(dev)}; level -{level}")
    res: dict = {}
    sets = None
    if set(args.stages) & {"bwt", "mtf", "pre", "iter", "post"}:
        bsz = args.blocks or Engine(device=dev)._batch_size_for(level)
        sets = [stage_from_numpy(b, dev)
                for b in batches(level, args.reps, bsz)]
        _say(f"batch: {bsz} x {sets[0][0].shape[1]}, {len(sets)} batches")
    A = C.MAX_ALPHA_SIZE

    for stage in args.stages:
        if stage == "decode":
            data = make_corpus(args.bytes)
            comp = engine_for(use_device=False).compress(data, level)
            dd = DeviceDecoder(device=dev)
            t0 = time.perf_counter()
            ok = dd.decompress(comp) == data
            _say(f"decode warm: {time.perf_counter() - t0:.3f} s ok={ok}")
            reset_telemetry()
            t0 = time.perf_counter()
            out = dd.decompress(comp)
            w = time.perf_counter() - t0
            if out != data:
                raise RuntimeError("device decode differs")
            share = busy_share(dev, lambda: dd.decompress(comp))
            walls = {k: round(v, 4) for k, v in STAGE_WALL.items()}
            _say(f"decode: {w:.3f} s -> {len(data) / 1e6 / w:.3f} MB/s; "
                 f"stage walls {walls}; {share}")
            res[stage] = {"wall_s": w, "busy": share}
        elif stage == "encode":
            eng = Engine(host_workers=0, device=dev)
            data = make_corpus(args.bytes)
            step = len(data) // 3
            eng.compress(data[:step // 4], level)     # first-use costs
            walls = []
            for r in range(args.reps):
                sl = data[(r % 3) * step:(r % 3 + 1) * step]
                t0 = time.perf_counter()
                eng.compress(sl, level)
                walls.append(time.perf_counter() - t0)
                _say(f"device-only encode {len(sl)} B: {walls[-1]:.3f} s -> "
                     f"{len(sl) / 1e6 / walls[-1]:.3f} MB/s")
            share = busy_share(dev, lambda: eng.compress(data[:step], level))
            _say(f"encode: {share}")
            res[stage] = {"walls_s": walls, "busy": share}
        elif stage == "bwt":
            res[stage] = _time(dev, bwt_batched, [(b, n) for b, n, _u, _c
                                                  in sets], "bwt",
                                syncs=True)
        elif stage == "mtf":
            lasts = [(bwt_batched(b, n)[0], n, u) for b, n, u, _c in sets]
            res[stage] = _time(dev, mtf_rle2_batched, lasts, "mtf+rle2")
        elif stage == "pre":
            res[stage] = _time(dev, encode_pre, [(b, n, u) for b, n, u, _c
                                                 in sets],
                               "encode_pre (bwt+mtf+hist)", syncs=True)
        else:
            outs = [encode_pre(b, n, u) for b, n, u, _c in sets]
            if stage == "iter":
                res[stage] = _time(dev, group_iter,
                                   [(o[6], o[5], o[7]) for o in outs],
                                   "group_iter")
                o = outs[0]
                _sel, freq6 = group_iter(o[6], o[5], o[7])
                t0 = time.perf_counter()
                freq = freq6.cpu().numpy().reshape(-1, A)
                alpha6 = np.repeat(o[2].cpu().numpy() + 2, 6).astype(np.int32)
                native.make_code_lengths_batch(freq, alpha6)
                _say(f"host heap+fetch: {(time.perf_counter() - t0) * 1e3:.3f}"
                     " ms")
            else:
                post = []
                for (b, n, u, c), o in zip(sets, outs):
                    (mtfv, n_mtf, n_in_use, orig, n_groups, lens0, hist,
                     inval) = o
                    sel, _f = group_iter(hist, lens0, inval)
                    post.append((mtfv, n_mtf, n_in_use, u, c, orig, n_groups,
                                 sel, lens0, _words_for(b.shape[1])))
                res[stage] = _time(dev, encode_post, post,
                                   "encode_post (emit+pack)")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return res


if __name__ == "__main__":
    main()
