"""Weak scaling of the sharded block encoder (counterpart of
``tools/scaling_bench.py``).

    python -m bzip2_tpu_torch.tools.scaling_bench [--entries 1,2,4,8]
        [--device cuda|cpu] [--per-entry 2]

Two blocks an entry (``--per-entry``) of seeded text at -1 through
``parallel.mesh.encode_blocks_sharded`` on 1, 2, 4 and 8 mesh entries,
each once untimed and then timed.  The entries are the cards
(``cuda:i``), repeated round-robin where there are fewer cards than
entries (repeats of ``cuda:0`` share one card, each on its own stream), or
CPU entries with ``--device cpu``.  Prints the table of the reference
tool: entries, blocks, wall, seconds a block and the efficiency against
one entry (per-block cost at 1 entry over per-block cost at d).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..bench import card_line, log, resolve_device


def entries(dev, d: int) -> list:
    """``d`` mesh entries on ``dev``'s type: the cards round-robin, or CPU
    entries."""
    import torch

    if dev.type != "cuda":
        return ["cpu"] * d
    n = torch.cuda.device_count()
    return [f"cuda:{i % n}" for i in range(d)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--entries", default="1,2,4,8")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--per-entry", type=int, default=2)
    args = ap.parse_args(argv)

    from .. import rle1
    from ..engine import _block_pad_size, _words_for, batch_arrays
    from ..parallel.mesh import encode_blocks_sharded, make_mesh

    dev = resolve_device(args.device)
    log(f"card: {card_line(dev)}", "scaling")
    level = 1
    rng = np.random.default_rng(7)
    data = rng.integers(97, 107, 16 * 95_000, dtype=np.uint8).tobytes()
    blocks = rle1.encode_blocks(data, level)
    N = _block_pad_size(level)
    W = _words_for(N)
    counts = [int(x) for x in args.entries.split(",")]

    base = None
    rows = []
    print(f"{'entries':>8} {'blocks':>7} {'wall s':>9} {'s/block':>9} "
          f"{'efficiency':>11}", flush=True)
    for d in counts:
        mesh = make_mesh(entries(dev, d))
        B = args.per_entry * d
        arrays = batch_arrays([blocks[j % len(blocks)] for j in range(B)],
                              B, N)
        encode_blocks_sharded(mesh, *arrays, W)          # warm-up
        t0 = time.perf_counter()
        encode_blocks_sharded(mesh, *arrays, W)
        dt = time.perf_counter() - t0
        per_block = dt / B
        base = per_block if base is None else base
        rows.append({"entries": d, "blocks": B, "wall_s": dt,
                     "s_per_block": per_block, "efficiency": base / per_block})
        print(f"{d:>8} {B:>7} {dt:>9.4f} {per_block:>9.4f} "
              f"{base / per_block:>10.0%}", flush=True)
    return {"rows": rows, "mesh": [entries(dev, d) for d in counts]}


if __name__ == "__main__":
    main()
