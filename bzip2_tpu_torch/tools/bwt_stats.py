"""Unresolved-set trajectory of the port's BWT on real corpus blocks
(counterpart of ``tools/bwt_stats.py``).

    python -m bzip2_tpu_torch.tools.bwt_stats [--device cuda|cpu]
        [--level 9] [--blocks 2]

Runs ``ops.bwt.bwt_batched`` on the first ``--blocks`` RLE1 blocks of the
bench corpus with ``ops.bwt.ROUND_HOOK`` set, and prints, after the
initial 16-byte ranks and after each doubling round, the prefix length k
the ranks resolve and each block's count of positions still tied at k:
the full-width rounds (stage 0), then the compact tail stages (1, 2, ...).
The rows come from the round record the device writes, read once at the
end of the call.  The counts depend on the data alone, not on the device.  Then the tail
ladder ``_tail_ladder(N)`` (the compaction widths) at each level's pad
size N.
"""
from __future__ import annotations

import argparse

from ..bench import card_line, log, make_corpus, resolve_device


def trajectory(blocks_t, n_t) -> list:
    """[(stage, k, [unresolved per block])] of one ``bwt_batched`` call."""
    from ..ops import bwt

    rows = []
    bwt.ROUND_HOOK = lambda stage, k, unres: rows.append(
        (stage, k, [int(x) for x in unres.tolist()]))
    try:
        bwt.bwt_batched(blocks_t, n_t)
    finally:
        bwt.ROUND_HOOK = None
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--level", type=int, default=9)
    ap.add_argument("--blocks", type=int, default=2)
    args = ap.parse_args(argv)

    from .. import rle1
    from ..engine import _block_pad_size, batch_arrays, stage_from_numpy
    from ..ops.bwt import _tail_ladder

    dev = resolve_device(args.device)
    log(f"card: {card_line(dev)}", "bwt")
    level = args.level
    N = _block_pad_size(level)
    data = make_corpus((args.blocks + 1) * 100_000 * level)
    blocks = rle1.encode_blocks(data, level)[:args.blocks]
    arr, ns, uses, _crcs = batch_arrays(blocks, len(blocks), N)
    bt, nt = stage_from_numpy((arr, ns), dev)
    rows = trajectory(bt, nt)
    print(f"-{level}: {len(blocks)} blocks of {ns.tolist()} bytes, N={N}, "
          f"cap0={_tail_ladder(N)[0]}", flush=True)
    for stage, k, unres in rows:
        where = "full width" if stage == 0 else f"tail stage {stage}"
        print(f"  after k={k:>8} ({where}): unres = {unres}", flush=True)
    ladders = {lv: _tail_ladder(_block_pad_size(lv)) for lv in range(1, 10)}
    for lv, lad in ladders.items():
        print(f"  tail ladder at -{lv} (N={_block_pad_size(lv)}): {lad}",
              flush=True)
    return {"rows": rows, "n": ns.tolist(), "N": N, "ladders": ladders}


if __name__ == "__main__":
    main()
