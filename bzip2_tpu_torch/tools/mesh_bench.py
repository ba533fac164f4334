"""Sharded encode and decode throughput on a mesh (counterpart of
``tools/mesh_bench.py``).

    python -m bzip2_tpu_torch.tools.mesh_bench [REPS] [--devices cuda:0,cuda:0]
        [--device cuda|cpu] [--level 9] [--blocks B] [--decode-bytes N]

Encode: ``REPS + 1`` disjoint batches of ``B`` corpus blocks (default the
engine's batch at the level) through ``parallel.mesh.encode_blocks_sharded``,
the first untimed.  Decode: ``REPS + 1`` streams of ``N`` corpus bytes
(default 8 MiB), encoded by the host engine
(``engine_for(use_device=False)``), through ``decode_blocks_sharded``, the
first untimed.  The mesh is ``make_mesh()`` (every card), the entries of
``--devices``, or one CPU entry with ``--device cpu``.  Prints each
timed batch's wall, MB/s and MB/s per entry, and the heals.
"""
from __future__ import annotations

import argparse
import time

from ..bench import card_line, log, make_corpus, resolve_device


def _say(msg: str) -> None:
    log(f"{time.strftime('%H:%M:%S')} {msg}", "mesh")


def make(devices: str | None, device: str):
    """The mesh of ``--devices`` (comma-separated), else ``make_mesh()`` on
    the card or one CPU entry."""
    from ..parallel import mesh as M

    dev = resolve_device(device)
    if devices:
        return M.make_mesh(devices.split(",")), dev
    return M.make_mesh() if dev.type == "cuda" else M.make_mesh([dev]), dev


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("reps", nargs="?", type=int, default=2)
    ap.add_argument("--devices", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--level", type=int, default=9)
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--decode-bytes", type=int, default=8 << 20)
    args = ap.parse_args(argv)

    from .. import rle1
    from ..engine import (Engine, _block_pad_size, _words_for, batch_arrays,
                          engine_for, payloads_from_words)
    from ..parallel import mesh as M

    msh, dev = make(args.devices, args.device)
    _say(f"card: {card_line(dev)}; mesh {[str(d) for d in msh.devices]}")
    level = args.level
    N = _block_pad_size(level)
    W = _words_for(N)
    bsz = args.blocks or Engine(device=dev)._batch_size_for(level)
    unit = 100_000 * level
    data = make_corpus(max((args.reps + 1) * bsz * unit,
                           (args.reps + 1) * args.decode_bytes))
    blocks = rle1.encode_blocks(data[:(args.reps + 1) * bsz * unit + unit],
                                level)
    batches = []
    for r in range(args.reps + 1):
        chunk = blocks[r * bsz:(r + 1) * bsz]
        if len(chunk) < bsz:
            break
        raw = sum(b.raw_span[1] - b.raw_span[0] for b in chunk)
        batches.append((batch_arrays(chunk, bsz, N), raw))

    M.reset_telemetry()
    M.encode_blocks_sharded(msh, *batches[0][0], n_words=W)   # warm-up
    enc = []
    for arrays, raw in batches[1:]:
        t0 = time.perf_counter()
        words, nbits = M.encode_blocks_sharded(msh, *arrays, n_words=W)
        payloads_from_words(words, nbits)
        w = time.perf_counter() - t0
        enc.append((w, raw))
        _say(f"sharded encode batch of {bsz}: {w:.3f} s -> "
             f"{raw / 1e6 / w:.3f} MB/s, {raw / 1e6 / w / msh.size:.3f} "
             "MB/s an entry")
    best = max(r / w for w, r in enc) / 1e6
    _say(f"sharded fused encode -{level}: best {best:.3f} MB/s, "
         f"{best / msh.size:.3f} MB/s an entry ({bsz} blocks a batch)")

    host = engine_for(use_device=False)
    streams = []
    for r in range(args.reps + 1):
        sl = data[r * args.decode_bytes:(r + 1) * args.decode_bytes]
        streams.append((host.compress(sl, level), sl))
    M.decode_blocks_sharded(msh, streams[0][0], level)       # warm-up
    M.reset_telemetry()
    dec = []
    for comp, sl in streams[1:]:
        t0 = time.perf_counter()
        out = M.decode_blocks_sharded(msh, comp, level)
        w = time.perf_counter() - t0
        if out != sl:
            raise RuntimeError("sharded decode differs from the input")
        dec.append((w, len(sl)))
        _say(f"sharded decode: {w:.3f} s -> {len(sl) / 1e6 / w:.3f} MB/s, "
             f"{len(sl) / 1e6 / w / msh.size:.3f} MB/s an entry "
             f"(heals={M.HEALS['lane']})")
    dbest = max(r / w for w, r in dec) / 1e6
    walls = {k: round(v, 4) for k, v in M.STAGE_WALL.items()}
    _say(f"sharded decode -{level}: best {dbest:.3f} MB/s, "
         f"{dbest / msh.size:.3f} MB/s an entry, heals={M.HEALS['lane']}, "
         f"stage walls {walls}")
    return {"entries": msh.size, "encode": enc, "decode": dec,
            "encode_best_mbs": best, "decode_best_mbs": dbest,
            "heals": M.HEALS["lane"]}


if __name__ == "__main__":
    main()
