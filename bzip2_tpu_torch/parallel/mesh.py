"""Block-data-parallel encode and decode over a mesh of devices (port of
``bzip2_tpu/parallel/mesh.py``).

The JAX mesh is single-controller: one jitted program covers every device
and XLA partitions it along the block axis.  Here one process drives the
mesh with a thread per entry.  Each thread works on its own device and its
own CUDA stream (``engine.worker_context``, whose streams every engine of
the process shares, so the caching allocator's pools stay shared), and one
entry's host syncs (the BWT's) stall only that entry.  Entries may repeat a
device (``make_mesh(["cuda:0", "cuda:0"])``): each repeat runs on a stream
of its own.

Blocks go to the entries in contiguous shards in block order, as
``P("blocks")`` lays a batch out.  No shard is padded with dummy lanes, and
an entry whose shard is empty launches nothing.  The host joins the shards'
results in block order; that join is the all-gather of the per-block bit
lengths.  There is nothing to compile, so nothing is cached.
"""
from __future__ import annotations

import concurrent.futures as _cf
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import constants as C
from .. import native
from ..api import DataError
from ..crc import combine_block_crcs
from ..decoder import (STAGES, batch_inputs, fetch_batch, heal_span,
                       launch_batch)
from ..engine import (_fetch, _resolve_device, encode_batch_device,
                      stage_from_numpy, worker_context)

#: sharded-decode lanes healed on the host (walk budget or CRC mismatch),
#: the mesh's counterpart of ``decoder.ANOMALIES["lane"]``
HEALS = {"lane": 0}
#: cumulative per-stage walls of the sharded decode (seconds; CUDA events
#: on a card, the host clock on the CPU), summed over the entries
STAGE_WALL: dict = {}
_LOCK = threading.Lock()


def reset_telemetry() -> None:
    with _LOCK:
        STAGE_WALL.clear()
        HEALS["lane"] = 0


class RandomisedBlockError(ValueError):
    """The stream holds a legacy randomised block, which the mesh does not
    decode; the host decoders do."""


@dataclass(frozen=True)
class Mesh:
    """One entry per device, in shard order along the block axis."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device).  Without CUDA
    the default raises RuntimeError; the CPU is used only when it is named,
    as in ``make_mesh(["cpu"] * 4)``.  Entries may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; name the "
                               "devices (e.g. ['cpu'] * 4) to use the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(_resolve_device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no devices")
    return Mesh(devs)


def shard_bounds(n_blocks: int, size: int) -> list:
    """(start, end) of each entry's shard: ceil(n_blocks / size) blocks an
    entry in block order, so the last entries may hold fewer or none."""
    k = -(-n_blocks // size)
    return [(min(i * k, n_blocks), min((i + 1) * k, n_blocks))
            for i in range(size)]


def _on_entries(mesh: Mesh, n_blocks: int, fn) -> list:
    """``fn(device, start, end)`` for each entry with a non-empty shard, one
    thread each, inside the entry's worker context.  Returns
    [(start, end, result)] in block order; the first error raises once
    every thread has stopped."""
    work = []
    repeats: dict = {}
    for dev, (s, e) in zip(mesh.devices, shard_bounds(n_blocks, mesh.size)):
        k = repeats.get(dev, 0)
        repeats[dev] = k + 1
        if e > s:
            work.append((dev, k, s, e))

    def run(dev, k, s, e):
        with worker_context(dev, k):
            return fn(dev, s, e)

    with _cf.ThreadPoolExecutor(max_workers=max(1, len(work))) as ex:
        futs = [ex.submit(run, *w) for w in work]
    for f in futs:
        if f.exception() is not None:
            raise f.exception()
    return [(s, e, f.result()) for (_d, _k, s, e), f in zip(work, futs)]


# ------------------------------------------------------------- encode ---

def encode_blocks_sharded(mesh: Mesh, blocks_np, n_np, in_use_np, crc_np,
                          n_words: int):
    """Encode a batch of RLE1 blocks on the mesh: blocks (B, N) uint8, n
    (B,), in_use (B, 256) bool, crc (B,) uint32, numpy.  Each entry stages
    its shard, runs the fused ``engine.encode_batch_device`` and fetches
    the bit counts, then only the used word prefix.  Returns (words
    np.uint32 (B, k), nbits np.int64 (B,)), k the longest block's used
    words."""
    arrays = (np.asarray(blocks_np, np.uint8), np.asarray(n_np, np.int32),
              np.asarray(in_use_np, bool), np.asarray(crc_np, np.uint32))
    B = arrays[0].shape[0]

    def shard(dev, s, e):
        t = stage_from_numpy([a[s:e] for a in arrays], dev)
        return _fetch(*encode_batch_device(*t, n_words))

    parts = _on_entries(mesh, B, shard)
    k = max((w.shape[1] for _s, _e, (w, _n) in parts), default=0)
    words = np.zeros((B, k), np.uint32)
    nbits = np.zeros(B, np.int64)
    for s, e, (w, nb) in parts:
        words[s:e, :w.shape[1]] = w
        nbits[s:e] = nb
    return words, nbits


# ------------------------------------------------------------- decode ---

def _parse(buf: np.ndarray, level):
    """The host parse of every member: (level, [ParsedBlock]), both CRC
    layers' stored values checked for the stream's framing."""
    total = buf.size * 8
    pos_bit = 0
    metas = []

    def bits(pos, k):
        v = 0
        for j in range(k):
            if pos + j >= total:
                raise ValueError("truncated stream")
            v = (v << 1) | ((int(buf[(pos + j) // 8])
                             >> (7 - (pos + j) % 8)) & 1)
        return v

    while True:
        if total - pos_bit < 32 or pos_bit % 8:
            raise ValueError("bad stream header")
        hdr = bytes(buf[pos_bit // 8: pos_bit // 8 + 4])
        if hdr[:3] != b"BZh" or not (0x31 <= hdr[3] <= 0x39):
            raise ValueError("bad stream header")
        lvl = hdr[3] - 0x30
        if level is None:
            level = lvl
        elif lvl != level:
            raise ValueError("mixed levels in stream")
        pos_bit += 32
        crcs = []
        while True:
            start_bit = pos_bit
            pb, _rc = native.parse_block(buf, pos_bit, lvl)
            if pb is None:
                break
            if pb.randomised:
                raise RandomisedBlockError("randomised legacy stream")
            pb.start_bit = start_bit
            metas.append(pb)
            crcs.append(pb.stored_crc)
            pos_bit = pb.end_bit
        # EOS: 48-bit magic and 32-bit combined CRC, then byte alignment
        if bits(pos_bit, 48) != C.EOS_MAGIC:
            raise ValueError("bad end-of-stream magic")
        if bits(pos_bit + 48, 32) != combine_block_crcs(crcs):
            raise ValueError("combined CRC mismatch")
        pos_bit = (pos_bit + 48 + 32 + 7) // 8 * 8
        if not (pos_bit // 8 + 4 <= buf.size
                and bytes(buf[pos_bit // 8: pos_bit // 8 + 3]) == b"BZh"):
            return level, metas


def decode_blocks_sharded(mesh: Mesh, stream, level: int | None = None
                          ) -> bytes:
    """Decode every block of the (possibly multi-member) .bz2 ``stream`` on
    the mesh.  The host parses (``native.parse_block``), checks both CRC
    layers and splices in block order; each entry runs its shard, one word
    row a block, through the decoder's four device stages
    (``decoder.launch_batch``).  A lane with a walk-budget or CRC anomaly
    heals on the host (``decoder.heal_span``) and counts in
    ``HEALS["lane"]``.

    Raises RandomisedBlockError for a legacy randomised block and
    ValueError for malformed input."""
    buf = np.frombuffer(bytes(stream), np.uint8)
    level, metas = _parse(buf, level)
    if not metas:
        return b""

    def shard(dev, s, e):
        res = launch_batch(dev, level,
                           batch_inputs(buf, metas[s:e], rows=True))
        blocks, walls = fetch_batch(res)
        with _LOCK:
            for key, w in zip(STAGES, walls):
                STAGE_WALL[key] = STAGE_WALL.get(key, 0.0) + w
        return blocks

    parts = []
    for s, _e, blocks in _on_entries(mesh, len(metas), shard):
        for j, blk in enumerate(blocks):
            i = s + j
            pb = metas[i]
            # the block CRC on the host: slice-by-8 C++ over bytes that are
            # gathered for the splice anyway
            if blk is None or native.crc32(blk) != pb.stored_crc:
                with _LOCK:
                    HEALS["lane"] += 1
                try:
                    blk = heal_span(buf, pb.start_bit, pb.end_bit, level)
                except DataError as err:
                    raise ValueError(f"block {i} failed sharded decode "
                                     f"({err})") from err
            parts.append(blk)
    return b"".join(parts)
