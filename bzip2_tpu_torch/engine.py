"""Batched block encoder on a PyTorch device (port of the hybrid flow of
``bzip2_tpu/engine.py``).

Per batch of RLE1 blocks:

  encode_pre   BWT, MTF+RLE2, per-group histograms,     device
               initial tables
  4 x          group_iter (cost/frequency matmuls,       device
               argmin) then the exact-heap Huffman       host C++ (native)
               lengths
  encode_post  canonical codes, selector MTF, field      device
               emission, bit packing

``Engine.encode_payloads`` is a block encoder for the port's
``api.register_block_encoder``: the api splits the input into
RLE1 blocks, applies the periodic origPtr corrector, bit-splices the
payloads and frames the stream.  Every block goes to the device; blocks
are batched in order and the last batch is padded with dummy lanes
(1-byte blocks) to the batch size.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import constants as C
from . import native, rle1
from .ops.bitpack import pack_fields
from .ops.bwt import bwt_batched
from .ops.groupsearch import (build_group_hist, group_iter,
                              initial_tables_batched, n_groups_batched,
                              selector_mtf)
from .ops.huffman import assign_codes_lanes
from .ops.mtf import mtf_rle2_batched

A = C.MAX_ALPHA_SIZE
MTF_TILE = 2048

#: cumulative encode stage walls (seconds); the blocks handed to the
#: engine and the blocks the device encoded
STAGE_WALL: dict = {}
SHARE: dict = {"blocks": 0, "dev_blocks": 0}


def reset_telemetry() -> None:
    STAGE_WALL.clear()
    SHARE["blocks"] = 0
    SHARE["dev_blocks"] = 0


def _stage_add(key: str, wall: float) -> None:
    STAGE_WALL[key] = STAGE_WALL.get(key, 0.0) + wall


def _emit_fields(in_use, crc, orig_ptr, mtfv, n_mtf, n_in_use, n_groups,
                 n_selectors, sel_mtf, lens, codes, selectors):
    """Build the (vals int64, lens int32) field arrays of one batch, in wire
    order.  Values are int64 holding uint32 bit patterns: the JAX version's
    uint32 shifts (``0xAAAAAAAA >> k``) are logical, torch's int32 shifts
    are not."""
    B, M = mtfv.shape
    dev = mtfv.device
    i64, i32 = torch.int64, torch.int32
    fields_v: list = []
    fields_l: list = []

    def add(v, ln):
        fields_v.append(v.to(i64))
        fields_l.append(ln.to(i32))

    def col(v, bits):
        v = torch.as_tensor(v, dtype=i64, device=dev).expand(B)[:, None]
        return v, torch.full((B, 1), bits, dtype=i32, device=dev)

    # block magic + CRC + (rand bit | origPtr)
    add(*col(C.BLOCK_MAGIC >> 24, 24))
    add(*col(C.BLOCK_MAGIC & 0xFFFFFF, 24))
    add(*col(crc.to(i64) & 0xFFFFFFFF, 32))
    add(*col(orig_ptr.to(i64), 25))

    # mapping: 16-bit group mask, then 16 bits per used group
    iu = in_use.reshape(B, 16, 16)
    gmask_bits = iu.any(dim=2)
    w16 = torch.ones(16, dtype=i64, device=dev) << torch.arange(
        15, -1, -1, dtype=i64, device=dev)
    w16 = w16[None, :]
    add(*col(torch.where(gmask_bits, w16, 0).sum(dim=1), 16))
    gbits = torch.where(iu, w16[None], 0).sum(dim=2)
    add(gbits, torch.where(gmask_bits, 16, 0))

    add(*col(n_groups.to(i64), 3))
    add(*col(n_selectors.to(i64), 15))

    # selectors: value v in 1..6 -> v bits of pattern (1<<v)-2
    sel = sel_mtf.to(i64)
    add((torch.ones_like(sel) << sel) - 2, torch.where(sel > 0, sel, 0))

    # coding tables: per table a 5-bit first length, then per symbol
    # {"10"*d | "11"*d, then "0"}
    arange_a = torch.arange(A, device=dev)[None, None, :]
    alpha = n_in_use + 2
    t_active = torch.arange(6, device=dev)[None, :] < n_groups[:, None]
    active = t_active[:, :, None] & (arange_a < alpha[:, None, None])
    lens_m = torch.where(active, lens.to(i64), 0)
    first = lens_m[:, :, 0]
    prev = torch.cat([first[:, :, None], lens_m[:, :, :-1]], dim=2)
    delta = torch.where(active, lens_m - prev, 0)
    up = torch.clamp(delta, min=0)
    down = torch.clamp(-delta, min=0)
    pat_up = torch.where(delta > 0, torch.full_like(up, 0xAAAAAAAA)
                         >> torch.clamp(32 - 2 * up, 0, 31), 0)
    pat_dn = torch.where(delta < 0, torch.full_like(down, 0xFFFFFFFF)
                         >> torch.clamp(32 - 2 * down, 0, 31), 0)
    W = 1 + 2 * A
    tab_v = torch.zeros((B, 6, W), dtype=i64, device=dev)
    tab_l = torch.zeros((B, 6, W), dtype=i32, device=dev)
    tab_v[:, :, 0] = first
    tab_l[:, :, 0] = torch.where(t_active, 5, 0).to(i32)
    tab_v[:, :, 1::2] = pat_up + pat_dn
    tab_l[:, :, 1::2] = (2 * (up + down)).to(i32)
    tab_l[:, :, 2::2] = active.to(i32)
    add(tab_v.reshape(B, 6 * W), tab_l.reshape(B, 6 * W))

    # payload: each symbol's (code, len) gathered directly by (selector of
    # its group, symbol); the JAX version's one-hot matmul served TPU
    # gather costs
    m = torch.arange(M, device=dev)[None, :]
    m_valid = m < n_mtf[:, None]
    packed_tab = ((codes.to(i32) << 5) | lens.to(i32)).reshape(B, 6 * A)
    sel_of = torch.gather(selectors.to(i64), 1, (m // C.G_SIZE).expand(B, M))
    pay = torch.gather(packed_tab, 1, sel_of * A + mtfv.to(i64))
    add(torch.where(m_valid, pay >> 5, 0), torch.where(m_valid, pay & 31, 0))

    return torch.cat(fields_v, dim=1), torch.cat(fields_l, dim=1)


def encode_pre(blocks, n, in_use):
    """(B, N) uint8 blocks, (B,) lengths, (B, 256) bool -> the inter-stage
    state (mtfv, n_mtf, n_in_use, orig_ptr, n_groups, lens0, hist,
    table_invalid); hist is float32 for the group_iter matmuls."""
    last, orig_ptr, _ = bwt_batched(blocks, n)
    mtfv, n_mtf, n_in_use = mtf_rle2_batched(last, n, in_use)
    n_groups = n_groups_batched(n_mtf)
    hist = build_group_hist(mtfv, n_mtf)
    freq = hist.sum(dim=1, dtype=torch.int32)
    lens0 = initial_tables_batched(freq, n_mtf, n_in_use + 2, n_groups)
    table_invalid = (torch.arange(6, device=blocks.device)[None, :]
                     >= n_groups[:, None])
    return (mtfv, n_mtf, n_in_use, orig_ptr, n_groups, lens0,
            hist.to(torch.float32), table_invalid)


def encode_post(mtfv, n_mtf, n_in_use, in_use, crc, orig_ptr, n_groups,
                selectors, lens, n_words: int):
    """Canonical codes, selector MTF, field emission and bit packing.
    Returns (words (B, n_words) int64 of uint32 values, nbits (B,))."""
    B = mtfv.shape[0]
    alpha = n_in_use + 2
    codes = assign_codes_lanes(
        lens.reshape(B * 6, A),
        alpha[:, None].expand(B, 6).reshape(B * 6)).reshape(B, 6, A)
    n_selectors = -(-n_mtf // C.G_SIZE)
    sel_mtf = selector_mtf(selectors, n_selectors)
    vals, flens = _emit_fields(in_use, crc, orig_ptr, mtfv, n_mtf, n_in_use,
                               n_groups, n_selectors, sel_mtf, lens, codes,
                               selectors)
    return pack_fields(vals, flens, n_words)


def _block_pad_size(level: int) -> int:
    n = C.nblock_max(level) + C.BLOCK_OVERSHOOT
    return -(-n // MTF_TILE) * MTF_TILE


def _words_for(N: int) -> int:
    # worst case: 17-bit codes for every symbol + headers, with slack
    return (17 * (N + 1) + 6 * A * 3 + C.MAX_SELECTORS * 6 + 4096) // 32 + 4


#: numpy dtype -> the port's tensor dtype: bf16 histograms widen to float32
#: (exact for counts <= 50), uint32 bit fields (CRCs) widen to int64
_DTYPE_MAP = {"bfloat16": torch.float32, "uint32": torch.int64,
              "int32": torch.int32, "uint8": torch.uint8, "bool": torch.bool}


def stage_from_numpy(arrays, device) -> tuple:
    """Numpy arrays (e.g. the JAX ``encode_pre`` outputs, or the host inputs
    of ``encode_post``) -> the port's tensors on ``device``."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        dt = _DTYPE_MAP.get(a.dtype.name)
        if dt is None:
            raise TypeError(f"stage_from_numpy: no mapping for {a.dtype}")
        if a.dtype.name in ("bfloat16", "uint32"):
            a = a.astype(np.float32 if dt == torch.float32 else np.int64)
        # torch.from_numpy needs a writable array (jax hands out read-only)
        out.append(torch.from_numpy(np.require(a, requirements=["C", "W"]))
                   .to(device))
    return tuple(out)


def split_blocks(data, level: int) -> list:
    """RLE1-encode ``data`` and split it into the blocks of ``level``
    (the port's ``rle1``): the blocks ``encode_payloads`` is given."""
    return rle1.encode_blocks(data, level)


def batch_arrays(blocks: list, bsz: int, N: int) -> tuple:
    """Up to ``bsz`` RLE1 blocks -> the padded numpy inputs of one batch
    (blocks (bsz, N) uint8, lengths, in_use (bsz, 256), CRCs).  Lanes past
    ``len(blocks)`` are dummy 1-byte blocks of 0x00, so every batch of a
    stream has one shape."""
    arr = np.zeros((bsz, N), np.uint8)
    ns = np.ones(bsz, np.int32)
    uses = np.zeros((bsz, 256), bool)
    crcs = np.zeros(bsz, np.uint32)
    uses[:, 0] = True
    for j, blk in enumerate(blocks):
        arr[j, :blk.data.size] = blk.data
        ns[j] = blk.data.size
        uses[j] = blk.in_use
        crcs[j] = blk.crc
    return arr, ns, uses, crcs


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    return device


class Engine:
    """Batched block encoder: device stages with the host's exact-heap
    Huffman lengths (the port's ``native``) between them."""

    #: target bytes of input per device batch when batch_size is automatic
    AUTO_BATCH_BYTES = 12 << 20

    def __init__(self, batch_size: int | None = None, device="cuda"):
        self.device = _resolve_device(device)
        if not native.available():
            raise RuntimeError("the hybrid encoder needs the native host "
                               "runtime (bzip2_tpu_torch.native), which did not build")
        self.batch_size = batch_size

    def _batch_size_for(self, level: int) -> int:
        if self.batch_size is not None:
            return self.batch_size
        return max(1, self.AUTO_BATCH_BYTES // (C.BLOCK_UNIT * level))

    def encode_batch(self, level, arr, ns, uses, crcs):
        """One device batch of padded numpy inputs -> (words uint32 (B, k)
        numpy, nbits int64 (B,) numpy), words cut to the longest block."""
        dev = self.device
        N = arr.shape[1]
        B = arr.shape[0]
        t0 = time.perf_counter()
        blocks, n, in_use, crc = stage_from_numpy((arr, ns, uses, crcs), dev)
        (mtfv, n_mtf, n_in_use, orig_ptr, n_groups, lens, hist,
         table_invalid) = encode_pre(blocks, n, in_use)
        # .cpu() waits for the device, so the wall below is the stage's
        alpha6 = np.repeat(n_in_use.cpu().numpy() + 2, 6).astype(np.int32)
        t1 = time.perf_counter()
        selectors = None
        for _ in range(C.N_ITERS):
            selectors, freq6 = group_iter(hist, lens, table_invalid)
            lens_np = native.make_code_lengths_batch(
                freq6.cpu().numpy().reshape(B * 6, A), alpha6)
            lens = torch.from_numpy(lens_np.reshape(B, 6, A)).to(dev)
        t2 = time.perf_counter()
        words, nbits = encode_post(mtfv, n_mtf, n_in_use, in_use, crc,
                                   orig_ptr, n_groups, selectors, lens,
                                   _words_for(N))
        nbits_np = nbits.cpu().numpy()
        need = int((int(nbits_np.max()) + 31) // 32)
        words_np = words[:, :need].cpu().numpy().astype(np.uint32)
        t3 = time.perf_counter()
        _stage_add("pre(bwt+mtf+hist)", t1 - t0)
        _stage_add("4xiter+heap", t2 - t1)
        _stage_add("post+fetch", t3 - t2)
        return words_np, nbits_np

    def encode_payloads(self, blocks: list, level: int) -> list:
        """Encode RLE1 blocks into per-block (MSB-first bytes, nbits)
        payloads, batch by batch in block order."""
        L = len(blocks)
        if L == 0:
            return []
        N = _block_pad_size(level)
        primary = self._batch_size_for(level)
        # a stream of one or two blocks runs in a 2-lane batch instead of
        # padding a whole primary batch with dummy lanes
        bsz = 2 if (L <= 2 and primary > 2) else primary
        SHARE["blocks"] += L
        results: list = []
        for s in range(0, L, bsz):
            chunk = blocks[s:s + bsz]
            words, nbits = self.encode_batch(level,
                                             *batch_arrays(chunk, bsz, N))
            SHARE["dev_blocks"] += len(chunk)
            for j in range(len(chunk)):
                nbit = int(nbits[j])
                by = words[j, :(nbit + 31) // 32].byteswap().view(np.uint8)
                results.append((by[:(nbit + 7) // 8], nbit))
        return results
