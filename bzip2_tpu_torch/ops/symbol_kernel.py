"""Group-parallel Huffman symbol decode: wrapper of the CUDA kernel in
``csrc/symbol_scan.cu`` and its plain PyTorch version.

Counterpart of ``_symbol_scan`` in ``bzip2_tpu/ops/decode.py`` (used by
``decode_symbols`` and ``decode_symbols_rows``), a ``lax.scan`` of 50 steps
that has no Pallas original.  Each (block, group) lane decodes its 50
symbols from its start bit: per step one 32-bit window read, a 12-bit
first-level lookup and, for an escape, a second-level lookup.  The plain
version is that scan in torch ops over every byte's window
(``_byte_windows``); the kernel runs every lane's 50 steps in one launch, a
CTA per 256 groups of one block with that block's selected ``lut1`` tables
and its span of words staged in shared memory, and builds each window from
the two words it spans.  A wrapper runs its plain
version only for a tensor on the CPU; for a CUDA tensor it launches its
kernel.
"""
from __future__ import annotations

import ctypes as ct

import torch

from .. import _build

G_SIZE = 50
LUT_BITS = 12
#: 12-bit windows the >12-bit code region can span (see the JAX module)
ESC_PREFIXES = 132
U32 = 0xFFFFFFFF

i32, i64 = torch.int32, torch.int64

SCAN = _build.Kernel("symbol_scan", "bz2t_symbol_scan",
                     [ct.c_void_p, ct.c_int64, ct.c_int64] + [ct.c_void_p] * 7
                     + [ct.c_int] * 2 + [ct.c_void_p])


def _byte_windows(words):
    """(..., WT) int64 words (uint32 values) -> (..., 4*WT) int64: entry i
    is the 32-bit big-endian window starting at byte i."""
    byts = torch.stack([words >> 24, (words >> 16) & 0xFF,
                        (words >> 8) & 0xFF, words & 0xFF], dim=-1).reshape(
        words.shape[:-1] + (4 * words.shape[-1],))
    return ((byts << 24) | (byts.roll(-1, dims=-1) << 16)
            | (byts.roll(-2, dims=-1) << 8) | byts.roll(-3, dims=-1))


def symbol_scan_plain(words, goff, gsel, gvalid, lut1, lut2, esc_base):
    """The 50-step symbol scan in torch ops over every byte's window:
    ``words`` 1-D is the batch's flat buffer, 2-D one row per block."""
    B, G = goff.shape
    dev = goff.device
    WT = words.shape[-1]
    wb8 = _byte_windows(words)
    if words.dim() == 2:
        def take_w(wi):                                    # take_rows
            return torch.gather(wb8, 1, wi.clamp(0, 4 * WT - 1).to(i64))
    else:
        def take_w(wi):                                    # take_flat
            return wb8[wi.clamp(0, 4 * WT - 1).to(i64)]
    lut1f = lut1.reshape(B, 6 << LUT_BITS)
    lut2f = lut2.reshape(B, 6 * (ESC_PREFIXES << 8))
    ebase = torch.zeros((B, G), dtype=i32, device=dev)
    for t in range(6):
        ebase = torch.where(gsel == t, esc_base[:, t][:, None], ebase)
    w2 = ESC_PREFIXES << 8
    off = goff.to(i32)
    syms = []
    for _ in range(G_SIZE):
        w = (take_w(off >> 3) << (off & 7)) & U32
        w12 = (w >> (32 - LUT_BITS)).to(i32)
        e1 = torch.gather(lut1f, 1, ((gsel << LUT_BITS) + w12).to(i64))
        loc2 = (w >> 12).to(i32) - (ebase << 8)
        e2 = torch.gather(lut2f, 1, (gsel * w2 + loc2.clamp(0, w2 - 1)).to(i64))
        entry = torch.where(e1 > 0, e1, e2)
        off = off + torch.where(gvalid, entry & 31, 0)
        syms.append(entry >> 5)
    return torch.stack(syms, dim=2).reshape(B, G * G_SIZE)


def symbol_scan(words, goff, gsel, gvalid, lut1, lut2, esc_base):
    """words: flat (WT,) int64 bit buffer shared by the batch, or (B, WT)
    int64 rows, one per block (uint32 values, big-endian bit order); goff
    (B, G) int32 bit offsets into the buffer or the lane's row; gsel (B, G)
    int32 table per group; gvalid (B, G) bool; lut1 (B, 6, 4096), lut2
    (B, 6, ESC_PREFIXES*256) and esc_base (B, 6) int32 from
    ``decode.build_tables``.  Returns syms (B, G*50) int32 in stream order
    (an invalid lane keeps its offset, so its symbols are deterministic)."""
    if goff.dim() != 2 or words.dim() not in (1, 2) or (
            words.dim() == 2 and words.shape[0] != goff.shape[0]):
        raise ValueError(f"symbol_scan: words {tuple(words.shape)}, goff "
                         f"{tuple(goff.shape)}")
    if words.device.type == "cpu":
        return symbol_scan_plain(words, goff, gsel, gvalid, lut1, lut2,
                                 esc_base)
    B, G = goff.shape
    WT = words.shape[-1]
    _build.check(words, "symbol_scan words", i64, words.dim())
    for t, name, dt, shape in (
            (goff, "goff", i32, (B, G)), (gsel, "gsel", i32, (B, G)),
            (gvalid, "gvalid", torch.bool, (B, G)),
            (lut1, "lut1", i32, (B, 6, 1 << LUT_BITS)),
            (lut2, "lut2", i32, (B, 6, ESC_PREFIXES << 8)),
            (esc_base, "esc_base", i32, (B, 6))):
        _build.check(t, f"symbol_scan {name}", dt, len(shape))
        if tuple(t.shape) != shape:
            raise ValueError(f"symbol_scan {name}: expected {shape}, got "
                             f"{tuple(t.shape)}")
    if WT == 0 or WT >= 1 << 31:
        raise ValueError(f"symbol_scan: {WT} words")
    if lut1.data_ptr() % 16:
        raise ValueError("symbol_scan lut1: not 16-byte aligned")
    syms = torch.empty((B, G * G_SIZE), dtype=i32, device=goff.device)
    SCAN(_build.ptr(words), WT, WT if words.dim() == 2 else 0,
         _build.ptr(goff), _build.ptr(gsel), _build.ptr(gvalid),
         _build.ptr(lut1), _build.ptr(lut2), _build.ptr(esc_base),
         _build.ptr(syms), B, G, _build.stream_of(goff))
    return syms
