"""ctypes bindings of the port's C++ host runtime (``bz2tpu_host.cpp``, a
copy of ``bzip2_tpu/native/bz2tpu_host.cpp``).

Binds only what the port calls: the CRC, the RLE1 split, the periodic
origPtr replay, the exact-heap Huffman lengths, the complete block encoder
of the engine's host workers, the decoder's per-block light parse, the
incremental block decoder (heals, ``stream.Decompressor`` and the
block-parallel decode) and the whole-stream decoder of the host
``api.decompress`` and the member-parallel decode.  The device decoder
never calls the whole-stream decoder.  ``available()`` or the first bound
call builds the library (``build.py``); a bound call raises if it did not
build.
"""
from __future__ import annotations

import ctypes as ct
import threading

import numpy as np

from .build import ensure_built

_lib = None
_load_failed = False
_lock = threading.Lock()

# error codes of the C exports (bzlib.h's BZ_* values)
BZT_OK = 0
BZT_MEM_ERROR = -3
BZT_DATA_ERROR = -4
BZT_DATA_ERROR_MAGIC = -5
BZT_UNEXPECTED_EOF = -7


def _load():
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        so = ensure_built()
        if so is None:
            _load_failed = True
            return None
        lib = ct.CDLL(so)
        lib.bz2tpu_crc32.restype = ct.c_uint32
        lib.bz2tpu_crc32.argtypes = [ct.c_void_p, ct.c_int64]
        lib.bz2tpu_make_code_lengths.restype = None
        lib.bz2tpu_make_code_lengths.argtypes = [
            ct.c_void_p, ct.c_void_p, ct.c_int32, ct.c_int32, ct.c_void_p]
        lib.bz2tpu_decode_some.restype = ct.c_int32
        lib.bz2tpu_decode_some.argtypes = [
            ct.c_void_p, ct.c_int64, ct.c_int64, ct.c_int32, ct.c_uint32,
            ct.POINTER(ct.c_void_p), ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int32)]
        lib.bz2tpu_decompress.restype = ct.c_int32
        lib.bz2tpu_decompress.argtypes = [
            ct.c_void_p, ct.c_int64, ct.c_int32, ct.POINTER(ct.c_void_p),
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64)]
        lib.bz2tpu_free.restype = None
        lib.bz2tpu_free.argtypes = [ct.c_void_p]
        lib.bz2tpu_set_rnums.restype = None
        lib.bz2tpu_set_rnums.argtypes = [ct.c_void_p]
        lib.bz2tpu_parse_block.restype = ct.c_int32
        lib.bz2tpu_parse_block.argtypes = [
            ct.c_void_p, ct.c_int64, ct.c_int64, ct.c_int32,
            ct.c_void_p, ct.c_void_p, ct.POINTER(ct.c_uint32), ct.c_void_p,
            ct.c_void_p, ct.c_void_p, ct.c_void_p]
        lib.bz2tpu_rle1_split.restype = ct.c_int64
        lib.bz2tpu_rle1_split.argtypes = [
            ct.c_void_p, ct.c_int64, ct.c_int32, ct.c_void_p, ct.c_void_p,
            ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_int64]
        lib.bz2tpu_fallback_origptr.restype = ct.c_int64
        lib.bz2tpu_fallback_origptr.argtypes = [ct.c_void_p, ct.c_int32]
        lib.bz2tpu_encode_block.restype = ct.c_int64
        lib.bz2tpu_encode_block.argtypes = [
            ct.c_void_p, ct.c_int32, ct.c_void_p, ct.c_uint32, ct.c_void_p,
            ct.c_int64]
        from ..rand_table import RNUMS
        r = np.ascontiguousarray(RNUMS, dtype=np.int32)
        lib.bz2tpu_set_rnums(r.ctypes.data_as(ct.c_void_p))
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


def _need():
    lib = _load()
    if lib is None:
        raise RuntimeError("bzip2_tpu_torch: the native host runtime did not "
                           "build (g++'s error is on stderr)")
    return lib


def _u8(data) -> np.ndarray:
    return np.ascontiguousarray(
        np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray)
        else data, dtype=np.uint8)


def crc32(data) -> int:
    buf = _u8(data)
    return int(_need().bz2tpu_crc32(buf.ctypes.data_as(ct.c_void_p), buf.size))


def rle1_split(data, nmax: int):
    """RLE1-encode + block-split (reference bzlib.c:212-315 semantics; see
    ``rle1.py``).  Returns (out u8 buffer, block_off i64, block_len i32,
    block_crc u32, in_use bool (B, 256), raw_end i64)."""
    lib = _need()
    buf = _u8(data)
    n = buf.size
    # worst-case RLE1 expansion is 5/4 (runs of exactly 4 emit 4 literals +
    # a length byte), so the block table is sized from the expanded output
    max_blocks = (n + n // 4) // max(nmax, 1) + 2
    out = np.empty(n + n // 4 + 16, np.uint8)
    block_off = np.empty(max_blocks, np.int64)
    block_len = np.empty(max_blocks, np.int32)
    block_crc = np.empty(max_blocks, np.uint32)
    in_use = np.empty((max_blocks, 256), np.uint8)
    raw_end = np.empty(max_blocks, np.int64)
    nb = lib.bz2tpu_rle1_split(
        buf.ctypes.data_as(ct.c_void_p), n, np.int32(nmax),
        out.ctypes.data_as(ct.c_void_p),
        block_off.ctypes.data_as(ct.c_void_p),
        block_len.ctypes.data_as(ct.c_void_p),
        block_crc.ctypes.data_as(ct.c_void_p),
        in_use.ctypes.data_as(ct.c_void_p),
        raw_end.ctypes.data_as(ct.c_void_p), max_blocks)
    if nb < 0:
        raise RuntimeError(f"rle1_split: native error {nb}")
    nb = int(nb)
    return (out, block_off[:nb], block_len[:nb], block_crc[:nb],
            in_use[:nb].astype(bool), raw_end[:nb])


def fallback_origptr(block) -> int:
    """Sorted-order index of rotation 0 under stock bzip2's fallback-sort
    dynamics (the origPtr stock emits on exactly-periodic blocks)."""
    lib = _need()
    buf = _u8(block)
    op = int(lib.bz2tpu_fallback_origptr(buf.ctypes.data_as(ct.c_void_p),
                                         np.int32(buf.size)))
    if op < 0:
        raise RuntimeError("fallback_origptr: invalid input")
    return op


def encode_block(block, in_use, crc: int):
    """Encode one RLE1 block (bytes + 256-bool used table + raw CRC) into
    its bit payload with the complete native block encoder (the engine's
    host workers).  Returns (payload bytes, nbits)."""
    lib = _need()
    buf = _u8(block)
    use = np.ascontiguousarray(np.asarray(in_use), dtype=np.uint8)
    out = np.empty(3 * buf.size + (1 << 16), np.uint8)
    bits = lib.bz2tpu_encode_block(
        buf.ctypes.data_as(ct.c_void_p), np.int32(buf.size),
        use.ctypes.data_as(ct.c_void_p), np.uint32(crc & 0xFFFFFFFF),
        out.ctypes.data_as(ct.c_void_p), out.size)
    if bits < 0:
        raise RuntimeError(f"native encode failed (rc={bits})")
    nbits = int(bits)
    return bytes(out[: (nbits + 7) // 8]), nbits


def make_code_lengths_batch(freqs: np.ndarray, alphas: np.ndarray,
                            max_len: int = 17) -> np.ndarray:
    """freqs: (L, 258) int32; alphas: (L,) int32 -> (L, 258) int32."""
    lib = _need()
    freqs = np.ascontiguousarray(freqs, dtype=np.int32)
    alphas = np.ascontiguousarray(alphas, dtype=np.int32)
    out = np.zeros_like(freqs)
    lib.bz2tpu_make_code_lengths(
        freqs.ctypes.data_as(ct.c_void_p), alphas.ctypes.data_as(ct.c_void_p),
        np.int32(freqs.shape[0]), np.int32(max_len),
        out.ctypes.data_as(ct.c_void_p))
    return out


class ParsedBlock:
    """Header + light-scan metadata for one block (bz2tpu_parse_block):
    the host half of the device decode path.  Fields mirror the C export;
    the decoder sets ``start_bit``."""

    __slots__ = ("n_used", "n_groups", "n_selectors", "orig_ptr",
                 "randomised", "n_mtf", "n_groups_used", "sym_start_bit",
                 "end_bit", "stored_crc", "used", "selectors", "lens",
                 "group_offsets", "start_bit")


def parse_block(data, start_bit: int, level: int):
    """Parse one block header at ``start_bit`` (the 48-bit magic) and
    light-scan its symbol stream.  Returns (ParsedBlock, BZT_OK) or
    (None, errcode)."""
    lib = _need()
    buf = _u8(data)
    hdr_i32 = np.zeros(7, np.int32)
    hdr_i64 = np.zeros(2, np.int64)
    crc_out = ct.c_uint32()
    used = np.zeros(256, np.uint8)
    selectors = np.zeros(18002, np.uint8)
    lens = np.zeros((6, 258), np.uint8)
    goff = np.zeros(18002, np.int64)
    rc = lib.bz2tpu_parse_block(
        buf.ctypes.data_as(ct.c_void_p), buf.size, start_bit,
        np.int32(100_000 * level),
        hdr_i32.ctypes.data_as(ct.c_void_p),
        hdr_i64.ctypes.data_as(ct.c_void_p), ct.byref(crc_out),
        used.ctypes.data_as(ct.c_void_p),
        selectors.ctypes.data_as(ct.c_void_p),
        lens.ctypes.data_as(ct.c_void_p),
        goff.ctypes.data_as(ct.c_void_p))
    if rc != BZT_OK:
        return None, rc
    pb = ParsedBlock()
    (pb.n_used, pb.n_groups, pb.n_selectors, pb.orig_ptr, pb.randomised,
     pb.n_mtf, pb.n_groups_used) = (int(x) for x in hdr_i32)
    pb.sym_start_bit, pb.end_bit = (int(x) for x in hdr_i64)
    pb.stored_crc = int(crc_out.value)
    pb.used = used.astype(bool)
    pb.selectors = selectors[:pb.n_selectors].astype(np.int32)
    pb.lens = lens
    pb.group_offsets = goff[:pb.n_groups_used]
    return pb, rc


def decode_some(data, start_bit: int, level: int, combined: int):
    """Incremental decode of complete blocks from start_bit.

    Returns (out_bytes, next_bit, level, combined, status, errcode) where
    status: 0 = need more input, 1 = stream end reached.  level 0 on input
    means "expect a stream header".  out_bytes is None on error."""
    lib = _need()
    buf = _u8(data)
    out_p = ct.c_void_p()
    out_len = ct.c_int64()
    next_bit = ct.c_int64()
    level_out = ct.c_int32()
    combined_out = ct.c_uint32()
    status = ct.c_int32()
    rc = lib.bz2tpu_decode_some(
        buf.ctypes.data_as(ct.c_void_p), buf.size, start_bit,
        level, combined & 0xFFFFFFFF,
        ct.byref(out_p), ct.byref(out_len), ct.byref(next_bit),
        ct.byref(level_out), ct.byref(combined_out), ct.byref(status))
    if rc != BZT_OK:
        return None, start_bit, level, combined, 0, rc
    try:
        res = ct.string_at(out_p.value, out_len.value) if out_len.value else b""
    finally:
        lib.bz2tpu_free(out_p)
    return (res, int(next_bit.value), int(level_out.value),
            int(combined_out.value), int(status.value), rc)


def decompress(data, multi_stream: bool = False):
    """Decode a whole stream (or every concatenated stream if
    ``multi_stream``).  Returns (bytes, consumed, errcode); bytes is None
    on error."""
    lib = _need()
    buf = _u8(data)
    out_p = ct.c_void_p()
    out_len = ct.c_int64()
    consumed = ct.c_int64()
    rc = lib.bz2tpu_decompress(
        buf.ctypes.data_as(ct.c_void_p), buf.size,
        1 if multi_stream else 0,
        ct.byref(out_p), ct.byref(out_len), ct.byref(consumed))
    if rc != BZT_OK:
        return None, 0, rc
    try:
        res = ct.string_at(out_p.value, out_len.value) if out_len.value else b""
    finally:
        lib.bz2tpu_free(out_p)
    return res, int(consumed.value), rc
