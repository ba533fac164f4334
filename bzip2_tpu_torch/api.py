"""The port's one-shot compress API: stream framing around a registered
block encoder, and the error classes of its decoder.

Counterpart of the parts of ``bzip2_tpu/api.py`` that the port uses: the
error classes, the block-encoder registry with its exactly-periodic
origPtr corrector, the default backend, and the framing of ``compress``
(header, bit-spliced block payloads, end-of-stream magic and combined CRC).
No backend is registered until ``bzip2_tpu_torch.enable_gpu_backend`` or
``bzip2_tpu_torch.compress`` registers the port's engine as ``"gpu"``.
"""
from __future__ import annotations

from . import constants as C
from . import crc as _crc
from . import periodic
from . import rle1 as _rle1
from .bitstream import BitWriter, splice


class BZ2Error(Exception):
    code = C.BZ_DATA_ERROR


class DataError(BZ2Error):
    """Stream is corrupt (BZ_DATA_ERROR)."""
    code = C.BZ_DATA_ERROR


class DataErrorMagic(DataError):
    """Not a bzip2 stream (BZ_DATA_ERROR_MAGIC)."""
    code = C.BZ_DATA_ERROR_MAGIC


class UnexpectedEOF(BZ2Error):
    """Stream truncated mid-block (BZ_UNEXPECTED_EOF)."""
    code = C.BZ_UNEXPECTED_EOF


_BLOCK_ENCODERS: dict = {}
_default_backend: str | None = None


def register_block_encoder(name: str, fn) -> None:
    """Register a batched block encoder: fn(list[RLE1Block], level) ->
    list[(uint8 array, nbits)] of per-block bit payloads.

    ``compress`` wraps the encoder with the exactly-periodic origPtr
    corrector (``periodic.patch_payloads``), so its output equals stock
    bzip2's on periodic blocks too."""
    _BLOCK_ENCODERS[name] = fn


def set_default_backend(name: str | None) -> None:
    global _default_backend
    _default_backend = name


def get_default_backend() -> str | None:
    return _default_backend


def compress(data, level: int = 9, backend: str | None = None) -> bytes:
    """Compress ``data`` into a complete single .bz2 stream."""
    if not 1 <= level <= 9:
        raise ValueError("level must be 1..9")
    backend = backend or _default_backend
    encoder = _BLOCK_ENCODERS.get(backend)
    if encoder is None:
        raise ValueError(f"unknown backend {backend!r} (none registered: "
                         "call bzip2_tpu_torch.enable_gpu_backend())")
    return compress_with(encoder, data, level)


def compress_with(encoder, data, level: int = 9) -> bytes:
    """One .bz2 stream of ``data``: its RLE1 blocks through the block
    encoder ``encoder(blocks, level)`` and the periodic corrector, between
    the stream header and the end-of-stream magic and combined CRC."""
    if not 1 <= level <= 9:
        raise ValueError("level must be 1..9")
    blocks = _rle1.encode_blocks(data, level)
    payloads = periodic.patch_payloads(encoder(blocks, level), blocks,
                                       level) if blocks else []

    w = BitWriter()
    w.write(C.HDR_B, 8)
    w.write(C.HDR_Z, 8)
    w.write(C.HDR_h, 8)
    w.write(C.HDR_0 + level, 8)
    header, hbits = w.getvalue()
    parts = [(header, hbits)]
    parts.extend(payloads)
    eos = BitWriter()
    eos.write(C.EOS_MAGIC, 48)
    eos.write(_crc.combine_block_crcs([b.crc for b in blocks]), 32)
    parts.append(eos.getvalue())
    buf, _ = splice(parts)
    return buf.tobytes()
