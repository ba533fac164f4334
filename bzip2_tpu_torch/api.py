"""The port's one-shot compress API: stream framing around a registered
block encoder, and the error classes of its decoder.

Counterpart of the parts of ``bzip2_tpu/api.py`` that the port uses: the
error classes, the block-encoder registry (each entry wrapped with the
exactly-periodic origPtr corrector when it is registered), the default
backend, and the framing of ``compress`` (header, bit-spliced block
payloads, end-of-stream magic and combined CRC).  No backend is registered
until ``bzip2_tpu_torch.enable_gpu_backend`` or
``bzip2_tpu_torch.engine.register_backend`` registers the port's engine as
``"gpu"``.
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

    The registry holds ``fn`` wrapped with the exactly-periodic origPtr
    corrector (``periodic.patch_payloads``), as the reference's does, so a
    caller of a registry entry gets stock bzip2's payloads on periodic
    blocks too, and ``compress`` frames them without patching again."""
    _BLOCK_ENCODERS[name] = _corrected(fn)


def _corrected(fn):
    """The block encoder ``fn`` with its payloads passed through the
    periodic corrector."""

    def wrapped(blocks, level):
        return periodic.patch_payloads(fn(blocks, level), blocks, level)

    return wrapped


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
    return _compress_blocks(encoder, data, level)


def compress_with(encoder, data, level: int = 9) -> bytes:
    """One .bz2 stream of ``data`` through a raw block encoder
    ``encoder(blocks, level)`` (one not taken from the registry): its
    payloads go through the periodic corrector once, then into the stream
    framing."""
    if not 1 <= level <= 9:
        raise ValueError("level must be 1..9")
    return _compress_blocks(_corrected(encoder), data, level)


def _compress_blocks(encoder, data, level: int) -> bytes:
    """The RLE1 blocks of ``data`` through ``encoder``, whose payloads are
    final, then framed."""
    blocks = _rle1.encode_blocks(data, level)
    return frame(blocks, encoder(blocks, level) if blocks else [], level)


def frame(blocks: list, payloads: list, level: int) -> bytes:
    """The stream of ``blocks``' final payloads: the header, the payloads
    bit-spliced, then the end-of-stream magic and the combined CRC."""
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
