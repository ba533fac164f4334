"""The port's one-shot API: ``compress(bytes) -> bytes`` and
``decompress(bytes) -> bytes``, and the error classes of its decoders.

Counterpart of ``bzip2_tpu/api.py``: the error classes, the block-encoder
registry (each entry wrapped with the exactly-periodic origPtr corrector
when it is registered), the default backend, the framing of ``compress``
(header, bit-spliced block payloads, end-of-stream magic and combined CRC)
and ``decompress`` / ``decompress_with_tail``.  Two backends are known by
name and registered at first use: ``"gpu"``, the default, is the port's
default engine on the card (``engine.register_backend``), and ``"native"``
is the engine with ``use_device=False`` (host workers only; the card is
never touched).  To decode, ``"gpu"`` (the default) is the device decoder
(``decoder.default_decoder``) and ``"native"`` the C++ whole-stream
decoder.  There is no oracle backend: the port needs its native runtime.
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
_default_backend: str | None = "gpu"


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


def _register_gpu() -> None:
    from .engine import register_backend
    register_backend()


def _register_native() -> None:
    from .engine import engine_for
    register_block_encoder(
        "native", lambda blocks, level: engine_for(
            use_device=False).encode_payloads(blocks, level))


#: the backends registered at their first use, if no entry of that name
#: was registered before
_AT_FIRST_USE = {"gpu": _register_gpu, "native": _register_native}


def _known_backend(name: str) -> bool:
    return name in _AT_FIRST_USE or name in _BLOCK_ENCODERS


def block_encoder(name: str | None):
    """The registry entry ``name``; "gpu" and "native" are registered at
    first use.  Raises ValueError for a name that is neither."""
    fn = _BLOCK_ENCODERS.get(name)
    if fn is None and name in _AT_FIRST_USE:
        _AT_FIRST_USE[name]()
        fn = _BLOCK_ENCODERS.get(name)
    if fn is None:
        raise ValueError(f"unknown backend {name!r}")
    return fn


def set_default_backend(name: str | None) -> None:
    global _default_backend
    _default_backend = name


def get_default_backend() -> str | None:
    return _default_backend


def compress(data, level: int = 9, backend: str | None = None) -> bytes:
    """Compress ``data`` into a complete single .bz2 stream."""
    if not 1 <= level <= 9:
        raise ValueError("level must be 1..9")
    return _compress_blocks(block_encoder(backend or _default_backend),
                            data, level)


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


def decompress(data, multi_stream: bool = False,
               backend: str | None = None) -> bytes:
    """Decompress one .bz2 stream (or all concatenated streams if
    ``multi_stream``).  Verifies both CRC layers.

    Raises DataErrorMagic / DataError / UnexpectedEOF exactly where the
    reference returns the corresponding BZ_* codes.  backend: "gpu" (the
    default, the device decoder) or "native" (the host decoder)."""
    out, _ = decompress_with_tail(data, multi_stream=multi_stream,
                                  backend=backend)
    return out


def decompress_with_tail(data, multi_stream: bool = False,
                         backend: str | None = None) -> tuple[bytes, int]:
    """Like decompress(); also returns the byte offset where parsing stopped
    (start of any trailing garbage / next stream)."""
    backend = backend or "gpu"
    if backend == "gpu":
        from .decoder import default_decoder
        return default_decoder().decompress_with_tail(
            data, multi_stream=multi_stream)
    if backend != "native":
        raise ValueError(f"unknown backend {backend!r}")
    from . import native
    out, consumed, rc = native.decompress(data, multi_stream=multi_stream)
    if rc == native.BZT_OK:
        return out, consumed
    if rc == native.BZT_DATA_ERROR_MAGIC:
        raise DataErrorMagic("bad stream header")
    if rc == native.BZT_UNEXPECTED_EOF:
        raise UnexpectedEOF("stream truncated")
    raise DataError(f"corrupt stream (native rc={rc})")
