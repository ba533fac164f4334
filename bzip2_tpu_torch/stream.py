# Copied from bzip2_tpu/stream.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""Streaming (push) compression and decompression objects.

Mirrors the reference's caller-driven stream semantics (bz_stream,
bzlib.c:362-454 / 870-920) with the Python-idiomatic surface of
``bz2.BZ2Compressor`` / ``BZ2Decompressor``:

* ``Compressor.compress(data)``: buffers input and emits every block that is
  *provably closed* regardless of future input.  A block is held back while
  the RLE1 state machine's end-of-stream epilogue could still change it, so
  chunked compression is byte-identical to one-shot (verified by tests).
  The blocks go to the registry's block encoder of ``backend`` (default:
  ``api.get_default_backend()``, "gpu").
* ``Compressor.flush()``: final block + EOS trailer (BZ_FINISH).
* ``Decompressor.decompress(data)``: emits output per completed block; sets
  ``eof`` and ``unused_data`` at end of stream (the BZ2_bzReadGetUnused
  contract, bzlib.c:1283-1300).  It decodes on the host: through the
  pure-Python oracle (``oracle.block.decode_block_body``) for backend
  "oracle", else through ``native.decode_some``.
"""
from __future__ import annotations

import numpy as np

from . import constants as C
from . import crc as _crc
from . import rle1 as _rle1
from .api import (DataError, DataErrorMagic, _known_backend, block_encoder,
                  get_default_backend)
from .bitstream import BitWriter


class _BitAccumulator:
    """Accumulates (bytes, nbits) parts; yields completed whole bytes."""

    def __init__(self) -> None:
        self._acc = 0
        self._accn = 0

    def push(self, data: np.ndarray, nbits: int) -> bytes:
        w = BitWriter()
        if self._accn:
            w.write(self._acc, self._accn)
        w.write_bits_array(np.asarray(data, np.uint8), nbits)
        buf, total = w.getvalue()
        full = total // 8
        self._accn = total - full * 8
        self._acc = (int(buf[full]) >> (8 - self._accn)) if self._accn else 0
        return buf[:full].tobytes()

    def final(self) -> bytes:
        if not self._accn:
            return b""
        out = bytes([(self._acc << (8 - self._accn)) & 0xFF])
        self._acc = 0
        self._accn = 0
        return out


class Compressor:
    def __init__(self, level: int = 9, backend: str | None = None):
        if not 1 <= level <= 9:
            raise ValueError("level must be in 1..9")
        self.level = level
        self._backend = backend or get_default_backend()
        self._buf = bytearray()
        self._bits = _BitAccumulator()
        self._crcs: list[int] = []
        self._started = False
        self._finished = False
        #: consumed / produced byte counters (reference bz_stream total_in/
        #: total_out, 64-bit; Python ints don't wrap)
        self.total_in = 0
        self.total_out = 0
        # enough raw bytes to guarantee at least one closed block (RLE1
        # expands at most 5/4) plus slack
        self._watermark = (C.nblock_max(level) * 5) // 4 + 1024

    def _encoder(self):
        return block_encoder(self._backend)

    def _header(self) -> bytes:
        return bytes([C.HDR_B, C.HDR_Z, C.HDR_h, C.HDR_0 + self.level])

    def compress(self, data) -> bytes:
        if self._finished:
            raise ValueError("compressor has been flushed")
        data = bytes(data)
        self.total_in += len(data)
        self._buf += data
        out = b""
        if not self._started:
            out += self._header()
            self._started = True
        if len(self._buf) < self._watermark:
            return out
        blocks = _rle1.encode_blocks(bytes(self._buf), self.level)
        if len(blocks) <= 1:
            return out
        # Emit all blocks but the last: the final block's contents (and the
        # previous boundary, via the EOS epilogue rule) may still change
        # with more input.  Everything before is final.
        emit, hold = blocks[:-1], blocks[-1]
        payloads = self._encoder()(emit, self.level)
        for blk, (bits, nbits) in zip(emit, payloads):
            self._crcs.append(blk.crc)
            out += self._bits.push(bits, nbits)
        del self._buf[:hold.raw_span[0]]
        self.total_out += len(out)
        return out

    def flush(self) -> bytes:
        if self._finished:
            raise ValueError("compressor has been flushed")
        self._finished = True
        out = b""
        if not self._started:
            out += self._header()
            self._started = True
        blocks = _rle1.encode_blocks(bytes(self._buf), self.level)
        self._buf.clear()
        if blocks:
            payloads = self._encoder()(blocks, self.level)
            for blk, (bits, nbits) in zip(blocks, payloads):
                self._crcs.append(blk.crc)
                out += self._bits.push(bits, nbits)
        eos = BitWriter()
        eos.write(C.EOS_MAGIC, 48)
        eos.write(_crc.combine_block_crcs(self._crcs), 32)
        ebuf, ebits = eos.getvalue()
        out += self._bits.push(ebuf, ebits)
        out += self._bits.final()
        self.total_out += len(out)
        return out


class Decompressor:
    """Block-granular streaming decoder.  ``backend="oracle"`` decodes with
    the pure-Python oracle; every other known backend ("gpu", "native",
    None or a registered name) reads with the native incremental decoder
    (``native.decode_some``) on the host."""

    def __init__(self, backend: str | None = None):
        if backend is not None and not _known_backend(backend):
            raise ValueError(f"unknown backend {backend!r}")
        self._use_oracle = backend == "oracle"
        self.eof = False
        self.unused_data = b""
        #: bytes actually *consumed* by the decoder (bz_stream total_in
        #: parity: buffered-but-undecoded input does not count until a block
        #: completes; see the bit-position accounting in decompress()).
        self.total_in = 0
        self.total_out = 0
        self._pushed = 0
        self._dropped = 0
        self._buf = bytearray()
        self._bitpos = 0
        self._level = 0
        self._combined = 0

    @property
    def needs_input(self) -> bool:
        return not self.eof

    def decompress(self, data) -> bytes:
        if self.eof:
            self.unused_data += bytes(data)
            return b""
        data = bytes(data)
        self._pushed += len(data)
        self._buf += data
        if self._use_oracle:
            out = self._decompress_oracle()
            self.total_out += len(out)
            if self.eof:
                self.total_in = self._pushed - len(self.unused_data)
            else:
                self.total_in = min(self._pushed, (self._bitpos + 7) // 8)
            return out
        from . import native
        out, nbit, level, comb, status, rc = native.decode_some(
            bytes(self._buf), self._bitpos, self._level, self._combined)
        if rc == native.BZT_DATA_ERROR_MAGIC:
            raise DataErrorMagic("bad stream header")
        if rc != native.BZT_OK:
            raise DataError(f"corrupt stream (rc={rc})")
        self._bitpos, self._level, self._combined = nbit, level, comb
        self.total_out += len(out)
        if status == 1:
            self.eof = True
            self.unused_data = bytes(self._buf[(nbit + 7) // 8:])
            self.total_in = self._pushed - len(self.unused_data)
            self._buf.clear()
        else:
            # consumed = bytes covered by the resume bit position
            self.total_in = min(
                self._pushed,
                self._dropped + (self._bitpos + 7) // 8)
            # drop consumed whole bytes to bound memory
            drop = self._bitpos // 8
            if drop > (1 << 20):
                del self._buf[:drop]
                self._dropped += drop
                self._bitpos -= drop * 8
        return out

    def _decompress_oracle(self) -> bytes:
        """Pure-Python incremental path (slow; backend "oracle")."""
        from .bitstream import BitReader
        from .oracle import block as _oblock

        out = b""
        r = BitReader(np.frombuffer(bytes(self._buf), np.uint8))
        r.pos = self._bitpos
        while True:
            save = r.pos
            try:
                if self._level == 0:
                    hb, hz, hh, hl = (r.read(8) for _ in range(4))
                    if ((hb, hz, hh) != (C.HDR_B, C.HDR_Z, C.HDR_h)
                            or not C.HDR_0 + 1 <= hl <= C.HDR_0 + 9):
                        raise DataErrorMagic("bad stream header")
                    self._level = hl - C.HDR_0
                    self._bitpos = r.pos
                    continue
                magic = r.read(48)
                if magic == C.EOS_MAGIC:
                    stored = r.read(32)
                    if stored != self._combined:
                        raise DataError("combined CRC mismatch")
                    self.eof = True
                    self.unused_data = bytes(self._buf[(r.pos + 7) // 8:])
                    self._buf.clear()
                    return out
                if magic != C.BLOCK_MAGIC:
                    raise DataError("bad block magic")
                stored_crc, raw = _oblock.decode_block_body(r, self._level)
                if _crc.crc32(raw) != stored_crc:
                    raise DataError("block CRC mismatch")
                self._combined = ((((self._combined << 1)
                                    | (self._combined >> 31)) & 0xFFFFFFFF)
                                  ^ stored_crc)
                out += raw.tobytes()
                self._bitpos = r.pos
            except EOFError:
                r.pos = save
                return out
            except _oblock.DataError as e:
                raise DataError(str(e)) from e
