# Copied from bzip2_tpu/file.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""File-level API: ``BZ2TFile`` and ``open()``.

Mirrors the reference's high-level BZFILE layer (bzlib.c:943-1300):
buffered read/write handles over the streaming objects, multi-member
(concatenated) stream handling on read — including the unused-byte handoff
between members (BZ2_bzReadGetUnused) — and abandon semantics on close after
an error.  Interface modeled on the stdlib ``bz2.BZ2File`` so it is a
drop-in replacement.  Writes encode through ``backend``'s block encoder
(default "gpu", the card); reads decode on the host
(``stream.Decompressor``) whatever the backend.
"""
from __future__ import annotations

import io
import os

from .stream import Compressor, Decompressor
from .api import DataErrorMagic

_MODE_CLOSED, _MODE_READ, _MODE_WRITE = 0, 1, 2


class BZ2TFile(io.BufferedIOBase):
    def __init__(self, filename, mode: str = "r", *, compresslevel: int = 9,
                 backend: str | None = None):
        self._fp = None
        self._close_fp = False
        self._mode = _MODE_CLOSED
        self._backend = backend

        if mode in ("", "r", "rb"):
            mode_code = _MODE_READ
        elif mode in ("w", "wb", "x", "xb", "a", "ab"):
            mode_code = _MODE_WRITE
        else:
            raise ValueError(f"invalid mode: {mode!r}")

        if isinstance(filename, (str, bytes, os.PathLike)):
            raw_mode = {"r": "rb", "": "rb"}.get(mode.rstrip("b"), mode.rstrip("b") + "b")
            self._fp = io.open(filename, raw_mode)
            self._close_fp = True
        elif hasattr(filename, "read") or hasattr(filename, "write"):
            self._fp = filename
        else:
            raise TypeError("filename must be a path or file object")

        self._mode = mode_code
        if mode_code == _MODE_READ:
            self._decomp = Decompressor(backend=backend)
            self._read_buf = b""
            self._read_pos = 0
            self._eof_all = False
            self._pos = 0
        else:
            self._comp = Compressor(compresslevel, backend=backend)
            self._pos = 0

    # ------------------------------------------------------------- common --
    def close(self) -> None:
        if self._mode == _MODE_CLOSED:
            return
        try:
            if self._mode == _MODE_WRITE:
                self._fp.write(self._comp.flush())
        finally:
            try:
                if self._close_fp:
                    self._fp.close()
            finally:
                self._fp = None
                self._mode = _MODE_CLOSED

    @property
    def closed(self) -> bool:
        return self._mode == _MODE_CLOSED

    def fileno(self):
        return self._fp.fileno()

    def seekable(self) -> bool:
        return False

    def readable(self) -> bool:
        return self._mode == _MODE_READ

    def writable(self) -> bool:
        return self._mode == _MODE_WRITE

    # --------------------------------------------------------------- read --
    def _fill(self) -> bool:
        """Decode more data into the read buffer; returns False at EOF."""
        while self._read_pos >= len(self._read_buf):
            if self._eof_all:
                return False
            if self._decomp.eof:
                # Next member: reuse unused bytes, tolerate trailing garbage
                tail = self._decomp.unused_data
                nxt = self._fp.read(64 * 1024)
                data = tail + (nxt or b"")
                if not data.strip(b"\x00") and not nxt:
                    self._eof_all = True
                    return False
                self._decomp = Decompressor(backend=self._backend)
                try:
                    out = self._decomp.decompress(data)
                except DataErrorMagic:
                    self._eof_all = True  # trailing garbage after >=1 member
                    return False
                self._read_buf, self._read_pos = out, 0
                continue
            chunk = self._fp.read(64 * 1024)
            if not chunk:
                if not self._decomp.eof:
                    from .api import UnexpectedEOF
                    raise UnexpectedEOF("truncated bzip2 stream")
                continue
            out = self._decomp.decompress(chunk)
            self._read_buf, self._read_pos = out, 0
        return True

    def read(self, size: int = -1) -> bytes:
        if self._mode != _MODE_READ:
            raise io.UnsupportedOperation("file not open for reading")
        parts = []
        remaining = size if size >= 0 else None
        while remaining is None or remaining > 0:
            if not self._fill():
                break
            take = len(self._read_buf) - self._read_pos
            if remaining is not None:
                take = min(take, remaining)
                remaining -= take
            parts.append(self._read_buf[self._read_pos:self._read_pos + take])
            self._read_pos += take
        out = b"".join(parts)
        self._pos += len(out)
        return out

    def read1(self, size: int = -1) -> bytes:
        if not self._fill():
            return b""
        take = len(self._read_buf) - self._read_pos
        if size >= 0:
            take = min(take, size)
        out = self._read_buf[self._read_pos:self._read_pos + take]
        self._read_pos += take
        self._pos += len(out)
        return out

    # -------------------------------------------------------------- write --
    def write(self, data) -> int:
        if self._mode != _MODE_WRITE:
            raise io.UnsupportedOperation("file not open for writing")
        out = self._comp.compress(bytes(data))
        if out:
            self._fp.write(out)
        self._pos += len(data)
        return len(data)

    def tell(self) -> int:
        return self._pos


def open(filename, mode: str = "rb", *, compresslevel: int = 9,
         encoding=None, errors=None, newline=None, backend=None):
    """bz2.open-compatible helper (text modes supported via TextIOWrapper)."""
    if "t" in mode:
        binary = BZ2TFile(filename, mode.replace("t", ""),
                          compresslevel=compresslevel, backend=backend)
        return io.TextIOWrapper(binary, encoding, errors, newline)
    if encoding or errors or newline:
        raise ValueError("text-mode arguments with binary mode")
    return BZ2TFile(filename, mode, compresslevel=compresslevel,
                    backend=backend)
