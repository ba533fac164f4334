# Copied from bzip2_tpu/compat.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""zlib-compatibility API (reference bzlib.c:1434-1628, bzlib.h:233-272).

Mirrors the reference's ``BZ2_bzopen`` family — the thin convenience layer
some clients use instead of the BZFILE API:

  bzopen(path, mode) / bzdopen(fd, mode)   mode strings like "rb", "w9", "rs"
  bzread(f, n) / bzwrite(f, data)
  bzflush(f) / bzclose(f)
  bzerror(f)                               -> (message, errnum)
  bzlibVersion()

Mode-string semantics follow the reference's parser (bzlib.c:1436-1494):
a digit sets the block size (write) , 's' requests small mode (decode — we
accept and ignore it, see SURVEY §7 "What we deliberately do NOT port"),
'r'/'w' pick the direction (read wins if both), everything else is ignored.
Errors are reported through ``bzerror`` like the reference (BZ_* codes), not
raised, except for invalid arguments to the open calls themselves.
"""
from __future__ import annotations

import os

from . import __version__, api
from .file import BZ2TFile

# bzlib.h:33-46 error codes
BZ_OK = 0
BZ_RUN_OK = 1
BZ_FLUSH_OK = 2
BZ_FINISH_OK = 3
BZ_STREAM_END = 4
BZ_SEQUENCE_ERROR = -1
BZ_PARAM_ERROR = -2
BZ_MEM_ERROR = -3
BZ_DATA_ERROR = -4
BZ_DATA_ERROR_MAGIC = -5
BZ_IO_ERROR = -6
BZ_UNEXPECTED_EOF = -7
BZ_OUTBUFF_FULL = -8
BZ_CONFIG_ERROR = -9

_ERRSTR = {
    BZ_OK: "OK", BZ_RUN_OK: "OK", BZ_FLUSH_OK: "OK", BZ_FINISH_OK: "OK",
    BZ_STREAM_END: "OK",
    BZ_SEQUENCE_ERROR: "SEQUENCE_ERROR", BZ_PARAM_ERROR: "PARAM_ERROR",
    BZ_MEM_ERROR: "MEM_ERROR", BZ_DATA_ERROR: "DATA_ERROR",
    BZ_DATA_ERROR_MAGIC: "DATA_ERROR_MAGIC", BZ_IO_ERROR: "IO_ERROR",
    BZ_UNEXPECTED_EOF: "UNEXPECTED_EOF", BZ_OUTBUFF_FULL: "OUTBUFF_FULL",
    BZ_CONFIG_ERROR: "CONFIG_ERROR",
}


class _BzFile:
    """Handle returned by bzopen/bzdopen."""

    def __init__(self, inner: BZ2TFile, writing: bool, own_fp=None):
        self._inner = inner
        self._writing = writing
        self._own_fp = own_fp      # fdopen'd file to close (bzdopen)
        self.lasterr = BZ_OK


def _parse_mode(mode: str):
    """(reading, writing, level, small) per bzlib.c:1449-1472."""
    reading = writing = False
    small = False
    level = 9
    for ch in mode or "":
        if ch == "r":
            reading = True
        elif ch == "w":
            writing = True
        elif ch == "s":
            small = True
        elif ch.isdigit():
            level = int(ch)
    if reading:
        writing = False            # reference: read wins (bzlib.c:1482-1483)
    if not reading and not writing:
        return None
    if writing and not (1 <= level <= 9):
        return None
    return reading, writing, level, small


def bzopen(path, mode: str = "rb"):
    """Open path for bzip2 read or write; returns a handle or None."""
    parsed = _parse_mode(mode)
    if parsed is None or path is None:
        return None
    reading, writing, level, _small = parsed
    try:
        inner = BZ2TFile(path, "rb" if reading else "wb", compresslevel=level)
    except OSError:
        return None
    return _BzFile(inner, writing)


def bzdopen(fd: int, mode: str = "rb"):
    """Like bzopen over an existing OS file descriptor."""
    parsed = _parse_mode(mode)
    if parsed is None or fd is None or fd < 0:
        return None
    reading, writing, level, _small = parsed
    try:
        fileobj = os.fdopen(fd, "rb" if reading else "wb")
        inner = BZ2TFile(fileobj, "rb" if reading else "wb",
                         compresslevel=level)
    except OSError:
        return None
    return _BzFile(inner, writing, own_fp=fileobj)


def bzread(f: _BzFile, n: int) -> bytes:
    """Read up to n decompressed bytes; b"" at EOF; None on error."""
    if f is None or f._writing or n < 0:
        if f is not None:
            f.lasterr = BZ_PARAM_ERROR
        return None
    try:
        return f._inner.read(n)
    except api.DataErrorMagic:
        f.lasterr = BZ_DATA_ERROR_MAGIC
    except api.UnexpectedEOF:
        f.lasterr = BZ_UNEXPECTED_EOF
    except api.DataError:
        f.lasterr = BZ_DATA_ERROR
    except OSError:
        f.lasterr = BZ_IO_ERROR
    return None


def bzwrite(f: _BzFile, data) -> int:
    """Write bytes; returns count written or -1 on error."""
    if f is None or not f._writing:
        if f is not None:
            f.lasterr = BZ_PARAM_ERROR
        return -1
    try:
        return f._inner.write(data)
    except OSError:
        f.lasterr = BZ_IO_ERROR
        return -1


def bzflush(f: _BzFile) -> int:
    """No-op matching the reference (bzflush doesn't flush compressed
    state, bzlib.c:1597-1600)."""
    return BZ_OK


def bzclose(f: _BzFile) -> None:
    if f is None:
        return
    try:
        f._inner.close()
        if f._own_fp is not None:
            f._own_fp.close()
    except OSError:
        f.lasterr = BZ_IO_ERROR


def bzerror(f: _BzFile):
    """(message, errnum) for the last error on this handle
    (bzlib.c:1618-1628)."""
    code = f.lasterr if f is not None else BZ_PARAM_ERROR
    return _ERRSTR.get(code, "??"), code


def bzlibVersion() -> str:
    return __version__
