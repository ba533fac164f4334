# Copied from bzip2_tpu/recover.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""bz2t-recover: salvage blocks from damaged .bz2 files.

Same contract as the reference's bzip2recover (bzip2recover.c:284-504): scan
the damaged file at *bit* granularity for the 48-bit block and end-of-stream
magics, then write each block span as its own valid single-block .bz2 (a
``BZh9`` header, the block bits, and an EOS trailer whose combined CRC is the
block's own CRC — the rotl-fold of a single element).

The scan is vectorized: for each of the 8 bit phases we compare 6-byte
windows of the shifted buffer against the magic patterns (NumPy), instead of
walking bit by bit.  This same scanner is the block-discovery primitive for
parallel decode of damaged or concatenated streams.  Each block is
validated by the host decoder (``api.decompress(..., backend="native")``).
"""
from __future__ import annotations

import os
import sys

import numpy as np

from . import constants as C
from .bitstream import BitReader, BitWriter, splice

_BLOCK = C.BLOCK_MAGIC.to_bytes(6, "big")
_EOS = C.EOS_MAGIC.to_bytes(6, "big")


def find_magics(data: np.ndarray) -> list[tuple[int, bool]]:
    """Return sorted [(bit_offset, is_eos)] of every 48-bit magic occurrence."""
    n = data.size
    hits: list[tuple[int, bool]] = []
    if n < 6:
        return hits
    buf = data.astype(np.uint16)
    for phase in range(8):
        if phase == 0:
            shifted = data
        else:
            # byte stream shifted left by `phase` bits
            hi = (buf[:-1] << phase) & 0xFF
            lo = buf[1:] >> (8 - phase)
            shifted = (hi | lo).astype(np.uint8)
        m = shifted.size - 5
        if m <= 0:
            continue
        view = np.lib.stride_tricks.sliding_window_view(shifted, 6)
        for pat, is_eos in ((np.frombuffer(_BLOCK, np.uint8), False),
                            (np.frombuffer(_EOS, np.uint8), True)):
            eq = (view == pat).all(axis=1)
            for byte_off in np.flatnonzero(eq):
                hits.append((int(byte_off) * 8 + phase, is_eos))
    hits.sort()
    return hits


def recover_blocks(data: bytes):
    """Yield (bit_start, bit_end) spans of candidate blocks (magic included
    at start, end exclusive of the next magic)."""
    arr = np.frombuffer(data, np.uint8)
    magics = find_magics(arr)
    spans = []
    for i, (pos, is_eos) in enumerate(magics):
        if is_eos:
            continue
        end = magics[i + 1][0] if i + 1 < len(magics) else arr.size * 8
        spans.append((pos, end))
    return spans


def extract_block_stream(data: bytes, span: tuple[int, int]) -> bytes | None:
    """Re-wrap one block span as a standalone single-block .bz2 stream,
    or None if the span is malformed."""
    start, end = span
    arr = np.frombuffer(data, np.uint8)
    r = BitReader(arr, start_bit=start)
    try:
        magic = r.read(48)
        if magic != C.BLOCK_MAGIC:
            return None
        block_crc = r.read(32)
    except EOFError:
        return None

    w = BitWriter()
    for v in (C.HDR_B, C.HDR_Z, C.HDR_h, C.HDR_0 + 9):
        w.write(v, 8)
    header, hbits = w.getvalue()

    # copy the block bits verbatim (magic..end)
    nbits = end - start
    body = BitWriter()
    pos = start
    while pos < end:
        take = min(32, end - pos)
        rr = BitReader(arr, start_bit=pos)
        body.write(rr.read(take), take)
        pos += take
    bbuf, bbits = body.getvalue()

    eos = BitWriter()
    eos.write(C.EOS_MAGIC, 48)
    eos.write(block_crc, 32)  # combined CRC of a single block == its CRC
    ebuf, ebits = eos.getvalue()

    out, _ = splice([(header, hbits), (bbuf, bbits), (ebuf, ebits)])
    return out.tobytes()


def recover_file(path: str, verbose: bool = True, validate: bool = True) -> int:
    """Write rec00001<name>.bz2 ... for each salvageable block; returns the
    number of blocks written (mirrors bzip2recover's output naming)."""
    with open(path, "rb") as f:
        data = f.read()
    spans = recover_blocks(data)
    if verbose:
        sys.stderr.write(f"bz2t-recover: searching for block boundaries ...\n")
        sys.stderr.write(f"bz2t-recover: found {len(spans)} candidate block(s)\n")
    base = os.path.basename(path)
    dirn = os.path.dirname(path) or "."
    written = 0
    for i, span in enumerate(spans, 1):
        stream = extract_block_stream(data, span)
        if stream is None:
            continue
        if validate:
            from . import api
            try:
                api.decompress(stream, backend="native")
            except api.BZ2Error:
                if verbose:
                    sys.stderr.write(
                        f"bz2t-recover: block {i} fails validation, skipped\n")
                continue
        name = os.path.join(dirn, f"rec{written + 1:05d}{base}")
        if not name.endswith(".bz2"):
            name += ".bz2"
        with open(name, "wb") as f:
            f.write(stream)
        if verbose:
            sys.stderr.write(f"bz2t-recover: writing {name}\n")
        written += 1
    return written


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        sys.stderr.write("usage: bz2t-recover <damaged.bz2>\n")
        return 1
    try:
        n = recover_file(argv[0])
    except OSError as e:
        sys.stderr.write(f"bz2t-recover: {e}\n")
        return 1
    return 0 if n > 0 else 2


if __name__ == "__main__":
    sys.exit(main())
