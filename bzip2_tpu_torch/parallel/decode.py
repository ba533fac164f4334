# Copied from bzip2_tpu/parallel/decode.py: the port keeps its own copy and imports nothing of bzip2_tpu.
"""Parallel decode of multi-member .bz2 streams on the host, and the magic
scans of the port's device decoder.

Concatenated .bz2 members are byte-aligned (each stream is padded to a byte
boundary), so member starts can be discovered without decoding: scan for
the 10-byte pattern ``BZh<level>`` + 48-bit block magic (or EOS magic for
an empty member).  That is the same magic-scan idea as ``bzip2recover``
(bzip2recover.c:284-288) lifted to stream granularity, where it is exact
enough to drive speculative parallelism: each candidate segment decodes
independently (the native decoder releases the GIL, so workers scale on
real cores; block CRCs validate every segment), and any false-positive
candidate is healed by re-merging the segment with its successor and
decoding sequentially.  Every decode here is the native runtime's
(``native.decompress``, ``native.decode_some`` and the host
``api.decompress``); ``find_bit_magics`` also feeds the device decoder's
parse pool.
"""
from __future__ import annotations

import concurrent.futures as _cf

import numpy as np

from .. import api
from ..constants import BLOCK_MAGIC, EOS_MAGIC


def find_member_offsets(data) -> list[int]:
    """Byte offsets of plausible member starts: BZh[1-9] followed by a
    block or EOS magic.  Offset 0 is always included (validated later)."""
    buf = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else data
    n = buf.size
    if n < 10:
        return [0]
    cand = ((buf[:-9] == ord("B")) & (buf[1:-8] == ord("Z"))
            & (buf[2:-7] == ord("h"))
            & (buf[3:-6] >= ord("1")) & (buf[3:-6] <= ord("9")))
    idx = np.flatnonzero(cand)
    bm = BLOCK_MAGIC.to_bytes(6, "big")
    em = EOS_MAGIC.to_bytes(6, "big")
    offs = [0]
    view = buf.tobytes()
    for i in idx:
        i = int(i)
        if i == 0:
            continue
        magic = view[i + 4:i + 10]
        if magic == bm or magic == em:
            offs.append(i)
    return offs


def find_bit_magics(data, magic: int) -> np.ndarray:
    """Bit offsets of every occurrence of a 48-bit magic (any bit phase) —
    the vectorized form of bzip2recover's bit-serial scan
    (bzip2recover.c:367-410)."""
    b = np.frombuffer(data, np.uint8).astype(np.uint64) if not isinstance(
        data, np.ndarray) else data.astype(np.uint64)
    n = b.size
    if n < 7:
        return np.zeros(0, np.int64)
    w = np.zeros(n - 6, np.uint64)
    for k in range(7):
        w = (w << np.uint64(8)) | b[k: n - 6 + k]
    mask = np.uint64((1 << 48) - 1)
    hits = []
    for s in range(8):
        val = (w >> np.uint64(8 - s)) & mask
        pos = np.flatnonzero(val == np.uint64(magic))
        hits.append(pos.astype(np.int64) * 8 + s)
    return np.sort(np.concatenate(hits))


def _rotl(x: int, k: int) -> int:
    k %= 32
    return ((x << k) | (x >> (32 - k))) & 0xFFFFFFFF if k else x


def decompress_blocks_parallel(data, max_workers: int | None = None,
                               _candidates=None) -> bytes:
    """Block-grain parallel decode of a single .bz2 stream.

    Blocks are bit-aligned but delimited by 48-bit magics; the scan above
    finds every candidate block start, each worker decodes its block
    independently (``decode_some`` resumes at any bit offset; per-block
    CRCs validate each segment), and the stream CRC is re-composed on the
    host from the per-block CRCs via the linearity of the rotl1+xor fold.

    A false candidate (magic bits inside a block's payload) is healed
    PER SEGMENT: the failed span is merged forward one candidate at a
    time and re-decoded seeded with the running combined CRC — only the
    bytes of the failed span are re-read, never the whole stream.
    ``_candidates`` injects a synthetic candidate list for testing the
    healing path (natural 48-bit false positives are ~2^-48/bit)."""
    from .. import native

    data = bytes(data)
    if len(data) < 10 or data[:3] != b"BZh":
        return api.decompress(data, backend="native")
    level = data[3] - ord("0")
    if not 1 <= level <= 9:
        raise api.DataErrorMagic("bad stream header")

    if _candidates is not None:
        starts, eos = _candidates
    else:
        starts = [o for o in find_bit_magics(data, BLOCK_MAGIC) if o >= 32]
        eos = [o for o in find_bit_magics(data, EOS_MAGIC) if o >= 32]
    if not eos or not starts or starts[0] != 32:
        return api.decompress(data, backend="native")
    ends = starts[1:] + [eos[-1]]
    nseg = len(starts)

    def decode_span(lo_bit: int, hi_bit: int, seed: int):
        # slice ends right before the next candidate so decode_some stops
        # with "need more" after exactly this span's complete blocks.
        lo_byte = int(lo_bit) // 8
        hi_byte = (int(hi_bit) + 7) // 8
        res = native.decode_some(data[lo_byte:hi_byte],
                                 int(lo_bit) - 8 * lo_byte, level, seed)
        return res, 8 * lo_byte

    with _cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        results = list(ex.map(lambda s: decode_span(s[0], s[1], 0),
                              zip(starts, ends)))

    combined = 0
    parts = []
    eos_done = False
    i = 0
    while i < nseg:
        (out, next_bit, _lvl, comb, _status, rc), base = results[i]
        if rc == 0 and out is not None and next_bit + base == ends[i]:
            parts.append(out)
            # comb folds this segment's blocks over a 0 seed; one block
            # per unhealed segment, so the running fold advances by one
            combined = _rotl(combined, 1) ^ comb
            i += 1
            continue
        # ---- heal: merge the failed span forward, one candidate at a
        # time, re-decoding seeded with the running combined CRC
        healed = False
        for j in range(i + 1, nseg):
            (out2, nb2, _l2, comb2, st2, rc2), b2 = decode_span(
                starts[i], ends[j], combined)
            if rc2 == 0 and out2 is not None and st2 == 0 \
                    and nb2 + b2 == ends[j]:
                parts.append(out2)
                combined = comb2
                i = j + 1
                healed = True
                break
        if healed:
            continue
        # span reaches the stream tail: decode through the EOS
        (out3, nb3, _l3, comb3, st3, rc3), _b3 = decode_span(
            starts[i], len(data) * 8, combined)
        if rc3 != 0 or out3 is None or st3 != 1:
            if rc3 == native.BZT_UNEXPECTED_EOF or st3 != 1:
                raise api.UnexpectedEOF("stream truncated")
            raise api.DataError(f"corrupt stream (rc={rc3})")
        parts.append(out3)
        combined = comb3
        eos_done = True
        i = nseg
    if not eos_done:
        # EOS: 48-bit magic + 32-bit stored combined CRC
        o = eos[-1] + 48
        if o + 32 > len(data) * 8:
            raise api.UnexpectedEOF("stream truncated")
        stored = 0
        for k in range(32):
            stored = (stored << 1) | (
                (data[(o + k) // 8] >> (7 - (o + k) % 8)) & 1)
        if stored != combined:
            raise api.DataError("stream CRC mismatch")
    return b"".join(parts)


#: member spans at least this large decode block-parallel inside
BLOCK_PARALLEL_MIN = 1 << 20


def decompress_parallel(data, max_workers: int | None = None) -> bytes:
    """Decode a (possibly multi-member) .bz2 byte string with member-grain
    parallelism, and block-grain parallelism inside members larger than
    BLOCK_PARALLEL_MIN.  Bit-exact with ``api.decompress(data,
    multi_stream=True, backend="native")``; raises the same error classes
    on corrupt input.  This is the CLI's ``--backend=native`` decode path
    for regular files."""
    from .. import native

    data = bytes(data)
    offs = find_member_offsets(data)
    if len(offs) <= 1:
        if len(data) >= BLOCK_PARALLEL_MIN:
            return decompress_blocks_parallel(data, max_workers)
        return api.decompress(data, multi_stream=True, backend="native")
    offs.append(len(data))

    def decode_span(lo: int, hi: int):
        if hi - lo >= BLOCK_PARALLEL_MIN:
            try:
                return decompress_blocks_parallel(data[lo:hi],
                                                  max_workers), hi - lo, 0
            except api.BZ2Error:
                pass                     # sequential native retry below
        out, consumed, rc = native.decompress(data[lo:hi], multi_stream=True)
        return out, consumed, rc

    results: list[bytes] = []
    spans = [(offs[i], offs[i + 1]) for i in range(len(offs) - 1)]
    with _cf.ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = list(ex.map(lambda s: decode_span(*s), spans))

    i = 0
    while i < len(spans):
        out, consumed, rc = futs[i]
        lo, hi = spans[i]
        if rc == 0 and consumed == hi - lo:
            results.append(out)
            i += 1
            continue
        # false-positive split (or trailing garbage): heal by decoding
        # sequentially from this span's start through the rest.
        tail = data[lo:]
        out2, _ = api.decompress_with_tail(tail, multi_stream=True,
                                           backend="native")
        results.append(out2)
        break
    return b"".join(results)
