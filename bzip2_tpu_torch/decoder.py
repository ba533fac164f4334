"""Batched block decoder on a PyTorch device (port of
``bzip2_tpu/decoder.py``).

  host    stream walk and per-block light parse (``native.parse_block``:
          header fields, tables, selectors, each 50-symbol group's start
          bit), speculatively in a thread pool
  device  symbol decode -> MTF^-1 + RLE2 -> inverse BWT (walk kernel)
          -> RLE1^-1                                    (``ops/decode.py``)
  host    CRC check of every block (``native.crc32``), ordered splice,
          combined CRC

Three threads overlap: the parse-ahead thread parses batch k+1, the main
thread launches batch k's stages (all device work stays on that thread and
the device's current stream), and the commit thread copies batch k-1's
output to the host once an event recorded at its end has completed, checks
its CRCs and splices it.  No stage waits on the host: stage walls are CUDA
events, read when the batch drains.

Robustness contract (the reference's): a lane flagged by the walk budget or
a CRC mismatch is healed on the host (``native.decode_some`` over exactly
that block's bits) and counted in ``ANOMALIES``; a parse error, a
randomised legacy block, a bad magic or a truncation hands the member's
remainder to ``native.decode_some``, so corrupt input raises the host
decoder's errors.  There is no catch-all: an error of the device path
propagates, and the stream is never re-decoded by ``native.decompress``.
"""
from __future__ import annotations

import concurrent.futures as _cf
import os
import sys
import threading
import time

import numpy as np
import torch

from . import constants as C
from . import native
from .api import DataError, DataErrorMagic, UnexpectedEOF
from .engine import _resolve_device
from .ops import decode as D
from .parallel.decode import find_bit_magics

#: blocks per device batch
BATCH = 8
#: wave-1 walkers per block in the inverse-BWT splitter walk
WALKERS = 4096
STAGES = ("symbols", "mtf+rle2", "ibwt", "tail")

#: cumulative per-stage device walls (seconds)
STAGE_WALL: dict = {}
#: host heals of single blocks ("lane").  "batch" is the reference's count
#: of batches without a device result (a batch over its word or group
#: bucket); the port sizes every batch exactly, so it stays 0.
ANOMALIES: dict = {"lane": 0, "batch": 0}
#: blocks handed to the device path, and blocks whose bytes came from it
SHARE: dict = {"blocks": 0, "dev_blocks": 0}
_LOCK = threading.Lock()


def reset_telemetry() -> None:
    with _LOCK:
        STAGE_WALL.clear()
        ANOMALIES.update(lane=0, batch=0)
        SHARE.update(blocks=0, dev_blocks=0)


def _add(table: dict, key: str, v=1) -> None:
    with _LOCK:
        table[key] = table.get(key, 0) + v


class _Marks:
    """Stage boundaries of one batch: CUDA events on a card, read once the
    batch has drained; the host clock on the CPU, where ops are eager."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.t: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.t.append(ev)
        else:
            self.t.append(time.perf_counter())

    def wait(self) -> None:
        if self.cuda:
            self.t[-1].synchronize()

    def walls(self) -> list:
        if self.cuda:
            return [a.elapsed_time(b) / 1e3 for a, b in zip(self.t, self.t[1:])]
        return [b - a for a, b in zip(self.t, self.t[1:])]


def _up(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def batch_inputs(stream: np.ndarray, pbs: list, rows: bool = False) -> tuple:
    """The numpy inputs of one batch of ParsedBlock: (words, goff, gsel,
    gvalid, lens6, used_list, head).  ``words`` holds uint32 values as
    int64: one flat buffer over the batch's contiguous bit span, or with
    ``rows`` one row per block holding exactly its used words (from its
    symbol start to one word past its end), zero-padded to the longest.
    ``goff`` counts bits from the buffer's or the row's first word."""
    B = len(pbs)
    if rows:
        wbase = [pb.sym_start_bit // 32 for pb in pbs]
        wend = [(pb.end_bit + 31) // 32 + 1 for pb in pbs]
        words = np.zeros((B, max(e - b for b, e in zip(wbase, wend)) * 4),
                         np.uint8)
        for i, (b, e) in enumerate(zip(wbase, wend)):
            span = stream[b * 4: min(e * 4, stream.size)]
            words[i, :span.size] = span
    else:
        b = min(pb.sym_start_bit for pb in pbs) // 32
        e = (max(pb.end_bit for pb in pbs) + 31) // 32 + 1
        wbase = [b] * B
        span = stream[b * 4: min(e * 4, stream.size)]
        words = np.zeros((e - b) * 4, np.uint8)
        words[: span.size] = span
    words = words.view(">u4").astype(np.int64)

    G = max(pb.n_groups_used for pb in pbs)
    goff = np.zeros((B, G), np.int32)
    gsel = np.zeros((B, G), np.int32)
    gvalid = np.zeros((B, G), bool)
    lens6 = np.zeros((B, 6, C.MAX_ALPHA_SIZE), np.int32)
    used_list = np.zeros((B, 256), np.int32)
    head = np.zeros((4, B), np.int32)      # alpha, n_used, n_mtf, orig
    for i, pb in enumerate(pbs):
        g = pb.n_groups_used
        goff[i, :g] = pb.group_offsets - wbase[i] * 32
        gsel[i, :g] = pb.selectors[:g]
        gvalid[i, :g] = True
        lens6[i] = pb.lens
        ul = np.flatnonzero(pb.used)
        used_list[i, : ul.size] = ul
        head[:, i] = (pb.n_used + 2, pb.n_used, pb.n_mtf, pb.orig_ptr)
    return words, goff, gsel, gvalid, lens6, used_list, head


def launch_batch(device: torch.device, level: int, inputs: tuple) -> tuple:
    """Upload ``batch_inputs`` to ``device`` and launch the four stages on
    the current stream: symbols (flat ``decode_symbols`` or, for word rows,
    ``decode_symbols_rows``), MTF^-1 + RLE2, the inverse BWT (``D.ibwt``,
    looked up at call time) and RLE1^-1.  Returns (raw bytes (B, NOUT)
    uint8, lengths, ok flags, stage marks) without waiting for the
    device."""
    N = 100_000 * level
    NOUT = N + N // 4 + 64
    words, goff, gsel, gvalid, lens6, used_list, head = (
        _up(a, device) for a in inputs)
    alpha, n_used, n_mtf, orig = head
    symbols = D.decode_symbols_rows if words.dim() == 2 else D.decode_symbols

    marks = _Marks(device)
    marks.mark()
    lut1, lut2, ebase = D.build_tables(lens6, alpha)
    syms = symbols(words, goff, gsel, gvalid, lut1, lut2, ebase)
    marks.mark()
    vals = D.mtf_inverse(syms, used_list, n_used, n_mtf)
    last, n_out = D.rle2_expand(syms, vals, n_used, n_mtf, N)
    marks.mark()
    out, ok = D.ibwt(last, n_out, orig, WALKERS)
    marks.mark()
    raw, out_len, fits = D.rle1_inverse(out, n_out, NOUT)
    raw8 = raw.to(torch.uint8)
    marks.mark()
    return raw8, out_len, ok & fits, marks


def heal_span(stream: np.ndarray, start_bit: int, end_bit: int,
              level: int) -> bytes:
    """Host-decode exactly one block's bits [start_bit, end_bit)
    (``native.decode_some``); raises DataError if the host cannot."""
    sl = np.ascontiguousarray(stream[: (end_bit + 7) // 8])
    out, next_bit, _lvl, _comb, _st, rc = native.decode_some(
        sl, start_bit, level, 0)
    if out is None or next_bit != end_bit:
        raise DataError(f"corrupt stream (host heal rc={rc})")
    return out


class DeviceDecoder:
    """Batched block decoder on ``device`` (default ``"cuda"``)."""

    def __init__(self, batch_size: int = BATCH, device="cuda"):
        self.batch = batch_size
        self.device = _resolve_device(device)
        self._copy = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    # ------------------------------------------------------------------
    def _decode_batch(self, stream: np.ndarray, level: int, pbs: list):
        """Launch the device stages for a list of ParsedBlock over one flat
        word buffer; returns the batch's pending result (raw bytes,
        lengths, ok flags, stage marks) without waiting for the device."""
        _add(SHARE, "blocks", len(pbs))
        return launch_batch(self.device, level, batch_inputs(stream, pbs))

    def _drain_batch(self, res, pbs):
        """Wait for a batch's end event, copy its output to the host (on a
        side stream, so the copy does not queue behind the next batch) and
        check each block's CRC.  Returns bytes per block, None for a lane
        that needs the host."""
        raw8, out_len, ok, marks = res
        marks.wait()
        if self._copy is not None:
            with torch.cuda.stream(self._copy):
                raw, out_len, ok = (t.cpu().numpy() for t in (raw8, out_len, ok))
        else:
            raw, out_len, ok = (t.numpy() for t in (raw8, out_len, ok))
        for k, w in zip(STAGES, marks.walls()):
            _add(STAGE_WALL, k, w)
        outs = []
        for i, pb in enumerate(pbs):
            b = raw[i, : int(out_len[i])].tobytes() if ok[i] else None
            if b is not None and native.crc32(b) != pb.stored_crc:
                b = None
            outs.append(b)
        return outs

    # ------------------------------------------------------------------
    def decompress(self, data, multi_stream: bool = True) -> bytes:
        return self.decompress_with_tail(data, multi_stream)[0]

    def decompress_with_tail(self, data, multi_stream: bool = True):
        """Decode on the device path.  Returns (bytes, consumed byte
        offset).  Raises DataErrorMagic / DataError / UnexpectedEOF where
        the host decoder would."""
        buf = np.frombuffer(bytes(data), np.uint8)
        return self._decompress_stream(buf, multi_stream)

    def _decompress_stream(self, buf: np.ndarray, multi_stream: bool):
        # speculative parse pool: every 48-bit block-magic candidate is, with
        # probability 1 - n*2^-48, a real block start, so candidates parse
        # concurrently (the native scan releases the GIL) and the batch
        # assembler stitches the futures along the end_bit chain.  The scan
        # for candidates runs in the pool too; until it lands, blocks parse
        # one by one along the chain (_get_parse), so the first batch does
        # not wait for a scan of the whole stream.
        # submitted: candidate bit offset -> (level, future)
        scan_state = {"ex": None, "scan": None, "cands": None, "ci": 0}
        submitted = {}

        def _pump(pos, level):
            st = scan_state
            if st["ex"] is None:
                st["ex"] = _cf.ThreadPoolExecutor(
                    max_workers=min(8, (os.cpu_count() or 1) + 1))
                st["scan"] = st["ex"].submit(find_bit_magics, buf,
                                             C.BLOCK_MAGIC)
            if st["cands"] is None:
                if not st["scan"].done():
                    return
                st["cands"] = st["scan"].result()
            cands = st["cands"]
            ci = st["ci"]
            while ci < len(cands) and cands[ci] < pos:
                submitted.pop(int(cands[ci]), None)
                ci += 1
            st["ci"] = ci
            j = ci
            while j < len(cands) and len(submitted) < 4 * self.batch:
                c = int(cands[j])
                j += 1
                ent = submitted.get(c)
                if ent is None or ent[0] != level:
                    submitted[c] = (level, st["ex"].submit(
                        native.parse_block, buf, c, level))

        def _get_parse(pos, level):
            ent = submitted.pop(pos, None)
            if ent is not None and ent[0] == level:
                return ent[1].result()
            return native.parse_block(buf, pos, level)

        try:
            return self._stream_loop(buf, multi_stream, _pump, _get_parse)
        finally:
            if scan_state["ex"] is not None:
                scan_state["ex"].shutdown(wait=False, cancel_futures=True)

    def _stream_loop(self, buf, multi_stream, _pump, _get_parse):
        parts = []
        pos_bit = 0
        total = buf.size * 8
        first = True
        while True:
            hdr = bytes(buf[pos_bit // 8: pos_bit // 8 + 4])
            if len(hdr) < 4 or hdr[:3] != b"BZh" or not 0x31 <= hdr[3] <= 0x39:
                if first:
                    raise DataErrorMagic("bad stream header")
                break           # trailing garbage after a complete member
            first = False
            level = hdr[3] - 0x30
            pos_bit += 32
            combined = 0

            def commit(res, pbs):
                nonlocal combined
                outs = self._drain_batch(res, pbs)
                _add(SHARE, "dev_blocks", sum(o is not None for o in outs))
                for pb, o in zip(pbs, outs):
                    if o is None:
                        # walk budget or CRC mismatch: heal just this block
                        _add(ANOMALIES, "lane")
                        sys.stderr.write("bz2tpu_torch: device lane anomaly; "
                                         "block healed on host\n")
                        o = heal_span(buf, pb.start_bit, pb.end_bit,
                                      level)
                    combined = (((combined << 1) | (combined >> 31))
                                & 0xFFFFFFFF) ^ pb.stored_crc
                    parts.append(o)

            host_rest = False
            if self._peek48(buf, pos_bit) == C.BLOCK_MAGIC:

                def parse_batch(pos):
                    pbs = []
                    while len(pbs) < self.batch:
                        _pump(pos, level)
                        pb, _rc = _get_parse(pos, level)
                        if pb is None:
                            return (pbs, pos, False) if pbs else None
                        if pb.randomised:
                            return None     # legacy path: host decoder
                        pb.start_bit = pos
                        pbs.append(pb)
                        pos = pb.end_bit
                        if self._peek48(buf, pos) != C.BLOCK_MAGIC:
                            return pbs, pos, False
                    return pbs, pos, self._peek48(buf, pos) == C.BLOCK_MAGIC

                pending = None
                cfut = None
                with _cf.ThreadPoolExecutor(max_workers=1) as ex, \
                        _cf.ThreadPoolExecutor(max_workers=1) as cex:
                    fut = ex.submit(parse_batch, pos_bit)
                    while True:
                        parsed = fut.result()
                        if parsed is None:
                            host_rest = True
                            break
                        pbs, newpos, more = parsed
                        if more:
                            fut = ex.submit(parse_batch, newpos)
                        if pending is not None:
                            cfut = cex.submit(commit, *pending)
                            pending = None
                        res = self._decode_batch(buf, level, pbs)
                        if cfut is not None:
                            cfut.result()
                            cfut = None
                        pending = (res, pbs)
                        pos_bit = newpos
                        if not more:
                            break
                    if cfut is not None:
                        cfut.result()
                if pending is not None:
                    commit(*pending)
            if host_rest or self._peek48(buf, pos_bit) != C.EOS_MAGIC:
                # parse error, randomised block, bad magic or truncation:
                # the host decodes the member's remainder and checks its end
                out, next_bit, _lvl, _comb, status, rc = native.decode_some(
                    buf, pos_bit, level, combined)
                if out is None:
                    if rc == native.BZT_UNEXPECTED_EOF:
                        raise UnexpectedEOF("stream truncated")
                    raise DataError(f"corrupt stream (rc={rc})")
                if status != 1:
                    raise UnexpectedEOF("stream truncated")
                parts.append(out)
                pos_bit = next_bit
            else:
                pos_bit += 48
                if total - pos_bit < 32:
                    raise UnexpectedEOF("stream truncated")
                stored = 0
                for k in range(32):
                    bit = pos_bit + k
                    stored = (stored << 1) | ((int(buf[bit // 8])
                                               >> (7 - bit % 8)) & 1)
                pos_bit += 32
                if stored != combined:
                    raise DataError("combined CRC mismatch")
            # byte-align and look for another member
            pos_bit = (pos_bit + 7) // 8 * 8
            if not (multi_stream and pos_bit // 8 + 4 <= buf.size
                    and bytes(buf[pos_bit // 8: pos_bit // 8 + 3]) == b"BZh"):
                break
        return b"".join(parts), pos_bit // 8

    @staticmethod
    def _peek48(buf: np.ndarray, bit: int) -> int:
        if (bit + 48) > buf.size * 8:
            return -1
        v = 0
        for k in range(6):
            byte_i = (bit + 8 * k) // 8
            sh = bit % 8
            b0 = int(buf[byte_i]) << 8
            b1 = int(buf[byte_i + 1]) if byte_i + 1 < buf.size else 0
            v = (v << 8) | (((b0 | b1) >> (8 - sh)) & 0xFF)
        return v


_default: DeviceDecoder | None = None


def default_decoder() -> DeviceDecoder:
    """The process's decoder on the default device (``cuda``)."""
    global _default
    if _default is None:
        _default = DeviceDecoder()
    return _default
