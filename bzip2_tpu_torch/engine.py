"""Batched block encoder on a PyTorch device (port of
``bzip2_tpu/engine.py``).

Two ways to encode a batch of RLE1 blocks (``Engine(mode=...)``):

hybrid (default)
  encode_pre   BWT, MTF+RLE2, per-group histograms,     device
               initial tables
  4 x          group_iter (cost/frequency matmuls,       device
               argmin) then the exact-heap Huffman       host C++ (native)
               lengths
  encode_post  canonical codes, selector MTF, field      device
               emission, bit packing
fused
  encode_batch_device: the whole encoder on the device, the four Huffman
  rebuilds in the ``huffman_lengths`` kernel; one fetch a batch.

``Engine.encode_payloads`` is a block encoder for the port's
``api.register_block_encoder`` (the api splits the input into RLE1 blocks,
applies the periodic origPtr corrector, bit-splices the payloads and frames
the stream).  It is the reference's work-stealing scheduler: ``pipeline``
device workers claim batches from the front of the block list while
``host_workers`` threads steal single blocks from the tail and encode them
with the native C++ block encoder; an adaptive handoff lets the device
decline a batch the host pool would finish sooner.  Results come back in
block order.  ``use_device=False`` encodes every block on the host.
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from . import constants as C
from . import hostmem, native, rle1, tracing
from .api import compress_with
from .ops.bitpack import pack_fields
from .ops.bwt import bwt_batched
from .ops.groupsearch import (group_iter, group_search_batched, search_init,
                              selector_mtf)
from .ops.huffman import assign_codes_lanes
from .ops.mtf import mtf_rle2_batched

A = C.MAX_ALPHA_SIZE
MTF_TILE = 2048

#: cumulative encode stage walls (seconds); the blocks handed to the
#: engine, those the device and the host workers encoded, and the batches
#: the device declined.  Updated under _TELEM_LOCK by every worker.
STAGE_WALL: dict = {}
SHARE: dict = {"blocks": 0, "dev_blocks": 0, "host_blocks": 0, "declines": 0}
_TELEM_LOCK = threading.Lock()


def reset_telemetry() -> None:
    with _TELEM_LOCK:
        STAGE_WALL.clear()
        SHARE.update(blocks=0, dev_blocks=0, host_blocks=0, declines=0)


def _stage_add(key: str, wall: float) -> None:
    with _TELEM_LOCK:
        STAGE_WALL[key] = STAGE_WALL.get(key, 0.0) + wall


def _share_add(key: str, k: int = 1) -> None:
    with _TELEM_LOCK:
        SHARE[key] += k


def _emit_fields(in_use, crc, orig_ptr, mtfv, n_mtf, n_in_use, n_groups,
                 n_selectors, sel_mtf, lens, codes, selectors):
    """Build the (vals int64, lens int32) field arrays of one batch, in wire
    order.  Values are int64 holding uint32 bit patterns: the JAX version's
    uint32 shifts (``0xAAAAAAAA >> k``) are logical, torch's int32 shifts
    are not."""
    B, M = mtfv.shape
    dev = mtfv.device
    i64, i32 = torch.int64, torch.int32
    fields_v: list = []
    fields_l: list = []

    def add(v, ln):
        fields_v.append(v.to(i64))
        fields_l.append(ln.to(i32))

    def col(v, bits):
        v = torch.as_tensor(v, dtype=i64, device=dev).expand(B)[:, None]
        return v, torch.full((B, 1), bits, dtype=i32, device=dev)

    # block magic + CRC + (rand bit | origPtr)
    add(*col(C.BLOCK_MAGIC >> 24, 24))
    add(*col(C.BLOCK_MAGIC & 0xFFFFFF, 24))
    add(*col(crc.to(i64) & 0xFFFFFFFF, 32))
    add(*col(orig_ptr.to(i64), 25))

    # mapping: 16-bit group mask, then 16 bits per used group
    iu = in_use.reshape(B, 16, 16)
    gmask_bits = iu.any(dim=2)
    w16 = torch.ones(16, dtype=i64, device=dev) << torch.arange(
        15, -1, -1, dtype=i64, device=dev)
    w16 = w16[None, :]
    add(*col(torch.where(gmask_bits, w16, 0).sum(dim=1), 16))
    gbits = torch.where(iu, w16[None], 0).sum(dim=2)
    add(gbits, torch.where(gmask_bits, 16, 0))

    add(*col(n_groups.to(i64), 3))
    add(*col(n_selectors.to(i64), 15))

    # selectors: value v in 1..6 -> v bits of pattern (1<<v)-2
    sel = sel_mtf.to(i64)
    add((torch.ones_like(sel) << sel) - 2, torch.where(sel > 0, sel, 0))

    # coding tables: per table a 5-bit first length, then per symbol
    # {"10"*d | "11"*d, then "0"}
    arange_a = torch.arange(A, device=dev)[None, None, :]
    alpha = n_in_use + 2
    t_active = torch.arange(6, device=dev)[None, :] < n_groups[:, None]
    active = t_active[:, :, None] & (arange_a < alpha[:, None, None])
    lens_m = torch.where(active, lens.to(i64), 0)
    first = lens_m[:, :, 0]
    prev = torch.cat([first[:, :, None], lens_m[:, :, :-1]], dim=2)
    delta = torch.where(active, lens_m - prev, 0)
    up = torch.clamp(delta, min=0)
    down = torch.clamp(-delta, min=0)
    pat_up = torch.where(delta > 0, torch.full_like(up, 0xAAAAAAAA)
                         >> torch.clamp(32 - 2 * up, 0, 31), 0)
    pat_dn = torch.where(delta < 0, torch.full_like(down, 0xFFFFFFFF)
                         >> torch.clamp(32 - 2 * down, 0, 31), 0)
    W = 1 + 2 * A
    tab_v = torch.zeros((B, 6, W), dtype=i64, device=dev)
    tab_l = torch.zeros((B, 6, W), dtype=i32, device=dev)
    tab_v[:, :, 0] = first
    tab_l[:, :, 0] = torch.where(t_active, 5, 0).to(i32)
    tab_v[:, :, 1::2] = pat_up + pat_dn
    tab_l[:, :, 1::2] = (2 * (up + down)).to(i32)
    tab_l[:, :, 2::2] = active.to(i32)
    add(tab_v.reshape(B, 6 * W), tab_l.reshape(B, 6 * W))

    # payload: each symbol's (code, len) gathered directly by (selector of
    # its group, symbol); the JAX version's one-hot matmul served TPU
    # gather costs
    m = torch.arange(M, device=dev)[None, :]
    m_valid = m < n_mtf[:, None]
    packed_tab = ((codes.to(i32) << 5) | lens.to(i32)).reshape(B, 6 * A)
    sel_of = torch.gather(selectors.to(i64), 1, (m // C.G_SIZE).expand(B, M))
    pay = torch.gather(packed_tab, 1, sel_of * A + mtfv.to(i64))
    add(torch.where(m_valid, pay >> 5, 0), torch.where(m_valid, pay & 31, 0))

    return torch.cat(fields_v, dim=1), torch.cat(fields_l, dim=1)


def encode_batch_device(blocks, n, in_use, crc, n_words: int):
    """The whole block encoder on the device (fused mode): (B, N) uint8
    padded RLE1 blocks, (B,) lengths, (B, 256) bool, (B,) int64 CRCs ->
    (words (B, n_words) int64 of uint32 values, nbits (B,))."""
    last, orig_ptr, _ = bwt_batched(blocks, n)
    mtfv, n_mtf, n_in_use = mtf_rle2_batched(last, n, in_use)
    (n_groups, n_selectors, selectors, sel_mtf, lens,
     codes) = group_search_batched(mtfv, n_mtf, n_in_use)
    vals, flens = _emit_fields(in_use, crc, orig_ptr, mtfv, n_mtf, n_in_use,
                               n_groups, n_selectors, sel_mtf, lens, codes,
                               selectors)
    return pack_fields(vals, flens, n_words)


def encode_pre(blocks, n, in_use):
    """(B, N) uint8 blocks, (B,) lengths, (B, 256) bool -> the inter-stage
    state (mtfv, n_mtf, n_in_use, orig_ptr, n_groups, lens0, hist,
    table_invalid); hist is float32 for the group_iter matmuls."""
    last, orig_ptr, _ = bwt_batched(blocks, n)
    mtfv, n_mtf, n_in_use = mtf_rle2_batched(last, n, in_use)
    n_groups, hist, lens0, table_invalid = search_init(mtfv, n_mtf,
                                                       n_in_use + 2)
    return (mtfv, n_mtf, n_in_use, orig_ptr, n_groups, lens0, hist,
            table_invalid)


def encode_post(mtfv, n_mtf, n_in_use, in_use, crc, orig_ptr, n_groups,
                selectors, lens, n_words: int):
    """Canonical codes, selector MTF, field emission and bit packing.
    Returns (words (B, n_words) int64 of uint32 values, nbits (B,))."""
    B = mtfv.shape[0]
    alpha = n_in_use + 2
    codes = assign_codes_lanes(
        lens.reshape(B * 6, A),
        alpha[:, None].expand(B, 6).reshape(B * 6)).reshape(B, 6, A)
    n_selectors = -(-n_mtf // C.G_SIZE)
    sel_mtf = selector_mtf(selectors, n_selectors)
    vals, flens = _emit_fields(in_use, crc, orig_ptr, mtfv, n_mtf, n_in_use,
                               n_groups, n_selectors, sel_mtf, lens, codes,
                               selectors)
    return pack_fields(vals, flens, n_words)


def _block_pad_size(level: int) -> int:
    n = C.nblock_max(level) + C.BLOCK_OVERSHOOT
    return -(-n // MTF_TILE) * MTF_TILE


def _words_for(N: int) -> int:
    # worst case: 17-bit codes for every symbol + headers, with slack
    return (17 * (N + 1) + 6 * A * 3 + C.MAX_SELECTORS * 6 + 4096) // 32 + 4


#: numpy dtype -> the port's tensor dtype: bf16 histograms widen to float32
#: (exact for counts <= 50), uint32 bit fields (CRCs) widen to int64
_DTYPE_MAP = {"bfloat16": torch.float32, "uint32": torch.int64,
              "int32": torch.int32, "uint8": torch.uint8, "bool": torch.bool}


def stage_from_numpy(arrays, device) -> tuple:
    """Numpy arrays (e.g. the JAX ``encode_pre`` outputs, or the host inputs
    of ``encode_post``) -> the port's tensors on ``device``."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        dt = _DTYPE_MAP.get(a.dtype.name)
        if dt is None:
            raise TypeError(f"stage_from_numpy: no mapping for {a.dtype}")
        if a.dtype.name in ("bfloat16", "uint32"):
            a = a.astype(np.float32 if dt == torch.float32 else np.int64)
        # torch.from_numpy needs a writable array (jax hands out read-only)
        out.append(torch.from_numpy(np.require(a, requirements=["C", "W"]))
                   .to(device))
    return tuple(out)


def split_blocks(data, level: int) -> list:
    """RLE1-encode ``data`` and split it into the blocks of ``level``
    (the port's ``rle1``): the blocks ``encode_payloads`` is given."""
    return rle1.encode_blocks(data, level)


def batch_arrays(blocks: list, bsz: int, N: int) -> tuple:
    """Up to ``bsz`` RLE1 blocks -> the padded numpy inputs of one batch
    (blocks (bsz, N) uint8, lengths, in_use (bsz, 256), CRCs).  Lanes past
    ``len(blocks)`` are dummy 1-byte blocks of 0x00.  The engine passes
    ``bsz == len(blocks)``: a tail batch runs with its own lanes only."""
    arr = np.zeros((bsz, N), np.uint8)
    ns = np.ones(bsz, np.int32)
    uses = np.zeros((bsz, 256), bool)
    crcs = np.zeros(bsz, np.uint32)
    uses[:, 0] = True
    for j, blk in enumerate(blocks):
        arr[j, :blk.data.size] = blk.data
        ns[j] = blk.data.size
        uses[j] = blk.in_use
        crcs[j] = blk.crc
    return arr, ns, uses, crcs


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not available")
    return device


#: the device workers' CUDA streams, per device, shared by every Engine of
#: the process: the caching allocator reuses a block only on the stream
#: that freed it, so streams made per engine or per call would each grow a
#: pool of their own.  Two threads on one stream stay correct: the stream
#: orders their work.
_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def _worker_streams(device: torch.device, n: int) -> list:
    with _STREAMS_LOCK:
        pool = _STREAMS.setdefault(device, [])
        while len(pool) < n:
            pool.append(torch.cuda.Stream(device))
        return pool[:n]


def _fetch(words, nbits) -> tuple:
    """One fetch of the bit counts, then one of the used words: (words
    uint32 (B, k) numpy cut to the longest block, nbits (B,) numpy)."""
    nbits_np = nbits.cpu().numpy()
    need = int((int(nbits_np.max()) + 31) // 32)
    return words[:, :need].cpu().numpy().astype(np.uint32), nbits_np


class Engine:
    """Batched block encoder with the reference's work-stealing scheduler.

    ``mode`` "hybrid" (the default, ``None``): device stages with the
    host's exact-heap Huffman lengths between them; "fused": the whole
    encoder on the device.  ``pipeline`` device workers (default 2) and
    ``host_workers`` native host encoders (default 1) share a stream's
    blocks; ``host_workers=0`` keeps every block on the device.
    ``use_device=False`` encodes on the host alone and never touches the
    device.  The native runtime is required in every mode.
    """

    #: target bytes of input per device batch when batch_size is automatic
    AUTO_BATCH_BYTES = 12 << 20

    def __init__(self, batch_size: int | None = None, mode: str | None = None,
                 pipeline: int = 2, host_workers: int | None = None,
                 use_device: bool = True, device="cuda"):
        # allocator retention is an Engine-scoped policy, not an import-time
        # side effect
        hostmem.set_malloc_retention()
        if not native.available():
            raise RuntimeError("the engine needs the native host runtime "
                               "(bzip2_tpu_torch.native), which did not build")
        mode = "hybrid" if mode is None else mode
        if mode not in ("hybrid", "fused"):
            raise ValueError(f"mode must be 'hybrid' or 'fused', not {mode!r}")
        self.mode = mode
        self.batch_size = batch_size
        self.pipeline = max(1, pipeline)
        self.host_workers = 1 if host_workers is None else max(0, host_workers)
        self.use_device = use_device
        # host-only mode never touches the device, so it is not checked
        self.device = (_resolve_device(device) if use_device
                       else torch.device(device))
        #: scheduler rates, kept across streams so that a fresh stream
        #: starts calibrated
        self._sched = {"host_done": 0, "host_time": 0.0, "dev_wall": 0.0,
                       "declines": 0}

    def _batch_size_for(self, level: int) -> int:
        if self.batch_size is not None:
            return self.batch_size
        return max(1, self.AUTO_BATCH_BYTES // (C.BLOCK_UNIT * level))

    @contextlib.contextmanager
    def _worker_context(self, i: int):
        """Device worker ``i`` runs on its own CUDA stream.  The kernels
        follow it (``_build.stream_of`` reads the thread's current stream),
        and a ``.cpu()`` waits for its own stream only, so one worker's host
        round trips overlap another's device stages.  A batch's tensors are
        made and used inside its worker, on that stream; the stream first
        waits for the work already queued on the device's current stream.
        On the CPU there are no streams."""
        if self.device.type != "cuda":
            yield
            return
        s = _worker_streams(self.device, i + 1)[i]
        with torch.cuda.device(self.device):
            s.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(s):
                yield

    def encode_batch(self, level, arr, ns, uses, crcs):
        """One device batch of numpy inputs -> (words uint32 (B, k) numpy,
        nbits int64 (B,) numpy), words cut to the longest block."""
        if self.mode == "fused":
            return self._encode_fused(arr, ns, uses, crcs)
        return self._encode_hybrid(arr, ns, uses, crcs)

    def _encode_fused(self, arr, ns, uses, crcs):
        """One device call and one fetch a batch; no host heap."""
        t0 = time.perf_counter()
        blocks, n, in_use, crc = stage_from_numpy((arr, ns, uses, crcs),
                                                  self.device)
        words, nbits = encode_batch_device(blocks, n, in_use, crc,
                                           _words_for(arr.shape[1]))
        out = _fetch(words, nbits)
        _stage_add("fused+fetch", time.perf_counter() - t0)
        return out

    def _encode_hybrid(self, arr, ns, uses, crcs):
        dev = self.device
        B = arr.shape[0]
        t0 = time.perf_counter()
        blocks, n, in_use, crc = stage_from_numpy((arr, ns, uses, crcs), dev)
        (mtfv, n_mtf, n_in_use, orig_ptr, n_groups, lens, hist,
         table_invalid) = encode_pre(blocks, n, in_use)
        # .cpu() waits for the device, so the wall below is the stage's
        alpha6 = np.repeat(n_in_use.cpu().numpy() + 2, 6).astype(np.int32)
        t1 = time.perf_counter()
        selectors = None
        for _ in range(C.N_ITERS):
            selectors, freq6 = group_iter(hist, lens, table_invalid)
            lens_np = native.make_code_lengths_batch(
                freq6.cpu().numpy().reshape(B * 6, A), alpha6)
            lens = torch.from_numpy(lens_np.reshape(B, 6, A)).to(dev)
        t2 = time.perf_counter()
        words, nbits = encode_post(mtfv, n_mtf, n_in_use, in_use, crc,
                                   orig_ptr, n_groups, selectors, lens,
                                   _words_for(arr.shape[1]))
        out = _fetch(words, nbits)
        t3 = time.perf_counter()
        _stage_add("pre(bwt+mtf+hist)", t1 - t0)
        _stage_add("4xiter+heap", t2 - t1)
        _stage_add("post+fetch", t3 - t2)
        return out

    def encode_payloads(self, blocks: list, level: int) -> list:
        """Encode RLE1 blocks into per-block (MSB-first bytes, nbits)
        payloads.

        Work-stealing scheduler: ``pipeline`` device workers claim batches
        from the front of the block list while ``host_workers`` threads
        (native C++ encoder, GIL released) steal single blocks from the
        tail; both meet in the middle.  Results are in block order.  The
        first error of any worker is raised after every worker has stopped;
        nothing is retried elsewhere."""
        L = len(blocks)
        if L == 0:
            return []
        N = _block_pad_size(level)
        bsz = self._batch_size_for(level)
        _share_add("blocks", L)
        results: list = [None] * L
        lock = threading.Lock()
        state = {"lo": 0, "hi": L, "dev_inflight": 0}
        sched = self._sched  # measured rates, persisted across calls
        errors: list = []
        n_host = self.host_workers if self.use_device \
            else max(1, self.host_workers)

        def claim_front():
            """Device batch claim.  Adaptive tail handoff: once both rates
            are known, the device declines a batch whenever the host pool
            alone would finish the remainder sooner than the device's
            backlog (in-flight batches share the one card) plus this batch;
            otherwise a late device batch gates the whole stream while the
            host sits idle."""
            with lock:
                remaining = state["hi"] - state["lo"]
                if (remaining > 0 and n_host and sched["dev_wall"]
                        and sched["host_done"] >= 3):
                    host_rate = (sched["host_done"] / sched["host_time"]
                                 * n_host)
                    backlog = (state["dev_inflight"] + 1) * sched["dev_wall"]
                    if remaining <= host_rate * backlog * 0.9:
                        # Starvation guard: a dev_wall estimate poisoned
                        # high by a one-off stall would make the device
                        # decline forever; the min-biased estimate can
                        # only correct if batches run.  Probe with one
                        # batch when the device is idle and the stream is
                        # long enough that a slow probe cannot gate it.
                        sched["declines"] += 1
                        _share_add("declines")
                        if not (state["dev_inflight"] == 0
                                and remaining > 5 * bsz
                                and sched["declines"] >= 8):
                            return 0, 0
                        sched["declines"] = 0
                take = min(bsz, remaining)
                s = state["lo"]
                state["lo"] += take
                if take:
                    state["dev_inflight"] += 1
                return s, take

        def claim_back():
            with lock:
                if state["hi"] <= state["lo"]:
                    return -1
                state["hi"] -= 1
                return state["hi"]

        def record_block(k, nbit):
            blk = blocks[k]
            raw = blk.raw_span[1] - blk.raw_span[0]
            tracing.vlog(2, "    block %d: crc 0x%08x, in %d, out %d bits"
                         " (%.3f bits/byte)", k, blk.crc, raw, nbit,
                         nbit / max(raw, 1))
            tracing.record("block", index=k, crc=blk.crc, raw_bytes=raw,
                           rle1_bytes=int(blk.data.size), out_bits=nbit)

        def run_batch(s, take):
            # the batch has exactly ``take`` lanes: nothing is compiled per
            # shape, so a tail batch needs no dummy lanes
            chunk = blocks[s:s + take]
            t0 = time.perf_counter()
            with tracing.span(f"batch[{s}:{s + take}]"):
                words, nbits = self.encode_batch(
                    level, *batch_arrays(chunk, take, N))
            wall = time.perf_counter() - t0
            with lock:
                # min-biased estimate of the device batch wall: a queued or
                # cold batch reports an inflated wall, and an estimate
                # poisoned high starves the device; a fast batch resets the
                # belief at once while slow ones drag it up gently
                if not sched["dev_wall"] or wall < sched["dev_wall"]:
                    sched["dev_wall"] = wall
                else:
                    sched["dev_wall"] = 0.8 * sched["dev_wall"] + 0.2 * wall
                state["dev_inflight"] -= 1
            _share_add("dev_blocks", take)
            for j in range(take):
                nbit = int(nbits[j])
                by = words[j, :(nbit + 31) // 32].byteswap().view(np.uint8)
                results[s + j] = (by[:(nbit + 7) // 8], nbit)
                record_block(s + j, nbit)

        def device_worker(i):
            try:
                with self._worker_context(i):
                    while not errors:
                        s, take = claim_front()
                        if take == 0:
                            return
                        run_batch(s, take)
            except BaseException as e:  # noqa: BLE001 -- re-raised after join
                errors.append(e)

        def host_worker():
            try:
                while not errors:
                    k = claim_back()
                    if k < 0:
                        return
                    blk = blocks[k]
                    t0 = time.perf_counter()
                    payload, nbits = native.encode_block(blk.data,
                                                         blk.in_use, blk.crc)
                    dt = time.perf_counter() - t0
                    with lock:
                        sched["host_done"] += 1
                        sched["host_time"] += dt
                    _share_add("host_blocks")
                    results[k] = (np.frombuffer(payload, np.uint8), nbits)
                    record_block(k, nbits)
            except BaseException as e:  # noqa: BLE001 -- re-raised after join
                errors.append(e)

        host_threads = [threading.Thread(target=host_worker)
                        for _ in range(n_host)]
        for t in host_threads:
            t.start()
        if self.use_device:
            dev_threads = [threading.Thread(target=device_worker, args=(i,))
                           for i in range(1, self.pipeline)]
            for t in dev_threads:
                t.start()
            device_worker(0)
            for t in dev_threads:
                t.join()
        else:
            host_worker()   # the main thread joins the host pool
        for t in host_threads:
            t.join()
        if errors:
            raise errors[0]
        assert all(r is not None for r in results)
        return results

    def compress(self, data, level: int = 9) -> bytes:
        """One .bz2 stream of ``data``, every block through this engine."""
        return compress_with(self.encode_payloads, data, level)


#: the engines of the process, one per distinct set of Engine arguments
#: (the sorted keyword items; ``()`` is the default engine), so that each
#: keeps its scheduler rates and allocator policy from one stream to the next
_ENGINES: dict = {}
_ENGINES_LOCK = threading.Lock()


def engine_for(**engine_kwargs) -> Engine:
    """The process's one Engine built with ``engine_kwargs``, made at first
    use; no arguments gives :func:`default_engine`."""
    key = tuple(sorted(engine_kwargs.items()))
    with _ENGINES_LOCK:
        eng = _ENGINES.get(key)
        if eng is None:
            eng = _ENGINES[key] = Engine(**engine_kwargs)
        return eng


def default_engine() -> Engine:
    """The process's Engine with the default arguments."""
    return engine_for()


def register_backend() -> None:
    """Register the default engine as block-encoder backend "gpu" for
    ``api.compress(..., backend="gpu")``."""
    from . import api

    api.register_block_encoder(
        "gpu", lambda blocks, level: default_engine().encode_payloads(
            blocks, level))
