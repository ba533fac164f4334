"""Device block decode on a PyTorch device: batched Huffman symbol decode,
MTF^-1, RLE2 expansion, inverse BWT and RLE1^-1 (port of
``bzip2_tpu/ops/decode.py``; each function keeps its JAX counterpart's name,
arguments and outputs, and returns the same integers).

* **Symbol decode** — the host light parse gives each 50-symbol group's
  start bit, so all groups decode in parallel: 50 steps, each one 32-bit
  window gather and one or two lookups in canonical tables built on the
  device (a 12-bit direct level and a 20-bit-prefix escape level).
* **MTF^-1** — the list update for rank r is a fixed cycle on positions, so
  512 chunks scan locally and one short compose over the chunks' net
  permutations anchors each chunk to the initial list.
* **RLE2 expansion** — run lengths from the bijective base-2 digits,
  offsets by prefix sum, then a scatter and a running max build the BWT's
  last column.
* **Inverse BWT** — the successor array from one stable sort, packed with
  the emitted byte and a segment-end flag; a two-wave splitter walk
  (``ibwt_kernel.ibwt_walk``, the one hand-written kernel of the decoder);
  segment ranks by pointer jumping; assembly by running max and one gather.

Differences from the JAX formulation, with equal outputs:

* uint32 bit windows and CRC states are carried in int64 and masked after
  each left shift (torch's int32 shifts are arithmetic).
* Every ``.at[].set`` scatter is ``scatter_reduce(amax, include_self=False)``:
  where targets are unique, as on every well-formed block, it is the plain
  set; where they repeat (the dropped dummy columns, or corrupt input) it
  takes the largest value instead of whichever write lands last, so the
  result does not depend on the device's scatter order.
* ``lax.scan``/``while_loop`` become Python loops of torch ops, except the
  walk, which is one kernel launch.

Shapes are exact per batch.  Corrupt input degrades to wrong bytes, never to
an out-of-bounds access; the decoder (``bzip2_tpu_torch/decoder.py``)
checks both CRC layers and heals a flagged block on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import MAX_ALPHA_SIZE as A

from .huffman import assign_codes_lanes
from .ibwt_kernel import ibwt_walk

G_SIZE = 50
LUT_BITS = 12
#: 12-bit windows the >12-bit code region can span (see the JAX module)
ESC_PREFIXES = 132
MTF_CHUNKS = 512
U32 = 0xFFFFFFFF

i32, i64 = torch.int32, torch.int64


def _set(base: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``base.at[rows, idx].set(val)`` along dim 1, independent of scatter
    order: a target written more than once takes the largest value."""
    val = torch.as_tensor(val, dtype=base.dtype, device=base.device)
    return base.scatter_reduce(1, idx.to(i64), val.expand(idx.shape), "amax",
                               include_self=False)


# --------------------------------------------------------------- tables ---

def build_tables(lens, alpha):
    """lens (B, 6, A) int32 code lengths (unused tables all zero); alpha
    (B,) int32.  Returns (lut1 (B, 6, 4096), lut2 (B, 6, ESC_PREFIXES*256),
    esc_base (B, 6)), all int32; entries are len | sym << 5, 0 = escape to
    lut2 (or invalid input).  Three scatter + cummax range fills over the
    canonical codes (huffman.c:152-166)."""
    B = lens.shape[0]
    L = B * 6
    dev = lens.device
    lensf = lens.reshape(L, A).to(i32)
    alpha6 = alpha.to(i32).repeat_interleave(6)
    codes = assign_codes_lanes(lensf, alpha6)
    sym = torch.arange(A, dtype=i32, device=dev)[None, :]
    active = sym < alpha6[:, None]
    payload = torch.where(active, lensf | (sym << 5), 0)

    def range_fill(width, pos, val, extra_pos=None, extra_val=None):
        """Scatter (pos << 15 | val) marks, cummax, keep the low 15 bits."""
        pc = pos.clamp(0, width - 1)
        buf = _set(torch.zeros((L, width + 1), dtype=i32, device=dev),
                   torch.where(val > 0, pc, width),
                   torch.where(val > 0, (pc << 15) | val, 0))
        if extra_pos is not None:     # a later write: it overrides
            buf[torch.arange(L, device=dev),
                torch.where(extra_pos < width, extra_pos, width)] = extra_val
        return torch.cummax(buf[:, :width], dim=1).values & 0x7FFF

    short = active & (lensf >= 1) & (lensf <= LUT_BITS)
    span1 = torch.ones_like(lensf) << (LUT_BITS - lensf).clamp(0, 12)
    start1 = torch.where(short, codes << (LUT_BITS - lensf).clamp(0, 12), 0)
    ebase = torch.where(short, span1, 0).sum(dim=1, dtype=i32)
    lut1 = range_fill(1 << LUT_BITS, start1, torch.where(short, payload, 0),
                      extra_pos=ebase, extra_val=ebase << 15)

    longm = active & (lensf > LUT_BITS)
    start2 = torch.where(
        longm, (codes << (20 - lensf).clamp(0, 8)) - (ebase[:, None] << 8), 0)
    lut2 = range_fill(ESC_PREFIXES << 8, start2,
                      torch.where(longm & (start2 >= 0), payload, 0))
    return (lut1.reshape(B, 6, 1 << LUT_BITS),
            lut2.reshape(B, 6, ESC_PREFIXES << 8), ebase.reshape(B, 6))


# -------------------------------------------------------- symbol decode ---

def _symbol_scan(wb8, goff, gsel, gvalid, lut1, lut2, esc_base, take_w):
    """The 50-step symbol scan; ``take_w(wb8, wi)`` reads the 32-bit window
    (int64) at byte index wi."""
    B, G = goff.shape
    dev = goff.device
    lut1f = lut1.reshape(B, 6 << LUT_BITS)
    lut2f = lut2.reshape(B, 6 * (ESC_PREFIXES << 8))
    ebase = torch.zeros((B, G), dtype=i32, device=dev)
    for t in range(6):
        ebase = torch.where(gsel == t, esc_base[:, t][:, None], ebase)
    w2 = ESC_PREFIXES << 8
    off = goff.to(i32)
    syms = []
    for _ in range(G_SIZE):
        w = (take_w(wb8, off >> 3) << (off & 7)) & U32
        w12 = (w >> (32 - LUT_BITS)).to(i32)
        e1 = torch.gather(lut1f, 1, ((gsel << LUT_BITS) + w12).to(i64))
        loc2 = (w >> 12).to(i32) - (ebase << 8)
        e2 = torch.gather(lut2f, 1, (gsel * w2 + loc2.clamp(0, w2 - 1)).to(i64))
        entry = torch.where(e1 > 0, e1, e2)
        off = off + torch.where(gvalid, entry & 31, 0)
        syms.append(entry >> 5)
    return torch.stack(syms, dim=2).reshape(B, G * G_SIZE)


def _byte_windows(words):
    """(..., WT) int64 words (uint32 values) -> (..., 4*WT) int64: entry i
    is the 32-bit big-endian window starting at byte i."""
    byts = torch.stack([words >> 24, (words >> 16) & 0xFF,
                        (words >> 8) & 0xFF, words & 0xFF], dim=-1).reshape(
        words.shape[:-1] + (4 * words.shape[-1],))
    return ((byts << 24) | (byts.roll(-1, dims=-1) << 16)
            | (byts.roll(-2, dims=-1) << 8) | byts.roll(-3, dims=-1))


def decode_symbols(words, goff, gsel, gvalid, lut1, lut2, esc_base):
    """words: flat (WT,) int64 big-endian bit buffer (uint32 values) shared
    by the batch; goff (B, G) int32 absolute bit offsets into it; gsel
    (B, G) int32; gvalid (B, G) bool; tables from build_tables.  Returns
    syms (B, G*50) int32 in stream order (garbage in invalid lanes)."""
    WT = words.shape[0]
    wb8 = _byte_windows(words)

    def take_flat(wb, wi):
        return wb[wi.clamp(0, 4 * WT - 1).to(i64)]

    return _symbol_scan(wb8, goff, gsel, gvalid, lut1, lut2, esc_base,
                        take_flat)


# ---------------------------------------------------------------- MTF^-1 ---

def mtf_inverse(syms, used_list, n_used, n_mtf, n_chunks: int = MTF_CHUNKS):
    """syms (B, M) int32; used_list (B, 256) int32 initial MTF list (padded
    0); n_used/n_mtf (B,) int32.  Returns vals (B, M) int32: the decoded
    byte per symbol (for RUNA/RUNB, the byte the zero run repeats).

    Chunked permutation-monoid form: a chunk's local scan gives each
    symbol's index into the chunk-start list and the chunk's net
    permutation; a sequential compose over the n_chunks summaries anchors
    every chunk to the initial list.  Exact at any chunking."""
    B, M = syms.shape
    dev = syms.device
    C = n_chunks
    K = -(-M // C)
    syms_p = torch.nn.functional.pad(syms.to(i32), (0, C * K - M),
                                     value=10_000)   # no-op symbols
    xs = syms_p.reshape(B, C, K)
    # per symbol: r = its list index (RUNA/RUNB read the front, as the
    # reference's where(s <= 1, lst[0], lst[r]) does, since r clamps to 0),
    # and lim = r + 1 when it moves lst[r] to the front (0 otherwise), so a
    # step is one gather, one shift and one masked select
    r = (xs - 1).clamp(0, 255)
    lim = torch.where((xs >= 2) & (xs <= n_used.to(i32)[:, None, None]),
                      r + 1, 0)
    r = r.to(i64)[..., None]
    j256 = torch.arange(256, dtype=i32, device=dev)
    lst = j256.expand(B, C, 256).contiguous()
    es = []
    for k in range(K):
        v = torch.gather(lst, 2, r[:, :, k])                # (B, C, 1)
        es.append(v)
        shifted = torch.cat([v, lst[:, :, :-1]], dim=2)
        lst = torch.where(j256 < lim[:, :, k, None], shifted, lst)
    e = torch.cat(es, dim=2)                                # (B, C, K)

    # exclusive compose over the chunk permutations: S_{c+1} = S_c[P_c]
    P = lst.to(i64)
    S = j256.expand(B, 256)
    S_all = []
    for c in range(C):
        S_all.append(S)
        S = torch.gather(S, 1, P[:, c])
    S_all = torch.stack(S_all, dim=1)                       # (B, C, 256)
    F = torch.gather(used_list.to(i32)[:, None, :].expand(B, C, 256), 2,
                     S_all.to(i64))
    g = (torch.arange(C, dtype=i32, device=dev)[None, :, None] * 256
         + e.clamp(0, 255)).reshape(B, C * K)
    return torch.gather(F.reshape(B, C * 256), 1, g.to(i64))[:, :M]


# ------------------------------------------------- RLE2 + BWT last column ---

def rle2_expand(syms, vals, n_used, n_mtf, N):
    """Build the BWT last column: syms/vals (B, M) int32.  Returns
    (last (B, N) int32 with 0 padding, n_out (B,) int32)."""
    B, M = syms.shape
    dev = syms.device
    idx = torch.arange(M, dtype=i32, device=dev)[None, :]
    valid = idx < n_mtf[:, None]
    isz = (syms <= 1) & valid
    seg_start = isz & torch.cat(
        [torch.ones((B, 1), dtype=torch.bool, device=dev), ~isz[:, :-1]], 1)
    run_base = torch.cummax(torch.where(seg_start, idx, 0), dim=1).values
    k = (idx - run_base).clamp(0, 30)
    cnt = torch.where(isz, (syms + 1) << k,
                      torch.where(valid & (syms >= 2)
                                  & (syms <= n_used[:, None]), 1, 0)).to(i32)
    offs = torch.cumsum(cnt, dim=1, dtype=i32) - cnt       # exclusive
    n_out = cnt.sum(dim=1, dtype=i32)
    emit = cnt > 0
    packed = torch.where(emit, ((idx + 1) << 8) | (vals & 0xFF), 0)
    tgt = torch.where(emit, offs.clamp(0, N - 1), N)
    blk = _set(torch.zeros((B, N + 1), dtype=i32, device=dev), tgt,
               packed)[:, :N]
    return torch.cummax(blk, dim=1).values & 0xFF, n_out


# ----------------------------------------------------------- inverse BWT ---

def ibwt(last, n_out, orig_ptr, n_walkers: int = 4096, budget: int = 32):
    """last (B, N) int32; n_out (B,); orig_ptr (B,).  Returns (out (B, N)
    int32 decoded post-RLE1 bytes, ok (B,) bool — False when a lane ran out
    of its step budget and needs the host).

    tt = A << 9 | is_splitter(A) << 8 | last, with A the successor map of a
    stable sort.  W1 - 1 evenly spaced splitters plus seq_0 = A[orig_ptr]
    cut the cycle into segments.  Wave 1 walks every segment up to twice
    the mean length; survivors compact into W1/4 lanes and walk on under
    the rest of the budget.  Ranks come from pointer jumping over the
    walker-successor graph; assembly is a scatter of segment-start marks,
    running maxima and one gather across both waves' buffers."""
    B, N = last.shape
    dev = last.device
    W1 = n_walkers
    if W1 > 4096 or N > (1 << 20):
        raise ValueError("ibwt: tt packing holds 20-bit successors and "
                         "at most 4096 walkers")
    W2 = max(W1 // 4, 8)
    S = W1 - 1                                  # regular splitter count
    idx = torch.arange(N, dtype=i32, device=dev)[None, :]
    n = n_out.to(i32).clamp(min=1)[:, None]                # (B, 1)

    key = torch.where(idx < n, last, 1 << 20)
    A_ = torch.sort(key, dim=1, stable=True).indices.to(i32)   # successors
    start_pos = torch.gather(
        A_, 1, orig_ptr.to(i64).clamp(0, N - 1)[:, None])   # (B, 1)

    # splitters p_j = floor(j*n/S) for j < S (j*n would overflow int32),
    # deduplicated when n < S and against seq_0 (walker S)
    j_s = torch.arange(W1, dtype=i32, device=dev)[None, :]
    j_reg = j_s[:, :S]
    p_reg = j_reg * (n // S) + (j_reg * (n % S)) // S
    p_j = torch.cat([p_reg, start_pos], dim=1)             # (B, W1)
    tru = torch.ones((B, 1), dtype=torch.bool, device=dev)
    w_valid = torch.cat([tru, p_reg[:, 1:] != p_reg[:, :-1], tru], dim=1)
    w_valid = w_valid & ((j_s == S) | (p_j != start_pos))

    # walker id + 1 at each valid segment start
    smap = _set(torch.zeros((B, N + 1), dtype=i32, device=dev),
                torch.where(w_valid, p_j.clamp(0, N - 1), N),
                torch.where(w_valid, j_s + 1, 0))[:, :N]

    def splitter_id(q):
        """Walker id whose segment starts at position q, or -1."""
        return torch.gather(smap, 1, q.to(i64)) - 1

    tt = ((A_ << 9)
          | ((torch.gather(smap, 1, A_.to(i64)) > 0).to(i32) << 8)
          | torch.where(idx < n, last & 0xFF, 0)).contiguous()

    m = N // S + 1                                         # mean seg len
    cap1 = 2 * m
    cap2 = max((budget - 2) * m, 1)
    # assembly marks are (offset << 11 | payload): lane ids over 11 bits
    # ship their two high bits in the c1 fill's spare bits
    if cap1 > 0x1FF or W2 > 0x7FF:
        raise ValueError("ibwt: assembly mark packing needs cap1 < 512")

    def wave(cur0, cap):
        cur, cnt, hitp, buf = ibwt_walk(tt, cur0.contiguous(), cap)
        hitj = torch.where(hitp >= 0, splitter_id(hitp.clamp(0, N - 1)), -1)
        return cur, cnt, hitj, buf

    cur0 = torch.where(w_valid, p_j, -1)
    cur1, cnt1, hitj1, buf1 = wave(cur0, cap1)

    # compact the rare survivors (long segments) into W2 lanes
    surv = cur1 >= 0
    dest = torch.cumsum(surv.to(i32), dim=1, dtype=i32) - 1
    over = (surv & (dest >= W2)).any(dim=1)
    slot = torch.where(surv & (dest < W2), dest, W2)
    cur2in = _set(torch.full((B, W2 + 1), -1, dtype=i32, device=dev), slot,
                  torch.where(surv, cur1, -1))[:, :W2]
    src_id = _set(torch.full((B, W2 + 1), -1, dtype=i32, device=dev), slot,
                  torch.where(surv, j_s, -1))[:, :W2]
    cur2, cnt2c, hitj2c, buf2 = wave(cur2in, cap2)
    ok = ~((cur2 >= 0).any(dim=1) | over)

    # merge wave-2 results back onto their originating walkers
    src_t = torch.where(src_id >= 0, src_id.clamp(0, W1 - 1), W1)
    add_cnt = _set(torch.zeros((B, W1 + 1), dtype=i32, device=dev), src_t,
                   cnt2c)[:, :W1]
    fix_hit = _set(torch.full((B, W1 + 1), -1, dtype=i32, device=dev), src_t,
                   hitj2c)[:, :W1]
    cnt = cnt1 + add_cnt
    hitj = torch.where(hitj1 >= 0, hitj1, fix_hit)
    hitj = torch.where(w_valid, hitj, -1)

    # segment ranks by pointer jumping: seq_0 (walker S) is rank 0 and the
    # zero-distance terminal; rank = (live count - distance) mod live count
    live = w_valid & (cnt > 0)
    terminal = (~live) | (j_s == S)
    ptr = torch.where(terminal, j_s, hitj.clamp(0, W1 - 1)).to(i64)
    dist = torch.where(terminal, 0, 1).to(i32)
    for _ in range(max(W1.bit_length(), 1)):
        dist = dist + torch.gather(dist, 1, ptr)
        ptr = torch.gather(ptr, 1, ptr)
    total = live.sum(dim=1, dtype=i32)[:, None]
    rank = torch.where(live, (total - dist) % total.clamp(min=1), W1)

    # per-walker output offsets: cnt by rank, exclusive cumsum, gather back
    rank_c = rank.clamp(0, W1)
    cnt_by_rank = _set(torch.zeros((B, W1 + 1), dtype=i32, device=dev),
                       rank_c, torch.where(live, cnt, 0))[:, :W1]
    off_by_rank = torch.cumsum(cnt_by_rank, dim=1, dtype=i32) - cnt_by_rank
    goffw = torch.gather(
        torch.cat([off_by_rank, torch.zeros((B, 1), dtype=i32, device=dev)],
                  dim=1), 1, rank_c.to(i64))

    # assemble: (goffw << 11 | payload) marks at segment starts, cummax
    # fills; one gather pulls the bytes from the two waves' buffers
    goc = goffw.clamp(0, N - 1) << 11
    mark_at = torch.where(live, goffw.clamp(0, N - 1), N)

    def fill(payload):
        mk = _set(torch.zeros((B, N + 1), dtype=i32, device=dev), mark_at,
                  torch.where(live, goc | payload, 0))[:, :N]
        return torch.cummax(mk, dim=1).values

    f_lane = fill((j_s + 1) & 0x7FF)
    pos_in = idx - (f_lane >> 11)
    # c1 fill: 9 bits of wave-1 count + the lane id's two high bits
    fc1 = fill((((j_s + 1) >> 11) << 9) | cnt1.clamp(max=0x1FF))
    lane_c = ((((fc1 >> 9) & 3) << 11) | (f_lane & 0x7FF)).clamp(1, W1) - 1
    c1 = fc1 & 0x1FF
    # wave-2 lane of each walker (W2 when it had none)
    w2lane = _set(torch.full((B, W1 + 1), W2, dtype=i32, device=dev), src_t,
                  torch.arange(W2, dtype=i32, device=dev)[None, :])[:, :W1]
    l2 = fill(w2lane) & 0x7FF
    in1 = pos_in < c1
    flat = torch.cat([buf1.reshape(B, W1 * cap1),
                      buf2.reshape(B, W2 * cap2)], dim=1)
    g = torch.where(in1, lane_c * cap1 + pos_in.clamp(0, cap1 - 1),
                    W1 * cap1 + l2.clamp(0, W2 - 1) * cap2
                    + (pos_in - c1).clamp(0, cap2 - 1))
    return torch.gather(flat, 1, g.to(i64)).to(i32), ok


# ----------------------------------------------------- RLE1^-1 + CRC-32 ---

CRC_POLY = 0x04C11DB7


def _crc_constants():
    """Host constants: the 8 basis images of an input byte's bits in the
    next CRC state, and the 32 squaring matrices for x^(8*2^k) (each 32
    uint32 rows)."""
    def times_x8(c):
        for _ in range(8):
            c = ((c << 1) ^ CRC_POLY) & U32 if c & 0x80000000 else (c << 1) & U32
        return c

    basis = np.array([times_x8(1 << (k + 24)) for k in range(8)], np.uint32)

    def mat_mul(a, b):
        out = np.zeros(32, np.uint32)
        for i in range(32):
            r = 0
            for bit in range(32):
                if (int(a[i]) >> bit) & 1:
                    r ^= int(b[bit])
            out[i] = r
        return out

    mats = [np.array([times_x8(1 << i) for i in range(32)], np.uint32)]
    for _ in range(31):
        mats.append(mat_mul(mats[-1], mats[-1]))
    return basis, np.stack(mats)             # (8,), (32, 32)


_CRC_BASIS, _CRC_POW = _crc_constants()


def _mat_apply(vec, mat_rows):
    """vec: int64 CRC states (uint32 values); mat_rows (32,) uint32: the xor
    of the rows whose bit is set in vec."""
    out = torch.zeros_like(vec)
    for b in range(32):
        out = out ^ torch.where(((vec >> b) & 1) != 0, int(mat_rows[b]), 0)
    return out


def _xor_reduce(x):
    """Xor of (B, C) uint32 values (int64) along dim 1."""
    bits = torch.arange(32, dtype=i64, device=x.device)
    par = ((x[:, :, None] >> bits) & 1).sum(dim=1) & 1
    return (par << bits).sum(dim=1)


def crc32_device(data, lengths, n_lanes: int = 512):
    """CRC-32/BZIP2 of each row of ``data`` (B, N) over ``lengths`` (B,)
    bytes, as a GF(2)-linear fold: per-lane partial CRCs (a table-free byte
    feed) combined with x^(8k) matrix powers.  Returns (B,) int64 holding
    the uint32 CRCs."""
    B, N = data.shape
    dev = data.device
    C = n_lanes
    Lc = -(-N // C)
    NT = C * Lc
    # right-align each message: leading zeros are free for a zero-init fold
    idx = torch.arange(NT, dtype=i64, device=dev)[None, :]
    pad = NT - lengths.to(i64)[:, None]
    src = (idx - pad).clamp(0, N - 1)
    x = torch.where(idx >= pad,
                    torch.gather(data.to(i64) & 0xFF, 1, src), 0)
    xs = x.reshape(B, C, Lc)
    crc = torch.zeros((B, C), dtype=i64, device=dev)
    for i in range(Lc):
        t = (crc >> 24) ^ xs[:, :, i]
        nxt = (crc << 8) & U32
        for k in range(8):
            nxt = nxt ^ torch.where(((t >> k) & 1) != 0, int(_CRC_BASIS[k]), 0)
        crc = nxt

    def shift_by(vec, k):
        # vec * x^(8k): the squaring matrices selected by k's bits
        out = vec
        for b in range(26):                  # 8k < 2^29 bits
            out = torch.where(((k >> b) & 1) != 0,
                              _mat_apply(out, _CRC_POW[b]), out)
        return out

    suffix = ((C - 1 - torch.arange(C, dtype=i64, device=dev)) * Lc)[None, :]
    raw = _xor_reduce(shift_by(crc, suffix.expand(B, C)))
    init = shift_by(torch.full((B,), U32, dtype=i64, device=dev),
                    lengths.to(i64))
    return (raw ^ init) ^ U32


def rle1_inverse(x, n, NOUT: int):
    """Invert the RLE1 pre-pass: x (B, N) int32 post-RLE1 bytes, n (B,)
    lengths.  Returns (out (B, NOUT) int32, out_len (B,) int32, fits (B,)
    bool).  A count byte is the 5th byte of a 4-byte equal group, or the
    first byte of a run whose predecessor run left the parser count-pending;
    the 2-state parser over maximal runs is "parity of flips since the last
    reset", plain cumsums and one gather (bzlib.c:531-677 semantics)."""
    B, N = x.shape
    dev = x.device
    idx = torch.arange(N, dtype=i32, device=dev)[None, :]
    valid = idx < n[:, None]
    xb = torch.where(valid, x & 0xFF, -1)
    prev = torch.cat([torch.full((B, 1), -2, dtype=i32, device=dev),
                      xb[:, :-1]], dim=1)
    start = (xb != prev) & valid                           # run starts
    rs = torch.cummax(torch.where(start, idx, 0), dim=1).values
    r = idx - rs

    # run lengths at start positions: next start's index - this start's
    big = 1 << 30
    nxt_start_pos = torch.cummin(
        torch.where(start, idx, big).flip(1), dim=1).values.flip(1)
    after = torch.cat([nxt_start_pos[:, 1:],
                       torch.full((B, 1), big, dtype=i32, device=dev)], 1)
    run_end = torch.minimum(after, n[:, None])             # exclusive
    run_len = torch.where(start, run_end - idx, 0)

    # pending' = ((L - pending) % 5 == 4): flip, identity or reset per run
    flip = start & ((run_len % 5) == 4)
    reset = start & ((run_len % 5) != 4) & (((run_len - 1) % 5) != 4)
    flips_at = torch.cumsum(flip.to(i32), dim=1, dtype=i32)  # inclusive
    flips_prev = torch.cat([torch.zeros((B, 1), dtype=i32, device=dev),
                            flips_at[:, :-1]], dim=1)
    reset_pos = torch.cummax(torch.where(reset, idx, -1), dim=1).values
    reset_prev = torch.cat([torch.full((B, 1), -1, dtype=i32, device=dev),
                            reset_pos[:, :-1]], dim=1)
    flips_at_reset = torch.where(
        reset_prev >= 0,
        torch.gather(flips_at, 1, reset_prev.clamp(0, N - 1).to(i64)), 0)
    pending_start = (flips_prev - flips_at_reset) & 1      # at run starts
    pending_here = torch.gather(pending_start, 1, rs.to(i64))

    eff = r - pending_here
    is_cnt = valid & (((pending_here == 1) & (r == 0))
                      | ((eff >= 0) & (eff % 5 == 4)))
    emit = torch.where(valid, torch.where(is_cnt, xb, 1), 0)
    val = torch.where(is_cnt, prev, xb)
    offs = torch.cumsum(emit, dim=1, dtype=i32) - emit
    out_len = emit.sum(dim=1, dtype=i32)
    fits = out_len <= NOUT

    do = (emit > 0) & fits[:, None]
    packed = torch.where(do, ((idx + 1) << 8) | val, 0)
    tgt = torch.where(do, offs.clamp(0, NOUT - 1), NOUT)
    out = _set(torch.zeros((B, NOUT + 1), dtype=i32, device=dev), tgt,
               packed)[:, :NOUT]
    filled = torch.cummax(out, dim=1).values
    covered = (torch.arange(NOUT, dtype=i32, device=dev)[None, :]
               < out_len[:, None])
    return torch.where(covered, filled & 0xFF, 0), out_len, fits
