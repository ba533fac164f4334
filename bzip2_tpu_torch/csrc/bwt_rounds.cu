// The BWT's doubling rounds on the card: a round's keys, its rerank after
// the sort, the tail stages' rerank, the loop test, and the loop itself.
//
// Replaces the lax.while_loops of bzip2_tpu/ops/bwt.py, the full-width
// loop (:260) and each compact tail stage (:323), with the bodies they run
// and their _gapped_rerank (:86) and _scatter_rank (:105); none has a
// Pallas original.  Run as Python loops, each loop test was a host sync.
// Here each stage's loop is one CUDA graph with lax.while_loop's
// semantics: a gate kernel node runs the loop test and sets the graph's
// conditional handle, then a conditional WHILE node runs one round (this
// file's kernels and sort_pairs.cu's, captured from ops/bwt.py's calls on
// a private stream) and the gate again, until the test fails.  ops/bwt.py
// captures one such graph a stage once for each (stream, N) plan and
// launches it at every call, with no host sync; no round runs past the
// test.
//
// ctl, the loop's state on the card: ctl[0] the gate (the last loop
// test), ctl[1] k (the prefix length the ranks resolve), ctl[2] the rows
// of the round record written.  In a loop graph the gate also counts the
// stage's entries and rounds on the card (cnt), from which the port counts
// the launches of the kernels inside the graph (ops/bwt_kernel.py).
//
//   * keys: a full-width round's (A, B) pair per position, A = r1 << 11 |
//     r2 >> 9, B = (r2 & 511) << 20 | i with r1 = rank[i] and r2 the
//     neighbour rank k on; a tail round's pair gathers r2 from rankD at
//     (p + k) mod n for each live compact entry.  The JAX package writes a
//     pad mirror (rank[0:2048] again past each row's end) so that a roll
//     stands in for the gather while k <= N - max(n); no mirror is written
//     here, the kernel reads rank through the mirror's index map, because
//     on a row shorter than k (exactly periodic) the roll reads the pads'
//     own ranks and the reference's output depends on that.
//   * rerank: from the sorted pairs, the gapped rank (the sorted index of
//     the class's first member: a running max of "class starts here ? j"),
//     the singleton flag, the scatter of both through the sorted order (a
//     permutation, so no write conflicts) and each row's count of tied
//     positions.  Also the 16-byte initial ranks, on two int64 key columns.
//   * tail rerank: the same on a compact buffer with two running maxes
//     (segment and sub-class starts), written back in place, and the
//     scatter of the new ranks into rankD (dead lanes skip it).
//   * gate: k < N && any(unres > thresh), after doubling k when a round ran;
//     it appends (stage, k, unres per row) to the round record and, inside
//     a loop graph, sets the WHILE node's handle.
//
// The running max across a row of up to 2^20 entries is two passes: a
// tile's last class start (scan kernels), then each tile takes the max of
// the tiles before it as its carry and scans its 4096 entries in shared
// memory (scatter kernels).  The per-row counts are block sums added with
// one atomic a CTA; the scan pass clears them in the same round.
// What bounds it: device-memory traffic.  A full-width round reads rank
// twice (4 B at i and 4 B at (i + k) mod n, both runs of consecutive
// positions), writes the pair (8 B), reads the sorted pair twice (16 B)
// and scatters rank and the tied flag to random positions (a 32-byte
// sector each).
#include "common.cuh"

namespace {

constexpr int kInf = 0x7FFFFFFF;
constexpr int kP20 = (1 << 20) - 1;
constexpr int kGate = 0, kK = 1, kRows = 2;     // ctl's fields
constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;        // sorted entries a CTA
constexpr int kKeyCtas = 160;                   // keys CTAs a row, at most
constexpr int kMirror = 2048;                   // the JAX pad mirror's width
constexpr int kWarps = kThreads / 32;

// The block's max of v, in every thread.  s: kWarps ints.
__device__ __forceinline__ int block_max(int v, int* s) {
  v = __reduce_max_sync(kFullMask, v);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = s[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = max(m, s[i]);
  __syncthreads();
  return m;
}

// The block's sum of v, in every thread.
__device__ __forceinline__ int block_sum(int v, int* s) {
  v = __reduce_add_sync(kFullMask, v);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) m += s[i];
  __syncthreads();
  return m;
}

// The max of v over the threads before this one (-1 for thread 0).
__device__ __forceinline__ int block_exclusive_max(int v, int* s) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, d);
    if (lane >= d) x = max(x, y);
  }
  int excl = __shfl_up_sync(kFullMask, x, 1);
  if (lane == 0) excl = -1;
  if (lane == 31) s[w] = x;
  __syncthreads();
  for (int i = 0; i < w; ++i) excl = max(excl, s[i]);
  __syncthreads();
  return excl;
}

// ---------------------------------------------------------------- keys --

__global__ void __launch_bounds__(kThreads)
    full_keys_kernel(const int* __restrict__ rank, const int* __restrict__ nv,
                     const int* __restrict__ ctl, int* __restrict__ A,
                     int* __restrict__ Bv, int B, int N, int ld) {
  const int b = blockIdx.y;
  const int n = nv[b];
  const int k = ctl[kK];
  const int km = k % max(n, 1);
  int max_n = 0;
  for (int i = 0; i < B; ++i) max_n = max(max_n, nv[i]);
  // the reference's roll: rank[i + k] of the mirrored row, i + k < N
  const bool roll = k <= min(N - max_n, kMirror);
  const int ms = min(kMirror, N);
  const int* r = rank + (long long)b * N;
  int* a = A + (long long)b * ld;
  int* bv = Bv + (long long)b * ld;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < N;
       i += gridDim.x * kThreads) {
    if (i < n) {
      int j;
      if (roll) {
        j = i + k;
        if (j >= n && j - n < ms) j -= n;
      } else {
        j = i + km;
        if (j >= n) j -= n;
      }
      const int r1 = r[i], r2 = r[j];
      a[i] = (r1 << 11) | (r2 >> 9);
      bv[i] = ((r2 & 511) << 20) | i;
    } else {
      a[i] = kInf;
      bv[i] = (1 << 29) | i;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    tail_keys_kernel(const int* __restrict__ rankD, const int* __restrict__ p,
                     const int* __restrict__ r1, const int* __restrict__ nv,
                     const int* __restrict__ ctl, int* __restrict__ A,
                     int* __restrict__ Bv, int N, int C) {
  const int b = blockIdx.y;
  const int nn = max(nv[b], 1);
  const int km = ctl[kK] % nn;
  const int* rd = rankD + (long long)b * (N + 1);
  const long long row = (long long)b * C;
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < C;
       j += gridDim.x * kThreads) {
    const int pj = p[row + j];
    if (pj >= 0) {
      int q = pj + km;
      if (q >= nn) q %= nn;
      const int n1 = rd[q];
      const int rc = min(r1[row + j], kP20);
      A[row + j] = (rc << 11) | (n1 >> 9);
      Bv[row + j] = ((n1 & 511) << 20) | pj;
    } else {
      A[row + j] = kInf;
      Bv[row + j] = (1 << 29) | j;
    }
  }
}

// -------------------------------------------------------------- rerank --

// Does sorted entry j (>= 1) start a new class?  Wide: two int64 key
// columns (the 16-byte ranks); packed: a round's (A, B >> 20).
template <bool kWide>
__device__ __forceinline__ bool differs(const void* ka, const void* kb,
                                        long long off, int j) {
  if (kWide) {
    const long long* x = static_cast<const long long*>(ka) + off;
    const long long* y = static_cast<const long long*>(kb) + off;
    return x[j] != x[j - 1] || y[j] != y[j - 1];
  }
  const int* x = static_cast<const int*>(ka) + off;
  const int* y = static_cast<const int*>(kb) + off;
  return x[j] != x[j - 1] || (y[j] >> 20) != (y[j - 1] >> 20);
}

template <bool kWide>
__device__ __forceinline__ bool starts(const void* ka, const void* kb,
                                       long long off, int j) {
  return j == 0 || differs<kWide>(ka, kb, off, j);
}

// Pass 1: each tile's last class start (tile_last (B, tiles)); clears the
// row's count.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
    rerank_scan_kernel(const void* ka, const void* kb, int ld, int S,
                       int* __restrict__ tile_last,
                       int* __restrict__ unres) {
  __shared__ int s_red[kWarps];
  const int b = blockIdx.y, t = blockIdx.x;
  const long long off = (long long)b * ld;
  const int base = t * kTile;
  int last = -1;
#pragma unroll 4
  for (int r = 0; r < kItems; ++r) {
    const int j = base + r * kThreads + threadIdx.x;
    if (j < S && starts<kWide>(ka, kb, off, j)) last = j;
  }
  last = block_max(last, s_red);
  if (threadIdx.x == 0) {
    tile_last[(long long)b * gridDim.x + t] = last;
    if (t == 0) unres[b] = 0;
  }
}

// Pass 2: the gapped rank of each sorted entry (its class's first sorted
// index), scattered with the tie flag to the entry's position.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
    rerank_scatter_kernel(const void* ka, const void* kb,
                          const long long* __restrict__ order, int ld, int S,
                          int N, const int* __restrict__ nv,
                          const int* __restrict__ tile_last,
                          int* __restrict__ rank,
                          unsigned char* __restrict__ tied,
                          int* __restrict__ unres) {
  __shared__ unsigned char s_flag[kTile + 1];
  __shared__ int s_start[kTile];
  __shared__ int s_red[kWarps];
  const int b = blockIdx.y, t = blockIdx.x;
  const long long off = (long long)b * ld;
  const int base = t * kTile;
  int carry = -1;
  for (int i = threadIdx.x; i < t; i += kThreads)
    carry = max(carry, tile_last[(long long)b * gridDim.x + i]);
  carry = block_max(carry, s_red);
  // flags of the tile's entries and of the next tile's first (past the
  // row's end a class always "starts", so the last entry's successor test
  // holds)
  for (int l = threadIdx.x; l <= kTile; l += kThreads) {
    const int j = base + l;
    s_flag[l] = j >= S || starts<kWide>(ka, kb, off, j);
  }
  __syncthreads();
  const int d = threadIdx.x * kItems;
  int run = -1;
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    if (s_flag[d + i]) run = base + d + i;
  int cur = max(carry, block_exclusive_max(run, s_red));
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (s_flag[d + i]) cur = base + d + i;
    s_start[d + i] = cur;
  }
  __syncthreads();
  const int n = nv[b];
  const long long prow = (long long)b * N;
  int cnt = 0;
#pragma unroll 4
  for (int r = 0; r < kItems; ++r) {
    const int l = r * kThreads + threadIdx.x;
    const int j = base + l;
    if (j < S) {
      const int pos =
          kWide ? (int)order[off + j]
                : (static_cast<const int*>(kb)[off + j] & kP20);
      const bool tie = !(s_flag[l] && s_flag[l + 1]) && pos < n;
      rank[prow + pos] = s_start[l];
      tied[prow + pos] = tie;
      cnt += tie;
    }
  }
  cnt = block_sum(cnt, s_red);
  if (threadIdx.x == 0 && cnt) atomicAdd(unres + b, cnt);
}

// --------------------------------------------------------- tail rerank --

// Segment start (r1 = A >> 11 changes) and sub-class start ((A, B >> 20)
// changes) of sorted entry j of a row.
__device__ __forceinline__ int tail_flags(const int* a, const int* bb, int j,
                                          int C) {
  if (j >= C || j == 0) return 3;
  const int a0 = a[j - 1], a1 = a[j];
  const bool seg = (a1 >> 11) != (a0 >> 11);
  const bool sub = seg || a1 != a0 || (bb[j] >> 20) != (bb[j - 1] >> 20);
  return (int)seg | ((int)sub << 1);
}

// Pass 1: each tile's last segment and sub-class start (tile_last
// (B, tiles, 2)); clears the row's count.
__global__ void __launch_bounds__(kThreads)
    tail_scan_kernel(const int* __restrict__ As, const int* __restrict__ Bs,
                     int C, int* __restrict__ tile_last,
                     int* __restrict__ unres) {
  __shared__ int s_red[kWarps];
  const int b = blockIdx.y, t = blockIdx.x;
  const int* a = As + (long long)b * C;
  const int* bb = Bs + (long long)b * C;
  const int base = t * kTile;
  int seg = -1, sub = -1;
#pragma unroll 4
  for (int r = 0; r < kItems; ++r) {
    const int j = base + r * kThreads + threadIdx.x;
    if (j < C) {
      const int f = tail_flags(a, bb, j, C);
      if (f & 1) seg = j;
      if (f & 2) sub = j;
    }
  }
  seg = block_max(seg, s_red);
  sub = block_max(sub, s_red);
  if (threadIdx.x == 0) {
    int* tl = tile_last + ((long long)b * gridDim.x + t) * 2;
    tl[0] = seg;
    tl[1] = sub;
    if (t == 0) unres[b] = 0;
  }
}

// Pass 2: new ranks r1 + (sub start - segment start), the unresolved flags
// and positions written back to the compact buffer in place, the new ranks
// scattered into rankD at the live positions.
__global__ void __launch_bounds__(kThreads)
    tail_scatter_kernel(const int* __restrict__ As, const int* __restrict__ Bs,
                        int N, int C, const int* __restrict__ tile_last,
                        int* __restrict__ rankD, int* __restrict__ p,
                        int* __restrict__ r1,
                        unsigned char* __restrict__ unresolved,
                        int* __restrict__ unres) {
  __shared__ unsigned char s_flag[kTile + 1];
  __shared__ int s_diff[kTile];
  __shared__ int s_red[kWarps];
  const int b = blockIdx.y, t = blockIdx.x;
  const long long row = (long long)b * C;
  const int* a = As + row;
  const int* bb = Bs + row;
  const int base = t * kTile;
  int cseg = -1, csub = -1;
  for (int i = threadIdx.x; i < t; i += kThreads) {
    const int* tl = tile_last + ((long long)b * gridDim.x + i) * 2;
    cseg = max(cseg, tl[0]);
    csub = max(csub, tl[1]);
  }
  cseg = block_max(cseg, s_red);
  csub = block_max(csub, s_red);
  for (int l = threadIdx.x; l <= kTile; l += kThreads)
    s_flag[l] = (unsigned char)tail_flags(a, bb, base + l, C);
  __syncthreads();
  const int d = threadIdx.x * kItems;
  int rseg = -1, rsub = -1;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (s_flag[d + i] & 1) rseg = base + d + i;
    if (s_flag[d + i] & 2) rsub = base + d + i;
  }
  int seg = max(cseg, block_exclusive_max(rseg, s_red));
  int sub = max(csub, block_exclusive_max(rsub, s_red));
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (s_flag[d + i] & 1) seg = base + d + i;
    if (s_flag[d + i] & 2) sub = base + d + i;
    s_diff[d + i] = sub - seg;
  }
  __syncthreads();
  int* rd = rankD + (long long)b * (N + 1);
  int cnt = 0;
#pragma unroll 4
  for (int r = 0; r < kItems; ++r) {
    const int l = r * kThreads + threadIdx.x;
    const int j = base + l;
    if (j < C) {
      const int aj = a[j];
      const bool live = aj != kInf;
      const int nr = (aj >> 11) + s_diff[l];
      const bool un = !((s_flag[l] & 2) && (s_flag[l + 1] & 2)) && live;
      const int pos = bb[j] & kP20;
      p[row + j] = live ? pos : -1;
      r1[row + j] = live ? nr : kInf;
      unresolved[row + j] = un;
      if (live) rd[pos] = nr;
      cnt += un;
    }
  }
  cnt = block_sum(cnt, s_red);
  if (threadIdx.x == 0 && cnt) atomicAdd(unres + b, cnt);
}

// ---------------------------------------------------------------- gate --

// mode 0: the loop test at a stage's entry; 1: the same, after appending
// (stage, k, unres) to the record (the initial ranks); 2: after a round:
// k *= 2, append to the record, then the loop test.  With has_cond, the
// test's result also goes to the loop graph's handle; with cnt, the call
// adds one to cnt[0] (an entry) or cnt[1] (a round).
__global__ void __launch_bounds__(kThreads)
    gate_kernel(int* ctl, const int* __restrict__ unres, int* __restrict__ rec,
                int* __restrict__ cnt, int B, int N, int thresh, int stage,
                int rec_rows, int mode, cudaGraphConditionalHandle cond,
                int has_cond) {
  __shared__ int s_any;
  const int k = mode == 2 ? ctl[kK] * 2 : ctl[kK];
  const int row = ctl[kRows];
  const bool keep = mode != 0 && rec != nullptr && row < rec_rows;
  int* out = rec + (long long)row * (B + 2);
  if (threadIdx.x == 0) s_any = 0;
  __syncthreads();
  int any = 0;
  for (int b = threadIdx.x; b < B; b += kThreads) {
    const int u = unres[b];
    any |= u > thresh;
    if (keep) out[2 + b] = u;
  }
  if (__any_sync(kFullMask, any) && (threadIdx.x & 31) == 0) s_any = 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    if (keep) {
      out[0] = stage;
      out[1] = k;
      ctl[kRows] = row + 1;
    }
    const int go = k < N && s_any;
    ctl[kK] = k;
    ctl[kGate] = go;
    if (has_cond) cudaGraphSetConditional(cond, go ? 1u : 0u);
    if (cnt != nullptr) cnt[mode == 2 ? 1 : 0] += 1;
  }
}

unsigned key_ctas(int width) {
  const int ctas = (width + kThreads - 1) / kThreads;
  return (unsigned)(ctas < kKeyCtas ? ctas : kKeyCtas);
}

}  // namespace

// A round's keys into A, Bv (ctl holds k).  p null: a full-width round,
// rank (B, N), keys for N positions at row stride ld; else a tail round,
// rank is rankD (B, N + 1), p and r1 (B, C), ld = C.
BZ2T_API int bz2t_bwt_keys(const int* rank, const int* p, const int* r1,
                           const int* n, const int* ctl, int* A, int* Bv,
                           int B, int N, int C, int ld, void* stream) {
  if (ctl == nullptr || B < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (p == nullptr) {
    if (ld < N) return (int)cudaErrorInvalidValue;
    full_keys_kernel<<<dim3(key_ctas(N), B), kThreads, 0, st>>>(
        rank, n, ctl, A, Bv, B, N, ld);
  } else {
    if (ld != C || C < 1) return (int)cudaErrorInvalidValue;
    tail_keys_kernel<<<dim3(key_ctas(C), B), kThreads, 0, st>>>(
        rank, p, r1, n, ctl, A, Bv, N, C);
  }
  BZ2T_CHECK_LAUNCH();
  return 0;
}

// The rerank after a sort: S sorted entries a row (row stride ld) of two
// int64 key columns ka, kb and an int64 order (wide, the 16-byte ranks),
// or of a round's sorted int32 (A, B) pair in ka, kb (order null).  Writes
// rank (B, N) int32 and tied (B, N) bool at every position and unres (B,)
// int32; tile_last: (B, ceil(S / 4096)) int32 scratch.
BZ2T_API int bz2t_bwt_rerank(const void* ka, const void* kb,
                             const long long* order, const int* n,
                             int* tile_last, int* rank,
                             unsigned char* tied, int* unres, int wide, int B,
                             int N, int S, int ld, void* stream) {
  if (B < 1 || S < 1 || S > N || ld < S || (wide && order == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((S + kTile - 1) / kTile), (unsigned)B);
  if (wide) {
    rerank_scan_kernel<true><<<grid, kThreads, 0, st>>>(ka, kb, ld, S,
                                                         tile_last, unres);
    BZ2T_CHECK_LAUNCH();
    rerank_scatter_kernel<true><<<grid, kThreads, 0, st>>>(
        ka, kb, order, ld, S, N, n, tile_last, rank, tied, unres);
  } else {
    rerank_scan_kernel<false><<<grid, kThreads, 0, st>>>(ka, kb, ld, S,
                                                          tile_last, unres);
    BZ2T_CHECK_LAUNCH();
    rerank_scatter_kernel<false><<<grid, kThreads, 0, st>>>(
        ka, kb, nullptr, ld, S, N, n, tile_last, rank, tied, unres);
  }
  BZ2T_CHECK_LAUNCH();
  return 0;
}

// A tail round's rerank from its sorted (As, Bs) (B, C): p, r1 (B, C)
// int32 and unresolved (B, C) bool in place, rankD (B, N + 1) at the live
// positions, unres (B,); tile_last: (B, ceil(C / 4096), 2) int32 scratch.
BZ2T_API int bz2t_bwt_tail_rerank(const int* As, const int* Bs,
                                  int* tile_last, int* rankD,
                                  int* p, int* r1, unsigned char* unresolved,
                                  int* unres, int B, int N, int C,
                                  void* stream) {
  if (B < 1 || C < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((C + kTile - 1) / kTile), (unsigned)B);
  tail_scan_kernel<<<grid, kThreads, 0, st>>>(As, Bs, C, tile_last, unres);
  BZ2T_CHECK_LAUNCH();
  tail_scatter_kernel<<<grid, kThreads, 0, st>>>(
      As, Bs, N, C, tile_last, rankD, p, r1, unresolved, unres);
  BZ2T_CHECK_LAUNCH();
  return 0;
}

// The loop test (see gate_kernel for the modes); rec: (rec_rows, B + 2)
// int32 or null; cnt: two int32 (entries, rounds) or null; has_cond: set
// the loop graph's handle cond too.
BZ2T_API int bz2t_bwt_gate(int* ctl, const int* unres, int* rec, int* cnt,
                           int B, int N, int thresh, int stage, int rec_rows,
                           int mode, unsigned long long cond, int has_cond,
                           void* stream) {
  if (ctl == nullptr || B < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  gate_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      ctl, unres, rec, cnt, B, N, thresh, stage, rec_rows, mode,
      (cudaGraphConditionalHandle)cond, has_cond);
  BZ2T_CHECK_LAUNCH();
  return 0;
}

// ---------------------------------------------------------------- loop --
//
// One stage's loop as a graph [entry gate] -> WHILE(cond) { round; gate },
// built and instantiated by one call, bz2t_bwt_loop_build, which captures
// the launches of this file's entry points and of bz2t_sort_pairs on a
// capture stream.  The capture runs in C from start to end, so no other
// host thread's work (Python's, say) has to run for it to finish.  A
// device-wide synchronize or free by another thread while it runs
// invalidates it (the call then returns cudaErrorStreamCaptureInvalidated
// and may be made again).  ops/bwt.py keeps the graph with the buffers it
// was built on and launches it at every call that has them.  Launching
// waits for nothing; instantiating a graph with a conditional node and
// destroying one wait for the card, so they are done only when a plan is
// made or dropped.

BZ2T_API int bz2t_sort_pairs(const int* a, const int* b, int* a_out,
                             int* b_out, uint64_t* k0, uint64_t* k1, int rows,
                             int n, int tile, void* stream);

// A private non-blocking stream on the current device, for the captures.
BZ2T_API int bz2t_bwt_capture_stream(void** out) {
  cudaStream_t s;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (e != cudaSuccess) return (int)e;
  *out = s;
  return 0;
}

namespace {

// The round of a loop graph: a full-width round (p null: keys from rank,
// sort, rerank into rank and tied) or a tail round (keys from rankD, p and
// r1, sort, tail rerank into rankD, p, r1 and unresolved).
int launch_round(cudaStream_t st, int* ctl, int* unres, int B, int N,
                 int* rank, int* p, int* r1, const int* n, int* A, int* Bv,
                 int C, int ld, int* sa, int* sb, uint64_t* k0, uint64_t* k1,
                 int sort_n, int sort_tile, int* tiles, unsigned char* flags) {
  int e = bz2t_bwt_keys(rank, p, r1, n, ctl, A, Bv, B, N, C, ld, st);
  if (e == 0) e = bz2t_sort_pairs(A, Bv, sa, sb, k0, k1, B, sort_n,
                                  sort_tile, st);
  if (e != 0) return e;
  if (p == nullptr)
    return bz2t_bwt_rerank(sa, sb, nullptr, n, tiles, rank, flags, unres, 0,
                           B, N, N, sort_n, st);
  return bz2t_bwt_tail_rerank(sa, sb, tiles, rank, p, r1, flags, unres, B,
                              N, C, st);
}

// Ends the capture on st if one is open, and drops what it made.
int abandon(cudaStream_t st, cudaGraph_t g, int e) {
  cudaStreamCaptureStatus status;
  if (cudaStreamIsCapturing(st, &status) == cudaSuccess &&
      status != cudaStreamCaptureStatusNone) {
    cudaGraph_t part;
    if (cudaStreamEndCapture(st, &part) == cudaSuccess && part != g)
      cudaGraphDestroy(part);
  }
  cudaGraphDestroy(g);
  cudaGetLastError();
  return e;
}

}  // namespace

// Builds and instantiates one stage's loop graph on the capture stream
// cap: the gate (entry mode entry_mode) at the entry, then a WHILE node
// whose body is one round (launch_round's arguments) and the gate after a
// round.  The gates count entries and rounds in cnt (two int32).  Writes
// the graph and its executable to *graph, *exec.
BZ2T_API int bz2t_bwt_loop_build(
    void* cap, int* ctl, int* unres, int* rec, int* cnt, int B, int N,
    int thresh, int stage, int rec_rows, int entry_mode, int* rank, int* p,
    int* r1, const int* n, int* A, int* Bv, int C, int ld, int* sa, int* sb,
    uint64_t* k0, uint64_t* k1, int sort_n, int sort_tile, int* tiles,
    unsigned char* flags, void** graph, void** exec) {
  if (entry_mode < 0 || entry_mode > 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)cap;
  cudaGraph_t g;
  cudaError_t ce = cudaGraphCreate(&g, 0);
  if (ce != cudaSuccess) return (int)ce;
  cudaGraphConditionalHandle h;
  ce = cudaGraphConditionalHandleCreate(&h, g, 0, cudaGraphCondAssignDefault);
  if (ce == cudaSuccess)
    ce = cudaStreamBeginCaptureToGraph(st, g, nullptr, nullptr, 0,
                                       cudaStreamCaptureModeRelaxed);
  if (ce != cudaSuccess) return abandon(st, g, (int)ce);
  int e = bz2t_bwt_gate(ctl, unres, rec, cnt, B, N, thresh, stage, rec_rows,
                        entry_mode, h, 1, st);
  cudaGraph_t same;
  ce = cudaStreamEndCapture(st, &same);
  if (e != 0 || ce != cudaSuccess) return abandon(st, g, e ? e : (int)ce);
  constexpr size_t kMaxEntry = 8;
  cudaGraphNode_t entry[kMaxEntry];
  size_t n_entry = kMaxEntry;
  ce = cudaGraphGetNodes(g, entry, &n_entry);
  if (ce != cudaSuccess) return abandon(st, g, (int)ce);
  if (n_entry < 1 || n_entry > kMaxEntry)
    return abandon(st, g, (int)cudaErrorInvalidValue);
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = h;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  cudaGraphNode_t loop;
  ce = cudaGraphAddNode(&loop, g, entry, n_entry, &cp);
  if (ce == cudaSuccess)
    ce = cudaStreamBeginCaptureToGraph(st, cp.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeRelaxed);
  if (ce != cudaSuccess) return abandon(st, g, (int)ce);
  e = launch_round(st, ctl, unres, B, N, rank, p, r1, n, A, Bv, C, ld, sa, sb,
                   k0, k1, sort_n, sort_tile, tiles, flags);
  if (e == 0)
    e = bz2t_bwt_gate(ctl, unres, rec, cnt, B, N, thresh, stage, rec_rows, 2,
                      h, 1, st);
  cudaGraph_t body;
  ce = cudaStreamEndCapture(st, &body);
  if (e != 0 || ce != cudaSuccess) return abandon(st, g, e ? e : (int)ce);
  cudaGraphExec_t ex = nullptr;
  ce = cudaGraphInstantiate(&ex, g, 0);
  if (ce != cudaSuccess) return abandon(st, g, (int)ce);
  *graph = g;
  *exec = ex;
  return 0;
}

BZ2T_API int bz2t_bwt_loop_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

// Waits until the card is idle (the runtime does, to destroy the graph).
BZ2T_API int bz2t_bwt_loop_free(void* exec, void* graph) {
  cudaError_t e = exec ? cudaGraphExecDestroy((cudaGraphExec_t)exec)
                       : cudaSuccess;
  cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
  return (int)(e != cudaSuccess ? e : e2);
}
