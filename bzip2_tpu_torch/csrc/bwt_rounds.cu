// The BWT's doubling rounds on the card: a round's keys, its rerank after
// the sort, the tail stages' rerank, the loop test, and the loop itself.
//
// Replaces the lax.while_loops of bzip2_tpu/ops/bwt.py, the full-width
// loop (:260) and each compact tail stage (:323), with the bodies they run
// and their _gapped_rerank (:86) and _scatter_rank (:105); none has a
// Pallas original.  Run as Python loops, each loop test was a host sync.
// Here each stage's loop is one CUDA graph with lax.while_loop's
// semantics: a gate kernel node runs the loop test at the stage's entry
// and sets the graph's conditional handle, then a conditional WHILE node
// runs one round (this file's kernels and sort_pairs.cu's, captured from
// ops/bwt.py's calls on a private stream) until the test fails.  The test
// after a round is not a node of its own: the round's last kernel runs it
// in the CTA that finishes last.  ops/bwt.py captures one such graph a
// stage once for each (stream, N) plan and launches it at every call, with
// no host sync; no round runs past the test.
//
// ctl, the loop's state on the card: ctl[0] the gate (the last loop
// test), ctl[1] k (the prefix length the ranks resolve), ctl[2] the rows
// of the round record written.  In a loop graph the test also counts the
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
//     Two passes: a tile's last class start, then each tile takes the max
//     of the tiles before it as its carry and scans its 4096 entries in
//     shared memory.  In a round it ends with the loop test.
//   * tail rerank: the same on a compact buffer with two running maxes
//     (segment and sub-class starts), written back in place, and the
//     scatter of the new ranks into rankD (dead lanes skip it), in one pass
//     with a decoupled look-back for the carry (below); it ends with the
//     loop test.
//   * gate: k < N && any(unres > thresh), after doubling k when a round ran;
//     it appends (stage, k, unres per row) to the round record and, inside
//     a loop graph, sets the WHILE node's handle.
//
// The tail rerank in one pass (Merrill and Garland, "Single-pass Parallel
// Prefix Scan with Decoupled Look-back", 2016).  A CTA takes its tile from
// a ticket counter, so every tile it waits on took its ticket earlier and
// is running: the look-back cannot deadlock.  Each warp reads its 256
// entries of the sorted pair once, 32 at a time into registers (coalesced),
// and its segment and sub-class starts are ballots: a running max of "a
// start here ? j" is the highest set bit at or below the lane, or the carry.
// The carry across tiles is a max, which is idempotent, and a tile that
// holds a segment start knows its final value at once (no start before it
// can be larger), so it publishes it as final; any other tile publishes its
// aggregate, looks back over its predecessors a warp at a time (32 status
// words a step) until one is final, and then publishes its own final
// value.  Each status word carries the launch's epoch (scratch), which the
// last CTA raises, so a word left by an earlier launch never reads as this
// one's.  The row counts go to a scratch sum a row; the last CTA moves them
// to unres, leaves the sums and tickets at zero for the next launch, and
// runs the loop test.  The stage loops keep rankD[p] == r1 at every live
// entry (a compaction takes r1 from rankD's positions, a round writes both),
// so a live entry whose rank does not change (the first sub-class of its
// segment) is not written again: a random 4-byte write costs a 32-byte
// sector, and the scatter is most of the kernel's time (in the first tail
// round of chip_smoke.py's first -9 batch 41% of the live entries keep
// their rank).  Tiles of 2048 entries and at most 40 registers a thread
// (six CTAs an SM) keep that round's 832 CTAs close to one wave.
// What bounds it: device-memory traffic.  A full-width round reads rank
// twice (4 B at i and 4 B at (i + k) mod n, both runs of consecutive
// positions), writes the pair (8 B), reads the sorted pair twice (16 B)
// and scatters rank and the tied flag to random positions (a 32-byte
// sector each); a tail round reads its sorted pair once, writes p, r1 and
// the flag, and scatters a live entry's new rank into rankD where it
// changes (a sector each).
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
constexpr int kTailTile = 2048;                 // compact entries a CTA
constexpr int kTailCtas = 6;                    // tail CTAs an SM, at least
constexpr int kSpan = kTailTile / kWarps;       // a tail warp's entries
constexpr int kSteps = kSpan / 32;              // ... 32 at a time
// the tail rerank's scratch after its status words: the tile tickets, the
// CTAs done, the launch epoch, a spare word, then a sum a row
constexpr int kTicket = 0, kDone = 1, kEpoch = 2, kCtrl = 4;
// a tail tile's status word: epoch (20 bits) | flag (2) | seg + 1 (21) |
// sub + 1 (21); flag 0: not written in this launch
constexpr unsigned kAggregate = 1, kFinal = 2, kEpochMask = 0xFFFFF;

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

// ----------------------------------------------------------- loop test --

// What the loop test needs besides unres: ctl (null: no test), the round
// record (rec_rows rows of B + 2 int32, or null), the stage's entry and
// round counts (cnt, two int32, or null) and the loop graph's handle.
struct LoopTest {
  int* ctl;
  int* rec;
  int* cnt;
  int thresh, stage, rec_rows, has_cond;
  cudaGraphConditionalHandle cond;
};

// The loop test, run by every thread of one CTA.  mode 0: the test at a
// stage's entry; 1: the same, after appending (stage, k, unres) to the
// record (the initial ranks); 2: after a round: k *= 2, append to the
// record, then the test.  With has_cond the result also goes to the loop
// graph's handle; with cnt, the call adds one to cnt[0] (an entry) or
// cnt[1] (a round).  unres is read from L2: in a round's last CTA the
// other CTAs added to it with atomics.
__device__ void loop_test(const LoopTest& t, const int* unres, int B, int N,
                          int mode) {
  __shared__ int s_any;
  int* ctl = t.ctl;
  const int k = mode == 2 ? (int)((unsigned)ctl[kK] * 2u) : ctl[kK];
  const int row = ctl[kRows];
  const bool keep = mode != 0 && t.rec != nullptr && row < t.rec_rows;
  int* out = t.rec + (long long)row * (B + 2);
  if (threadIdx.x == 0) s_any = 0;
  __syncthreads();
  int any = 0;
  for (int b = threadIdx.x; b < B; b += kThreads) {
    const int u = __ldcg(unres + b);
    any |= u > t.thresh;
    if (keep) out[2 + b] = u;
  }
  if (__any_sync(kFullMask, any) && (threadIdx.x & 31) == 0) s_any = 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    if (keep) {
      out[0] = t.stage;
      out[1] = k;
      ctl[kRows] = row + 1;
    }
    const int go = k < N && s_any;
    ctl[kK] = k;
    ctl[kGate] = go;
    if (t.has_cond) cudaGraphSetConditional(t.cond, go ? 1u : 0u);
    if (t.cnt != nullptr) t.cnt[mode == 2 ? 1 : 0] += 1;
  }
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
// index), scattered with the tie flag to the entry's position.  With a
// test (test.ctl set), the CTA that finishes last runs the loop test after
// the round (done: the CTAs done, zero before and after a launch).
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
    rerank_scatter_kernel(const void* ka, const void* kb,
                          const long long* __restrict__ order, int ld, int S,
                          int N, const int* __restrict__ nv,
                          const int* __restrict__ tile_last,
                          int* __restrict__ rank,
                          unsigned char* __restrict__ tied,
                          int* __restrict__ unres, int* done,
                          LoopTest test) {
  __shared__ unsigned char s_flag[kTile + 1];
  __shared__ int s_start[kTile];
  __shared__ int s_red[kWarps];
  __shared__ int s_last;
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
  if (threadIdx.x == 0) {
    if (cnt) atomicAdd(unres + b, cnt);
    if (test.ctl != nullptr) {
      __threadfence();
      s_last = atomicAdd(done, 1) == (int)(gridDim.x * gridDim.y) - 1;
    }
  }
  if (test.ctl == nullptr) return;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) *done = 0;
  loop_test(test, unres, (int)gridDim.y, N, 2);
}

// --------------------------------------------------------- tail rerank --

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long tile_status(unsigned epoch,
                                                          unsigned flag,
                                                          int seg, int sub) {
  return ((unsigned long long)(epoch & kEpochMask) << 44) |
         ((unsigned long long)flag << 42) |
         ((unsigned long long)(seg + 1) << 21) | (unsigned long long)(sub + 1);
}

// The highest index of a set bit of m at or below lane (offset j0), else
// carry.
__device__ __forceinline__ int last_start(unsigned m, int lane, int j0,
                                          int carry) {
  const unsigned upto = m & (kFullMask >> (31 - lane));
  return upto ? j0 + 31 - __clz(upto) : carry;
}

// One tail round's rerank after its sort: new ranks r1 + (sub-class start
// - segment start), the unresolved flags and positions written back to
// the compact buffer in place, the new ranks scattered into rankD where
// they change, the per-row counts into unres, and (test.ctl set) the loop
// test.  Grid: B * tiles CTAs, a tile each by ticket.  status: a word
// a tile; ctrl: the tickets, CTAs done, epoch; sums: a count a row.
__global__ void __launch_bounds__(kThreads, kTailCtas)
    tail_rerank_kernel(const int* __restrict__ As, const int* __restrict__ Bs,
                       int B, int N, int C, int tiles,
                       unsigned long long* status, int* ctrl, int* sums,
                       int* __restrict__ rankD, int* __restrict__ p,
                       int* __restrict__ r1,
                       unsigned char* __restrict__ unresolved,
                       int* __restrict__ unres, LoopTest test) {
  __shared__ unsigned s_seg[kWarps][kSteps], s_sub[kWarps][kSteps];
  __shared__ int s_wseg[kWarps], s_wsub[kWarps];
  __shared__ int s_red[kWarps];
  __shared__ int s_id, s_cseg, s_csub, s_last;
  __shared__ unsigned s_epoch, s_after;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_id = atomicAdd(ctrl + kTicket, 1);
    s_epoch = (unsigned)__ldcg(ctrl + kEpoch);
  }
  __syncthreads();
  const unsigned epoch = s_epoch;
  const int b = s_id / tiles, t = s_id - b * tiles;
  const long long row = (long long)b * C;
  const int* a = As + row;
  const int* bb = Bs + row;
  const int base = t * kTailTile;
  const int wbase = base + w * kSpan;

  // pass 1: the warp's entries in registers, their start flags as ballots
  int va[kSteps], vb[kSteps];
#pragma unroll
  for (int r = 0; r < kSteps; ++r) {
    const int j = wbase + r * 32 + lane;
    va[r] = j < C ? a[j] : kInf;
    vb[r] = j < C ? bb[j] : 0;
  }
  int pa = 0, pb = 0;                 // the entry before the warp's first
  if (wbase >= 1 && wbase <= C) {
    pa = a[wbase - 1];
    pb = bb[wbase - 1];
  }
  int wseg = -1, wsub = -1;
#pragma unroll
  for (int r = 0; r < kSteps; ++r) {
    const int j0 = wbase + r * 32, j = j0 + lane;
    int xa = __shfl_up_sync(kFullMask, va[r], 1);
    int xb = __shfl_up_sync(kFullMask, vb[r], 1);
    if (lane == 0) {
      xa = pa;
      xb = pb;
    }
    pa = __shfl_sync(kFullMask, va[r], 31);
    pb = __shfl_sync(kFullMask, vb[r], 31);
    bool seg = true, sub = true;      // past C and at 0 a class starts
    if (j < C && j > 0) {
      seg = (va[r] >> 11) != (xa >> 11);
      sub = seg || va[r] != xa || (vb[r] >> 20) != (xb >> 20);
    }
    const unsigned ms = __ballot_sync(kFullMask, seg);
    const unsigned mu = __ballot_sync(kFullMask, sub);
    if (lane == 0) {
      s_seg[w][r] = ms;
      s_sub[w][r] = mu;
    }
    if (ms) wseg = j0 + 31 - __clz(ms);
    if (mu) wsub = j0 + 31 - __clz(mu);
  }
  if (lane == 0) {
    s_wseg[w] = wseg;
    s_wsub[w] = wsub;
  }
  if (threadIdx.x == kThreads - 1) {  // the entry after the tile
    const int j = base + kTailTile;
    s_after = j >= C || a[j] != va[kSteps - 1] ||
              (bb[j] >> 20) != (vb[kSteps - 1] >> 20);
  }
  __syncthreads();

  // the tile's carry: the max of the earlier tiles' last starts
  if (w == 0) {
    int aseg = -1, asub = -1;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      aseg = max(aseg, s_wseg[i]);
      asub = max(asub, s_wsub[i]);
    }
    unsigned long long* st = status + (long long)b * tiles;
    // a segment start in the tile: its sub-class start is one too, and no
    // start before the tile is larger, so both values are final
    if (lane == 0)
      store_release(st + t,
                    tile_status(epoch, aseg >= 0 ? kFinal : kAggregate, aseg,
                                asub));
    int cseg = -1, csub = -1;
    for (int top = t; top > 0; top -= 32) {
      const int i = top - 1 - lane;
      int vseg = -1, vsub = -1;
      bool stop = true;
      if (i >= 0) {
        unsigned long long v;
        do {
          v = load_acquire(st + i);
        } while ((unsigned)(v >> 44) != (epoch & kEpochMask) ||
                 ((v >> 42) & 3) == 0);
        vseg = (int)((v >> 21) & 0x1FFFFF) - 1;
        vsub = (int)(v & 0x1FFFFF) - 1;
        stop = ((v >> 42) & 3) == kFinal || vseg >= 0;
      }
      // fold the predecessors up to the nearest final one
      const unsigned sm = __ballot_sync(kFullMask, stop);
      const int upto = sm ? __ffs(sm) - 1 : 31;
      if (lane <= upto) {
        cseg = max(cseg, vseg);
        csub = max(csub, vsub);
      }
      if (sm) break;
    }
    cseg = __reduce_max_sync(kFullMask, cseg);
    csub = __reduce_max_sync(kFullMask, csub);
    if (lane == 0) {
      if (aseg < 0)
        store_release(st + t, tile_status(epoch, kFinal, cseg,
                                          max(csub, asub)));
      s_cseg = cseg;
      s_csub = csub;
    }
  }
  __syncthreads();

  // pass 2: each entry's segment and sub-class start, its new rank and
  // flag, written in place and scattered
  int seg = s_cseg, sub = s_csub;
  for (int i = 0; i < w; ++i) {
    seg = max(seg, s_wseg[i]);
    sub = max(sub, s_wsub[i]);
  }
  int* rd = rankD + (long long)b * (N + 1);
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < kSteps; ++r) {
    const int j0 = wbase + r * 32, j = j0 + lane;
    const unsigned ms = s_seg[w][r], mu = s_sub[w][r];
    // the next entry's sub-class flag: the next lane's, or the first of
    // the next 32
    const unsigned nb = r + 1 < kSteps ? s_sub[w][r + 1]
                        : w + 1 < kWarps ? s_sub[w + 1][0]
                                         : s_after;
    const unsigned nxt = (mu >> 1) | ((nb & 1u) << 31);
    if (j < C) {
      const int aj = va[r];
      const bool live = aj != kInf;
      const int nr = (aj >> 11) + (last_start(mu, lane, j0, sub) -
                                   last_start(ms, lane, j0, seg));
      const bool un = !((mu >> lane) & (nxt >> lane) & 1u) && live;
      const int pos = vb[r] & kP20;
      p[row + j] = live ? pos : -1;
      r1[row + j] = live ? nr : kInf;
      unresolved[row + j] = un;
      // rankD holds r1 at a live entry's position already: only a rank
      // that changes is written
      if (live && nr != (aj >> 11)) rd[pos] = nr;
      cnt += un;
    }
    if (ms) seg = j0 + 31 - __clz(ms);
    if (mu) sub = j0 + 31 - __clz(mu);
  }
  cnt = block_sum(cnt, s_red);
  if (threadIdx.x == 0) {
    if (cnt) atomicAdd(sums + b, cnt);
    __threadfence();
    s_last = atomicAdd(ctrl + kDone, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // the last CTA: every other one is done
  __threadfence();
  for (int i = threadIdx.x; i < B; i += kThreads)
    unres[i] = atomicExch(sums + i, 0);
  if (threadIdx.x == 0) {
    ctrl[kTicket] = 0;
    ctrl[kDone] = 0;
    ctrl[kEpoch] = (int)(epoch + 1);
  }
  if (test.ctl != nullptr) {
    __syncthreads();
    loop_test(test, unres, B, N, 2);
  }
}

// ---------------------------------------------------------------- gate --

__global__ void __launch_bounds__(kThreads)
    gate_kernel(LoopTest test, const int* __restrict__ unres, int B, int N,
                int mode) {
  loop_test(test, unres, B, N, mode);
}

unsigned key_ctas(int width) {
  const int ctas = (width + kThreads - 1) / kThreads;
  return (unsigned)(ctas < kKeyCtas ? ctas : kKeyCtas);
}

LoopTest loop_test_args(int* ctl, int* rec, int* cnt, int thresh, int stage,
                        int rec_rows, unsigned long long cond, int has_cond) {
  LoopTest t;
  t.ctl = ctl;
  t.rec = rec;
  t.cnt = cnt;
  t.thresh = thresh;
  t.stage = stage;
  t.rec_rows = rec_rows;
  t.has_cond = has_cond;
  t.cond = (cudaGraphConditionalHandle)cond;
  return t;
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
// int32; scratch: B * ceil(S / 4096) + 1 int32, its last word zero.  With
// ctl (the loop test after a round: rec, cnt, thresh, stage, rec_rows,
// cond and has_cond as for bz2t_bwt_gate), the CTA that finishes last runs
// it.
BZ2T_API int bz2t_bwt_rerank(const void* ka, const void* kb,
                             const long long* order, const int* n,
                             int* scratch, int* rank, unsigned char* tied,
                             int* unres, int wide, int B, int N, int S,
                             int ld, int* ctl, int* rec, int* cnt, int thresh,
                             int stage, int rec_rows, unsigned long long cond,
                             int has_cond, void* stream) {
  if (B < 1 || S < 1 || S > N || ld < S || (wide && order == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((unsigned)((S + kTile - 1) / kTile), (unsigned)B);
  int* done = scratch + (long long)grid.x * B;
  const LoopTest test = loop_test_args(ctl, rec, cnt, thresh, stage,
                                       rec_rows, cond, has_cond);
  if (wide) {
    rerank_scan_kernel<true><<<grid, kThreads, 0, st>>>(ka, kb, ld, S,
                                                         scratch, unres);
    BZ2T_CHECK_LAUNCH();
    rerank_scatter_kernel<true><<<grid, kThreads, 0, st>>>(
        ka, kb, order, ld, S, N, n, scratch, rank, tied, unres, done, test);
  } else {
    rerank_scan_kernel<false><<<grid, kThreads, 0, st>>>(ka, kb, ld, S,
                                                          scratch, unres);
    BZ2T_CHECK_LAUNCH();
    rerank_scatter_kernel<false><<<grid, kThreads, 0, st>>>(
        ka, kb, nullptr, ld, S, N, n, scratch, rank, tied, unres, done, test);
  }
  BZ2T_CHECK_LAUNCH();
  return 0;
}

// A tail round's rerank from its sorted (As, Bs) (B, C): p, r1 (B, C)
// int32 and unresolved (B, C) bool in place, rankD (B, N + 1) at the live
// positions, unres (B,); scratch: 2 * B * ceil(C / 2048) + 4 + B int32,
// zero before the first launch (each launch leaves it ready for the
// next).  With ctl, the loop test after the round (as bz2t_bwt_rerank).
BZ2T_API int bz2t_bwt_tail_rerank(const int* As, const int* Bs,
                                  int* scratch, int* rankD, int* p, int* r1,
                                  unsigned char* unresolved, int* unres,
                                  int B, int N, int C, int* ctl, int* rec,
                                  int* cnt, int thresh, int stage,
                                  int rec_rows, unsigned long long cond,
                                  int has_cond, void* stream) {
  if (B < 1 || C < 1 || N < 1 || C > (1 << 20) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const int tiles = (C + kTailTile - 1) / kTailTile;
  const long long words = (long long)B * tiles;
  int* ctrl = scratch + 2 * words;
  tail_rerank_kernel<<<(unsigned)words, kThreads, 0, (cudaStream_t)stream>>>(
      As, Bs, B, N, C, tiles, (unsigned long long*)scratch, ctrl,
      ctrl + kCtrl, rankD, p, r1, unresolved, unres,
      loop_test_args(ctl, rec, cnt, thresh, stage, rec_rows, cond,
                     has_cond));
  BZ2T_CHECK_LAUNCH();
  return 0;
}

// The loop test (see loop_test for the modes); rec: (rec_rows, B + 2)
// int32 or null; cnt: two int32 (entries, rounds) or null; has_cond: set
// the loop graph's handle cond too.
BZ2T_API int bz2t_bwt_gate(int* ctl, const int* unres, int* rec, int* cnt,
                           int B, int N, int thresh, int stage, int rec_rows,
                           int mode, unsigned long long cond, int has_cond,
                           void* stream) {
  if (ctl == nullptr || B < 1 || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  gate_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      loop_test_args(ctl, rec, cnt, thresh, stage, rec_rows, cond, has_cond),
      unres, B, N, mode);
  BZ2T_CHECK_LAUNCH();
  return 0;
}

// ---------------------------------------------------------------- loop --
//
// One stage's loop as a graph [entry gate] -> WHILE(cond) { round }, the
// round ending in the loop test, built and instantiated by one call,
// bz2t_bwt_loop_build, which captures the launches of this file's entry
// points and of bz2t_sort_pairs on a capture stream.  The capture runs in C
// from start to end, so no other host thread's work (Python's, say) has to
// run for it to finish.  A device-wide synchronize or free by another
// thread while it runs invalidates it (the call then returns
// cudaErrorStreamCaptureInvalidated and may be made again).  ops/bwt.py
// keeps the graph with the buffers it was built on and launches it at
// every call that has them.  Launching waits for nothing; instantiating a
// graph with a conditional node and destroying one wait for the card, so
// they are done only when a plan is made or dropped.

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
// r1, sort, tail rerank into rankD, p, r1 and unresolved); the rerank ends
// with the loop test, which sets the handle h.
int launch_round(cudaStream_t st, int* ctl, int* unres, int* rec, int* cnt,
                 int B, int N, int thresh, int stage, int rec_rows,
                 cudaGraphConditionalHandle h, int* rank, int* p, int* r1,
                 const int* n, int* A, int* Bv, int C, int ld, int* sa,
                 int* sb, uint64_t* k0, uint64_t* k1, int sort_n,
                 int sort_tile, int* scratch, unsigned char* flags) {
  int e = bz2t_bwt_keys(rank, p, r1, n, ctl, A, Bv, B, N, C, ld, st);
  if (e == 0) e = bz2t_sort_pairs(A, Bv, sa, sb, k0, k1, B, sort_n,
                                  sort_tile, st);
  if (e != 0) return e;
  const unsigned long long cond = (unsigned long long)h;
  if (p == nullptr)
    return bz2t_bwt_rerank(sa, sb, nullptr, n, scratch, rank, flags, unres,
                           0, B, N, N, sort_n, ctl, rec, cnt, thresh, stage,
                           rec_rows, cond, 1, st);
  return bz2t_bwt_tail_rerank(sa, sb, scratch, rank, p, r1, flags, unres, B,
                              N, C, ctl, rec, cnt, thresh, stage, rec_rows,
                              cond, 1, st);
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
// whose body is one round (launch_round's arguments) ending in the loop
// test.  The entry gate counts the entries in cnt[0], the round's last
// kernel the rounds in cnt[1].  Writes the graph and its executable to
// *graph, *exec.
BZ2T_API int bz2t_bwt_loop_build(
    void* cap, int* ctl, int* unres, int* rec, int* cnt, int B, int N,
    int thresh, int stage, int rec_rows, int entry_mode, int* rank, int* p,
    int* r1, const int* n, int* A, int* Bv, int C, int ld, int* sa, int* sb,
    uint64_t* k0, uint64_t* k1, int sort_n, int sort_tile, int* scratch,
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
  e = launch_round(st, ctl, unres, rec, cnt, B, N, thresh, stage, rec_rows, h,
                   rank, p, r1, n, A, Bv, C, ld, sa, sb, k0, k1, sort_n,
                   sort_tile, scratch, flags);
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
