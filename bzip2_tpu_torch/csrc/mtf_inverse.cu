// Inverse MTF of every block's symbols, in four launches.
//
// Replaces the two lax.scans of bzip2_tpu/ops/decode.py:mtf_inverse (the
// chunks' local scans and the compose over their permutations), which have
// no Pallas original; written with torch ops they are some 2,300 steps of
// four ops each a -9 batch, every op a host launch.
//
// The update for a decoded rank r is the cycle (0 1 .. r) on list
// positions: it does not depend on what the list holds.  So each chunk of
// K symbols scans alone from the identity list, and a compose over the
// chunks' net permutations anchors every chunk to the block's initial
// list.  The rule a symbol s follows (the plain version,
// ops/mtf_inverse_kernel.mtf_inverse_plain): r = clamp(s - 1, 0, 255); its
// value is lst[r] (so RUNA/RUNB read the front); lst[r] moves to the front
// only when 2 <= s <= n_used.  EOB, the pad symbol and garbage past n_mtf
// read a value and leave the list alone, so the result equals a sequential
// MTF of the whole row at every position, at any chunking.
//
//   mtf_local_kernel: one warp per (block, chunk).  The 256-entry list is
//     held 8 bytes a lane, as two 32-bit halves (lane L: positions
//     8L .. 8L+3 in lo, 8L+4 .. 8L+7 in hi).  Per 32 symbols the warp
//     ballots the movers (2 <= s <= n_used), queues them in order in shared
//     memory with what each step needs computed by its own lane (the lane
//     holding r, the half's mask, the byte selector, 4 r + 4), and steps
//     only on them, the next entry loaded one step ahead: a mover reads
//     lst[r] with one shuffle, every lane takes the top byte of the lane
//     below (__shfl_up_sync; lane 0 the value) and shifts its bytes at or
//     below r up one with a byte permute (PRMT) a half, the selector masked
//     to the bytes that move by one LOP3.  Non-movers leave the list alone:
//     RUNA/RUNB (r = 0) read the front, the value the last mover before
//     them left there, so when every non-mover of the 32 has r = 0 (all but
//     a few in 10,000 on real data) the loop does nothing between movers,
//     each mover's value goes to shared memory and after the loop every
//     lane takes its own or the last one's before it.  Otherwise each
//     stretch of non-movers between two movers reads its lst[r] with one
//     parallel read (two shuffles).  The symbol's index into the chunk's
//     start list is written as a byte; at the end the chunk's list is its
//     net permutation P_c.
//   mtf_compose_kernel, twice: the chunks in super-chunks of W, one CTA of
//     256 threads each (grid NS x B), S in shared memory, W steps of
//     S <- S[P_c] in parallel over the super-chunks; each P_c is replaced
//     in place by its prefix within the super-chunk and the net Q_s is
//     written.  Then one CTA per block composes the NS nets the same way,
//     replacing each Q_s by the super-chunk's start state G_s.  The chain
//     is W + NS steps, about 2 sqrt(C), not C.
//   mtf_anchor_kernel: a CTA per (chunk, block) builds the chunk's start
//     list used_list[b, G_s[P_c]] in shared memory and maps its symbols'
//     indices through it, four a thread.
//
// What bounds it: its bytes (4 in and 4 out a symbol, 4.5 M symbols in an
// 8-block -9 batch: about 11 us at 3.35 TB/s) are far below its issued
// instructions.  Integer ALU ops issue at two warp instructions a clock an
// SM, half the SM's issue rate (chip_smoke.py's rate probe), so the design
// counts them: 9 a mover in the compiled loop (beside two shuffles, a
// shared store and load and two IMADs), and none on the symbols that do
// not move the list.  ops/mtf_inverse_kernel.chunks_for picks the chunk
// count so that B x C warps fill the card's warp slots for small batches
// too.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;            // chunks per CTA of the local scan
constexpr int kPrefetch = 8;         // compose steps whose P_c load ahead

// lst[r] for each lane's own r: two shuffles of the lane holding it
__device__ __forceinline__ unsigned list_at(unsigned lo, unsigned hi, int r) {
  const unsigned wl = __shfl_sync(kFullMask, lo, r >> 3);
  const unsigned wh = __shfl_sync(kFullMask, hi, r >> 3);
  return __byte_perm(r & 4 ? wh : wl, 0u, (unsigned)(r & 3));
}

// a half's bytes moved up one where the nibbles of m are set: a byte
// permute (of x, with y's top byte below it) whose selector is 0x3210
// (unmoved) or 0x2107 (moved) nibble by nibble, c ^ (a & b) in one LOP3
// with the constants held in registers; PTX's prmt directly, since every
// nibble is below 8 (__byte_perm would mask each nibble to 3 bits first)
__device__ __forceinline__ unsigned move_up(unsigned x, unsigned y,
                                           unsigned m, unsigned k1317,
                                           unsigned k3210) {
  unsigned sel, d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;" : "=r"(sel) : "r"(m), "r"(k1317),
      "r"(k3210));
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(y), "r"(sel));
  return d;
}

// byte permute by PTX's prmt, whose selector's bits above 15 are ignored
__device__ __forceinline__ unsigned prmt(unsigned x, unsigned y, unsigned s) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(y), "r"(s));
  return d;
}

__global__ void __launch_bounds__(kWarps * 32)
mtf_local_kernel(const int* __restrict__ syms, const int* __restrict__ n_used,
                 unsigned char* __restrict__ e_out,
                 unsigned char* __restrict__ perm, int B, int M, int C,
                 int K) {
  // each warp's movers of its current 32 symbols in order, precomputed:
  // (the lane holding r, the half's mask, the byte selector | t << 16,
  // 4 r + 4); one entry past the last, read ahead and not used
  __shared__ int4 queue[kWarps][33];
  __shared__ unsigned moved[kWarps][32];       // each mover's value
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)B * C) return;
  const int lane = threadIdx.x & 31;
  int4* q = queue[threadIdx.x >> 5];
  unsigned* vq = moved[threadIdx.x >> 5];
  const int b = (int)(warp / C), c = (int)(warp % C);
  const int nu = n_used[b];
  // byte k of lo (hi): list position 8 lane + k (+ 4), identity at the start
  unsigned lo = 0x03020100u + 0x08080808u * (unsigned)lane;
  unsigned hi = lo + 0x04040404u;
  const int lane32 = 32 * lane;
  unsigned k1317 = 0x1317u, k3210 = 0x3210u;
  asm("" : "+r"(k1317), "+r"(k3210));          // keep them in registers
  const long long start = (long long)c * K;
  const long long end = min(start + K, (long long)M);
  const int* s = syms + (long long)b * M;
  unsigned char* e = e_out + (long long)b * M;
  int next = start + lane < end ? s[start + lane] : 0;
  unsigned front = 0;                  // lst[0] (its low byte)
  for (long long base = start; base < end; base += 32) {
    const long long i = base + lane;
    const int sym = next;
    next = i + 32 < end ? s[i + 32] : 0;
    // clamp(s - 1, 0, 255) with int32 wrap-around, as torch computes it
    const int r = min(max((int)((unsigned)sym - 1u), 0), 255);
    const int n = (int)min(32ll, end - base);
    const bool mover = lane < n && sym >= 2 && sym <= nu;
    const unsigned movers = __ballot_sync(kFullMask, mover);
    // a non-mover with r = 0 (RUNA, RUNB) reads the front, the value the
    // last mover before it put there; others need a read of the list
    const bool far = __any_sync(kFullMask, !mover && lane < n && r != 0);
    const int rank = __popc(movers & ((1u << lane) - 1u));
    if (mover)
      q[rank] = make_int4(r >> 3, r & 4 ? -1 : 0, (r & 3) | lane << 16,
                          4 * r + 4);
    __syncwarp();
    const int nm = __popc(movers);
    unsigned mine = 0;
    int first = 0;                     // far: the first lane of a stretch
    int4 cur = q[0];
    for (int j = 0; j < nm; ++j) {     // warp-uniform
      const int4 mv = cur;
      cur = q[j + 1];                  // the next mover, off the chain
      if (far) {                       // non-movers before t: one read
        const int t = mv.z >> 16;
        if (t > first) {
          const unsigned val = list_at(lo, hi, r);
          if (lane >= first) mine = val;
        }
        first = t + 1;
      }
      const unsigned w = __shfl_sync(
          kFullMask, (lo & ~(unsigned)mv.y) | (hi & (unsigned)mv.y), mv.x);
      const unsigned v = prmt(w, 0u, (unsigned)mv.z);
      vq[j] = v;
      // positions 0 .. r move up one, v to the front: nibble k of m is set
      // where byte k of this lane's 8 moves
      unsigned up = __shfl_up_sync(kFullMask, hi, 1);
      if (lane == 0) up = v << 24;
      const unsigned m =
          __funnelshift_lc(0xFFFFFFFFu, 0u, max(mv.w - lane32, 0));
      const unsigned nhi = move_up(hi, lo, m >> 16, k1317, k3210);
      lo = move_up(lo, up, m, k1317, k3210);
      hi = nhi;
    }
    __syncwarp();
    if (!far) {
      mine = mover ? vq[rank] : rank > 0 ? vq[rank - 1] : front;
    } else {
      if (mover) mine = vq[rank];
      if (first < n) {                 // the non-movers after the last
        const unsigned val = list_at(lo, hi, r);
        if (lane >= first) mine = val;
      }
    }
    if (nm > 0) front = vq[nm - 1];
    if (i < end) e[i] = (unsigned char)mine;
    __syncwarp();                      // q and vq are read; the next tile
  }                                    // writes them
  reinterpret_cast<uint2*>(perm + ((long long)b * C + c) * 256)[lane] =
      make_uint2(lo, hi);
}

// For block blockIdx.y, super-chunk blockIdx.x: the n permutations
// P[b, sW .. sW + W) of P (B, n, 256) composed in order from the identity,
// each replaced in place by the state before it (S_c, with S_{c+1} =
// S_c[P_c]); the state after the last goes to net[b, s] when net is given.
__global__ void __launch_bounds__(256)
mtf_compose_kernel(unsigned char* __restrict__ P,
                   unsigned char* __restrict__ net, int n, int W) {
  __shared__ int S[2][256];
  const int b = blockIdx.y, j = threadIdx.x;
  const int c0 = blockIdx.x * W, c1 = min(c0 + W, n);
  unsigned char* Pb = P + (long long)b * n * 256;
  int s = j;
  S[0][j] = j;
  __syncthreads();
  for (int k0 = c0; k0 < c1; k0 += kPrefetch) {
    int p[kPrefetch];
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k)
      p[k] = k0 + k < c1 ? Pb[(long long)(k0 + k) * 256 + j] : 0;
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int c = k0 + k;
      if (c >= c1) break;                             // block-uniform
      Pb[(long long)c * 256 + j] = (unsigned char)s;  // only j reads it
      s = S[(c - c0) & 1][p[k]];
      S[(c - c0 + 1) & 1][j] = s;
      __syncthreads();
    }
  }
  if (net != nullptr)
    net[((long long)b * gridDim.x + blockIdx.x) * 256 + j] = (unsigned char)s;
}

// vals[b, cK .. cK + K) = T[e] with T = used_list[b, G_s[P_c]], the
// chunk's start list in byte values, built once in shared memory
__global__ void __launch_bounds__(256)
mtf_anchor_kernel(const unsigned char* __restrict__ e,
                  const unsigned char* __restrict__ P,
                  const unsigned char* __restrict__ Q,
                  const int* __restrict__ U, int* __restrict__ vals, int M,
                  int C, int K, int W, int NS) {
  __shared__ int T[256];
  const int c = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const int sl = P[((long long)b * C + c) * 256 + j];
  T[j] = U[b * 256 + Q[((long long)b * NS + c / W) * 256 + sl]];
  __syncthreads();
  const long long row = (long long)b * M;
  const long long start = row + (long long)c * K;
  const long long end = row + min((long long)c * K + K, (long long)M);
  // four symbols a thread, from a 4-aligned index: one load, one store
  for (long long i = (start & ~3ll) + 4 * j; i < end; i += 4 * 256) {
    if (i >= start && i + 3 < end) {
      const uchar4 x = *reinterpret_cast<const uchar4*>(e + i);
      *reinterpret_cast<int4*>(vals + i) =
          make_int4(T[x.x], T[x.y], T[x.z], T[x.w]);
    } else {
      for (long long k = max(i, start); k < min(i + 4, end); ++k)
        vals[k] = T[e[k]];
    }
  }
}

}  // namespace

// syms: (B, M) int32; used_list: (B, 256) int32; n_used: (B,) int32;
// e: (B, M) uint8, perm: (B, C, 256) uint8 and q: (B, ceil(C / W), 256)
// uint8 scratch; vals: (B, M) int32, 16-byte aligned.  K = ceil(M / C)
// symbols a chunk, W chunks a super-chunk.
BZ2T_API int bz2t_mtf_inverse(const int* syms, const int* used_list,
                              const int* n_used, unsigned char* e,
                              unsigned char* perm, unsigned char* q,
                              int* vals, int B, int M, int C, int W,
                              void* stream) {
  if (B == 0 || M == 0) return 0;
  if (C < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int K = (M + C - 1) / C;
  const int NS = (C + W - 1) / W;
  cudaStream_t st = (cudaStream_t)stream;
  const long long warps = (long long)B * C;
  mtf_local_kernel<<<(unsigned)((warps + kWarps - 1) / kWarps), kWarps * 32,
                     0, st>>>(syms, n_used, e, perm, B, M, C, K);
  BZ2T_CHECK_LAUNCH();
  mtf_compose_kernel<<<dim3(NS, B), 256, 0, st>>>(perm, q, C, W);
  BZ2T_CHECK_LAUNCH();
  mtf_compose_kernel<<<dim3(1, B), 256, 0, st>>>(q, nullptr, NS, NS);
  BZ2T_CHECK_LAUNCH();
  mtf_anchor_kernel<<<dim3(C, B), 256, 0, st>>>(e, perm, q, used_list, vals,
                                                M, C, K, W, NS);
  BZ2T_CHECK_LAUNCH();
  return 0;
}
