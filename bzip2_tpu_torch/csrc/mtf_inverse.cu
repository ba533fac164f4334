// Inverse MTF of every block's symbols, in three kernels.
//
// Replaces the two lax.scans of bzip2_tpu/ops/decode.py:mtf_inverse (the
// chunks' local scans and the compose over their permutations), which have
// no Pallas original; written with torch ops they are some 2,300 steps of
// four ops each a -9 batch, every op a host launch.
//
// The update for a decoded rank r is the cycle (0 1 .. r) on list
// positions: it does not depend on what the list holds.  So each chunk of
// K symbols scans alone from the identity list, and one short sequential
// compose over the chunks' net permutations anchors every chunk to the
// block's initial list.  The rule a symbol s follows (the plain version,
// ops/mtf_inverse_kernel.mtf_inverse_plain): r = clamp(s - 1, 0, 255); its
// value is lst[r] (so RUNA/RUNB read the front); lst[r] moves to the front
// only when 2 <= s <= n_used.  EOB, the pad symbol and garbage past n_mtf
// read a value and leave the list alone, so the result equals a sequential
// MTF of the whole row at every position, at any chunking.
//
//   mtf_local_kernel: one warp per (block, chunk).  The 256-entry list is
//     held 8 bytes a lane (lane L: positions 8L .. 8L+7 in one 64-bit
//     word), as csrc/mtf_ranks.cu's rank kernel holds it.  Per symbol, one
//     shuffle reads lst[r]; when the symbol moves it, every lane below r's
//     lane shifts its 8 bytes up one place, taking the lane below's top
//     byte by __shfl_up_sync, r's lane shifts only the bytes up to r, and
//     lane 0 takes the value in front.  The symbol's index into the chunk's
//     start list is written as a byte; at the end the chunk's list is its
//     net permutation P_c.
//   mtf_compose_kernel: one CTA of 256 threads per block, S in shared
//     memory: C steps of S <- S[P_c].  Step c writes F_c = used_list[S_c]
//     (S_c exclusive), the chunk's start list in byte values.
//   mtf_anchor_kernel: vals[b, i] = F[b, i / K, e[b, i]], elementwise.
//
// What bounds it: its bytes (4 in and 4 out a symbol, 7.2 M symbols in an
// 8-block -9 batch: about 17 us at 3.35 TB/s) are far below its chains.
// Each warp runs K dependent steps of two shuffles (about 1,760 at -9 with
// 512 chunks) and the compose C dependent steps of a shared-memory gather
// and a barrier; the design keeps a step to those and a few ALU ops, and
// fills the card with B x C warps (4,096 for 8 blocks, against 132 SMs).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;            // chunks per CTA of the local scan
constexpr int kPrefetch = 8;         // compose steps whose P_c load ahead

__global__ void __launch_bounds__(kWarps * 32)
mtf_local_kernel(const int* __restrict__ syms, const int* __restrict__ n_used,
                 unsigned char* __restrict__ e_out,
                 unsigned char* __restrict__ perm, int B, int M, int C,
                 int K) {
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)B * C) return;
  const int lane = threadIdx.x & 31;
  const int b = (int)(warp / C), c = (int)(warp % C);
  const int nu = n_used[b];
  // byte k of x: list position 8 * lane + k (identity at the chunk start)
  unsigned long long x = 0x0706050403020100ull +
                         0x0808080808080808ull * (unsigned long long)lane;
  const long long start = (long long)c * K;
  const long long end = min(start + K, (long long)M);
  const int* s = syms + (long long)b * M;
  unsigned char* e = e_out + (long long)b * M;
  for (long long base = start; base < end; base += 32) {
    const long long i = base + lane;
    const int sym = i < end ? s[i] : 0;
    const int n = (int)min(32ll, end - base);
    unsigned mine = 0;
    for (int t = 0; t < n; ++t) {                     // warp-uniform
      const int st = __shfl_sync(kFullMask, sym, t);
      // clamp(s - 1, 0, 255) with int32 wrap-around, as torch computes it
      const int r = min(max((int)((unsigned)st - 1u), 0), 255);
      const int hl = r >> 3, q = r & 7;
      const unsigned word = (unsigned)(q & 4 ? x >> 32 : x);
      const unsigned v =
          (__shfl_sync(kFullMask, word, hl) >> (8 * (q & 3))) & 0xFFu;
      if (lane == t) mine = v;
      if (st >= 2 && st <= nu) {                      // warp-uniform
        unsigned up = __shfl_up_sync(kFullMask, (unsigned)(x >> 56), 1);
        if (lane == 0) up = v;
        const unsigned long long sh = (x << 8) | up;
        const unsigned long long m =
            lane < hl ? ~0ull
            : lane == hl ? (q == 7 ? ~0ull : (1ull << (8 * q + 8)) - 1ull)
                         : 0ull;
        x = (sh & m) | (x & ~m);
      }
    }
    if (i < end) e[i] = (unsigned char)mine;
  }
  reinterpret_cast<unsigned long long*>(
      perm + ((long long)b * C + c) * 256)[lane] = x;
}

__global__ void __launch_bounds__(256)
mtf_compose_kernel(const unsigned char* __restrict__ perm,
                   const int* __restrict__ used_list, int* __restrict__ F,
                   int C) {
  __shared__ int S[2][256];
  __shared__ int U[256];
  const int b = blockIdx.x, j = threadIdx.x;
  U[j] = used_list[b * 256 + j];
  S[0][j] = j;
  int s = j;
  __syncthreads();
  const unsigned char* P = perm + (long long)b * C * 256;
  int* Fb = F + (long long)b * C * 256;
  for (int c0 = 0; c0 < C; c0 += kPrefetch) {
    int p[kPrefetch];
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k)
      p[k] = c0 + k < C ? P[(long long)(c0 + k) * 256 + j] : 0;
#pragma unroll
    for (int k = 0; k < kPrefetch; ++k) {
      const int c = c0 + k;
      if (c >= C) break;                              // block-uniform
      Fb[(long long)c * 256 + j] = U[s];
      s = S[c & 1][p[k]];
      S[(c + 1) & 1][j] = s;
      __syncthreads();
    }
  }
}

__global__ void mtf_anchor_kernel(const unsigned char* __restrict__ e,
                                  const int* __restrict__ F,
                                  int* __restrict__ vals, long long total,
                                  int M, int C, int K) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / M;
    const int k = (int)(i - b * M);
    vals[i] = __ldg(F + ((b * C + k / K) << 8) + e[i]);
  }
}

}  // namespace

// syms: (B, M) int32; used_list: (B, 256) int32; n_used: (B,) int32;
// e: (B, M) uint8 and perm: (B, C, 256) uint8 scratch; F: (B, C, 256)
// int32 scratch; vals: (B, M) int32.  K = ceil(M / C) symbols a chunk.
BZ2T_API int bz2t_mtf_inverse(const int* syms, const int* used_list,
                              const int* n_used, unsigned char* e,
                              unsigned char* perm, int* F, int* vals, int B,
                              int M, int C, void* stream) {
  if (B == 0 || M == 0) return 0;
  const int K = (M + C - 1) / C;
  cudaStream_t st = (cudaStream_t)stream;
  const long long warps = (long long)B * C;
  mtf_local_kernel<<<(unsigned)((warps + kWarps - 1) / kWarps), kWarps * 32,
                     0, st>>>(syms, n_used, e, perm, B, M, C, K);
  BZ2T_CHECK_LAUNCH();
  mtf_compose_kernel<<<B, 256, 0, st>>>(perm, used_list, F, C);
  BZ2T_CHECK_LAUNCH();
  const long long total = (long long)B * M;
  const unsigned blocks = (unsigned)min((total + 255) / 256, 132ll * 16);
  mtf_anchor_kernel<<<blocks, 256, 0, st>>>(e, F, vals, total, M, C, K);
  BZ2T_CHECK_LAUNCH();
  return 0;
}
