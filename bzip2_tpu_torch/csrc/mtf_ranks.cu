// MTF ranks over 256-position tiles, in two kernels with a cummax between.
//
// Replaces the Pallas kernels bzip2_tpu/ops/mtf_pallas.py:_tile_last_kernel
// and :_rank_kernel.  On the TPU both expand each tile into (256, 256)
// one-hot planes in VMEM and reduce them: 256 lanes of vector work per
// position.  Here one warp owns one tile.
//
//   bz2t_mtf_tile_last: the cummax's input, written directly.  For tile t of
//     a row, each symbol's global index of last occurrence in the tile
//     (t * 256 + in-tile index, or -2^30 if absent) goes to slot t + 1 of
//     the row; slot 0 holds the initial list's seeds, symbol j at -(j + 1),
//     written by the row's last tile, whose own occurrences no tile needs.
//     Per 32-position step, __match_any_sync groups the lanes by symbol and
//     only the highest lane of a group stores, so the steps, taken in
//     order, leave each symbol's last occurrence with plain shared stores:
//     no atomics, which long runs of one symbol would serialise.  Bound:
//     4 bytes read and 4 written a position.
//   (glue in PyTorch: lx = cummax over the row's slots, the exclusive
//    carries: each symbol's last occurrence before the tile, or its seed.)
//   bz2t_mtf_rank: the MTF list at a tile's start is the 256 symbols ordered
//     by descending lx.  The warp builds it once, with a bitonic sort of 256
//     packed (lx, symbol) keys held 8 a lane, and keeps it as bytes: lane L
//     holds list positions 8L .. 8L+7 in two words.  A position whose symbol
//     repeats the one before it has rank 0 and changes nothing (58% of a -9
//     text batch's positions): one ballot per 32 positions lists the others
//     and the warp visits only those.  There every lane tests its 8 bytes
//     for the symbol (a zero-byte test on word ^ symbol), a ballot names the
//     hit lane, the lanes below it shift their bytes up one place (taking
//     the previous lane's top byte by __shfl_up_sync), the hit lane shifts
//     only the bytes below the hit, lane 0 takes the symbol in front, and
//     the hit lane writes its rank 8 * lane + byte.  About 45 warp
//     instructions a visited position and no reduction: what bounds it is
//     issued instructions, which depend on the data's share of rank 0, not
//     its 12 bytes of traffic a position.
// Symbols outside 0..255 (pads, id 300) match nothing and get rank 0.
#include "common.cuh"

namespace {

constexpr int kTileLen = 256;
constexpr int kWarps = 4;            // tiles per block: a finished block
                                     // frees its slots sooner than at 8
constexpr int kNeg = -(1 << 30);     // no occurrence in the tile

__global__ void __launch_bounds__(kWarps * 32)
tile_last_kernel(const int* seq, int* out, long long rows, int tiles_per_row) {
  __shared__ int last[kWarps][kTileLen];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * kWarps + w;
  if (tile >= rows) return;
  const int t = (int)(tile % tiles_per_row);
  if (t + 1 == tiles_per_row) {      // the row's seeds into its slot 0
    int* o = out + (tile - t) * kTileLen;
    for (int j = lane; j < kTileLen; j += 32) o[j] = -(j + 1);
    return;
  }
  const int* s = seq + tile * kTileLen;
  int v[kTileLen / 32];
#pragma unroll
  for (int k = 0; k < kTileLen / 32; ++k) v[k] = s[k * 32 + lane];
  int* L = last[w];
  for (int j = lane; j < kTileLen; j += 32) L[j] = kNeg;
  __syncwarp();
  const int base = t * kTileLen;
#pragma unroll
  for (int k = 0; k < kTileLen / 32; ++k) {
    const unsigned peers = __match_any_sync(kFullMask, v[k]);
    if ((peers >> lane) == 1u && (unsigned)v[k] < (unsigned)kTileLen)
      L[v[k]] = base + k * 32 + lane;
    __syncwarp();
  }
  int* o = out + (tile + 1) * kTileLen;
  for (int j = lane; j < kTileLen; j += 32) o[j] = L[j];
}

// Sort the warp's 256 keys (8 a lane, element 8 * lane + q) descending: a
// bitonic sort in which every merge starts by comparing each element with
// its mirror in the run (i ^ (k - 1)), so every compare-exchange puts the
// larger key at the lower index and no step depends on a direction.
__device__ __forceinline__ void warp_sort_desc(unsigned (&key)[8], int lane) {
#pragma unroll
  for (int lk = 1; lk <= 8; ++lk) {
    const int k = 1 << lk;           // merge runs of k / 2 into runs of k
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;         // partner i ^ (k - 1) first, then i ^ j
      const bool mirror = lj == lk - 1;
      if (j >= 8) {                  // partner in another lane
        const int lm = mirror ? (k - 1) >> 3 : j >> 3;
        const bool lower = (lane & (j >> 3)) == 0;
        unsigned o[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          o[q] = __shfl_xor_sync(kFullMask, key[mirror ? 7 - q : q], lm);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          key[q] = lower ? max(key[q], o[q]) : min(key[q], o[q]);
      } else {                       // partner in this lane
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q & j) continue;
          const int p = mirror ? q ^ (k - 1) : q | j;
          const unsigned hi = max(key[q], key[p]), lo = min(key[q], key[p]);
          key[q] = hi;
          key[p] = lo;
        }
      }
    }
  }
}

// 0x80 in the lowest zero byte of x (bytes above it may be flagged too)
__device__ __forceinline__ unsigned zero_byte_flags(unsigned x) {
  return (x - 0x01010101u) & ~x & 0x80808080u;
}

__global__ void __launch_bounds__(kWarps * 32)
rank_kernel(const int* seq, const int* lx, int* out, long long rows) {
  __shared__ int s_seq[kWarps][kTileLen];
  __shared__ int s_out[kWarps][kTileLen];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * kWarps + w;
  if (tile >= rows) return;
  const int* s = seq + tile * kTileLen;
  int* ss = s_seq[w];
  int* so = s_out[w];
  for (int j = lane; j < kTileLen; j += 32) {
    ss[j] = s[j];
    so[j] = 0;
  }
  // keys of symbols 8 * lane + q: (lx + 256) in the high 24 bits (lx is in
  // [-256, 2^24 - 256) and distinct), the symbol in the low 8
  const int4* l4 =
      reinterpret_cast<const int4*>(lx + tile * kTileLen) + 2 * lane;
  const int4 a = l4[0], b = l4[1];
  const int v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned key[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    key[q] = ((unsigned)(v[q] + 256) << 8) | (unsigned)(lane * 8 + q);
  warp_sort_desc(key, lane);
  // byte k of w0 / w1: list position 8 * lane + k / + 4 + k
  unsigned w0 = __byte_perm(__byte_perm(key[0], key[1], 0x0040),
                            __byte_perm(key[2], key[3], 0x0040), 0x5410);
  unsigned w1 = __byte_perm(__byte_perm(key[4], key[5], 0x0040),
                            __byte_perm(key[6], key[7], 0x0040), 0x5410);
  const unsigned front = __shfl_sync(kFullMask, w0, 0) & 0xFFu;
  const unsigned below = (1u << lane) - 1u;       // lanes under this one
  __syncwarp();
  // positions whose rank is surely 0 (a repeat of the symbol before them,
  // or a pad) are left at 0; a ballot per 32 positions lists the others
  unsigned todo[kTileLen / 32];
#pragma unroll
  for (int k = 0; k < kTileLen / 32; ++k) {
    const int i = 32 * k + lane;
    const unsigned c = (unsigned)ss[i];
    const unsigned p = i ? (unsigned)ss[i - 1] : front;
    todo[k] = __ballot_sync(kFullMask, c < (unsigned)kTileLen && c != p);
  }
#pragma unroll
  for (int k = 0; k < kTileLen / 32; ++k) {
    for (unsigned msk = todo[k]; msk; msk &= msk - 1u) {   // warp-uniform
      const int i = 32 * k + __ffs(msk) - 1;
      const unsigned c4 = (unsigned)ss[i] * 0x01010101u;
      const unsigned z0 = zero_byte_flags(w0 ^ c4);
      const unsigned z1 = zero_byte_flags(w1 ^ c4);
      const unsigned hits = __ballot_sync(kFullMask, (z0 | z1) != 0u);
      unsigned up = __shfl_up_sync(kFullMask, w1, 1);
      if (lane == 0) up = c4;                      // byte 3 is the symbol
      const unsigned s0 = __byte_perm(w0, up, 0x2107);
      const unsigned s1 = __funnelshift_l(w0, w1, 8);
      const unsigned long long z = ((unsigned long long)z1 << 32) | z0;
      unsigned long long m = z ^ (z - 1ull);
      if (hits & below) m = 0ull;
      const unsigned m0 = (unsigned)m, m1 = (unsigned)(m >> 32);
      w0 = (s0 & m0) | (w0 & ~m0);
      w1 = (s1 & m1) | (w1 & ~m1);
      if (z != 0ull) so[i] = 8 * lane + (__popcll(m) >> 3) - 1;
    }
  }
  __syncwarp();
  int* o = out + tile * kTileLen;
  for (int j = lane; j < kTileLen; j += 32) o[j] = so[j];
}

}  // namespace

// seq: (rows, 256) int32 symbols, rows = B * tiles_per_row; out: (rows,
// 256) int32, the cummax's input (slot 0 of each row the seeds, slot t + 1
// tile t's global last occurrences).
BZ2T_API int bz2t_mtf_tile_last(const int* seq, int* out, long long rows,
                                int tiles_per_row, void* stream) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  tile_last_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      seq, out, rows, tiles_per_row);
  BZ2T_CHECK_LAUNCH();
  return 0;
}

// seq, lx: (rows, 256) int32, lx 16-byte aligned; out: (rows, 256) int32.
BZ2T_API int bz2t_mtf_rank(const int* seq, const int* lx, int* out,
                           long long rows, void* stream) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  rank_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(seq, lx, out,
                                                                 rows);
  BZ2T_CHECK_LAUNCH();
  return 0;
}
