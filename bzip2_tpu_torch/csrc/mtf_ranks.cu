// MTF ranks over 256-position tiles, in two kernels with a cummax between.
//
// Replaces the Pallas kernels bzip2_tpu/ops/mtf_pallas.py:_tile_last_kernel
// and :_rank_kernel.  On the TPU both expand each tile into (256, 256)
// one-hot planes in VMEM and reduce them: 256 lanes of vector work per
// position.  Here one warp owns one tile and keeps its state in registers
// and shared memory, so a position costs a few warp instructions and the
// kernels move about 12 bytes per position through device memory.
//
//   bz2t_mtf_tile_last: for each tile and symbol 0..255, the in-tile index of
//     the symbol's last occurrence, or -1 (shared-memory atomicMax).
//   (glue in PyTorch: lx = exclusive cummax of the tiles' last occurrences,
//    seeded with symbol j at time -(j+1), the initial MTF list.)
//   bz2t_mtf_rank: the MTF list at a tile's start is the 256 symbols ordered
//     by descending lx.  Each lane holds the recency times of 8 symbols; for
//     every position the warp counts the symbols more recent than the
//     current one (its rank), then stamps the current symbol with a time
//     above every carry.  The loop over the tile's 256 positions is serial,
//     so what bounds it is the latency of the shuffle and the reduction per
//     position; 45760 independent tiles at -9 keep the SMs' warps busy.
// Symbols outside 0..255 (pads, id 300) match nothing and get rank 0.
#include "common.cuh"

namespace {

constexpr int kTileLen = 256;
constexpr int kWarps = 8;            // tiles per block

__global__ void tile_last_kernel(const int* seq, short* out, long long rows) {
  __shared__ int last[kWarps][kTileLen];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * kWarps + w;
  if (tile >= rows) return;
  int* L = last[w];
  for (int j = lane; j < kTileLen; j += 32) L[j] = -1;
  __syncwarp();
  const int* s = seq + tile * kTileLen;
  for (int p = lane; p < kTileLen; p += 32) {
    int v = s[p];
    if (v >= 0 && v < kTileLen) atomicMax(&L[v], p);
  }
  __syncwarp();
  for (int j = lane; j < kTileLen; j += 32)
    out[tile * kTileLen + j] = (short)L[j];
}

__global__ void rank_kernel(const int* seq, const int* lx, int* out,
                            long long rows) {
  __shared__ int s_seq[kWarps][kTileLen];
  __shared__ int s_out[kWarps][kTileLen];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * kWarps + w;
  if (tile >= rows) return;
  const int* s = seq + tile * kTileLen;
  const int* l = lx + tile * kTileLen;
  for (int j = lane; j < kTileLen; j += 32) s_seq[w][j] = s[j];
  int t[8];                          // recency of symbols lane*8 .. lane*8+7
#pragma unroll
  for (int q = 0; q < 8; ++q) t[q] = l[lane * 8 + q];
  __syncwarp();
  for (int i = 0; i < kTileLen; ++i) {
    const int c = s_seq[w][i];       // warp-uniform
    int r = 0;
    if (c >= 0 && c < kTileLen) {
      int mine = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (lane * 8 + q == c) mine = t[q];
      const int tc = __shfl_sync(kFullMask, mine, c >> 3);
      unsigned cnt = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) cnt += t[q] > tc ? 1u : 0u;
      r = (int)__reduce_add_sync(kFullMask, cnt);
      // carries are < 2^30 (positions below 2^20, or the negative seeds)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (lane * 8 + q == c) t[q] = (1 << 30) + i;
    }
    if (lane == 0) s_out[w][i] = r;
  }
  __syncwarp();
  for (int j = lane; j < kTileLen; j += 32)
    out[tile * kTileLen + j] = s_out[w][j];
}

}  // namespace

// seq: (rows, 256) int32 symbols; out: (rows, 256) int16.
BZ2T_API int bz2t_mtf_tile_last(const int* seq, short* out, long long rows,
                                void* stream) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  tile_last_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      seq, out, rows);
  BZ2T_CHECK_LAUNCH();
  return 0;
}

// seq, lx: (rows, 256) int32; out: (rows, 256) int32 ranks.
BZ2T_API int bz2t_mtf_rank(const int* seq, const int* lx, int* out,
                           long long rows, void* stream) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  rank_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(seq, lx, out,
                                                                 rows);
  BZ2T_CHECK_LAUNCH();
  return 0;
}
