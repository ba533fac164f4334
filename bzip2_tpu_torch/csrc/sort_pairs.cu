// Row-wise lexicographic sort of (a, b) int32 pairs.
//
// Replaces the Pallas kernel bzip2_tpu/ops/sort_pallas.py:_sort_kernel
// (with _exchange_group), which holds a whole row in VMEM and runs a
// bitonic network on it.  A 2^20-pair row is 8 MB, far over the 227 KB of
// shared memory a block may use, so that design does not carry over.
//
// Here each pair becomes one 64-bit key
//   ((a ^ 0x80000000) << 32) | (b ^ 0x80000000),
// whose unsigned order is the signed lexicographic order of (a, b), and the
// keys go through a bitonic network in three kinds of launches:
//   * tile_kernel, local mode: sorts each 4096-key tile in shared memory
//     (all stages of size <= 4096, direction taken from the global index);
//   * global_pass: one compare-exchange step at a distance >= 4096, one
//     thread per pair, straight in device memory;
//   * tile_kernel, merge mode: the steps of one stage below the tile width,
//     again in shared memory.
// What bounds it: device-memory traffic of the global passes, 16 bytes per
// key and pass (1 + 2 + ... + 8 = 36 passes for a 2^20 row), so the design
// keeps every step below the tile width in shared memory.  Callers keep the
// pairs distinct (a position in b's low bits), or equal only where both
// halves are equal, so the unstable network gives one defined output.
#include "common.cuh"

namespace {

constexpr int kTile = 4096;          // keys per shared-memory tile (32 KB)
constexpr int kTileThreads = 1024;   // two compare-exchanges per thread
constexpr int kPassThreads = 256;

__device__ __forceinline__ uint64_t pack_pair(int a, int b) {
  return ((uint64_t)((uint32_t)a ^ 0x80000000u) << 32) |
         (uint64_t)((uint32_t)b ^ 0x80000000u);
}

// Index of the lower element of compare-exchange pair p at distance d
// (a power of two): insert a 0 bit at position log2(d).
__device__ __forceinline__ long long pair_lo(long long p, long long d) {
  return ((p & ~(d - 1)) << 1) | (p & (d - 1));
}

// Sort ascending where (global index & k) == 0, descending elsewhere.
__device__ __forceinline__ void cex(uint64_t* s, long long lo, long long d,
                                    long long gi, long long k) {
  uint64_t x = s[lo], y = s[lo + d];
  bool asc = (gi & k) == 0;
  if ((x > y) == asc) {
    s[lo] = y;
    s[lo + d] = x;
  }
}

// k_merge == 0: full local sort of the tile; otherwise the steps d < tile of
// stage k_merge.  Input from (a_in, b_in) if given, else keys_in; output to
// (a_out, b_out) if given, else keys_out.
__global__ void tile_kernel(const int* a_in, const int* b_in,
                            const uint64_t* keys_in, uint64_t* keys_out,
                            int* a_out, int* b_out, int n, int tile,
                            long long k_merge) {
  __shared__ uint64_t s[kTile];
  const long long base = (long long)blockIdx.x * tile;
  const long long off = (long long)blockIdx.y * n + base;
  for (int l = threadIdx.x; l < tile; l += blockDim.x)
    s[l] = a_in ? pack_pair(a_in[off + l], b_in[off + l]) : keys_in[off + l];
  __syncthreads();
  const int half = tile >> 1;
  if (k_merge == 0) {
    for (int k = 2; k <= tile; k <<= 1) {
      for (int d = k >> 1; d > 0; d >>= 1) {
        for (int p = threadIdx.x; p < half; p += blockDim.x) {
          long long lo = pair_lo(p, d);
          cex(s, lo, d, base + lo, k);
        }
        __syncthreads();
      }
    }
  } else {
    for (int d = half; d > 0; d >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        long long lo = pair_lo(p, d);
        cex(s, lo, d, base + lo, k_merge);
      }
      __syncthreads();
    }
  }
  for (int l = threadIdx.x; l < tile; l += blockDim.x) {
    uint64_t key = s[l];
    if (a_out) {
      a_out[off + l] = (int)((uint32_t)(key >> 32) ^ 0x80000000u);
      b_out[off + l] = (int)((uint32_t)key ^ 0x80000000u);
    } else {
      keys_out[off + l] = key;
    }
  }
}

__global__ void global_pass(uint64_t* keys, int n, long long d, long long k) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (n >> 1)) return;
  long long lo = pair_lo(p, d);
  cex(keys + (long long)blockIdx.y * n, lo, d, lo, k);
}

}  // namespace

BZ2T_API const char* bz2t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// a, b: (rows, n) int32 in; a_out, b_out: (rows, n) int32 out; keys:
// (rows, n) 64-bit scratch.  n is a power of two in [128, 2^20].
BZ2T_API int bz2t_sort_pairs(const int* a, const int* b, int* a_out,
                             int* b_out, uint64_t* keys, int rows, int n,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int tile = n < kTile ? n : kTile;
  const dim3 tgrid(n / tile, rows);
  if (n <= kTile) {
    tile_kernel<<<tgrid, kTileThreads, 0, st>>>(a, b, nullptr, nullptr,
                                                a_out, b_out, n, tile, 0);
    BZ2T_CHECK_LAUNCH();
    return 0;
  }
  tile_kernel<<<tgrid, kTileThreads, 0, st>>>(a, b, nullptr, keys, nullptr,
                                              nullptr, n, tile, 0);
  BZ2T_CHECK_LAUNCH();
  const dim3 pgrid(((n >> 1) + kPassThreads - 1) / kPassThreads, rows);
  for (long long k = 2LL * tile; k <= n; k <<= 1) {
    for (long long d = k >> 1; d >= tile; d >>= 1) {
      global_pass<<<pgrid, kPassThreads, 0, st>>>(keys, n, d, k);
      BZ2T_CHECK_LAUNCH();
    }
    const bool last = k == n;
    tile_kernel<<<tgrid, kTileThreads, 0, st>>>(
        nullptr, nullptr, keys, last ? nullptr : keys, last ? a_out : nullptr,
        last ? b_out : nullptr, n, tile, k);
    BZ2T_CHECK_LAUNCH();
  }
  return 0;
}
