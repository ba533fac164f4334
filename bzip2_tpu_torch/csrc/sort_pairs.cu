// Row-wise lexicographic sort of (a, b) int32 pairs.
//
// Replaces the Pallas kernel bzip2_tpu/ops/sort_pallas.py:_sort_kernel
// (with _exchange_group), which holds a whole row in VMEM and runs a
// bitonic network on it.  A 2^20-pair row is 8 MB, far over the 227 KB of
// shared memory a block may use, so that design does not carry over: run on
// this card, every network step wider than a tile becomes a pass over device
// memory, 36 of them for a 2^20 row.
//
// Each pair becomes one 64-bit key
//   ((a ^ 0x80000000) << 32) | (b ^ 0x80000000),
// whose unsigned order is the signed lexicographic order of (a, b), and the
// keys go through a merge sort in two kinds of launches:
//   * sort_tile_kernel: one block sorts kTile = 8192 keys in dynamic shared
//     memory.  Each thread sorts a run of 16 keys in registers with a fixed
//     network, then the runs are merged pairwise in shared memory, each
//     thread finding its 16 outputs by a merge-path search and merging them
//     serially.  Rows narrower than a tile are sorted whole here (the merges
//     stop at the row width), and this one launch is the whole sort.
//   * sort_merge_kernel: one merge round over device memory, sorted runs of
//     width w into runs of 2w.  Each block makes kSpan = 4096 outputs: one
//     warp-wide 32-way search per end finds its windows in the two runs, the
//     windows are staged in shared memory, and each thread merges 16 of them
//     after a merge-path search there.  Rounds ping-pong between two key
//     buffers; the last unpacks into the output planes.
// What bounds it: device-memory traffic, 16 bytes per key and pass (8 read,
// 8 written) over 1 + log2(n / 8192) passes, 8 for a 2^20 row: 128 bytes
// per key, against 720 for the bitonic network's 45 passes.  Shared-memory
// work (about 9 in-tile merge steps per key) is the second limit.
// Tie rule: the merge-path searches and the serial merges both take the key
// from the left run when two keys are equal, so every output slot is filled
// exactly once.  Equal keys are equal pairs, so the output is defined.
// Why not radix: the plain version (torch.sort, CUB's LSD radix sort) makes
// 8 scatter passes of 8 bits over a 64-bit key and moves an index with it;
// a hand radix sort would repeat that, and merge path needs fewer passes,
// all with coalesced writes.  Tensor cores have no role in a comparison sort.
#include "common.cuh"

namespace {

constexpr int kItems = 16;                          // keys per thread
constexpr int kTileThreads = 512;
constexpr int kTile = kTileThreads * kItems;        // 8192 keys per tile
constexpr int kMergeThreads = 256;
constexpr int kSpan = kMergeThreads * kItems;       // 4096 outputs per block
constexpr uint64_t kPadKey = ~0ull;

// Shared-memory slot of key p: one pad slot every 16 keys, so that a thread
// reading its 16 consecutive keys and a warp reading 16 consecutive keys
// both meet distinct banks.  One spare slot at the end takes merge_serial's
// read past the last key.
__device__ __forceinline__ int sidx(int p) { return p + (p >> 4); }
__host__ __device__ constexpr int smem_slots(int keys) {
  return keys + keys / 16 + 1;
}

__device__ __forceinline__ uint64_t pack_pair(int a, int b) {
  return ((uint64_t)((uint32_t)a ^ 0x80000000u) << 32) |
         (uint64_t)((uint32_t)b ^ 0x80000000u);
}

__device__ __forceinline__ void store_key(uint64_t key, long long g,
                                          uint64_t* keys_out, int* a_out,
                                          int* b_out) {
  if (keys_out) {
    keys_out[g] = key;
  } else {
    a_out[g] = (int)((uint32_t)(key >> 32) ^ 0x80000000u);
    b_out[g] = (int)((uint32_t)key ^ 0x80000000u);
  }
}

// Bitonic network over the thread's registers; every index is a constant.
__device__ __forceinline__ void sort_registers(uint64_t (&v)[kItems]) {
#pragma unroll
  for (int k = 2; k <= kItems; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const uint64_t x = v[i], y = v[l];
          const bool up = (i & k) == 0;
          const uint64_t lo = x < y ? x : y, hi = x < y ? y : x;
          v[i] = up ? lo : hi;
          v[l] = up ? hi : lo;
        }
      }
    }
  }
}

// Merge path in shared memory: the number of keys of run A (la keys at slot
// a0) among the first k outputs of merging A with run B (lb keys at b0),
// equal keys taken from A first.
__device__ __forceinline__ int split_shared(const uint64_t* s, int a0, int la,
                                            int b0, int lb, int k) {
  int lo = k > lb ? k - lb : 0, hi = k < la ? k : la;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[sidx(a0 + mid)] <= s[sidx(b0 + k - 1 - mid)])
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The next kItems outputs of merging A[ai, ae) with B[bi, be), slots of s.
// Branch-free, one shared load per output; a run's end slot may be read
// (B follows A, and a spare slot follows the last key), never taken.
__device__ __forceinline__ void merge_serial(const uint64_t* s, int ai, int ae,
                                             int bi, int be,
                                             uint64_t (&v)[kItems]) {
  uint64_t x = s[sidx(ai)], y = s[sidx(bi)];
#pragma unroll
  for (int t = 0; t < kItems; ++t) {
    const bool take_a = ai < ae && (bi >= be || x <= y);
    v[t] = take_a ? x : y;
    ai += take_a;
    bi += !take_a;
    const uint64_t z = s[sidx(take_a ? ai : bi)];
    x = take_a ? z : x;
    y = take_a ? y : z;
  }
}

// Merge path in device memory, by one warp: the number of keys of A among
// the first k outputs of merging A and B (w keys each), equal keys from A
// first.  Each step probes 32 points of the range, so 2^19 candidates take
// five rounds of loads.
__device__ __forceinline__ long long split_global(const uint64_t* A,
                                                  const uint64_t* B,
                                                  long long w, long long k) {
  const int lane = threadIdx.x & 31;
  long long lo = k > w ? k - w : 0, hi = k < w ? k : w;
  while (lo < hi) {
    const long long r = hi - lo;
    const long long p = lo + r * lane / 32;
    const unsigned m = __ballot_sync(kFullMask, A[p] <= B[k - 1 - p]);
    const int c = __popc(m);   // the predicate holds on a prefix of lanes
    const long long nlo = c > 0 ? lo + r * (c - 1) / 32 + 1 : lo;
    hi = c < 32 ? lo + r * c / 32 : hi;
    lo = nlo;
  }
  return lo;
}

// Sorts each kTile-key tile of the flattened (rows * n) input, or each row
// when n < kTile (seg = min(n, kTile)).  Writes keys_out, or the output
// planes when keys_out is null.
__global__ void __launch_bounds__(kTileThreads, 2)
    sort_tile_kernel(const int* a, const int* b, uint64_t* keys_out, int* a_out,
                     int* b_out, long long total, int seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* s = reinterpret_cast<uint64_t*>(smem_raw);
  const long long base = (long long)blockIdx.x * kTile;
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int p = tid + r * kTileThreads;
    const long long g = base + p;
    s[sidx(p)] = g < total ? pack_pair(a[g], b[g]) : kPadKey;
  }
  __syncthreads();
  uint64_t v[kItems];
  const int d = tid * kItems;
#pragma unroll
  for (int i = 0; i < kItems; ++i) v[i] = s[sidx(d + i)];
  sort_registers(v);
  for (int w = kItems; w < seg; w <<= 1) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) s[sidx(d + i)] = v[i];
    __syncthreads();
    const int a0 = d & ~(2 * w - 1), b0 = a0 + w, k = d - a0;
    const int i = split_shared(s, a0, w, b0, w, k);
    merge_serial(s, a0 + i, b0, b0 + k - i, b0 + w, v);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) s[sidx(d + i)] = v[i];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int p = tid + r * kTileThreads;
    const long long g = base + p;
    if (g < total) store_key(s[sidx(p)], g, keys_out, a_out, b_out);
  }
}

// One merge round: sorted runs of width w in keys_in (w >= kTile, so a
// block's kSpan outputs lie in one pair of runs) into runs of 2w, written to
// keys_out, or to the output planes when keys_out is null.
__global__ void __launch_bounds__(kMergeThreads, 4)
    sort_merge_kernel(const uint64_t* keys_in, uint64_t* keys_out, int* a_out,
                      int* b_out, long long w) {
  __shared__ uint64_t s[smem_slots(kSpan)];
  __shared__ long long split[2];
  const int tid = threadIdx.x;
  const long long g0 = (long long)blockIdx.x * kSpan;
  const long long pair = g0 & ~(2 * w - 1);
  const uint64_t* A = keys_in + pair;
  const uint64_t* B = A + w;
  const long long k0 = g0 - pair;
  if (tid < 64) {
    const long long i = split_global(A, B, w, k0 + (tid >> 5) * kSpan);
    if ((tid & 31) == 0) split[tid >> 5] = i;
  }
  __syncthreads();
  const long long i0 = split[0], j0 = k0 - i0;
  const int la = (int)(split[1] - i0);
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int l = tid + r * kMergeThreads;
    s[sidx(l)] = l < la ? A[i0 + l] : B[j0 + (l - la)];
  }
  __syncthreads();
  uint64_t v[kItems];
  const int d = tid * kItems;
  const int i = split_shared(s, 0, la, la, kSpan - la, d);
  merge_serial(s, i, la, la + d - i, kSpan, v);
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kItems; ++t) s[sidx(d + t)] = v[t];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kItems; ++r) {
    const int l = tid + r * kMergeThreads;
    store_key(s[sidx(l)], g0 + l, keys_out, a_out, b_out);
  }
}

}  // namespace

BZ2T_API const char* bz2t_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// a, b: (rows, n) int32 in; a_out, b_out: (rows, n) int32 out; k0, k1:
// (rows, n) 64-bit key buffers, unused when n <= tile.  n is a power of two
// in [128, 2^20] and tile must equal kTile.  The tile sort writes k0, the
// merge rounds then write k1, k0, k1, ... in turn, and the last round writes
// the output planes instead (so k1 may be the output planes' memory when
// the last round reads k0, and the other way round).
BZ2T_API int bz2t_sort_pairs(const int* a, const int* b, int* a_out,
                             int* b_out, uint64_t* k0, uint64_t* k1, int rows,
                             int n, int tile, void* stream) {
  if (tile != kTile || rows < 1 || n < 128 || n > (1 << 20) || (n & (n - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = (long long)rows * n;
  constexpr int kTileSmem = smem_slots(kTile) * (int)sizeof(uint64_t);
  cudaError_t e = cudaFuncSetAttribute(
      sort_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
  if (e != cudaSuccess) return (int)e;
  const bool one = n <= kTile;
  sort_tile_kernel<<<(unsigned)((total + kTile - 1) / kTile), kTileThreads,
                     kTileSmem, st>>>(a, b, one ? nullptr : k0,
                                      one ? a_out : nullptr,
                                      one ? b_out : nullptr, total,
                                      one ? n : kTile);
  BZ2T_CHECK_LAUNCH();
  uint64_t* src = k0;
  uint64_t* dst = k1;
  for (long long w = kTile; w < n; w <<= 1) {
    const bool last = 2 * w == n;
    sort_merge_kernel<<<(unsigned)(total / kSpan), kMergeThreads, 0, st>>>(
        src, last ? nullptr : dst, last ? a_out : nullptr,
        last ? b_out : nullptr, w);
    BZ2T_CHECK_LAUNCH();
    uint64_t* t = src;
    src = dst;
    dst = t;
  }
  return 0;
}
