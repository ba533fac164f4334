// Reference-exact Huffman code lengths: one warp per (block, table) lane.
//
// Replaces bzip2_tpu/ops/huffman.py:136 make_code_lengths_lanes, a
// jax.vmap of fixed-bound lax loops over the reference heap (huffman.c:
// 25-148).  It has no Pallas original.  Written with torch ops those loops
// are some 90,000 tiny launches an attempt; here a lane is one launch of
// work, and the fused encoder's four rebuilds a batch are four launches.
//
// The heap discipline is huff_lengths_one of native/bz2tpu_host.cpp:
// packed keys (weight << 8) | depth, strict < sift-up, sift-down taking
// the right child only when it is strictly smaller, insertion order
// 1..alpha, parent key (w1 + w2) | (1 + max(d1, d2)), and halve-and-retry
// while a leaf is deeper than 17, at most 24 halvings (the JAX bound).
// Like JAX, out[lane, i] is the depth of node i + 1 for every i < 258:
// leaves below alpha, internal nodes (numbered from alpha + 1) above it, 0
// for nodes without a parent.  alpha is clamped to [0, 258].  Keys must
// stay positive int32 (frequency sums below 2^23, as a block's are); the
// sift-ups stop at the root, where the reference's sentinel (weight 0 at
// heap slot 0) stops them for positive keys, so an out-of-domain lane
// cannot loop.
//
// What bounds it: the heap build is one serial chain of dependent
// shared-memory steps, about 7,000 an attempt at alpha = 258 (258 sift-ups
// and 257 merges of two sift-downs and a sift-up, up to 9 levels each).
// Its bytes (freq, alpha and out: about 160 KB at 78 lanes) are under
// 0.05 us of device memory time, so they do not bound it.  The design runs
// that chain on one thread with weight, parent and heap in shared memory
// (6.2 KB), one lane per block so the lanes run on separate SMs, and
// spreads the rest over the warp: the leaf set-up, the reset of each
// attempt, the halving, and the depth walk (one node's parent chain per
// thread, a warp vote for "too long").
#include "common.cuh"

namespace {

constexpr int kA = 258;
constexpr int kNodes = 2 * kA + 2;
constexpr int kMaxLen = 17;
constexpr int kMaxHalvings = 24;
constexpr int kThreads = 32;
constexpr int kPerThread = (kA + kThreads - 1) / kThreads;

__global__ void __launch_bounds__(kThreads)
huffman_lengths_kernel(const int* __restrict__ freq,
                       const int* __restrict__ alpha, int* __restrict__ out) {
  __shared__ int weight[kNodes];
  __shared__ int parent[kNodes];
  __shared__ int heap[kA + 2];
  __shared__ int leaf[kA + 1];
  const int t = threadIdx.x;
  const long long row = (long long)blockIdx.x * kA;
  const int a = min(max(alpha[blockIdx.x], 0), kA);
  for (int i = t; i < kA; i += kThreads) {
    const int f = freq[row + i];
    leaf[i + 1] = (f ? f : 1) << 8;
  }
  if (t == 0) leaf[0] = 0;
  __syncwarp();

  for (int attempt = 0;; ++attempt) {
    for (int i = t; i < kNodes; i += kThreads) {
      weight[i] = i <= kA ? leaf[i] : 0;
      parent[i] = i == 0 ? -2 : -1;
    }
    __syncwarp();
    if (t == 0) {
      heap[0] = 0;                      // sentinel: weight[0] == 0
      int n_heap = 0, n_nodes = a;
      for (int i = 1; i <= a; ++i) {
        int zz = ++n_heap;
        const int wi = weight[i];
        while (zz > 1 && wi < weight[heap[zz >> 1]]) {
          heap[zz] = heap[zz >> 1];
          zz >>= 1;
        }
        heap[zz] = i;
      }
      while (n_heap > 1) {
        int picked[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          picked[r] = heap[1];
          const int tmp = heap[n_heap--];
          const int wt = weight[tmp];
          int zz = 1;
          for (;;) {
            int yy = zz << 1;
            if (yy > n_heap) break;
            if (yy < n_heap && weight[heap[yy + 1]] < weight[heap[yy]]) ++yy;
            if (wt < weight[heap[yy]]) break;
            heap[zz] = heap[yy];
            zz = yy;
          }
          heap[zz] = tmp;
        }
        const int nn = ++n_nodes;
        parent[picked[0]] = nn;
        parent[picked[1]] = nn;
        const int w1 = weight[picked[0]], w2 = weight[picked[1]];
        const int d1 = w1 & 0xff, d2 = w2 & 0xff;
        const int wn = ((w1 & ~0xff) + (w2 & ~0xff)) | (1 + max(d1, d2));
        weight[nn] = wn;
        int zz = ++n_heap;
        while (zz > 1 && wn < weight[heap[zz >> 1]]) {
          heap[zz] = heap[zz >> 1];
          zz >>= 1;
        }
        heap[zz] = nn;
      }
    }
    __syncwarp();

    int depth[kPerThread];
    int too_long = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int node = t + 1 + k * kThreads;
      int d = 0;
      if (node <= kA) {
        for (int p = parent[node]; p >= 0; p = parent[p]) ++d;
        too_long |= node <= a && d > kMaxLen;
      }
      depth[k] = d;
    }
    // the vote also orders every thread's walk before the next reset
    if (!__any_sync(kFullMask, too_long) || attempt == kMaxHalvings) {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int i = t + k * kThreads;
        if (i < kA) out[row + i] = depth[k];
      }
      return;
    }
    for (int i = t + 1; i <= kA; i += kThreads)
      leaf[i] = (1 + ((leaf[i] >> 8) / 2)) << 8;
    __syncwarp();
  }
}

}  // namespace

// freq, out: (L, 258) int32; alpha: (L,) int32.
BZ2T_API int bz2t_huffman_lengths(const int* freq, const int* alpha, int* out,
                                  int L, void* stream) {
  if (L <= 0) return 0;
  huffman_lengths_kernel<<<L, kThreads, 0, (cudaStream_t)stream>>>(freq, alpha,
                                                                    out);
  BZ2T_CHECK_LAUNCH();
  return 0;
}
