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
// shared-memory steps (4,726 in the longest lane of the first -9 batch's
// 78: 258 sift-ups, then 257 merges of two sift-downs and a sift-up).  Its
// bytes (freq, alpha and out: about 160 KB at 78 lanes) are under 0.05 us
// of device memory time, so the chain's latency is the whole cost and the
// design shortens it.  A heap slot is an 8-byte {key, node} entry, so a
// key travels with its node and a comparison needs no second load through
// weight[]; the children of slot z are slots 2z and 2z + 1, one 16-byte
// aligned pair.  A sift-down loads the pair of zz's children and both of
// their child pairs at once and decides two levels from the three loads,
// and a sift-up loads two ancestors at once, so a load latency is paid
// every second level.  A merge takes w1 and w2 from the two popped entries
// in registers, and its parent[] writes stay off the chain.  Heap accesses
// are inline PTX shared loads and stores (program order kept, a store
// without a branch).  Comparisons read the key word only, which keeps the
// ties exactly as the reference's.  The chain runs on one thread, one lane
// a block, so the lanes run on separate SMs; the warp shares the leaf
// set-up, the reset of each attempt, the halving and the depth walk (one
// node's parent chain per thread, a warp vote for "too long").
#include "common.cuh"

namespace {

constexpr int kA = 258;
constexpr int kNodes = 2 * kA + 2;
constexpr int kSlots = 520;  // pair loads reach slot 2 * (n + 1) + 1
constexpr int kMaxLen = 17;
constexpr int kMaxHalvings = 24;
constexpr int kThreads = 32;
constexpr int kPerThread = (kA + kThreads - 1) / kThreads;

// Heap slots are 8-byte {key, node} entries at shared address hb + 8 s;
// every heap access is one of these volatile asm statements, so they keep
// their program order, and a store is one st.shared.v2 with no branch.
__device__ __forceinline__ int2 ld_slot(unsigned a) {
  int2 v;
  asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}

__device__ __forceinline__ int4 ld_pair(unsigned a) {
  int4 v;
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}

__device__ __forceinline__ void st_slot(unsigned a, int2 e) {
  asm volatile("st.shared.v2.s32 [%0], {%1, %2};" :: "r"(a), "r"(e.x),
               "r"(e.y));
}

// Sift {key, node} up from slot zz, two levels a round: both ancestors'
// slots load together, since their addresses do not depend on the data.
__device__ __forceinline__ void sift_up(unsigned hb, int zz, int key,
                                        int node) {
  while (zz > 1) {
    const int z1 = zz >> 1, z2 = zz >> 2;
    const int2 p1 = ld_slot(hb + 8u * z1);
    const int2 p2 = ld_slot(hb + 8u * z2);
    if (!(key < p1.x)) break;
    st_slot(hb + 8u * zz, p1);
    zz = z1;
    if (zz <= 1 || !(key < p2.x)) break;
    st_slot(hb + 8u * zz, p2);
    zz = z2;
  }
  st_slot(hb + 8u * zz, make_int2(key, node));
}

// Pop the root of a heap of n entries: returns it, and sifts the last
// entry down from slot 1 over the remaining n - 1, two levels a round:
// the children of zz (pair zz) and both their pairs of children load
// together, so the second level decides from registers.
__device__ __forceinline__ int2 pop(unsigned hb, int n) {
  const int2 top = ld_slot(hb + 8u);
  const int2 tmp = ld_slot(hb + 8u * n);
  --n;
  int zz = 1;
  for (;;) {
    const int yy = zz << 1;
    if (yy > n) break;
    const int4 c = ld_pair(hb + 16u * zz);
    const int4 g0 = ld_pair(hb + 16u * yy);
    const int4 g1 = ld_pair(hb + 16u * (yy + 1));
    const bool r1 = yy < n && c.z < c.x;
    const int2 ch = r1 ? make_int2(c.z, c.w) : make_int2(c.x, c.y);
    if (tmp.x < ch.x) break;
    st_slot(hb + 8u * zz, ch);
    zz = yy + r1;
    const int y2 = zz << 1;
    if (y2 > n) break;
    const int4 g = r1 ? g1 : g0;
    const bool r2 = y2 < n && g.z < g.x;
    const int2 ch2 = r2 ? make_int2(g.z, g.w) : make_int2(g.x, g.y);
    if (tmp.x < ch2.x) break;
    st_slot(hb + 8u * zz, ch2);
    zz = y2 + r2;
  }
  st_slot(hb + 8u * zz, tmp);
  return top;
}

__global__ void __launch_bounds__(kThreads)
huffman_lengths_kernel(const int* __restrict__ freq,
                       const int* __restrict__ alpha, int* __restrict__ out) {
  __shared__ __align__(16) int2 heap[kSlots];
  __shared__ int parent[kNodes];
  __shared__ int leaf[kA + 1];
  const int t = threadIdx.x;
  const unsigned hb = (unsigned)__cvta_generic_to_shared(heap);
  const long long row = (long long)blockIdx.x * kA;
  const int a = min(max(alpha[blockIdx.x], 0), kA);
  for (int i = t; i < kA; i += kThreads) {
    const int f = freq[row + i];
    leaf[i + 1] = (f ? f : 1) << 8;
  }
  __syncwarp();

  for (int attempt = 0;; ++attempt) {
    for (int i = t; i < kNodes; i += kThreads) parent[i] = i == 0 ? -2 : -1;
    __syncwarp();
    if (t == 0) {
      int n_heap = 0, n_nodes = a;
      for (int i = 1; i <= a; ++i) sift_up(hb, ++n_heap, leaf[i], i);
      while (n_heap > 1) {
        const int2 e1 = pop(hb, n_heap--);
        const int2 e2 = pop(hb, n_heap--);
        const int nn = ++n_nodes;
        parent[e1.y] = nn;
        parent[e2.y] = nn;
        const int wn = ((e1.x & ~0xff) + (e2.x & ~0xff)) |
                       (1 + max(e1.x & 0xff, e2.x & 0xff));
        sift_up(hb, ++n_heap, wn, nn);
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
