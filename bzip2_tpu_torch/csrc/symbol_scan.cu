// Group-parallel Huffman symbol decode: one thread per (block, group), a
// CTA per 256 groups of one block.
//
// Replaces the 50-step lax.scan of bzip2_tpu/ops/decode.py:_symbol_scan
// (decode_symbols and decode_symbols_rows), which has no Pallas original;
// written with torch ops it is 50 steps of about 12 ops each a batch,
// every op a host launch.
//
// The host light parse gives each 50-symbol group its start bit, so the
// groups decode independently; inside a group every symbol's bit offset
// depends on the one before.  Per step the thread reads the 32-bit
// big-endian window at byte off >> 3, built from the two uint32 words it
// spans (a funnel shift), shifts it left by off & 7, looks up the 12-bit
// first-level table lut1[b, sel, w >> 20] and, where that entry is 0 (an
// escape), the second level lut2[b, sel, clamp((w >> 12) - esc_base * 256,
// 0, 132 * 256 - 1)]; a valid lane then advances by the entry's low 5 bits
// (an invalid lane keeps its offset) and the symbol is entry >> 5.
//
// The windows equal the plain version's (ops/symbol_kernel.py, which
// builds every byte's window with rolls): the byte index clamps to
// [0, 4 WT - 1] and the word after the last wraps to the buffer's first,
// the flat buffer's (row stride 0, shared by the batch) or each row's.
//
// What bounds it: 50 dependent steps a lane, each a window read and one or
// two table reads; the bytes (the words, the table entries read and 4
// bytes a symbol out) are far below.  A warp's 32 lanes gather their
// entries at addresses of their own, so through the L1 a step costs up to
// 32 cache lines a warp.  So a CTA serves groups of one block and stages
// in shared memory the lut1 tables its groups select (found with a warp
// OR), narrowed to uint16 (entries are len | sym << 5 < 2^15, as
// ops/decode.build_tables cuts them), and the span of words its valid
// groups start in plus the 33 words a group can reach; a step's gathers
// then cost a few bank wavefronts.  A lane whose window falls outside the
// span (an invalid lane, the last word, the wrap) reads the words from
// global memory under the same clamp and wrap; lut2 (about a tenth of the
// lookups) stays in global memory.  The 50 symbols stay in registers and
// go out through shared memory, stored coalesced.
#include <atomic>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;              // groups a CTA, of one block
constexpr int kGroup = 50;                 // symbols a group
constexpr int kLut1 = 1 << 12;
constexpr int kLut2 = 132 << 8;
constexpr int kReach = 33;                 // words past a group's start
constexpr int kSpanWords = 4096;           // staged words, at most
constexpr int kStride = kGroup + 1;        // odd: the staging is conflict-free
constexpr int kTableBytes = kLut1 * 2;
constexpr int kScanBytes = 6 * kTableBytes + kSpanWords * 4;
constexpr int kOutBytes = kThreads * kStride * 4;
constexpr int kSmem = kScanBytes > kOutBytes ? kScanBytes : kOutBytes;

__global__ void __launch_bounds__(kThreads, 3)
symbol_scan_kernel(const long long* __restrict__ words, long long WT,
                   long long row_stride, const int* __restrict__ goff,
                   const int* __restrict__ gsel,
                   const unsigned char* __restrict__ gvalid,
                   const int* __restrict__ lut1, const int* __restrict__ lut2,
                   const int* __restrict__ esc_base, int* __restrict__ syms,
                   int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* tabs = reinterpret_cast<unsigned short*>(smem);
  unsigned* span = reinterpret_cast<unsigned*>(smem + 6 * kTableBytes);
  int* out = reinterpret_cast<int*>(smem);   // after the scan
  __shared__ int s_mask, s_lo, s_hi;
  const int b = blockIdx.y;
  const int g0 = blockIdx.x * kThreads;
  const int g = g0 + threadIdx.x;
  const bool live = g < G;
  const long long lane = (long long)b * G + g;
  const long long* w = words + b * row_stride;
  const long long last = 4 * WT - 1;
  int sel = 0, off = 0;
  bool valid = false;
  if (live) {
    sel = min(max(gsel[lane], 0), 5);
    off = goff[lane];
    valid = gvalid[lane] != 0;
  }
  if (threadIdx.x == 0) s_mask = 0, s_lo = INT_MAX, s_hi = -1;
  __syncthreads();
  // the tables the CTA's lanes select, and the words its valid lanes start in
  const int wstart =
      valid ? (int)(min(max((long long)(off >> 3), 0ll), last) >> 2) : -1;
  const unsigned any = __reduce_or_sync(kFullMask, live ? 1u << sel : 0u);
  const int lo = __reduce_min_sync(kFullMask, valid ? wstart : INT_MAX);
  const int hi = __reduce_max_sync(kFullMask, wstart);
  if ((threadIdx.x & 31) == 0) {
    atomicOr(&s_mask, (int)any);
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }
  __syncthreads();
  const int mask = s_mask;
  // staged words [w0, w1): nothing when no lane is valid
  const long long w0 = s_hi < 0 ? 0 : s_lo;
  const long long w1 = s_hi < 0 ? 0
                       : min(min((long long)s_hi + kReach + 1, WT),
                             w0 + kSpanWords);
  for (int t = 0, slot = 0; t < 6; ++t) {
    if (!(mask >> t & 1)) continue;                   // block-uniform
    const int4* src =
        reinterpret_cast<const int4*>(lut1 + ((long long)b * 6 + t) * kLut1);
    uint2* dst = reinterpret_cast<uint2*>(tabs + slot * kLut1);
    for (int k = threadIdx.x; k < kLut1 / 4; k += kThreads) {
      const int4 v = __ldg(src + k);
      dst[k] = make_uint2(__byte_perm(v.x, v.y, 0x5410),
                          __byte_perm(v.z, v.w, 0x5410));
    }
    ++slot;
  }
  for (long long k = threadIdx.x; k < w1 - w0; k += kThreads)
    span[k] = (unsigned)__ldg(w + w0 + k);
  __syncthreads();

  int sy[kGroup];
  if (live) {
    const unsigned short* l1 =
        tabs + __popc(mask & ((1 << sel) - 1)) * kLut1;
    const int* l2 = lut2 + ((long long)b * 6 + sel) * kLut2;
    const int eb = __ldg(esc_base + (long long)b * 6 + sel);
    // wi is staged with wi + 1 when 0 <= wi - w0 < inner
    const unsigned long long inner =
        (unsigned long long)max(w1 - w0 - 1, 0ll);
#pragma unroll
    for (int t = 0; t < kGroup; ++t) {
      const long long bi = min(max((long long)(off >> 3), 0ll), last);
      const long long wi = bi >> 2;
      unsigned cur, nxt;
      if ((unsigned long long)(wi - w0) < inner) {
        cur = span[wi - w0];
        nxt = span[wi - w0 + 1];
      } else {
        cur = (unsigned)__ldg(w + wi);
        nxt = (unsigned)__ldg(w + (wi + 1 == WT ? 0 : wi + 1));
      }
      const unsigned v = __funnelshift_l(nxt, cur, 8 * (int)(bi & 3))
                         << (off & 7);
      int entry = l1[v >> 20];
      if (entry == 0) {
        const int loc = min(max((int)(v >> 12) - (eb << 8), 0), kLut2 - 1);
        entry = __ldg(l2 + loc);
      }
      if (valid) off = (int)((unsigned)off + (unsigned)(entry & 31));
      sy[t] = entry >> 5;
    }
  }
  __syncthreads();                    // the tables and the span are done
  if (live) {
#pragma unroll
    for (int t = 0; t < kGroup; ++t) out[threadIdx.x * kStride + t] = sy[t];
  }
  __syncthreads();
  // the CTA's groups are consecutive, so are their symbols: store them whole
  const int n = min(kThreads, G - g0) * kGroup;
  int* dst = syms + ((long long)b * G + g0) * kGroup;
  for (int k = threadIdx.x; k < n; k += kThreads)
    dst[k] = out[(k / kGroup) * kStride + k % kGroup];
}

// the dynamic shared memory above 48 KiB, allowed once for each device
std::atomic<bool> g_smem_set[64];

}  // namespace

// words: (WT,) int64 (row_stride 0: one buffer for the batch) or (B, WT)
// int64 rows (row_stride WT), uint32 values; goff, gsel: (B, G) int32;
// gvalid: (B, G) bool; lut1: (B, 6, 4096), lut2: (B, 6, 132 * 256),
// esc_base: (B, 6), all int32 (lut1 16-byte aligned); syms: (B, G * 50)
// int32.
BZ2T_API int bz2t_symbol_scan(const long long* words, long long WT,
                              long long row_stride, const int* goff,
                              const int* gsel, const unsigned char* gvalid,
                              const int* lut1, const int* lut2,
                              const int* esc_base, int* syms, int B, int G,
                              void* stream) {
  if ((long long)B * G == 0 || WT == 0) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64 || !g_smem_set[dev].load()) {
    e = cudaFuncSetAttribute(symbol_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 0 && dev < 64) g_smem_set[dev].store(true);
  }
  const dim3 grid((unsigned)((G + kThreads - 1) / kThreads), (unsigned)B);
  symbol_scan_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      words, WT, row_stride, goff, gsel, gvalid, lut1, lut2, esc_base, syms,
      G);
  BZ2T_CHECK_LAUNCH();
  return 0;
}
