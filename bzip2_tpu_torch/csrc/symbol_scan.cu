// Group-parallel Huffman symbol decode: one thread per (block, group).
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
// two table reads (a chain of L1/L2 latencies); the bytes (the words, the
// tables once and 4 bytes a symbol out) are far below.  The tables are
// read through the read-only cache; each CTA's 128 x 50 symbols are staged
// in shared memory and stored coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kGroup = 50;                 // symbols a group
constexpr int kLut1 = 1 << 12;
constexpr int kLut2 = 132 << 8;

__global__ void __launch_bounds__(kThreads)
symbol_scan_kernel(const long long* __restrict__ words, long long WT,
                   long long row_stride, const int* __restrict__ goff,
                   const int* __restrict__ gsel,
                   const unsigned char* __restrict__ gvalid,
                   const int* __restrict__ lut1, const int* __restrict__ lut2,
                   const int* __restrict__ esc_base, int* __restrict__ syms,
                   long long lanes, int G) {
  __shared__ int out[kThreads * kGroup];
  const long long lane0 = (long long)blockIdx.x * kThreads;
  const long long lane = lane0 + threadIdx.x;
  if (lane < lanes) {
    const long long b = lane / G;
    const long long* w = words + b * row_stride;
    const int sel = min(max(gsel[lane], 0), 5);
    const bool valid = gvalid[lane] != 0;
    const int eb = __ldg(esc_base + b * 6 + sel);
    const int* l1 = lut1 + (b * 6 + sel) * kLut1;
    const int* l2 = lut2 + (b * 6 + sel) * kLut2;
    const long long last = 4 * WT - 1;
    int off = goff[lane];
    for (int t = 0; t < kGroup; ++t) {
      const long long bi = min(max((long long)(off >> 3), 0ll), last);
      const long long wi = bi >> 2;
      const unsigned cur = (unsigned)__ldg(w + wi);
      const unsigned nxt = (unsigned)__ldg(w + (wi + 1 == WT ? 0 : wi + 1));
      const unsigned v = __funnelshift_l(nxt, cur, 8 * (int)(bi & 3))
                         << (off & 7);
      int entry = __ldg(l1 + (v >> 20));
      if (entry <= 0) {
        const int loc = min(max((int)(v >> 12) - (eb << 8), 0), kLut2 - 1);
        entry = __ldg(l2 + loc);
      }
      if (valid) off = (int)((unsigned)off + (unsigned)(entry & 31));
      out[threadIdx.x * kGroup + t] = entry >> 5;
    }
  }
  __syncthreads();
  // the CTA's lanes are consecutive, so are their symbols: store them whole
  const long long n = (min(lanes, lane0 + kThreads) - lane0) * kGroup;
  int* dst = syms + lane0 * kGroup;
  for (int k = threadIdx.x; k < n; k += kThreads) dst[k] = out[k];
}

}  // namespace

// words: (WT,) int64 (row_stride 0: one buffer for the batch) or (B, WT)
// int64 rows (row_stride WT), uint32 values; goff, gsel: (B, G) int32;
// gvalid: (B, G) bool; lut1: (B, 6, 4096), lut2: (B, 6, 132 * 256),
// esc_base: (B, 6), all int32; syms: (B, G * 50) int32.
BZ2T_API int bz2t_symbol_scan(const long long* words, long long WT,
                              long long row_stride, const int* goff,
                              const int* gsel, const unsigned char* gvalid,
                              const int* lut1, const int* lut2,
                              const int* esc_base, int* syms, int B, int G,
                              void* stream) {
  const long long lanes = (long long)B * G;
  if (lanes == 0 || WT == 0) return 0;
  const unsigned blocks = (unsigned)((lanes + kThreads - 1) / kThreads);
  symbol_scan_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      words, WT, row_stride, goff, gsel, gvalid, lut1, lut2, esc_base, syms,
      lanes, G);
  BZ2T_CHECK_LAUNCH();
  return 0;
}
