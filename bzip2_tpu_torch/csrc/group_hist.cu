// Per-group symbol histograms of the MTF/RLE2 stream.
//
// Replaces the Pallas kernel bzip2_tpu/ops/mtf_pallas.py:_group_hist_kernel,
// which compares each group's 50 symbols with a 384-wide iota in VMEM and
// sums the one-hot planes.  Here one warp owns one group: it clears 258
// counters in shared memory, adds the group's valid symbols with shared
// atomics and writes the counters out.  What bounds it is writing the
// (B, G, 258) int32 result, 1032 bytes per group against 200 bytes read,
// so the kernel writes each row once, coalesced, and nothing else.
#include "common.cuh"

namespace {

constexpr int kAlpha = 258;
constexpr int kWarps = 8;            // groups per block

__global__ void group_hist_kernel(const int* mtfv, const int* n_mtf, int* out,
                                  int B, int M, int G, int g_size) {
  __shared__ int cnt[kWarps][kAlpha];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long gid = (long long)blockIdx.x * kWarps + w;
  if (gid >= (long long)B * G) return;
  const int b = (int)(gid / G), g = (int)(gid % G);
  int* C = cnt[w];
  for (int j = lane; j < kAlpha; j += 32) C[j] = 0;
  __syncwarp();
  const long long lim = n_mtf[b] < M ? n_mtf[b] : M;
  const int* row = mtfv + (long long)b * M;
  for (int t = lane; t < g_size; t += 32) {
    long long pos = (long long)g * g_size + t;
    if (pos < lim) {
      int v = row[pos];
      if (v >= 0 && v < kAlpha) atomicAdd(&C[v], 1);
    }
  }
  __syncwarp();
  int* o = out + gid * kAlpha;
  for (int j = lane; j < kAlpha; j += 32) o[j] = C[j];
}

}  // namespace

// mtfv: (B, M) int32; n_mtf: (B,) int32; out: (B, G, 258) int32.
BZ2T_API int bz2t_group_hist(const int* mtfv, const int* n_mtf, int* out,
                             int B, int M, int G, int g_size, void* stream) {
  const long long groups = (long long)B * G;
  const unsigned blocks = (unsigned)((groups + kWarps - 1) / kWarps);
  group_hist_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      mtfv, n_mtf, out, B, M, G, g_size);
  BZ2T_CHECK_LAUNCH();
  return 0;
}
