// Inverse-BWT splitter walk: one thread per (block, walker) lane.
//
// Replaces the walk loop of bzip2_tpu/ops/decode.py:386 (ibwt.wave), a
// lax.while_loop whose condition is "any lane still walking".  It has no
// Pallas original.  Written with torch ops that condition is a host
// round trip per step: at -9 wave 1 runs to its cap of 440 steps and
// wave 2 about 1,800, so a kernel that runs every lane to its own end in
// one launch removes some 2,000 host syncs per batch.
//
// tt (B, N) int32 is the successor array with two fields packed beside
// the successor: tt = succ << 9 | is_splitter(succ) << 8 | byte.  Lane
// (b, w) starts at cur0[b, w] (-1: inactive) and per step reads
// tt[b, cur], writes the byte to buf[b, w, t], and stops when the
// splitter flag is set (recording the hit position) or after cap steps.
// Outputs match the plain loop (ops/ibwt_kernel.ibwt_walk_plain): cur is
// -1 when the lane finished and the next position when it was capped;
// buf is zero-filled by the wrapper, so steps a lane did not take stay 0.
//
// What bounds it: each step's load depends on the one before, so a lane
// is a chain of L2 latencies (a -9 block's tt row is 3.6 MB; a batch of
// 8 fits the 50 MB L2).  The design keeps every lane's chain in flight at
// once (32,768 lanes in wave 1) to hide that latency.  The byte writes
// have stride cap between neighbouring lanes and are not coalesced; a
// later PR can stage them in shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void ibwt_walk_kernel(const int* __restrict__ tt,
                                 const int* __restrict__ cur0, int* cur_out,
                                 int* cnt_out, int* hitp_out,
                                 unsigned char* buf, long long lanes, int N,
                                 int W, int cap) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const int* row = tt + (lane / W) * (long long)N;
  unsigned char* out = buf + lane * (long long)cap;
  int cur = cur0[lane], cnt = 0, hitp = -1;
  for (int t = 0; t < cap && cur >= 0; ++t) {
    const int v = __ldg(row + min(cur, N - 1));
    out[t] = (unsigned char)(v & 0xFF);
    ++cnt;
    if (v & 0x100) {
      hitp = v >> 9;
      cur = -1;
    } else {
      cur = v >> 9;
    }
  }
  cur_out[lane] = cur;
  cnt_out[lane] = cnt;
  hitp_out[lane] = hitp;
}

}  // namespace

// tt: (B, N) int32; cur0, cur, cnt, hitp: (B, W) int32; buf: (B, W, cap)
// uint8, zero-filled by the caller.
BZ2T_API int bz2t_ibwt_walk(const int* tt, const int* cur0, int* cur,
                            int* cnt, int* hitp, unsigned char* buf, int B,
                            int N, int W, int cap, void* stream) {
  const long long lanes = (long long)B * W;
  if (lanes == 0) return 0;
  const unsigned blocks = (unsigned)((lanes + kThreads - 1) / kThreads);
  ibwt_walk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tt, cur0, cur, cnt, hitp, buf, lanes, N, W, cap);
  BZ2T_CHECK_LAUNCH();
  return 0;
}
