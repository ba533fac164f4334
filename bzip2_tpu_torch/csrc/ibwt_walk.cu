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
// tt[b, cur], emits the byte as buf[b, w, t], and stops when the splitter
// flag is set (recording the hit position) or after cap steps.  Outputs
// match the plain loop (ops/ibwt_kernel.ibwt_walk_plain): cur is -1 when
// the lane finished and the next position when it was capped.  The entry
// point writes buf whole, 0 past a lane's last step, so the caller
// allocates it uninitialised.
//
// What bounds it: each step's load depends on the one before, so a lane is
// a chain of L2 latencies (a -9 block's tt row is 3.6 MB; a batch of 8
// fits the 50 MB L2), and its bytes are far under the memory rate.  Wave 1
// (32,768 lanes of up to 440 steps) and wave 2 (about 4,400 live lanes of
// up to some 2,000 steps) both take far longer than their longest chain at
// one thread's L2 latency (about 140 ns a step, chip_smoke.py's chase
// probe), so the chains slow each other down under load.  The design keeps
// everything else off the chains: a step is a load, a byte store and the
// next address; the zero tails (wave 2's buffer is 54 MB, nearly all tail)
// are written by a second kernel after every walk of the launch, a warp a
// lane with its 32 threads on consecutive 16-byte words, instead of a fill
// ahead of the walk; every buffer store is a streaming store (st.global.cs,
// evict-first).  Designs measured against it in chip_smoke.py --old-walk
// turns (PERF.md): the walked bytes packed into 16-byte words (slower:
// the packing lengthens each step); the tails written by each lane as it
// walked or by each CTA after its own walks; tt staged in a 16- or 8-CTA
// cluster's distributed shared memory (118 ns a dependent step against
// 140 ns from L2 alone, but slower under the walk's load, and the card
// holds only 7 16-CTA clusters for 8 rows); an L2 prefetch of tt with
// evict_last loads.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
ibwt_walk_kernel(const int* __restrict__ tt, const int* __restrict__ cur0,
                 int* __restrict__ cur_out, int* __restrict__ cnt_out,
                 int* __restrict__ hitp_out, unsigned char* __restrict__ buf,
                 long long lanes, int N, int W, int cap) {
  const long long lane = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= lanes) return;
  const int* row = tt + (lane / W) * (long long)N;
  unsigned char* out = buf + lane * cap;
  int cur = cur0[lane], hitp = -1, t = 0;
  for (; t < cap && cur >= 0; ++t) {
    const int v = __ldg(row + min(cur, N - 1));
    __stcs(out + t, (unsigned char)(v & 0xFF));
    if (v & 0x100) {
      hitp = v >> 9;
      cur = -1;
    } else {
      cur = v >> 9;
    }
  }
  cur_out[lane] = cur;
  cnt_out[lane] = t;
  hitp_out[lane] = hitp;
}

// The zero tails, after every walk of the launch: a warp a lane, its 32
// threads on consecutive 16-byte words from the lane's first unwalked byte
// to cap.
__global__ void __launch_bounds__(kThreads)
ibwt_tail_kernel(const int* __restrict__ cnt, unsigned char* __restrict__ buf,
                 long long lanes, int cap) {
  const long long l = (long long)blockIdx.x * (kThreads / 32) +
                      (threadIdx.x >> 5);
  if (l >= lanes) return;
  const int ln = threadIdx.x & 31;
  const unsigned long long out =
      reinterpret_cast<unsigned long long>(buf + l * cap);
  const unsigned long long s = out + cnt[l], e = out + cap;
  const unsigned long long a = min((s + 15) & ~15ull, e);
  const unsigned long long b = max(e & ~15ull, a);
  if (ln < (int)(a - s))
    __stcs(reinterpret_cast<unsigned char*>(s + ln), (unsigned char)0);
  if (ln < (int)(e - b))
    __stcs(reinterpret_cast<unsigned char*>(b + ln), (unsigned char)0);
  for (unsigned long long w = a + 16ull * ln; w < b; w += 16 * 32)
    __stcs(reinterpret_cast<ulonglong2*>(w), make_ulonglong2(0, 0));
}

}  // namespace

// tt: (B, N) int32; cur0, cur, cnt, hitp: (B, W) int32; buf: (B, W, cap)
// uint8, written whole.
BZ2T_API int bz2t_ibwt_walk(const int* tt, const int* cur0, int* cur,
                            int* cnt, int* hitp, unsigned char* buf, int B,
                            int N, int W, int cap, void* stream) {
  const long long lanes = (long long)B * W;
  if (lanes == 0) return 0;
  const unsigned blocks = (unsigned)((lanes + kThreads - 1) / kThreads);
  ibwt_walk_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tt, cur0, cur, cnt, hitp, buf, lanes, N, W, cap);
  BZ2T_CHECK_LAUNCH();
  const unsigned tail_blocks =
      (unsigned)((lanes + kThreads / 32 - 1) / (kThreads / 32));
  ibwt_tail_kernel<<<tail_blocks, kThreads, 0, (cudaStream_t)stream>>>(
      cnt, buf, lanes, cap);
  BZ2T_CHECK_LAUNCH();
  return 0;
}
