#!/usr/bin/env python3
"""Smoke run of the PyTorch port (bzip2_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--old-mtf PATH.cu] [--old-huffman PATH.cu]
                          [--old-walk PATH.cu ...]

Phases, in order; any failure ends the run with a non-zero exit:
  1. print the toolchain and the card; fail without CUDA;
  2. build the CUDA kernels from bzip2_tpu_torch/csrc/ and, at the same
     time, the port's C++ host runtime from bzip2_tpu_torch/native/, the
     dependent-load chase probe (CHASE_PROBE, into build/probe/) and any
     --old-* source;
  3. hold each kernel against its plain PyTorch version at the main path's
     shapes (exact equality) and time both with CUDA events, beside its
     bound (the larger of its bytes over the card's memory rate and its
     operations over its peak rate) and, where one PyTorch call computes
     the same function, that call's time.  The MTF kernels and the group
     histogram take the first -9 encode batch (13 blocks); the walk
     kernel's inputs are the first decode batch's two waves, recorded from
     one decode of the -9 stream through bzip2_tpu_torch.decompress.
     The Huffman-length kernel takes the 78 lanes of that batch's first
     refinement pass and a set of skewed lanes that halve and retry, and is
     timed beside the host heap of the hybrid path
     (native.make_code_lengths_batch); the heap steps its inputs need and
     its longest lane's serial chain of them are printed with it, since
     that chain, not its bytes, limits it.  The chase probe times one
     thread's dependent loads over a 3.6 MB table (a -9 row of the walk's
     tt) from L2 and from a 16-CTA cluster's distributed shared memory, in
     ns a step, and prints how many such clusters the card holds at once
     (cudaOccupancyMaxActiveClusters).  The sort is timed beside
     torch.sort of its packed key at every shape, mtf_tile_last beside one
     scatter_reduce_ "amax" and group_hist beside one torch.bincount.  With
     --old-mtf, --old-huffman or --old-walk (the last two may be given
     more than once), an earlier source of that kernel, built into
     build/probe/, is held against the current kernel's output (exact) on
     the same inputs and timed in turns with it: old, current, current,
     old;
  4. compress ~16 MB of seeded text at -9 through bzip2_tpu_torch.compress
     in hybrid mode with one device worker and no host worker: the stream
     must equal bz2.compress(data, 9) and round-trip through
     bz2.decompress, every block must go to the device and every encode
     kernel must have been launched by that run;
  5. one more such compression under torch.profiler, with the host RLE1
     split timed apart: prints the device's busy share, the ops that take
     its time, each hand kernel's device time and the peak device memory;
  6. decode that -9 stream through bzip2_tpu_torch.decompress_with_tail
     (one warm-up, then the timed run): the bytes and the consumed length
     must be exact, every block decoded on the device, no block healed on
     the host, the walk kernel launched; then a -1 stream of a 2 MB
     prefix and a two-member stream with trailing garbage, and one more -9
     decode under torch.profiler; a spy on native.decompress, the host's
     whole-stream decoder, must see no call from any of these decodes;
  6b. the port's native batch decoder, native.decode_some, on the whole -9
     stream in a child process (a crash fails the run with its signal):
     every block, the bytes exact;
  6c. the same for native.decompress, the host api.decompress's decoder:
     the bytes and the consumed length exact;
  7. the fused mode (mode="fused", host_workers=0) on the same data, after
     one warm-up: bit-exact, round-trips, every block on the device, the
     Huffman-length kernel launched 4 times a batch, every encode kernel
     launched; prints the wall and the stage walls, and profiles one more
     fused run;
  8. the scheduler: phase 4's and phase 7's settings, two device workers
     and no host worker, the defaults (two device workers, one host
     worker) and use_device=False, each warmed up once, then timed in turns
     for three rounds; every run bit-exact and round-tripped, device and
     host blocks adding up to the stream's, the device runs launching every
     encode kernel and the host-only runs none; prints each run's wall,
     block split and declines and each setting's median, and profiles the
     default setting once;
  9. the user surfaces on the corpus written to build/smoke/: the CLI
     (python -m bzip2_tpu_torch.cli -zkf -9) in a child process, bit-exact;
     cli.main in process with an engine of no host worker registered as
     "gpu": bit-exact, every block on the card, every encode kernel
     launched, the blocks each encode_payloads call carried printed; the
     CLI's card decode (-d -c and -t in child processes, -dkf in process:
     exact, every block on the card, the walk kernel launched); the host
     decode (--backend=native -d -c, a child); BZ2File write and read on
     the defaults (device/host split printed); recover on a copy with a
     byte flipped in block 5 (18 valid rec*.bz2, each read by
     bz2.decompress); --backend=bogus (exit 3, no output file).  The
     kernels line takes its launches from the in-process CLI encode and
     decode (huffman_lengths, on the fused path only, from phase 7);
  10a. the mesh (bzip2_tpu_torch.parallel.mesh): encode_blocks_sharded of
     the corpus's 19 blocks on make_mesh() (the one card) and on two entries
     of cuda:0, each warmed up once, then timed with the launch counts
     reset: the spliced stream must equal bz2.compress(data, 9) and
     round-trip, and every encode kernel, huffman_lengths included, must
     have been launched; prints the walls, the blocks on each entry, the
     launches and the peak device memory;
  10b. decode_blocks_sharded of the -9 stream on the same two meshes, the
     same way: exact, no host heal (mesh.HEALS), the walk kernel launched;
     prints the walls and mesh.STAGE_WALL; profiles one more encode and
     decode on make_mesh() (device busy share, top device ops, each hand
     kernel's device time); then a two-member stream (exact) and a flipped
     byte (ValueError);
  10c. two child processes, a Gloo group over 127.0.0.1 with local mesh
     [cuda:0] each (bzip2_tpu_torch.parallel.multihost), run
     compress_sharded on the corpus cut at 8 MiB (each rank encodes at
     least eight 900k blocks) and decompress_members(backend="gpu") of a
     three-member stream, each warmed up once and then timed: rank 0's
     stream must equal bz2.compress(data, 9) and the members' bytes be
     exact, every kernel launched on each rank; a child's non-zero exit or
     signal fails the run.  Prints the wall with the children's start and
     each rank's walls.
The last line is a JSON object naming the device.  The script imports the
port (bzip2_tpu_torch), torch, numpy and the standard library only.
"""
from __future__ import annotations

import bz2
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_MS = 3.35e9        # H100 SXM device memory, 3.35 TB/s
INT32_OPS_PER_MS = 67e9          # its non-tensor 32-bit peak, 67 T/s
LEVEL = 9
CORPUS_BYTES = 16 << 20
SEED = 20261016
REPLACES = {
    "sort_pairs": "bzip2_tpu/ops/sort_pallas.py:76",
    "mtf_tile_last": "bzip2_tpu/ops/mtf_pallas.py:34",
    "mtf_rank": "bzip2_tpu/ops/mtf_pallas.py:44",
    "group_hist": "bzip2_tpu/ops/mtf_pallas.py:77",
    "ibwt_walk": "bzip2_tpu/ops/decode.py:386 ibwt.wave (lax.while_loop; "
                 "no Pallas original)",
    "huffman_lengths": "bzip2_tpu/ops/huffman.py:136 make_code_lengths_lanes "
                       "(jax.vmap of lax loops; no Pallas original)",
}
SOURCES = {
    "sort_pairs": "bzip2_tpu_torch/csrc/sort_pairs.cu",
    "mtf_tile_last": "bzip2_tpu_torch/csrc/mtf_ranks.cu",
    "mtf_rank": "bzip2_tpu_torch/csrc/mtf_ranks.cu",
    "group_hist": "bzip2_tpu_torch/csrc/group_hist.cu",
    "ibwt_walk": "bzip2_tpu_torch/csrc/ibwt_walk.cu",
    "huffman_lengths": "bzip2_tpu_torch/csrc/huffman_lengths.cu",
}
# the CUDA kernels each wrapper launches, as the profiler names them
SYMBOLS = {
    "sort_pairs": ("sort_tile_kernel", "sort_merge_kernel"),
    "mtf_tile_last": ("tile_last_kernel",),
    "mtf_rank": ("rank_kernel",),
    "group_hist": ("group_hist_kernel",),
    "ibwt_walk": ("ibwt_walk_kernel", "ibwt_tail_kernel"),
    "huffman_lengths": ("huffman_lengths_kernel",),
}
ENCODE = ("sort_pairs", "mtf_tile_last", "mtf_rank", "group_hist")
FUSED = ENCODE + ("huffman_lengths",)
DECODE = ("ibwt_walk",)
#: the hybrid slice of phases 4 and 5: one device worker, every block on
#: the device (the engine's defaults add a second worker and a host one)
HYBRID = {"pipeline": 1, "host_workers": 0}
ROUNDS = 3          # phase 8's rounds of runs in turns
#: phases 6b and 6c: fresh child processes a native decoder, each with its
#: own address layout, so a read through a stray pointer has several
#: chances to fault
NATIVE_RUNS = 5
PROBE_DIR = os.path.join(HERE, "build", "probe")
SURFACE_DIR = os.path.join(HERE, "build", "smoke")   # phase 9's files
MESH_DIR = os.path.join(HERE, "build", "mesh")        # phase 10c's files
MESH_CUT = 8 << 20      # phase 10c cuts the corpus here between its ranks
CHASE_STEPS = (20_000, 220_000)   # the chase probe's two run lengths

#: the chase probe: one thread follows a single-cycle permutation for
#: ``steps`` dependent loads, read from global memory (L2), as ibwt_walk.cu
#: reads tt, or from the distributed shared memory of a cluster that staged
#: it (a row sliced over up to 16 CTAs), the design the walk was measured
#: against
CHASE_PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
namespace cg = cooperative_groups;
constexpr int kSliceMax = 232448 / 4;
constexpr int kThreads = 256;

__global__ void chase_global(const int* __restrict__ next, int steps,
                             int start, int* out) {
  int c = start;
  for (int s = 0; s < steps; ++s) c = __ldg(next + c);
  *out = c;
}

__global__ void __launch_bounds__(kThreads)
chase_cluster(const int* __restrict__ next, int n, int slice,
              unsigned long long magic, int steps, int start, int* out) {
  extern __shared__ __align__(16) int st[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lo = rank * slice;
  const int here = max(0, min(slice, n - lo));
  for (int i = threadIdx.x; i < here; i += kThreads) st[i] = next[lo + i];
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    const unsigned base = (unsigned)__cvta_generic_to_shared(st);
    int c = start;
    for (int s = 0; s < steps; ++s) {
      const unsigned r = (unsigned)(((unsigned long long)c * magic) >> 40);
      const unsigned local = base + 4u * (unsigned)(c - (int)r * slice);
      unsigned remote;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(remote) : "r"(local), "r"(r));
      asm volatile("ld.shared::cluster.b32 %0, [%1];"
                   : "=r"(c) : "r"(remote));
    }
    *out = c;
  }
  cluster.sync();
}

extern "C" int probe_chase_global(const int* next, int steps, int start,
                                  int* out, void* stream) {
  chase_global<<<1, 1, 0, (cudaStream_t)stream>>>(next, steps, start, out);
  return (int)cudaGetLastError();
}

// one cluster of cs CTAs holding n entries: the shape of a -9 row
struct Shape {
  int cs, slice;
  unsigned long long magic;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
};

static int shape_for(int n, void* stream, Shape* s) {
  s->cs = std::min(16, (n + kSliceMax - 1) / kSliceMax);
  s->slice = std::min(kSliceMax, ((n + s->cs - 1) / s->cs + 3) & ~3);
  if ((long long)s->cs * s->slice < n) return (int)cudaErrorInvalidValue;
  s->magic = (1ull << 40) / s->slice + 1;
  cudaError_t e = cudaFuncSetAttribute(
      chase_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSliceMax * 4);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        chase_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  s->cfg = cudaLaunchConfig_t{};
  s->cfg.gridDim = dim3(s->cs);
  s->cfg.blockDim = dim3(kThreads);
  s->cfg.dynamicSmemBytes = (size_t)s->slice * 4;
  s->cfg.stream = (cudaStream_t)stream;
  s->attr.id = cudaLaunchAttributeClusterDimension;
  s->attr.val.clusterDim.x = s->cs;
  s->attr.val.clusterDim.y = 1;
  s->attr.val.clusterDim.z = 1;
  s->cfg.attrs = &s->attr;
  s->cfg.numAttrs = 1;
  return (int)e;
}

extern "C" int probe_chase_cluster(const int* next, int n, int steps,
                                   int start, int* out, void* stream) {
  Shape s;
  int rc = shape_for(n, stream, &s);
  if (rc) return rc;
  cudaError_t e = cudaLaunchKernelEx(&s.cfg, chase_cluster, next, n, s.slice,
                                     s.magic, steps, start, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out[0] = CTAs a cluster, out[1] = its shared memory bytes a CTA,
// out[2] = cudaOccupancyMaxActiveClusters for that shape
extern "C" int probe_cluster_occupancy(int n, int* out) {
  Shape s;
  int rc = shape_for(n, nullptr, &s);
  if (rc) return rc;
  int active = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&active, chase_cluster,
                                                 &s.cfg);
  out[0] = s.cs;
  out[1] = s.slice * 4;
  out[2] = active;
  return (int)e;
}
"""

#: phases 6b and 6c's child: a native decoder over a whole stream read from
#: stdin, native.decode_some ("some") or native.decompress ("whole"), the
#: whole-stream decoder of the host api.decompress
NATIVE_DECODE = r"""
import hashlib, json, sys, time
sys.path.insert(0, sys.argv[1])
from bzip2_tpu_torch import native
stream = sys.stdin.buffer.read()
native.available()
t0 = time.perf_counter()
if sys.argv[2] == "some":
    out, nxt, level, comb, status, rc = native.decode_some(stream, 0, 0, 0)
    res = {"status": status, "next_bit": nxt, "level": level}
else:
    out, consumed, rc = native.decompress(stream, multi_stream=True)
    res = {"consumed": consumed}
res["seconds"] = time.perf_counter() - t0
res.update(rc=rc, bytes=-1 if out is None else len(out),
           sha256=None if out is None else hashlib.sha256(out).hexdigest())
print(json.dumps(res))
"""


#: phase 10c's child: one rank of a two-process Gloo group on the card
#: (local mesh [cuda:0]); compress_sharded of its half of the corpus, once
#: to warm up and once timed, then decompress_members(backend="gpu") of the
#: three-member stream, likewise.  Rank 0 writes the stream and the decoded
#: bytes beside the corpus; every rank prints its walls, the blocks it
#: encoded and its kernel launches in the timed runs as its last line.
MULTIHOST_CHILD = r"""
import json, os, sys, time
t_start = time.perf_counter()
here, pid, port, tmp, cut = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                             sys.argv[4], int(sys.argv[5]))
sys.path.insert(0, here)
import torch
import torch.distributed as dist
from bzip2_tpu_torch import _build
from bzip2_tpu_torch.parallel import multihost
multihost.initialize("127.0.0.1:" + port, num_processes=2, process_id=pid,
                     local_device_count=1)
mesh = multihost.local_mesh()
res = {"rank": pid, "mesh": [str(d) for d in mesh.devices]}
encoded = []
real = multihost.encode_blocks_sharded
def spy(m, blocks_np, *a):
    encoded.append(blocks_np.shape[0])
    return real(m, blocks_np, *a)
multihost.encode_blocks_sharded = spy
with open(os.path.join(tmp, "corpus"), "rb") as fh:
    data = fh.read()
shard = data[:cut] if pid == 0 else data[cut:]
with open(os.path.join(tmp, "members.bz2"), "rb") as fh:
    members = fh.read()

def timed(fn):
    fn()                        # warm-up: first-use costs at these shapes
    dist.barrier()
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {k: v.launches for k, v in _build.KERNELS.items()}

res["ready_s"] = time.perf_counter() - t_start
out, res["encode_s"], res["encode_launches"] = timed(
    lambda: multihost.compress_sharded(shard, level=9))
res["encode_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
res["blocks"] = encoded[-1] if encoded else 0
dec, res["decode_s"], res["decode_launches"] = timed(
    lambda: multihost.decompress_members(members, backend="gpu"))
res["decode_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
if pid == 0:
    with open(os.path.join(tmp, "stream.bz2"), "wb") as fh:
        fh.write(out)
    with open(os.path.join(tmp, "members.out"), "wb") as fh:
        fh.write(dec)
elif out is not None or dec is not None:
    raise SystemExit("rank 1 returned a result")
dist.destroy_process_group()
res["total_s"] = time.perf_counter() - t_start
print(json.dumps(res))
"""


def _run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def card_line() -> str:
    return _run(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0]


def corpus(size: int, seed: int) -> bytes:
    """De-periodized golden mix: copies of the golden samples 1 and 2, the
    lowercase letters of each copy rotated by an offset drawn from a seeded
    permutation of the 26 rotations, so no block holds two equal copies."""
    gold = os.path.join(HERE, "tests", "golden")
    src = np.frombuffer(b"".join(
        open(os.path.join(gold, f"sample{i}.ref"), "rb").read()
        for i in (1, 2)), np.uint8)
    lower = (src >= 97) & (src <= 122)
    rots = np.random.default_rng(seed).permutation(26)
    parts = []
    for i in range(-(-size // src.size)):
        r = int(rots[i % 26])
        parts.append(np.where(lower, (src - 97 + r) % 26 + 97, src)
                     .astype(np.uint8))
    return np.concatenate(parts)[:size].tobytes()


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def tensor_bytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nbytes: int, ops: int = 0) -> dict:
    """The least time the card could take: bytes over its memory rate or
    32-bit operations over its peak rate, whichever is larger."""
    b, o = nbytes / HBM_BYTES_PER_MS, ops / INT32_OPS_PER_MS
    return {"bound_ms": max(b, o), "bound_by": "bytes" if b >= o
            else "operations"}


def exact(torch, name, kern, plain, args) -> tuple:
    """Run kernel and plain version once on the same inputs and demand
    equality; returns the kernel's outputs."""
    got = kern(*args)
    exp = plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    exp = exp if isinstance(exp, tuple) else (exp,)
    err = 0
    for g, e in zip(got, exp):
        if g.shape != e.shape or g.dtype != e.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                 f"{e.shape}/{e.dtype}")
        err = max(err, int((g.to(torch.int64) - e.to(torch.int64))
                           .abs().max().item()))
    if err != 0:
        raise AssertionError(f"{name}: kernel differs from plain "
                             f"(max abs err {err})")
    return got


def compare(torch, name, kern, plain, args, reps=5, library=None, work=None):
    """Run kernel and plain version on the same inputs; demand equality.
    ``work(args, outputs)`` gives (bytes, operations) for the bound (by
    default each input read once and each output written once);
    ``library`` is one PyTorch call that computes the same function."""
    got = exact(torch, name, kern, plain, args)
    ms = cuda_ms(torch, lambda: kern(*args), reps)
    plain_ms = cuda_ms(torch, lambda: plain(*args), reps)
    lib_ms = None if library is None else cuda_ms(torch, library, reps)
    if work is None:
        nbytes = tensor_bytes(*(a for a in args if hasattr(a, "numel")), *got)
        b = bound(nbytes)
    else:
        b = bound(*work(args, got))
    shape = "x".join(str(s) for s in args[0].shape)
    lib = "" if lib_ms is None else f"   library {lib_ms:8.3f} ms"
    print(f"  {name:14s} {shape:>14s}  kernel {ms:9.4f} ms   "
          f"plain {plain_ms:9.3f} ms   bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}){lib}   max_abs_err 0", flush=True)
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": lib_ms}


def profiled(torch, fn) -> tuple:
    """Run fn once under torch.profiler.  Returns (wall ms, device busy ms,
    {device event name: (ms, count)}); busy is the union of the device's
    kernel and copy intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    if not by_name:
        raise AssertionError("torch.profiler recorded no device time")
    return wall, busy / 1e3, by_name


def print_profile(by_name: dict, kernels) -> None:
    """The ops that take the device's time, and each hand kernel's device
    time by its CUDA kernel names."""
    total = sum(ms for ms, _ in by_name.values())
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        print(f"  {ms:8.3f} ms {100 * ms / total:5.1f}%  {n:5d}x  {name[:90]}",
              flush=True)
    for kern in kernels:
        syms = SYMBOLS[kern]
        parts = {s: [0.0, 0] for s in syms}
        for name, (ms, n) in by_name.items():
            for s in syms:
                if f"{s}(" in name:
                    parts[s][0] += ms
                    parts[s][1] += n
        print(f"  hand kernel {kern}: {sum(p[0] for p in parts.values()):.3f} "
              "ms device time (" + ", ".join(
                  f"{s} {ms:.3f} ms {n}x" for s, (ms, n) in parts.items())
              + ")", flush=True)


def profile_slice(torch, data: bytes, expect: bytes) -> None:
    """Phase 5: the host RLE1 split alone, then one compression under
    torch.profiler."""
    from bzip2_tpu_torch import engine
    t0 = time.perf_counter()
    engine.split_blocks(data, LEVEL)
    print(f"phase 5: host rle1 split {time.perf_counter() - t0:.4f} s",
          flush=True)
    _profile_compress(torch, "hybrid", data, expect, HYBRID, ENCODE)


def decode_phase(torch, data: bytes, expect: bytes, n_blocks: int,
                 card: str) -> dict:
    """Phase 6: the decode path through the port's entry points, with a
    spy on native.decompress.  Returns the kernel launch counts of the
    timed -9 decode."""
    import bzip2_tpu_torch
    from bzip2_tpu_torch import decoder as dmod

    # a spy on the whole-stream host decoder: the device decoder never hands
    # it a stream.  One call through the spy first shows that it counts.
    whole = []
    real_whole = dmod.native.decompress

    def spy(*a, **k):
        whole.append(len(a[0]))
        return real_whole(*a, **k)

    dmod.native.decompress = spy
    try:
        probe = bz2.compress(b"spy", 1)
        if dmod.native.decompress(probe)[0] != b"spy" or whole != [len(probe)]:
            raise AssertionError("the native.decompress spy does not count")
        whole.clear()
        launches = _decode_runs(torch, bzip2_tpu_torch, dmod, data, expect,
                                n_blocks, card)
    finally:
        dmod.native.decompress = real_whole
    if whole:
        raise AssertionError(f"the device decoder called native.decompress "
                             f"{len(whole)} times")
    print("  native.decompress spy: no call from bzip2_tpu_torch.decompress "
          "or DeviceDecoder in phase 6", flush=True)
    return launches


def _decode_runs(torch, bzip2_tpu_torch, dmod, data, expect, n_blocks,
                 card) -> dict:
    """Phase 6's decodes, under decode_phase's spy."""
    from bzip2_tpu_torch import _build

    def clean(name, got, want):
        if got != want:
            raise AssertionError(f"{name}: decoded output or consumed length "
                                 "differs from the input")
        if dmod.ANOMALIES != {"lane": 0, "batch": 0}:
            raise AssertionError(f"{name}: host heals {dmod.ANOMALIES}")

    if bzip2_tpu_torch.decompress(expect) != data:   # warm-up
        raise AssertionError("warm-up decode differs from the input")
    dmod.reset_telemetry()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = bzip2_tpu_torch.decompress_with_tail(expect)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v.launches for k, v in _build.KERNELS.items()}
    share = dict(dmod.SHARE)
    clean("-9 stream", res, (data, len(expect)))
    if share != {"blocks": n_blocks, "dev_blocks": n_blocks}:
        raise AssertionError(f"device decoded {share['dev_blocks']} of "
                             f"{share['blocks']} blocks handed to it "
                             f"({n_blocks} in the stream)")
    if any(launches.get(k, 0) <= 0 for k in DECODE):
        raise AssertionError(f"decode kernels not launched: {launches}")
    mb = len(data) / 1e6
    print(f"phase 6: decoded {mb:.3f} MB from {len(expect)} bytes at "
          f"-{LEVEL}, {n_blocks} of {n_blocks} blocks on the device, "
          "exact, no host heal", flush=True)
    print(f"  wall {wall:.3f} s = {mb / wall:.3f} MB/s on {card}",
          flush=True)
    print("  stage walls (CUDA events): " + ", ".join(
        f"{k} {v:.4f} s" for k, v in dmod.STAGE_WALL.items()), flush=True)
    print("  launches: " + json.dumps(
        {k: launches[k] for k in DECODE}), flush=True)

    prefix = data[:2 << 20]
    s1 = bz2.compress(prefix, 1)
    dmod.reset_telemetry()
    clean("-1 prefix", bzip2_tpu_torch.decompress_with_tail(s1),
          (prefix, len(s1)))
    m1, m2 = bz2.compress(data[:1 << 20], 9), bz2.compress(
        data[1 << 20:3 << 20], 5)
    dmod.reset_telemetry()
    clean("two members + garbage", bzip2_tpu_torch.decompress_with_tail(
        m1 + m2 + b"trailing garbage", multi_stream=True),
        (data[:3 << 20], len(m1) + len(m2)))
    print(f"  -1 stream of {len(prefix)} bytes and a two-member stream "
          "with trailing garbage: exact, consumed lengths right, no host "
          "heal", flush=True)

    torch.cuda.reset_peak_memory_stats()
    out = []
    pwall, busy, by_name = profiled(
        torch, lambda: out.append(bzip2_tpu_torch.decompress(expect)))
    if out[0] != data:
        raise AssertionError("profiled decode differs from the input")
    total = sum(ms for ms, _ in by_name.values())
    print(f"  profiled decode wall {pwall:.1f} ms; device time {total:.1f} ms, "
          f"busy {busy:.1f} ms = {100 * busy / pwall:.1f}% of the wall; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print_profile(by_name, DECODE)
    return launches


def heap_steps(freq: np.ndarray, alpha: np.ndarray) -> list:
    """The dependent steps of each lane's heap build, as huffman_lengths.cu
    takes them on this data: one per insert, extraction and merge, one per
    level a key moves, over every attempt the halve-and-retry needs.
    Returns [(steps, attempts)] a lane.  The depth walks are not counted,
    so the count is a lower bound of the lane's serial chain."""
    out = []
    for row, a in zip(freq.tolist(), alpha.tolist()):
        a = min(max(int(a), 0), 258)
        leaf = [0] + [(f if f else 1) << 8 for f in row]
        steps = 0
        for attempt in range(25):
            weight = leaf[:a + 1] + [0] * a
            parent = [-1] * (2 * a + 1)
            heap = [0] * (a + 2)
            n, nodes = 0, a

            def up(zz, node):
                nonlocal steps
                w = weight[node]
                steps += 1
                while zz > 1 and w < weight[heap[zz >> 1]]:
                    heap[zz] = heap[zz >> 1]
                    zz >>= 1
                    steps += 1
                heap[zz] = node

            def pop():
                nonlocal n, steps
                top, tmp = heap[1], heap[n]
                n -= 1
                w, zz = weight[tmp], 1
                steps += 1
                while 2 * zz <= n:
                    yy = 2 * zz
                    if yy < n and weight[heap[yy + 1]] < weight[heap[yy]]:
                        yy += 1
                    if w < weight[heap[yy]]:
                        break
                    heap[zz] = heap[yy]
                    zz = yy
                    steps += 1
                heap[zz] = tmp
                return top

            for i in range(1, a + 1):
                n += 1
                up(n, i)
            while n > 1:
                n1, n2 = pop(), pop()
                nodes += 1
                parent[n1] = parent[n2] = nodes
                w1, w2 = weight[n1], weight[n2]
                weight[nodes] = (((w1 & ~0xFF) + (w2 & ~0xFF))
                                 | (1 + max(w1 & 0xFF, w2 & 0xFF)))
                n += 1
                up(n, nodes)
            too_long = False
            for i in range(1, a + 1):
                d, p = 0, parent[i]
                while p >= 0:
                    d, p = d + 1, parent[p]
                too_long |= d > 17
            if not too_long or attempt == 24:
                break
            leaf = [0] + [(1 + (w >> 8) // 2) << 8 for w in leaf[1:]]
        out.append((steps, attempt + 1))
    return out


def huffman_case(torch, name, hk, freq, alpha) -> dict:
    """The kernel against its plain version on (freq, alpha).  Its bound
    counts one 32-bit operation per heap step of this data (heap_steps);
    the longest lane's steps are the serial chain that limits it."""
    steps = heap_steps(freq.cpu().numpy(), alpha.cpu().numpy())
    total = sum(s for s, _ in steps)
    res = compare(torch, name, hk.make_code_lengths_lanes,
                  hk.make_code_lengths_lanes_plain, (freq, alpha), reps=1,
                  work=lambda args, out: (tensor_bytes(*args, *out), total))
    chain, tries = max(steps)
    print(f"    {name}: {total} heap steps over {len(steps)} lanes; longest "
          f"lane {chain} dependent steps in {tries} attempt(s), "
          f"{res['ms'] * 1e6 / chain:.1f} ns a step; attempts a lane "
          f"{min(t for _, t in steps)}-{max(t for _, t in steps)}", flush=True)
    return res


def mtf_input(torch, last, nt, ut):
    """The tiled MTF input of a batch's BWT output, exactly as
    mtf_rle2_batched builds it."""
    from bzip2_tpu_torch.ops import mtf_kernel as mk
    pos = torch.arange(last.shape[1], device=last.device)
    valid = pos[None, :] < nt[:, None]
    ui = ut.to(torch.int32)
    remap = torch.cumsum(ui, 1, dtype=torch.int32) - ui
    seq = torch.where(valid, torch.gather(remap, 1, last.to(torch.int64)), 0)
    seqm = torch.where(valid, seq, mk.PAD_SYM)
    return seqm.reshape(-1, mk.PTILE).contiguous()


def huffman_lanes(torch, bt, nt, ut) -> tuple:
    """(freq, alpha) of a batch's first refinement pass: 6 lanes a block."""
    from bzip2_tpu_torch.engine import encode_pre
    from bzip2_tpu_torch.ops.groupsearch import group_iter
    pre = encode_pre(bt, nt, ut)
    _, freq6 = group_iter(pre[6], pre[5], pre[7])
    freq = freq6.reshape(-1, 258).contiguous()
    alpha = (pre[2] + 2).repeat_interleave(6).to(torch.int32).contiguous()
    return freq, alpha


def mesh_shape_pass(torch, blocks, rows: int) -> None:
    """Phase 3 at a mesh batch: the first ``rows`` -9 blocks of the corpus
    in one batch, as encode_blocks_sharded hands an entry or a rank its
    shard (19 on the one-entry mesh, 10 on the first of two entries).  Each
    encode kernel after the sort is held exactly against its plain version
    on the inputs the fused encoder gives it."""
    from bzip2_tpu_torch import engine
    from bzip2_tpu_torch.ops import huffman as hk
    from bzip2_tpu_torch.ops import mtf_kernel as mk
    from bzip2_tpu_torch.ops.bwt import bwt_batched
    from bzip2_tpu_torch.ops.mtf import mtf_rle2_batched
    dev = torch.device("cuda")
    arr, ns, uses, _ = engine.batch_arrays(
        blocks[:rows], rows, engine._block_pad_size(LEVEL))
    bt, nt, ut = engine.stage_from_numpy((arr, ns, uses), dev)
    last, _, _ = bwt_batched(bt, nt)
    seqm = mtf_input(torch, last, nt, ut)
    T = seqm.shape[0] // rows
    tl, = exact(torch, "mtf_tile_last", mk.tile_last, mk.tile_last_plain,
                (seqm, T))
    lx = mk.carries(tl, rows).contiguous()
    exact(torch, "mtf_rank", mk.rank, mk.rank_plain, (seqm, lx))
    mtfv, n_mtf, _ = mtf_rle2_batched(last, nt, ut)
    exact(torch, "group_hist", mk.group_hist, mk.group_hist_plain,
          (mtfv.contiguous(), n_mtf.contiguous()))
    shapes = [seqm.shape, mtfv.shape]
    del last, seqm, tl, lx, mtfv, n_mtf
    freq, alpha = huffman_lanes(torch, bt, nt, ut)
    exact(torch, "huffman_lengths", hk.make_code_lengths_lanes,
          hk.make_code_lengths_lanes_plain, (freq, alpha))
    shapes.append(freq.shape)
    tiles, hist, lanes = ("x".join(map(str, sh)) for sh in shapes)
    print(f"  mesh batch of {rows} blocks: mtf_tile_last and mtf_rank "
          f"{tiles}, group_hist {hist}, huffman_lengths {lanes}: each exact "
          "vs plain", flush=True)


def huffman_pass(torch, rng, bt, nt, ut, old=()) -> dict:
    """Phase 3, the Huffman-length kernel: the 78 lanes (13 blocks x 6
    tables) of the first -9 batch's first refinement pass, then skewed
    lanes that halve and retry; each exact against the plain version, and
    timed beside the hybrid path's host heap on the same lanes.  ``old``
    lists (library, path) of earlier designs to time on both sets."""
    from bzip2_tpu_torch import native
    from bzip2_tpu_torch.ops import huffman as hk
    freq, alpha = huffman_lanes(torch, bt, nt, ut)
    res = huffman_case(torch, "huffman_lengths", hk, freq, alpha)

    def host_heap_ms(f, a):
        f_np, a_np = f.cpu().numpy(), a.cpu().numpy()
        lens = native.make_code_lengths_batch(f_np, a_np)
        t0 = time.perf_counter()
        for _ in range(5):
            native.make_code_lengths_batch(f_np, a_np)
        ms = (time.perf_counter() - t0) * 1e3 / 5
        got = hk.make_code_lengths_lanes(f, a).cpu().numpy()
        leaf = np.arange(258)[None, :] < a_np[:, None]
        if not np.array_equal(np.where(leaf, got, 0), lens):
            raise AssertionError("huffman_lengths: leaves differ from the "
                                 "host heap")
        return ms

    print(f"  host heap (native.make_code_lengths_batch, host clock) "
          f"{host_heap_ms(freq, alpha):.4f} ms on the same lanes; leaves "
          "equal", flush=True)
    L = freq.shape[0]
    # frequency sums below 2^23, as a block's are: the packed keys fit int32
    sk_alpha = rng.integers(5, 25, L).astype(np.int32)
    sk_freq = np.zeros((L, 258), np.int32)
    for i, a in enumerate(sk_alpha):
        sk_freq[i, :a] = (2 ** np.minimum(np.arange(a), 19)).astype(np.int32)
    sf = torch.from_numpy(sk_freq).to(freq.device)
    sa = torch.from_numpy(sk_alpha).to(freq.device)
    huffman_case(torch, "huffman skew", hk, sf, sa)
    print(f"  host heap on the skewed lanes {host_heap_ms(sf, sa):.4f} ms",
          flush=True)
    for lib, path in old:
        old_huffman_pass(torch, lib, path, [("the 78 lanes", freq, alpha),
                                            ("the skewed lanes", sf, sa)])
    return res


def _timed_compress(torch, data, kw) -> tuple:
    """One bzip2_tpu_torch.compress(data, 9, **kw) with the launch counts
    and engine telemetry reset just before it; returns (stream, wall s,
    launches, SHARE, STAGE_WALL)."""
    import bzip2_tpu_torch
    from bzip2_tpu_torch import _build, engine
    engine.reset_telemetry()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = bzip2_tpu_torch.compress(data, LEVEL, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (out, wall, {k: v.launches for k, v in _build.KERNELS.items()},
            dict(engine.SHARE), dict(engine.STAGE_WALL))


def _check_stream(name, out, expect, data) -> None:
    if out != expect:
        raise AssertionError(f"{name}: stream differs from bz2.compress")
    if bz2.decompress(out) != data:
        raise AssertionError(f"{name}: stream does not round-trip")


def fused_phase(torch, data: bytes, expect: bytes, n_blocks: int,
                card: str) -> int:
    """Phase 7: the fused mode after one warm-up.  Returns the
    Huffman-length kernel's launches in the timed run."""
    import bzip2_tpu_torch
    from bzip2_tpu_torch import engine
    kw = {"mode": "fused", "host_workers": 0}
    _check_stream("fused warm-up", bzip2_tpu_torch.compress(data, LEVEL, **kw),
                  expect, data)
    out, wall, launches, share, stages = _timed_compress(torch, data, kw)
    _check_stream("fused", out, expect, data)
    batches = -(-n_blocks // engine.Engine(device="cuda")._batch_size_for(
        LEVEL))
    if share != {"blocks": n_blocks, "dev_blocks": n_blocks,
                 "host_blocks": 0, "declines": 0}:
        raise AssertionError(f"fused: block share {share}")
    if launches["huffman_lengths"] != 4 * batches:
        raise AssertionError(f"fused: huffman_lengths launched "
                             f"{launches['huffman_lengths']} times, not "
                             f"4 x {batches} batches")
    missing = [k for k in FUSED if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"fused: kernels not launched: {missing}")
    mb = len(data) / 1e6
    print(f"phase 7: fused, {mb:.3f} MB at -{LEVEL}, {n_blocks} of {n_blocks} "
          f"blocks on the device in {batches} batches, bit-exact vs bz2 and "
          "round-tripped", flush=True)
    print(f"  wall {wall:.3f} s = {mb / wall:.3f} MB/s on {card}", flush=True)
    print("  stage walls: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in stages.items()), flush=True)
    print("  launches: " + json.dumps({k: launches[k] for k in FUSED}),
          flush=True)
    _profile_compress(torch, "fused", data, expect, kw, FUSED)
    return launches["huffman_lengths"]


def _profile_compress(torch, name, data, expect, kw, kernels) -> None:
    """One more compress(data, 9, **kw) under torch.profiler: the device's
    busy share, the ops that take its time, each hand kernel's time."""
    import bzip2_tpu_torch
    out = []
    torch.cuda.reset_peak_memory_stats()
    wall, busy, by_name = profiled(
        torch, lambda: out.append(bzip2_tpu_torch.compress(data, LEVEL, **kw)))
    _check_stream(f"profiled {name}", out[0], expect, data)
    total = sum(ms for ms, _ in by_name.values())
    print(f"  profiled {name} run: wall {wall:.1f} ms; device time "
          f"{total:.1f} ms, busy {busy:.1f} ms = {100 * busy / wall:.1f}% of "
          f"the wall; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print_profile(by_name, kernels)


def scheduler_phase(torch, data: bytes, expect: bytes, n_blocks: int,
                    card: str) -> None:
    """Phase 8: the scheduler's settings beside phase 4's and phase 7's,
    each warmed up once, then timed in turns for ROUNDS rounds (host-clock
    walls spread between runs, so only runs in turns compare); then the
    default setting under torch.profiler."""
    import bzip2_tpu_torch
    runs = [("hybrid pipeline=1 host_workers=0", HYBRID),
            ("fused pipeline=2 host_workers=0",
             {"mode": "fused", "host_workers": 0}),
            ("hybrid pipeline=2 host_workers=0",
             {"pipeline": 2, "host_workers": 0}),
            ("defaults (hybrid pipeline=2 host_workers=1)", {}),
            ("use_device=False", {"use_device": False})]
    mb = len(data) / 1e6
    print(f"phase 8: scheduler, {mb:.3f} MB at -{LEVEL}, {n_blocks} blocks, "
          f"{ROUNDS} rounds in turns, on {card}", flush=True)
    for name, kw in runs:
        _check_stream(f"{name} warm-up",
                      bzip2_tpu_torch.compress(data, LEVEL, **kw), expect, data)
    walls = {name: [] for name, _ in runs}
    for r in range(ROUNDS):
        for name, kw in runs:
            out, wall, launches, share, stages = _timed_compress(torch, data,
                                                                 kw)
            _check_stream(name, out, expect, data)
            if (share["blocks"] != n_blocks
                    or share["dev_blocks"] + share["host_blocks"] != n_blocks):
                raise AssertionError(f"{name}: block share {share}")
            if kw.get("use_device", True):
                missing = [k for k in ENCODE if launches.get(k, 0) <= 0]
                if share["dev_blocks"] < 1 or missing:
                    raise AssertionError(f"{name}: device blocks "
                                         f"{share['dev_blocks']}, kernels "
                                         f"not launched {missing}")
            elif any(launches.values()):
                raise AssertionError(f"{name}: kernels launched {launches}")
            walls[name].append(wall)
            print(f"  round {r + 1} {name}: wall {wall:.3f} s; device "
                  f"{share['dev_blocks']} + host {share['host_blocks']} "
                  f"blocks, {share['declines']} declines; stage walls "
                  + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()),
                  flush=True)
    for name, w in walls.items():
        med = float(np.median(w))
        print(f"  {name}: median wall {med:.3f} s = {mb / med:.3f} MB/s "
              f"(runs {', '.join(f'{x:.3f}' for x in w)})", flush=True)
    _profile_compress(torch, "default", data, expect, {}, ENCODE)


def tile_last_library(torch, seqm, T: int):
    """The library call for mtf_tile_last: one scatter_reduce_ "amax" of
    each position's row index into its (next tile, symbol) slot of a
    buffer set up once with the seeds and -2^30, pads and the last tile's
    positions sent to a spare slot.  Checked equal to the kernel once."""
    from bzip2_tpu_torch.ops import mtf_kernel as mk
    rows = seqm.shape[0]
    dev = seqm.device
    tile = torch.arange(rows, device=dev)[:, None] % T
    pos = (tile * mk.PTILE + torch.arange(mk.PTILE, device=dev)[None, :])
    keep = (seqm < 256) & (tile < T - 1)
    idx = torch.where(keep, (torch.arange(rows, device=dev)[:, None] + 1) * 256
                      + seqm.to(torch.int64), rows * 256).reshape(-1)
    val = pos.to(torch.int32).reshape(-1)
    init = torch.full((rows * 256 + 1,), -(1 << 30), dtype=torch.int32,
                      device=dev)
    init[:rows * 256].view(rows // T, T, 256)[:, 0] = -(torch.arange(
        256, dtype=torch.int32, device=dev) + 1)
    out = init.clone()

    def call():
        out.scatter_reduce_(0, idx, val, "amax")

    call()
    if not torch.equal(out[:-1].view(rows, 256), mk.tile_last(seqm, T)):
        raise AssertionError("tile_last library call differs from the kernel")
    return call


def group_hist_library(torch, mtfv, n_mtf, g_size: int = 50):
    """The library call for group_hist: one torch.bincount of the
    flattened (row, group, symbol) index, positions past n_mtf and symbols
    outside 0..257 sent to a spare bin.  Checked equal to the kernel once."""
    from bzip2_tpu_torch.ops import mtf_kernel as mk
    B, M = mtfv.shape
    G = -(-M // g_size)
    m = torch.arange(M, device=mtfv.device)[None, :]
    ok = (m < n_mtf[:, None]) & (mtfv >= 0) & (mtfv < mk.ALPHA)
    idx = torch.where(ok, (torch.arange(B, device=mtfv.device)[:, None] * G
                           + m // g_size) * mk.ALPHA + mtfv.to(torch.int64),
                      B * G * mk.ALPHA).reshape(-1)
    n_bins = B * G * mk.ALPHA + 1

    def call():
        return torch.bincount(idx, minlength=n_bins)

    got = call()[:-1].view(B, G, mk.ALPHA)
    if not torch.equal(got.to(torch.int32),
                       mk.group_hist(mtfv.contiguous(), n_mtf.contiguous())):
        raise AssertionError("group_hist library call differs from the kernel")
    return call


def start_probe_build(path: str, stem: str) -> tuple:
    """Start nvcc on one probe source into build/probe/, keyed by the
    source's hash, beside the kernels' build.  Returns (library path, the
    nvcc process or None when the library is already there)."""
    import hashlib

    from bzip2_tpu_torch import _build
    with open(path, "rb") as fh:
        tag = hashlib.sha256(fh.read()).hexdigest()[:12]
    so = os.path.join(PROBE_DIR, f"lib{stem}_{tag}.so")
    if os.path.exists(so):
        return so, None
    os.makedirs(PROBE_DIR, exist_ok=True)
    return so, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", _build.CSRC,
         "-o", so, path], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def probe_lib(build: tuple):
    """Wait for a probe build and load it."""
    import ctypes as ct
    so, proc = build
    if proc is not None:
        _, err = proc.communicate()
        if proc.returncode:
            raise AssertionError(f"nvcc failed on {so}:\n{err}")
    return ct.CDLL(so)


def chase_probe_source() -> str:
    """CHASE_PROBE written to build/probe/chase_probe.cu."""
    path = os.path.join(PROBE_DIR, "chase_probe.cu")
    os.makedirs(PROBE_DIR, exist_ok=True)
    with open(path, "w") as fh:
        fh.write(CHASE_PROBE)
    return path


def cuda_ms_each(torch, fn, reps: int, prep) -> float:
    """Mean device time of fn over reps launches timed one by one, each
    after an untimed prep(), after one warm-up."""
    fn()
    total = 0.0
    for _ in range(reps):
        prep()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / reps


def in_turns(torch, old, new, reps: int, prep=None) -> tuple:
    """CUDA-event means of old, new, new, old (each call after an untimed
    prep() when given); returns them and the speed-up of new over old."""
    ms = (lambda f: cuda_ms(torch, f, reps)) if prep is None else (
        lambda f: cuda_ms_each(torch, f, reps, prep))
    t = (ms(old), ms(new), ms(new), ms(old))
    return t, (t[0] + t[3]) / (t[1] + t[2])


def chase_pass(torch, lib, rng, n: int = 900_000) -> dict:
    """Phase 3: ns a dependent load for one thread chasing a random
    single-cycle permutation of n int32 entries (a -9 row of tt) from L2
    and from a cluster's distributed shared memory, and of 8 n entries (a
    batch's tt) from L2: the difference of two runs of CHASE_STEPS steps
    over the step difference."""
    import ctypes as ct

    from bzip2_tpu_torch import _build

    def cycle(size):
        order = rng.permutation(size)
        nxt = np.empty(size, np.int32)
        nxt[order] = np.roll(order, -1)
        return order, torch.from_numpy(nxt).cuda()

    row, batch = cycle(n), cycle(8 * n)
    out = torch.empty(1, dtype=torch.int32, device=row[1].device)
    stream = _build.stream_of(out)
    lib.probe_chase_global.argtypes = [ct.c_void_p, ct.c_int, ct.c_int,
                                       ct.c_void_p, ct.c_void_p]
    lib.probe_chase_cluster.argtypes = [ct.c_void_p, ct.c_int, ct.c_int,
                                        ct.c_int, ct.c_void_p, ct.c_void_p]

    def cluster(table, k, start, o, st):
        return lib.probe_chase_cluster(table, n, k, start, o, st)

    ns = {}
    for name, (order, table), fn in [("L2", row, lib.probe_chase_global),
                                     ("DSMEM", row, cluster),
                                     ("L2, 8 rows", batch,
                                      lib.probe_chase_global)]:
        int(table.sum())            # the table into L2

        def run(k):
            return fn(table.data_ptr(), k, int(order[0]), out.data_ptr(),
                      stream)

        ms = []
        for k in CHASE_STEPS:
            if run(k):
                raise AssertionError(f"chase probe {name} did not launch")
            torch.cuda.synchronize()
            if int(out.item()) != int(order[k % order.size]):
                raise AssertionError(f"chase probe {name} ended off the cycle")
            ms.append(cuda_ms(torch, lambda: run(k), 3))
        ns[name] = (ms[1] - ms[0]) * 1e6 / (CHASE_STEPS[1] - CHASE_STEPS[0])
    occ = (ct.c_int * 3)()
    lib.probe_cluster_occupancy.argtypes = [ct.c_int, ct.c_void_p]
    if lib.probe_cluster_occupancy(n, occ):
        raise AssertionError("cluster occupancy query failed")
    print(f"  chase probe, one thread over a {n * 4} B table: L2 "
          f"{ns['L2']:.1f} ns a step, cluster shared memory "
          f"{ns['DSMEM']:.1f} ns a step; over {8 * n * 4} B (a batch's "
          f"tt) from L2 {ns['L2, 8 rows']:.1f} ns a step; clusters of "
          f"{occ[0]} CTAs with {occ[1]} B each: "
          f"cudaOccupancyMaxActiveClusters {occ[2]}", flush=True)
    return ns


def old_huffman_pass(torch, lib, path, cases) -> None:
    """Phase 3 with --old-huffman: an earlier huffman_lengths.cu (same C
    entry point) on each (name, freq, alpha) case, held against the current
    kernel's output, then timed in turns."""
    import ctypes as ct

    from bzip2_tpu_torch import _build
    from bzip2_tpu_torch.ops import huffman as hk
    fn = lib.bz2t_huffman_lengths
    fn.argtypes = [ct.c_void_p] * 3 + [ct.c_int, ct.c_void_p]
    for name, freq, alpha in cases:
        out = torch.empty_like(freq)

        def old():
            if fn(freq.data_ptr(), alpha.data_ptr(), out.data_ptr(),
                  freq.shape[0], _build.stream_of(freq)):
                raise AssertionError("old huffman_lengths did not launch")

        old()
        if not torch.equal(out, hk.make_code_lengths_lanes(freq, alpha)):
            raise AssertionError(f"{name}: the old huffman_lengths disagrees "
                                 "with the current one")
        t, speedup = in_turns(
            torch, old, lambda: hk.make_code_lengths_lanes(freq, alpha), 5)
        print(f"  old design {os.path.basename(path)} on {name}: old "
              f"{t[0]:.4f}, new {t[1]:.4f}, new {t[2]:.4f}, old {t[3]:.4f} ms;"
              f" new {speedup:.2f}x faster, outputs equal", flush=True)


def old_walk_pass(torch, lib, path, waves) -> None:
    """Phase 3 with --old-walk: an earlier ibwt_walk.cu (same C entry point)
    on the recorded waves, held against the current kernel's outputs, then
    both timed in turns as their wrappers run them: a design that leaves
    the buffer's zero tail to its caller (found by handing it a buffer of
    0xFF) is timed with the zero fill its wrapper did."""
    import ctypes as ct

    from bzip2_tpu_torch import _build
    from bzip2_tpu_torch.ops import ibwt_kernel as ik
    fn = lib.bz2t_ibwt_walk
    fn.argtypes = [ct.c_void_p] * 6 + [ct.c_int] * 4 + [ct.c_void_p]
    for i, (tt, cur0, cap) in enumerate(waves):
        B, N = tt.shape
        W = cur0.shape[1]
        outs = [torch.empty_like(cur0) for _ in range(3)]
        buf = torch.full((B, W, cap), 0xFF, dtype=torch.uint8,
                         device=tt.device)

        def kernel():
            if fn(tt.data_ptr(), cur0.data_ptr(),
                  *(o.data_ptr() for o in outs), buf.data_ptr(), B, N, W, cap,
                  _build.stream_of(tt)):
                raise AssertionError("old ibwt_walk did not launch")

        kernel()
        got = ik.ibwt_walk(tt, cur0, cap)
        needs_fill = not torch.equal(buf, got[3])
        if needs_fill:
            buf.zero_()
            kernel()

            def old():
                buf.zero_()
                kernel()
        else:
            old = kernel
        if not all(torch.equal(a, b) for a, b in zip((*outs, buf), got)):
            raise AssertionError(f"wave {i + 1}: the old ibwt_walk disagrees "
                                 "with the current one")
        fill = " (with its zero fill)" if needs_fill else ""
        # back to back, each call finds tt as the last one's writes left
        # it; then tt read into L2 before each call, as the decoder's
        # batch finds it, freshly built
        for how, prep in (("back to back", None),
                          ("tt in L2", lambda: tt.sum())):
            t, speedup = in_turns(
                torch, old, lambda: ik.ibwt_walk(tt, cur0, cap), 3, prep)
            print(f"  old design {os.path.basename(path)} on wave {i + 1}"
                  f"{fill}, {how}: old {t[0]:.4f}, new {t[1]:.4f}, new "
                  f"{t[2]:.4f}, old {t[3]:.4f} ms; new {speedup:.2f}x "
                  "faster, outputs equal", flush=True)


def _child_gate(name: str, mode: str, stream: bytes) -> tuple:
    """Run NATIVE_DECODE's ``mode`` in a child process with ``stream`` on
    its stdin and the runtime phase 2 built; a crash fails the run with its
    signal.  Returns (the child's last line as JSON, wall seconds with the
    child's start)."""
    import signal
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", NATIVE_DECODE, HERE, mode],
                       input=stream, capture_output=True, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode < 0:
        raise AssertionError(
            f"{name} died with {signal.Signals(-r.returncode).name} on the "
            f"-{LEVEL} stream:\n" + r.stderr.decode(errors="replace")[-2000:])
    if r.returncode:
        raise AssertionError(f"{name} child failed:\n"
                             + r.stderr.decode(errors="replace")[-2000:])
    return json.loads(r.stdout.decode().strip().splitlines()[-1]), wall


def native_decode_gate(data: bytes, expect: bytes, n_blocks: int) -> None:
    """Phase 6b: native.decode_some over the whole -9 stream, in NATIVE_RUNS
    child processes: each must return every block's bytes exactly.  Phase
    6c: the same for native.decompress, the host api.decompress's
    whole-stream decoder, with the consumed length exact."""
    import hashlib
    sha = hashlib.sha256(data).hexdigest()

    def runs(name, mode, want, extra=lambda res: True):
        out = []
        for _ in range(NATIVE_RUNS):
            res, wall = _child_gate(name, mode, expect)
            if {k: res[k] for k in want} != want or not extra(res):
                raise AssertionError(f"{name} on the -9 stream: {res}")
            out.append((res["seconds"], wall))
        dec, wall = (sorted(x) for x in zip(*out))
        return (f"decode {dec[0]:.3f}-{dec[-1]:.3f} s, {wall[0]:.3f}-"
                f"{wall[-1]:.3f} s with the child's start (host clock)"), dec

    said, _ = runs("native.decode_some", "some",
                   {"rc": 0, "status": 1, "level": LEVEL, "bytes": len(data),
                    "sha256": sha},
                   lambda res: (res["next_bit"] + 7) // 8 == len(expect))
    print(f"phase 6b: native.decode_some decoded the whole -{LEVEL} stream "
          f"({n_blocks} blocks, {len(expect)} bytes) in each of {NATIVE_RUNS} "
          f"child processes: {len(data)} bytes exact, consumed to the end; "
          f"{said}", flush=True)
    said, dec = runs("native.decompress", "whole",
                     {"rc": 0, "consumed": len(expect), "bytes": len(data),
                      "sha256": sha})
    print(f"phase 6c: native.decompress decoded the whole -{LEVEL} stream "
          f"in each of {NATIVE_RUNS} child processes: {len(data)} bytes "
          f"exact, consumed {len(expect)} of {len(expect)}; {said}; "
          f"{len(data) / 1e6 / dec[len(dec) // 2]:.3f} MB/s at the median",
          flush=True)


def old_mtf_pass(torch, lib, path, seqm, tl, lx, B) -> None:
    """Phase 3 with --old-mtf: the first design's mtf_ranks.cu (its
    bz2t_mtf_tile_last writes (rows, 256) int16 in-tile indices, -1 where a
    symbol is absent; its bz2t_mtf_rank takes the current arguments) on the
    current kernels' batch.  Both old kernels are held against the current
    outputs, then timed in turns: old, current, current, old."""
    import ctypes as ct

    from bzip2_tpu_torch import _build
    from bzip2_tpu_torch.ops import mtf_kernel as mk
    lib.bz2t_mtf_tile_last.argtypes = [ct.c_void_p] * 2 + [ct.c_int64,
                                                           ct.c_void_p]
    lib.bz2t_mtf_rank.argtypes = [ct.c_void_p] * 3 + [ct.c_int64, ct.c_void_p]
    rows = seqm.shape[0]
    l16 = torch.empty((rows, mk.PTILE), dtype=torch.int16, device=seqm.device)
    out = torch.empty_like(seqm)
    stream = _build.stream_of(seqm)

    def old_last():
        if lib.bz2t_mtf_tile_last(seqm.data_ptr(), l16.data_ptr(), rows,
                                  stream):
            raise AssertionError("old tile_last did not launch")

    def old_rank():
        if lib.bz2t_mtf_rank(seqm.data_ptr(), lx.data_ptr(), out.data_ptr(),
                             rows, stream):
            raise AssertionError("old rank did not launch")

    old_last()
    old_rank()
    l3 = l16.reshape(B, -1, mk.PTILE).to(torch.int32)[:, :-1]
    base = (torch.arange(l3.shape[1], dtype=torch.int32, device=seqm.device)
            * mk.PTILE)[None, :, None]
    if not torch.equal(torch.where(l3 >= 0, base + l3, -(1 << 30)),
                       tl.reshape(B, -1, mk.PTILE)[:, 1:]):
        raise AssertionError("old tile_last disagrees with the current one")
    if not torch.equal(out, mk.rank(seqm, lx)):
        raise AssertionError("old rank disagrees with the current one")
    T = rows // B
    t = {"tile_last old": cuda_ms(torch, old_last, 5),
         "tile_last new": cuda_ms(torch, lambda: mk.tile_last(seqm, T), 5),
         "rank old": cuda_ms(torch, old_rank, 5),
         "rank new": cuda_ms(torch, lambda: mk.rank(seqm, lx), 5),
         "rank new 2": cuda_ms(torch, lambda: mk.rank(seqm, lx), 5),
         "rank old 2": cuda_ms(torch, old_rank, 5)}
    speedup = (t["rank old"] + t["rank old 2"]) / (t["rank new"]
                                                   + t["rank new 2"])
    print(f"  old design {os.path.basename(path)}: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in t.items())
        + f"; rank {speedup:.2f}x faster; rank-0 share "
        f"{float((out == 0).float().mean()):.4f}", flush=True)


def _port_cmd(args: list, name: str, stdin=None, timeout=600) -> tuple:
    """``python -m`` the port's ``args`` in a child process from the
    checkout; a crash fails the run with its signal.  Returns (exit code,
    stdout bytes, stderr text, wall seconds with the child's start)."""
    import signal
    env = dict(os.environ, PYTHONPATH=HERE)
    env.pop("BZIP2", None)
    env.pop("BZIP", None)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", *args], cwd=HERE, env=env,
                       input=stdin, capture_output=True, timeout=timeout)
    wall = time.perf_counter() - t0
    err = r.stderr.decode(errors="replace")
    if r.returncode < 0:
        raise AssertionError(f"{name} died with "
                             f"{signal.Signals(-r.returncode).name}:\n"
                             + err[-2000:])
    return r.returncode, r.stdout, err, wall


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def surfaces_phase(torch, data: bytes, expect: bytes, blocks: list,
                   card: str) -> dict:
    """Phase 9: the user surfaces on the corpus, written to a file under
    build/smoke/.  The CLI (python -m bzip2_tpu_torch.cli) compresses it at
    -9 in a child process and in process (with an engine of no host worker
    registered as "gpu" first, so that every block goes to the card, and
    the blocks of each encode_payloads call counted), decodes it on the
    card in child processes (-d -c, -t) and in process, and on the host
    (--backend=native, a child); BZ2File writes and reads it on the
    defaults; recover salvages the 18 good blocks of a copy damaged in
    block 5; --backend=bogus exits 3 and leaves no output.  Returns the
    launch counts of the in-process encode and decode."""
    import shutil

    import bzip2_tpu_torch
    from bzip2_tpu_torch import _build, api, cli, engine
    from bzip2_tpu_torch import decoder as dmod
    from bzip2_tpu_torch.constants import BLOCK_MAGIC
    from bzip2_tpu_torch.parallel.decode import find_bit_magics
    n_blocks = len(blocks)
    mb = len(data) / 1e6
    shutil.rmtree(SURFACE_DIR, ignore_errors=True)
    os.makedirs(SURFACE_DIR)
    src = os.path.join(SURFACE_DIR, "corpus")
    with open(src, "wb") as fh:
        fh.write(data)
    print(f"phase 9: the surfaces on {mb:.3f} MB at -{LEVEL} "
          f"({os.path.relpath(src, HERE)}), on {card}", flush=True)

    # 1. the CLI in a child process, on its defaults
    rc, _, err, wall = _port_cmd(["bzip2_tpu_torch.cli", "-zkf", f"-{LEVEL}",
                                  src], "bz2t -z")
    if rc:
        raise AssertionError(f"bz2t -zkf -{LEVEL}: exit {rc}\n{err[-2000:]}")
    if _read(src + ".bz2") != expect:
        raise AssertionError(f"bz2t -zkf -{LEVEL}: stream differs from "
                             "bz2.compress")
    print(f"  bz2t -zkf -{LEVEL} (child, defaults): bit-exact vs bz2; wall "
          f"{wall:.3f} s with the child's start", flush=True)

    # 2. the CLI in process, every block on the card, blocks a call counted
    calls = []
    eng = engine.engine_for(host_workers=0)

    def counted(blks, level):
        calls.append(len(blks))
        return eng.encode_payloads(blks, level)

    api.register_block_encoder("gpu", counted)
    os.unlink(src + ".bz2")
    engine.reset_telemetry()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["-zkf", f"-{LEVEL}", src])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    enc_launches = {k: v.launches for k, v in _build.KERNELS.items()}
    share = dict(engine.SHARE)
    if rc or _read(src + ".bz2") != expect:
        raise AssertionError(f"cli.main -zkf -{LEVEL}: exit {rc} or stream "
                             "differs from bz2.compress")
    if share != {"blocks": n_blocks, "dev_blocks": n_blocks,
                 "host_blocks": 0, "declines": 0}:
        raise AssertionError(f"cli.main encode: block share {share}")
    missing = [k for k in ENCODE if enc_launches.get(k, 0) <= 0]
    if missing or sum(calls) != n_blocks:
        raise AssertionError(f"cli.main encode: kernels not launched "
                             f"{missing}, blocks a call {calls}")
    print(f"  cli.main -zkf -{LEVEL} (in process, host_workers=0): bit-exact, "
          f"{n_blocks} of {n_blocks} blocks on the card; wall {wall:.3f} s = "
          f"{mb / wall:.3f} MB/s; {len(calls)} encode_payloads calls "
          f"carrying {calls} blocks", flush=True)
    print("  launches: " + json.dumps({k: enc_launches[k] for k in ENCODE}),
          flush=True)
    engine.register_backend()        # the defaults again for BZ2File below

    # 3. decode on the card: -d -c and -t in child processes, then in process
    comp = src + ".bz2"
    rc, out, err, wall = _port_cmd(["bzip2_tpu_torch.cli", "-d", "-c", comp],
                                   "bz2t -d -c")
    if rc or out != data:
        raise AssertionError(f"bz2t -d -c: exit {rc}, output "
                             f"{'exact' if out == data else 'differs'}\n"
                             + err[-2000:])
    rc, _, err, twall = _port_cmd(["bzip2_tpu_torch.cli", "-t", comp],
                                  "bz2t -t")
    if rc:
        raise AssertionError(f"bz2t -t: exit {rc}\n{err[-2000:]}")
    print(f"  bz2t -d -c (child, the card): exact, wall {wall:.3f} s; bz2t -t: "
          f"exit 0, wall {twall:.3f} s (with the child's start)", flush=True)
    d9 = os.path.join(SURFACE_DIR, "d9")
    shutil.copyfile(comp, d9 + ".bz2")
    dmod.reset_telemetry()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["-dkf", d9 + ".bz2"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dec_launches = {k: v.launches for k, v in _build.KERNELS.items()}
    if rc or _read(d9) != data:
        raise AssertionError(f"cli.main -dkf: exit {rc} or output differs")
    if (dict(dmod.SHARE) != {"blocks": n_blocks, "dev_blocks": n_blocks}
            or dmod.ANOMALIES != {"lane": 0, "batch": 0}
            or any(dec_launches.get(k, 0) <= 0 for k in DECODE)):
        raise AssertionError(f"cli.main decode: share {dmod.SHARE}, heals "
                             f"{dmod.ANOMALIES}, launches {dec_launches}")
    print(f"  cli.main -dkf (in process, the card): exact, {n_blocks} of "
          f"{n_blocks} blocks on the card, no host heal; wall {wall:.3f} s = "
          f"{mb / wall:.3f} MB/s; launches " + json.dumps(
              {k: dec_launches[k] for k in DECODE}), flush=True)

    # 4. decode on the host, in a child process
    rc, out, err, wall = _port_cmd(["bzip2_tpu_torch.cli", "--backend=native",
                                    "-d", "-c", comp], "bz2t --backend=native")
    if rc or out != data:
        raise AssertionError(f"bz2t --backend=native -d -c: exit {rc}\n"
                             + err[-2000:])
    print(f"  bz2t --backend=native -d -c (child, the host's parallel "
          f"decode): exact, wall {wall:.3f} s with the child's start",
          flush=True)

    # 5. BZ2File on the defaults
    path = os.path.join(SURFACE_DIR, "file.bz2")
    engine.reset_telemetry()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with bzip2_tpu_torch.BZ2File(path, "wb", compresslevel=LEVEL) as fh:
        for i in range(0, len(data), 1 << 20):
            fh.write(data[i:i + (1 << 20)])
    torch.cuda.synchronize()
    wwall = time.perf_counter() - t0
    share = dict(engine.SHARE)
    launched = sum(_build.KERNELS[k].launches > 0 for k in ENCODE)
    t0 = time.perf_counter()
    with bzip2_tpu_torch.BZ2File(path) as fh:
        back = fh.read()
    rwall = time.perf_counter() - t0
    if _read(path) != expect or back != data:
        raise AssertionError("BZ2File: written stream or read bytes differ")
    if share["blocks"] != n_blocks or (share["dev_blocks"]
                                       + share["host_blocks"]) != n_blocks:
        raise AssertionError(f"BZ2File write: block share {share}")
    print(f"  BZ2File write (defaults): bit-exact, wall {wwall:.3f} s; device "
          f"{share['dev_blocks']} + host {share['host_blocks']} blocks, "
          f"{share['declines']} declines, {launched} of {len(ENCODE)} encode "
          f"kernels launched; read (native.decode_some): exact, wall "
          f"{rwall:.3f} s", flush=True)

    # 6. recover a copy with one byte flipped in block 5
    rec_dir = os.path.join(SURFACE_DIR, "rec")
    os.makedirs(rec_dir)
    starts = [int(o) for o in find_bit_magics(expect, BLOCK_MAGIC)]
    if len(starts) != n_blocks:
        raise AssertionError(f"{len(starts)} block magics in the stream")
    bad = bytearray(expect)
    bad[(starts[4] + starts[5]) // 16] ^= 0x55
    dmg = os.path.join(rec_dir, "dmg.bz2")
    with open(dmg, "wb") as fh:
        fh.write(bytes(bad))
    rc, _, err, wall = _port_cmd(["bzip2_tpu_torch.recover", dmg],
                                 "bz2t-recover")
    recs = sorted(f for f in os.listdir(rec_dir) if f.startswith("rec"))
    got = b"".join(bz2.decompress(_read(os.path.join(rec_dir, f)))
                   for f in recs)
    lo, hi = blocks[4].raw_span
    if rc or len(recs) != n_blocks - 1 or got != data[:lo] + data[hi:]:
        raise AssertionError(f"recover: exit {rc}, {len(recs)} files\n"
                             + err[-2000:])
    print(f"  bz2t-recover on a copy damaged in block 5: {len(recs)} valid "
          f"rec*.bz2 files, each read by bz2.decompress, the other blocks' "
          f"bytes exact; wall {wall:.3f} s with the child's start",
          flush=True)

    # 7. an unknown backend
    small = os.path.join(SURFACE_DIR, "small")
    with open(small, "wb") as fh:
        fh.write(data[:2 << 20])
    rc, _, err, _ = _port_cmd(["bzip2_tpu_torch.cli", "--backend=bogus",
                               "-z", small], "bz2t --backend=bogus")
    if rc != 3 or os.path.exists(small + ".bz2"):
        raise AssertionError(f"--backend=bogus: exit {rc}, output "
                             f"{os.path.exists(small + '.bz2')}\n{err}")
    print("  bz2t --backend=bogus -z: exit 3, no output file", flush=True)
    shutil.rmtree(SURFACE_DIR)
    return {**{k: enc_launches[k] for k in ENCODE},
            **{k: dec_launches[k] for k in DECODE}}


def _mesh_encode(torch, mesh, arrays, blocks) -> tuple:
    """encode_blocks_sharded of the corpus's blocks, then the host splice;
    returns (stream, encode wall s, splice wall s)."""
    from bzip2_tpu_torch import api, engine
    from bzip2_tpu_torch.parallel import mesh as M
    t0 = time.perf_counter()
    words, nbits = M.encode_blocks_sharded(
        mesh, *arrays, engine._words_for(arrays[0].shape[1]))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stream = api.frame([b.crc for b in blocks],
                       engine.payloads_from_words(words, nbits), LEVEL)
    return stream, t1 - t0, time.perf_counter() - t1


def mesh_phase(torch, data: bytes, expect: bytes, blocks: list,
               card: str) -> None:
    """Phases 10a and 10b: encode_blocks_sharded and decode_blocks_sharded
    on make_mesh() (the one card) and on two entries of cuda:0, each warmed
    up once, then timed with the launch counts reset just before."""
    from bzip2_tpu_torch import _build, engine
    from bzip2_tpu_torch.parallel import mesh as M
    n = len(blocks)
    arrays = engine.batch_arrays(blocks, n, engine._block_pad_size(LEVEL))
    meshes = [("make_mesh()", M.make_mesh()),
              ("make_mesh(['cuda:0', 'cuda:0'])",
               M.make_mesh(["cuda:0", "cuda:0"]))]
    mb = len(data) / 1e6
    print(f"phase 10a: mesh encode, {mb:.3f} MB at -{LEVEL}, {n} blocks "
          f"(split by the port's rle1 beforehand), on {card}", flush=True)
    for name, mesh in meshes:
        _check_stream(f"{name} warm-up", _mesh_encode(torch, mesh, arrays,
                                                      blocks)[0], expect, data)
        torch.cuda.synchronize()
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        out, enc_s, splice_s = _mesh_encode(torch, mesh, arrays, blocks)
        launches = {k: _build.KERNELS[k].launches for k in FUSED}
        _check_stream(name, out, expect, data)
        missing = [k for k in FUSED if launches[k] <= 0]
        if missing:
            raise AssertionError(f"{name} encode: kernels not launched: "
                                 f"{missing}")
        shards = [e - s for s, e in M.shard_bounds(n, mesh.size)]
        print(f"  {name}: bit-exact vs bz2 and round-tripped; "
              f"encode_blocks_sharded {enc_s:.3f} s = {mb / enc_s:.3f} MB/s, "
              f"host splice {splice_s:.3f} s; blocks per entry {shards}; "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        print("    launches: " + json.dumps(launches), flush=True)

    print(f"phase 10b: mesh decode of the -{LEVEL} stream "
          f"({len(expect)} bytes), on {card}", flush=True)
    for name, mesh in meshes:
        if M.decode_blocks_sharded(mesh, expect) != data:
            raise AssertionError(f"{name}: warm-up decode differs")
        M.reset_telemetry()
        torch.cuda.synchronize()
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = M.decode_blocks_sharded(mesh, expect)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: _build.KERNELS[k].launches for k in DECODE}
        if got != data:
            raise AssertionError(f"{name}: sharded decode differs")
        if M.HEALS["lane"] or any(launches[k] <= 0 for k in DECODE):
            raise AssertionError(f"{name} decode: heals {M.HEALS}, launches "
                                 f"{launches}")
        print(f"  {name}: exact, no host heal; wall {wall:.3f} s = "
              f"{mb / wall:.3f} MB/s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
              + json.dumps(launches), flush=True)
        print("    stage walls (CUDA events, summed over the entries): "
              + ", ".join(f"{k} {v:.4f} s" for k, v in M.STAGE_WALL.items()),
              flush=True)
    # one more encode and decode on the one-entry mesh under torch.profiler
    one = meshes[0][1]
    for what, fn, want, kernels in (
            ("encode", lambda: _mesh_encode(torch, one, arrays, blocks)[0],
             expect, FUSED),
            ("decode", lambda: M.decode_blocks_sharded(one, expect), data,
             DECODE)):
        out = []
        torch.cuda.reset_peak_memory_stats()
        pwall, busy, by_name = profiled(torch, lambda: out.append(fn()))
        if out[0] != want:
            raise AssertionError(f"profiled one-entry mesh {what} differs")
        total = sum(ms for ms, _ in by_name.values())
        print(f"  profiled make_mesh() {what}: wall {pwall:.1f} ms; device "
              f"time {total:.1f} ms, busy {busy:.1f} ms = "
              f"{100 * busy / pwall:.1f}% of the wall; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        print_profile(by_name, kernels)
    mesh = meshes[1][1]
    m1, m2 = bz2.compress(data[:1 << 20], 9), bz2.compress(
        data[1 << 20:3 << 20], 9)
    if M.decode_blocks_sharded(mesh, m1 + m2) != data[:3 << 20]:
        raise AssertionError("two-member sharded decode differs")
    bad = bytearray(expect)
    bad[len(bad) // 2] ^= 0x40
    try:
        M.decode_blocks_sharded(mesh, bytes(bad))
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("a flipped byte decoded without an error")
    print(f"  two -9 members: exact; a flipped byte at {len(bad) // 2}: "
          f"ValueError ({refused})", flush=True)


def multihost_phase(torch, data: bytes, expect: bytes, card: str) -> None:
    """Phase 10c: two child processes, a Gloo group over 127.0.0.1, each
    with local mesh [cuda:0], run compress_sharded on the corpus cut at
    MESH_CUT and decompress_members(backend="gpu") of a three-member
    stream.  A child's non-zero exit or signal fails the run."""
    import shutil
    import signal
    import socket
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    try:
        with open(os.path.join(MESH_DIR, "corpus"), "wb") as fh:
            fh.write(data)
        half = len(data) // 4
        want = data[:half] + data[half:2 * half] + b"small member" * 100
        members = (bz2.compress(data[:half], 9)
                   + bz2.compress(data[half:2 * half], 9)
                   + bz2.compress(b"small member" * 100, 1))
        with open(os.path.join(MESH_DIR, "members.bz2"), "wb") as fh:
            fh.write(members)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", MULTIHOST_CHILD, HERE, str(pid), str(port),
             MESH_DIR, str(MESH_CUT)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE) for pid in (0, 1)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        res = []
        for pid, (p, (so, se)) in enumerate(zip(procs, outs)):
            err = se.decode(errors="replace")[-3000:]
            if p.returncode < 0:
                raise AssertionError(f"rank {pid} died with "
                                     f"{signal.Signals(-p.returncode).name}:"
                                     f"\n{err}")
            if p.returncode:
                raise AssertionError(f"rank {pid} exited {p.returncode}:\n"
                                     f"{err}")
            res.append(json.loads(so.decode().strip().splitlines()[-1]))
        if _read(os.path.join(MESH_DIR, "stream.bz2")) != expect:
            raise AssertionError("rank 0's stream differs from bz2.compress")
        if _read(os.path.join(MESH_DIR, "members.out")) != want:
            raise AssertionError("decompress_members output differs")
        for r in res:
            if r["mesh"] != ["cuda:0"] or r["blocks"] < 8:
                raise AssertionError(f"rank {r['rank']}: mesh {r['mesh']}, "
                                     f"{r['blocks']} blocks encoded")
            missing = [k for k in FUSED if r["encode_launches"][k] <= 0] + [
                k for k in DECODE if r["decode_launches"][k] <= 0]
            if missing:
                raise AssertionError(f"rank {r['rank']}: kernels not "
                                     f"launched: {missing}")
    finally:
        shutil.rmtree(MESH_DIR, ignore_errors=True)
    mb = len(data) / 1e6
    print(f"phase 10c: two Gloo ranks on {card}, local mesh [cuda:0] each, "
          f"{mb:.3f} MB at -{LEVEL} cut at {MESH_CUT}: rank 0's stream equals "
          f"bz2.compress; decompress_members(backend='gpu') of three members "
          f"({len(members)} bytes) exact", flush=True)
    print(f"  wall with the children's start {wall:.3f} s", flush=True)
    for r in res:
        print(f"  rank {r['rank']}: {r['blocks']} blocks; ready "
              f"{r['ready_s']:.3f} s after start; compress_sharded "
              f"{r['encode_s']:.3f} s (peak {r['encode_peak_gib']:.2f} GiB), "
              f"decompress_members {r['decode_s']:.3f} s (peak "
              f"{r['decode_peak_gib']:.2f} GiB), timed after a warm-up; "
              f"child total {r['total_s']:.3f} s", flush=True)
        print("    launches: encode " + json.dumps(
            {k: r["encode_launches"][k] for k in FUSED}) + ", decode "
            + json.dumps({k: r["decode_launches"][k] for k in DECODE}),
            flush=True)


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-mtf", metavar="PATH.cu",
                    help="an mtf_ranks.cu of the first design to time beside "
                    "the current MTF kernels")
    ap.add_argument("--old-huffman", metavar="PATH.cu", action="append",
                    default=[], help="an earlier huffman_lengths.cu to check "
                    "against and time beside the current kernel (repeatable)")
    ap.add_argument("--old-walk", metavar="PATH.cu", action="append",
                    default=[], help="an earlier ibwt_walk.cu to check "
                    "against and time beside the current kernel (repeatable)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    # ---- phase 1: toolchain and card
    import torch
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from bzip2_tpu_torch import _build
    print(_run([_build._nvcc(), "--version"]).splitlines()[-1])
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.cuda.set_device(0)

    # ---- phase 2: build the kernels and the host runtime side by side
    import threading

    from bzip2_tpu_torch import native
    from bzip2_tpu_torch.native import build as native_build
    t0 = time.perf_counter()
    host = {}

    def build_host():
        host["so"] = native_build.ensure_built()
        host["s"] = time.perf_counter() - t0

    th = threading.Thread(target=build_host)
    th.start()
    probes = {"chase": start_probe_build(chase_probe_source(), "chase")}
    for key, stem, path in [("mtf", "mtf_old", args.old_mtf),
                            *((f"huffman{i}", "huffman_old", p)
                              for i, p in enumerate(args.old_huffman)),
                            *((f"walk{i}", "walk_old", p)
                              for i, p in enumerate(args.old_walk))]:
        if path:
            probes[key] = start_probe_build(path, stem)
    so = _build.build()
    _build._load()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s: "
          f"{os.path.relpath(so, HERE)}", flush=True)
    th.join()
    if host["so"] is None or not native.available():
        raise AssertionError("the port's native host runtime did not build")
    print(f"host runtime built in {host['s']:.2f} s: "
          f"{os.path.relpath(host['so'], HERE)}", flush=True)

    # ---- phase 3: each kernel against its plain version
    from bzip2_tpu_torch import engine
    from bzip2_tpu_torch.engine import _block_pad_size, stage_from_numpy
    from bzip2_tpu_torch.ops import mtf_kernel as mk
    from bzip2_tpu_torch.ops import sort_kernel as sk
    from bzip2_tpu_torch.ops.bwt import _tail_ladder, bwt_batched
    from bzip2_tpu_torch.ops.mtf import mtf_rle2_batched

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    results = {}
    print("phase 3: kernel vs plain (exact)", flush=True)

    def pairs(B, N, inf_from=None, span=None):
        """Distinct pairs (a position in b's low bits), or with span, pairs
        drawn from span x span values (many equal pairs)."""
        if span:
            a, b = (rng.integers(0, span, (B, N)).astype(np.int32)
                    for _ in range(2))
        else:
            a = rng.integers(0, 1 << 31, (B, N), dtype=np.int64).astype(np.int32)
            b = ((rng.integers(0, 512, (B, N)).astype(np.int32) << 20)
                 | np.arange(N, dtype=np.int32)[None])
        if inf_from is not None:
            a[:, inf_from:] = 0x7FFFFFFF
        return (torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))

    def sort_work(args, out):
        """16 bytes a pair; log2(n) compares a pair."""
        rows, n = args[0].shape
        return tensor_bytes(*args, *out), rows * n * (n.bit_length() - 1)

    def sort_case(name, args, reps=5):
        # the library call: torch.sort of the packed key of sort_pairs_plain
        key = ((args[0].to(torch.int64) << 32)
               | (args[1].to(torch.int64) + (1 << 31)))
        return compare(torch, name, sk.sort_pairs, sk.sort_pairs_plain, args,
                       reps, library=lambda: torch.sort(key, dim=1),
                       work=sort_work)

    # the main path's shape: a -9 batch of 13 blocks of up to 900,000
    # rotations padded to 2^20 with INF-keyed lanes
    results["sort_pairs"] = sort_case("sort_pairs INF",
                                      pairs(13, 1 << 20, inf_from=900_000))
    sort_case("sort_pairs dup", pairs(13, 1 << 20, span=4), reps=2)
    # phase 10's one-entry mesh sorts all 19 blocks in one batch
    sort_case("sort_pairs INF", pairs(19, 1 << 20, inf_from=900_000), reps=2)
    for n in _tail_ladder(1 << 20):   # the tail stages' compaction widths
        sort_case("sort_pairs", pairs(13, n), reps=2)
    sort_case("sort_pairs", pairs(2, 1 << 20))
    sort_case("sort_pairs", pairs(2, 4096))
    sort_case("sort_pairs INF", pairs(2, 1 << 18, inf_from=100_000))
    for n in (128, 256, 8192, 1 << 16):
        sort_case("sort_pairs", pairs(3, n), reps=2)

    data = corpus(CORPUS_BYTES, SEED)
    blocks = engine.split_blocks(data, LEVEL)
    N = _block_pad_size(LEVEL)
    # the main path's first batch: 13 blocks at -9
    bsz = engine.Engine(device=dev)._batch_size_for(LEVEL)
    arr, ns, uses, _ = engine.batch_arrays(blocks[:bsz], bsz, N)
    bt, nt, ut = stage_from_numpy((arr, ns, uses), dev)
    last, _, _ = bwt_batched(bt, nt)
    seqm = mtf_input(torch, last, nt, ut)
    T = seqm.shape[0] // bsz
    results["mtf_tile_last"] = compare(torch, "mtf_tile_last", mk.tile_last,
                                       mk.tile_last_plain, (seqm, T),
                                       library=tile_last_library(torch, seqm,
                                                                 T))
    tl = mk.tile_last(seqm, T)
    cm_ms = cuda_ms(torch, lambda: mk.carries(tl, bsz), 5)
    print(f"  carries cummax {'x'.join(map(str, tl.shape))}: {cm_ms:.4f} ms "
          f"(bound {bound(2 * tensor_bytes(tl))['bound_ms']:.4f} ms, bytes)",
          flush=True)
    lx = mk.carries(tl, bsz).contiguous()
    results["mtf_rank"] = compare(torch, "mtf_rank", mk.rank, mk.rank_plain,
                                  (seqm, lx), reps=3)
    if args.old_mtf:
        old_mtf_pass(torch, probe_lib(probes["mtf"]), args.old_mtf, seqm, tl,
                     lx, bsz)
    mtfv, n_mtf, _ = mtf_rle2_batched(last, nt, ut)
    results["group_hist"] = compare(torch, "group_hist", mk.group_hist,
                                    mk.group_hist_plain,
                                    (mtfv.contiguous(), n_mtf.contiguous()),
                                    library=group_hist_library(torch, mtfv,
                                                               n_mtf))
    del last, seqm, tl, lx, mtfv, n_mtf
    results["huffman_lengths"] = huffman_pass(
        torch, rng, bt, nt, ut, old=[(probe_lib(probes[f"huffman{i}"]), p)
                                     for i, p in enumerate(args.old_huffman)])
    del bt, nt, ut
    # phase 10's batch shapes: all 19 blocks on the one-entry mesh, 10 on
    # the first of two entries (and on rank 1 of phase 10c)
    for rows in (len(blocks), -(-len(blocks) // 2)):
        mesh_shape_pass(torch, blocks, rows)

    # the walk kernel at the -9 decoder's shapes: the (tt, cur0, cap) of the
    # first batch's two waves, recorded from one decode of the stream
    import bzip2_tpu_torch
    from bzip2_tpu_torch.ops import decode as dec_ops
    from bzip2_tpu_torch.ops import ibwt_kernel as ik
    expect = bz2.compress(data, LEVEL)
    waves = []
    real_walk = dec_ops.ibwt_walk

    def record(tt, cur0, cap):
        if len(waves) < 2:
            waves.append((tt, cur0, cap))
        return real_walk(tt, cur0, cap)

    dec_ops.ibwt_walk = record
    try:
        if bzip2_tpu_torch.decompress(expect) != data:
            raise AssertionError("decode of the -9 stream differs from data")
    finally:
        dec_ops.ibwt_walk = real_walk

    def walk_work(args, out):
        """The steps taken read a 4-byte successor each; each lane's start
        is read and (cur, cnt, hitp) and its cap bytes of buf written."""
        return (int(out[1].sum()) * 4 + tensor_bytes(args[1], *out), 0)

    walk = [compare(torch, f"ibwt_walk wave{i + 1} {'x'.join(map(str, c.shape))}"
                    f" cap {cap}", ik.ibwt_walk, ik.ibwt_walk_plain,
                    (tt, c, cap), reps=3, work=walk_work)
            for i, (tt, c, cap) in enumerate(waves)]
    chase_pass(torch, probe_lib(probes["chase"]), rng)
    for i, path in enumerate(args.old_walk):
        old_walk_pass(torch, probe_lib(probes[f"walk{i}"]), path, waves)
    # one batch's walk: both waves
    results["ibwt_walk"] = {"max_abs_err": max(w["max_abs_err"] for w in walk),
                            "ms": sum(w["ms"] for w in walk),
                            "plain_ms": sum(w["plain_ms"] for w in walk),
                            "bound_ms": sum(w["bound_ms"] for w in walk),
                            "bound_by": "bytes", "library_ms": None}
    # the one-entry mesh's walk: its two waves over all 19 blocks, recorded
    # from one decode_blocks_sharded(make_mesh())
    from bzip2_tpu_torch.parallel import mesh as M
    waves.clear()
    dec_ops.ibwt_walk = record
    try:
        if M.decode_blocks_sharded(M.make_mesh(), expect) != data:
            raise AssertionError("mesh decode of the -9 stream differs")
    finally:
        dec_ops.ibwt_walk = real_walk
    torch.cuda.synchronize()
    for i, (tt, c, cap) in enumerate(waves):
        exact(torch, "ibwt_walk", ik.ibwt_walk, ik.ibwt_walk_plain,
              (tt, c, cap))
        print(f"  mesh ibwt_walk wave{i + 1} {'x'.join(map(str, c.shape))} "
              f"cap {cap} over {'x'.join(map(str, tt.shape))}: exact vs "
              "plain", flush=True)
    del waves, walk

    # ---- phase 4: the slice through the port's entry point
    # one untimed pass pays the first-use costs at the batch shapes
    # (allocator growth, cuBLAS set-up); the timed pass below is the result
    if bzip2_tpu_torch.compress(data, LEVEL, **HYBRID) != expect:
        raise AssertionError("warm-up stream differs from bz2.compress")
    out, wall, launches, share, stages = _timed_compress(torch, data, HYBRID)
    _check_stream("hybrid", out, expect, data)
    if share != {"blocks": len(blocks), "dev_blocks": len(blocks),
                 "host_blocks": 0, "declines": 0}:
        raise AssertionError(f"device encoded {share['dev_blocks']} of "
                             f"{share['blocks']} blocks handed to the engine "
                             f"({len(blocks)} expected)")
    missing = [k for k in ENCODE if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")
    mb = len(data) / 1e6
    print(f"phase 4: {mb:.3f} MB at -{LEVEL}, {len(blocks)} blocks, all on "
          f"the device, bit-exact vs bz2 and round-tripped", flush=True)
    print(f"  wall {wall:.3f} s = {mb / wall:.3f} MB/s  (ratio "
          f"{len(out) / len(data):.4f}) on {card}", flush=True)
    print("  stage walls: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in stages.items()), flush=True)
    print("  launches: " + json.dumps(launches), flush=True)
    profile_slice(torch, data, expect)

    # ---- phase 6: the decode path
    launches.update({k: v for k, v in decode_phase(
        torch, data, expect, len(blocks), card).items() if k in DECODE})
    native_decode_gate(data, expect, len(blocks))

    # ---- phases 7 and 8: the fused mode and the scheduler
    launches["huffman_lengths"] = fused_phase(torch, data, expect,
                                              len(blocks), card)
    scheduler_phase(torch, data, expect, len(blocks), card)

    # ---- phase 9: the user surfaces; the kernels line takes the launches
    # of its in-process CLI encode and decode
    launches.update(surfaces_phase(torch, data, expect, blocks, card))

    # ---- phase 10: the mesh in one process, then two processes on the card
    mesh_phase(torch, data, expect, blocks, card)
    multihost_phase(torch, data, expect, card)

    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k],
                "replaces": REPLACES[k], "launches": launches[k],
                **results[k]} for k in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
