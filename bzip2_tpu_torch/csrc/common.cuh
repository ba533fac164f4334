// Shared helpers of the kernel library: a plain C interface, loaded with
// ctypes (bzip2_tpu_torch/_build.py).  Every entry point launches on the
// stream it is given, allocates nothing and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define BZ2T_API extern "C" __attribute__((visibility("default")))

#define BZ2T_CHECK_LAUNCH()                      \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

constexpr unsigned kFullMask = 0xffffffffu;
