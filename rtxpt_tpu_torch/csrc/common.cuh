// Shared helpers of the port's CUDA kernels (plain C interface, built
// with nvcc for sm_90a and loaded with ctypes; see ops/cuda_lib.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define RTXPT_API extern "C" __attribute__((visibility("default")))

namespace rtxpt {

constexpr int kThreads = 256;

// blocks for a 1-D grid over `n` work items; a grid-stride loop covers
// the rest when `n` exceeds the cap
inline unsigned grid_for(long long n, int threads = kThreads) {
    long long b = (n + threads - 1) / threads;
    if (b < 1) b = 1;
    if (b > (1LL << 20)) b = 1LL << 20;
    return static_cast<unsigned>(b);
}

__device__ __forceinline__ int clamp_row(int r, int rows) {
    return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

}  // namespace rtxpt
