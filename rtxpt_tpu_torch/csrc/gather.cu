// K2 row gather and K3 barycentric row blend.
//
// Replaces: rtxpt_tpu/ops/gather_pallas.py `_make_kernel` (K2, via
// `_gather`/`gather_rows`) and `_make_interp_kernel` (K3, via
// `_gather_interp`/`gather_rows_interp`). The TPU versions fetch rows with
// one-hot bf16 matmuls over three residual planes because XLA gathers are
// slow on that chip; here a gather is a plain load.
//
// Bound on the H100: device-memory bandwidth. Each output word is one
// read of the (small, L2-resident) table and one coalesced write; the
// scene tables (at most a few MB) stay in the 50 MB L2 across a bounce.
// Design: one thread per output word (lane, column), so consecutive
// threads write consecutive addresses; the index is re-read per column
// but hits L1. Rows are moved as 32-bit words, so one kernel serves f32
// and i32 tables bit for bit. K3 blends in the order (w0*r0 + w1*r1) +
// w2*r2, the order of the TPU kernel and of the plain version.
#include "common.cuh"

namespace {

__global__ void gather_rows_kernel(const uint32_t* __restrict__ table,
                                   int rows, int width,
                                   const int32_t* __restrict__ idx,
                                   uint32_t* __restrict__ out,
                                   long long total) {
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         e < total; e += (long long)gridDim.x * blockDim.x) {
        long long lane = e / width;
        int c = static_cast<int>(e - lane * width);
        int r = rtxpt::clamp_row(idx[lane], rows);
        out[e] = table[(long long)r * width + c];
    }
}

__global__ void gather_interp_kernel(const float* __restrict__ table,
                                     int rows, int width,
                                     const int32_t* __restrict__ idx3,
                                     const float* __restrict__ w3,
                                     float* __restrict__ out,
                                     long long total) {
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         e < total; e += (long long)gridDim.x * blockDim.x) {
        long long lane = e / width;
        int c = static_cast<int>(e - lane * width);
        int r0 = rtxpt::clamp_row(idx3[lane * 3 + 0], rows);
        int r1 = rtxpt::clamp_row(idx3[lane * 3 + 1], rows);
        int r2 = rtxpt::clamp_row(idx3[lane * 3 + 2], rows);
        float acc = table[(long long)r0 * width + c] * w3[lane * 3 + 0];
        acc = acc + table[(long long)r1 * width + c] * w3[lane * 3 + 1];
        acc = acc + table[(long long)r2 * width + c] * w3[lane * 3 + 2];
        out[e] = acc;
    }
}

}  // namespace

RTXPT_API int rtxpt_gather_rows(const void* table, int rows, int width,
                                const int32_t* idx, void* out, int n,
                                cudaStream_t stream) {
    long long total = (long long)n * width;
    gather_rows_kernel<<<rtxpt::grid_for(total), rtxpt::kThreads, 0,
                         stream>>>(static_cast<const uint32_t*>(table),
                                   rows, width, idx,
                                   static_cast<uint32_t*>(out), total);
    return static_cast<int>(cudaGetLastError());
}

RTXPT_API int rtxpt_gather_rows_interp(const float* table, int rows,
                                       int width, const int32_t* idx3,
                                       const float* w3, float* out, int n,
                                       cudaStream_t stream) {
    long long total = (long long)n * width;
    gather_interp_kernel<<<rtxpt::grid_for(total), rtxpt::kThreads, 0,
                           stream>>>(table, rows, width, idx3, w3, out,
                                     total);
    return static_cast<int>(cudaGetLastError());
}
