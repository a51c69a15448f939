// K8: micro-kernels of the BVH8 traversal's ingredients (the counterpart
// of tools/kernel_lab.py, whose `run` harness and dynamic-row stack reach
// `pl.pallas_call` at :52 and :247). Each kernel runs one thread per lane
// and loops `iters` times over one ingredient of K5 (csrc/bvh8_trace.cu),
// carrying a value from one iteration to the next so that the loop is
// neither hoisted nor removed, and writes the carry; the lab
// (tools_torch/kernel_lab.py) times them at many iterations and holds each
// against a plain PyTorch version of the same arithmetic at a few.
//
// Built into its own library (not the renderer's): only the lab and
// chip_smoke.py's lab phase load it. Every constant is a power of two or
// a small integer, and nvcc runs with --fmad=false, so the plain versions
// round the same operations the same way.
#include "common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kRows = 640, kWidth = 144;   // node/leaf table (rows, floats)
constexpr int kStack = 48;                 // K5's local traversal stack
constexpr int kSharedRows = kStack + 8;

enum Which {
    kEmpty = 0, kRowFetch = 1, kLocalStack = 2, kLeafMT = 3, kSlabSort = 4,
    kWarpVote = 5, kSharedStack = 6,
};

__device__ __forceinline__ float carry0(int lane) {
    return 1.0f + 0.125f * static_cast<float>(lane & 7);
}

// a carry add per iteration: the loop's own cost
__global__ void empty_kernel(float* out, int lanes, int iters) {
    const int lane = blockIdx.x * kBlock + threadIdx.x;
    if (lane >= lanes) return;
    float c = carry0(lane);
    for (int it = 0; it < iters; ++it) c = c + 1.0f;
    out[lane] = c;
}

// one 144-float node row of a (640, 144) table per iteration, at a row
// picked from the carry's bits (K5's node fetch; the TPU's one-hot matmul
// gather)
__global__ void row_fetch_kernel(const float* __restrict__ table, float* out,
                                 int lanes, int iters) {
    const int lane = blockIdx.x * kBlock + threadIdx.x;
    if (lane >= lanes) return;
    float c = carry0(lane);
    for (int it = 0; it < iters; ++it) {
        const unsigned r = (__float_as_uint(c) + it) % kRows;
        const float* row = table + r * kWidth;
        float m = row[0];
        for (int k = 1; k < kWidth; ++k) m = fmaxf(m, row[k]);
        c = c + m * 0.0009765625f;             // 2^-10
    }
    out[lane] = c;
}

// a 48-entry stack in local memory: top read + pop, then 8 masked pushes
__global__ void local_stack_kernel(float* out, int lanes, int iters) {
    const int lane = blockIdx.x * kBlock + threadIdx.x;
    if (lane >= lanes) return;
    int stack[kStack];
    for (int k = 0; k < kStack; ++k) stack[k] = k + (lane & 15);
    int sp = 8 + (lane & 7);
    unsigned acc = 0;
    for (int it = 0; it < iters; ++it) {
        const int top = stack[sp - 1];
        sp -= 1;
        for (int k = 0; k < 8; ++k) {
            if (((top + it + k) & 3) != 0) {
                stack[sp] = top + k + 1;
                sp += 1;
            }
        }
        if (sp > 40) sp -= 32;
        if (sp < 1) sp = 1;
        acc += static_cast<unsigned>(top);
    }
    out[lane] = static_cast<float>(acc & 0xFFFFFu);
}

// Möller–Trumbore against a leaf of 16 triangles
__global__ void leaf_mt_kernel(float* out, int lanes, int iters) {
    const int lane = blockIdx.x * kBlock + threadIdx.x;
    if (lane >= lanes) return;
    float c = carry0(lane);
    const float dx = 0.125f, dy = -0.25f, dz = -1.0f;
    for (int it = 0; it < iters; ++it) {
        const float ox = c, oy = c * 0.5f, oz = 0.25f;
        float acc = 0.0f;
        for (int k = 0; k < 16; ++k) {
            const float kf = static_cast<float>(k);
            const float p0x = kf * 0.125f - c * 0.25f;
            const float p0y = c * 0.5f - kf * 0.0625f;
            const float p0z = -2.0f - kf * 0.25f;
            const float e1x = 1.0f + kf * 0.03125f, e1y = 0.5f,
                        e1z = kf * 0.0625f;
            const float e2x = -0.5f, e2y = 1.0f + c * 0.125f, e2z = 0.25f;
            const float hx = dy * e2z - dz * e2y;
            const float hy = dz * e2x - dx * e2z;
            const float hz = dx * e2y - dy * e2x;
            const float a = e1x * hx + e1y * hy + e1z * hz;
            const float f = 1.0f / (fabsf(a) < 1e-12f ? 1e-12f : a);
            const float sx = ox - p0x, sy = oy - p0y, sz = oz - p0z;
            const float u = f * (sx * hx + sy * hy + sz * hz);
            const float qx = sy * e1z - sz * e1y;
            const float qy = sz * e1x - sx * e1z;
            const float qz = sx * e1y - sy * e1x;
            const float v = f * (dx * qx + dy * qy + dz * qz);
            const float t = f * (e2x * qx + e2y * qy + e2z * qz);
            const bool hit = fabsf(a) > 1e-12f && u >= 0.0f && v >= 0.0f &&
                             u + v <= 1.0f && t > 0.0f && t < 1e30f;
            acc = acc + (hit ? t : 0.0f);
        }
        c = c * 0.5f + 1.0f + acc * 0.0078125f;   // 2^-7
    }
    out[lane] = c;
}

// 8 child slab tests and the 19-comparator sort of K5's node step
__global__ void slab_sort_kernel(float* out, int lanes, int iters) {
    const int lane = blockIdx.x * kBlock + threadIdx.x;
    if (lane >= lanes) return;
    const int kSort[19][2] = {{0, 1}, {2, 3}, {4, 5}, {6, 7}, {0, 2}, {1, 3},
                              {4, 6}, {5, 7}, {1, 2}, {5, 6}, {0, 4}, {3, 7},
                              {1, 5}, {2, 6}, {1, 4}, {3, 6}, {2, 4}, {3, 5},
                              {3, 4}};
    const float kNegInf = __int_as_float(0xff800000);
    float c = carry0(lane);
    for (int it = 0; it < iters; ++it) {
        const float ox = c, oy = c * 0.5f, oz = 0.25f;
        const float ix = 1.0f + c * 0.25f, iy = -0.5f, iz = 2.0f;
        float ts[8];
        int cs[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            float b[6];
#pragma unroll
            for (int j = 0; j < 6; ++j)
                b[j] = c * (0.015625f * static_cast<float>(k * 6 + j));
            const float t0x = (b[0] - ox) * ix, t1x = (b[3] - ox) * ix;
            const float t0y = (b[1] - oy) * iy, t1y = (b[4] - oy) * iy;
            const float t0z = (b[2] - oz) * iz, t1z = (b[5] - oz) * iz;
            const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                   fmaxf(fminf(t0z, t1z), 0.0f));
            const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                   fminf(fmaxf(t0z, t1z), 1e30f));
            ts[k] = tn <= tf ? tn : kNegInf;
            cs[k] = k;
        }
#pragma unroll
        for (int s = 0; s < 19; ++s) {
            const int a = kSort[s][0], b = kSort[s][1];
            if (ts[a] < ts[b]) {
                const float tt = ts[a];
                ts[a] = ts[b];
                ts[b] = tt;
                const int ct = cs[a];
                cs[a] = cs[b];
                cs[b] = ct;
            }
        }
        c = c * 0.5f + (ts[0] > kNegInf ? ts[0] * 0.015625f : 0.0f) +
            static_cast<float>(cs[7]) * 0.0078125f;
    }
    out[lane] = c;
}

// a warp vote and a branch on it (K5's "any lane still traversing")
__global__ void warp_vote_kernel(float* out, int lanes, int iters) {
    const int lane = blockIdx.x * kBlock + threadIdx.x;
    if (lane >= lanes) return;    // lanes is a multiple of kBlock
    float c = carry0(lane);
    const float step = 0.125f + 0.25f * static_cast<float>(lane & 3);
    for (int it = 0; it < iters; ++it) {
        if (__any_sync(0xffffffffu, c > 1.5f))
            c = c * 0.5f + 0.5f;
        else
            c = c + step;
    }
    out[lane] = c;
}

// a stack in shared memory, one column per thread: top read and 8 pushes
// at a row that moves each iteration (the TPU lab's dynamic-row pl.ds
// stack)
__global__ void shared_stack_kernel(float* out, int lanes, int iters) {
    __shared__ int s[kSharedRows * kBlock];
    const int lane = blockIdx.x * kBlock + threadIdx.x;
    const int tid = threadIdx.x;
    for (int r = 0; r < kSharedRows; ++r) s[r * kBlock + tid] = 0;
    s[tid] = lane & 15;
    unsigned acc = 0;
    for (int it = 0; it < iters; ++it) {
        const int sp = it % 40 + 1;
        const int top = s[(sp - 1) * kBlock + tid];
        for (int j = 0; j < 8; ++j) s[(sp + j) * kBlock + tid] = top + j + 1;
        acc += static_cast<unsigned>(top);
    }
    if (lane < lanes) out[lane] = static_cast<float>(acc & 0xFFFFFu);
}

}  // namespace

// runs micro-kernel `which` (enum Which) over `lanes` lanes (a multiple of
// 128) for `iters` iterations; `table` is the (640, 144) f32 row table of
// kRowFetch (ignored by the others)
RTXPT_API int rtxpt_lab_run(int which, const float* table, float* out,
                            int lanes, int iters, cudaStream_t stream) {
    if (lanes < kBlock || lanes % kBlock != 0 || iters < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const unsigned blocks = static_cast<unsigned>(lanes / kBlock);
    switch (which) {
    case kEmpty:
        empty_kernel<<<blocks, kBlock, 0, stream>>>(out, lanes, iters);
        break;
    case kRowFetch:
        row_fetch_kernel<<<blocks, kBlock, 0, stream>>>(table, out, lanes,
                                                       iters);
        break;
    case kLocalStack:
        local_stack_kernel<<<blocks, kBlock, 0, stream>>>(out, lanes, iters);
        break;
    case kLeafMT:
        leaf_mt_kernel<<<blocks, kBlock, 0, stream>>>(out, lanes, iters);
        break;
    case kSlabSort:
        slab_sort_kernel<<<blocks, kBlock, 0, stream>>>(out, lanes, iters);
        break;
    case kWarpVote:
        warp_vote_kernel<<<blocks, kBlock, 0, stream>>>(out, lanes, iters);
        break;
    case kSharedStack:
        shared_stack_kernel<<<blocks, kBlock, 0, stream>>>(out, lanes, iters);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
