// K5 and K6: BVH8 closest-hit / any-hit traversal over the unified table
// of ops/bvh.py (node rows: 8 child AABBs + 8 child codes as exact float
// values; leaf rows: up to leaf_size inlined triangles as p0, e1, e2).
//
// Replaces: rtxpt_tpu/ops/traverse_pallas.py `_make_kernel` (:119, the
// single-table kernel K5 launched by `_trace_pallas`) and
// `_trace_pallas_bucketed` (:316, K6, the same kernel over a stack of
// subtree tables, one subtree per ray tile by scalar prefetch). Both
// compute what `_trace8` (rtxpt_tpu/ops/traverse.py:150) computes, so
// they are one kernel here with two entry points: `rtxpt_bvh8_trace`
// (one table) and `rtxpt_bvh8_trace_sub` (a (K, S, W) stack of tables and
// a per-ray subtree index that each thread loads itself). The TPU fetched
// rows as one-hot matmuls from bf16 planes pinned in VMEM; here each
// thread reads its rows straight from global memory in float32.
//
// Design: one thread per ray. Ray, inverse direction and the best
// t/slot/u/v live in registers; the 48-entry stack (the depth
// collapse_bvh8 guarantees) lives in local memory, pushes clamp at slot
// 47 as in the reference. A node pop slab-tests all 8 children against
// the running best t, orders them with the reference's 19-comparator
// network (descending t, misses as -inf; the order of the comparators
// decides ties, so coplanar hits resolve to the reference's triangle) and
// pushes the valid ones far-to-near. A leaf pop runs Möller–Trumbore on
// its triangles in order and keeps a hit only if t < best t (the first
// smallest t wins, as argmin does) and its opacity micro-mask cell bit is
// set. Any-hit stops the ray after the first leaf that hits. Built with
// --fmad=false and no fast math: the arithmetic is the plain version's,
// operation for operation, with NaN-propagating min/max.
//
// Bound on the H100: the rows each traversal step fetches (224 bytes of
// node, up to 9*16*4 = 576 bytes of leaf) against memory bandwidth. The
// city's stacked table (26 x 2422 x 144 floats, 36.3 MB) fits in the 50 MB
// L2, so most fetches are L2 hits after the first touches. The design does
// nothing yet about warp divergence (a warp runs until its slowest ray
// finishes, and its lanes fetch unrelated rows); persistent threads, a
// shared-memory stack or a wider leaf test are left to later work.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kStack = 48;          // ops/bvh.py STACK_DEPTH
constexpr int kMaxIters = 500000;   // pops per ray, ops/traverse_bvh8.py
constexpr int kLeafMax = 31;

__device__ __forceinline__ float safe_inv(float c) {
    float s = fabsf(c) < 1e-12f ? (c < 0.0f ? -1e-12f : 1e-12f) : c;
    return 1.0f / s;
}

// torch.minimum / torch.maximum: NaN in, NaN out
__device__ __forceinline__ float pmin(float a, float b) {
    return (isnan(a) || isnan(b)) ? CUDART_NAN_F : fminf(a, b);
}
__device__ __forceinline__ float pmax(float a, float b) {
    return (isnan(a) || isnan(b)) ? CUDART_NAN_F : fmaxf(a, b);
}

__device__ __forceinline__ void cswap(float* ts, int* cs, int a, int b) {
    if (ts[a] < ts[b]) {
        float t = ts[a]; ts[a] = ts[b]; ts[b] = t;
        int c = cs[a]; cs[a] = cs[b]; cs[b] = c;
    }
}

template <bool ANY_HIT, bool SUB>
__global__ void __launch_bounds__(kBlock)
bvh8_kernel(const float* __restrict__ tables,     // (K, rows, width)
            int num_sub, int rows, int width, int leaf_size,
            const int32_t* __restrict__ leaf_omm,  // (K, rows*leaf_size)
            const int32_t* __restrict__ sub,       // (n,) when SUB
            const float* __restrict__ orig, const float* __restrict__ dirs,
            const float* __restrict__ t_max,
            const uint8_t* __restrict__ active,
            float* __restrict__ t_out, int32_t* __restrict__ slot_out,
            float* __restrict__ uv_out, int n) {
    const int lane = blockIdx.x * kBlock + threadIdx.x;
    if (lane >= n) return;
    float best_t = t_max[lane];
    int best = -1;
    float best_u = 0.0f, best_v = 0.0f;
    if (active[lane]) {
        const float* table = tables;
        const int32_t* omm = leaf_omm;
        if (SUB) {
            int s = sub[lane];
            s = s < 0 ? 0 : (s >= num_sub ? num_sub - 1 : s);
            table += (long long)s * rows * width;
            omm += (long long)s * rows * leaf_size;
        }
        const float ox = orig[lane * 3 + 0], oy = orig[lane * 3 + 1],
                    oz = orig[lane * 3 + 2];
        const float dx = dirs[lane * 3 + 0], dy = dirs[lane * 3 + 1],
                    dz = dirs[lane * 3 + 2];
        const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
        int stack[kStack];
        stack[0] = 0;
        int sp = 1;
        for (int it = 0; sp > 0 && it < kMaxIters; ++it) {
            const int top = stack[min(sp - 1, kStack - 1)];
            --sp;
            if (top >= 0) {
                // ---- node: slab-test the 8 children, push far-to-near
                const float* row =
                    table + (long long)rtxpt::clamp_row(top, rows) * width;
                // the 56 floats of the node (rows are 16-byte aligned:
                // the wrapper requires width % 4 == 0)
                float nb[56];
                const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
                for (int i = 0; i < 14; ++i) {
                    const float4 q = __ldg(row4 + i);
                    nb[4 * i + 0] = q.x;
                    nb[4 * i + 1] = q.y;
                    nb[4 * i + 2] = q.z;
                    nb[4 * i + 3] = q.w;
                }
                float ts[8];
                int cs[8];
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const float bx0 = nb[6 * k + 0], by0 = nb[6 * k + 1],
                                bz0 = nb[6 * k + 2], bx1 = nb[6 * k + 3],
                                by1 = nb[6 * k + 4], bz1 = nb[6 * k + 5];
                    const int code = static_cast<int>(nb[48 + k]);
                    const float t0x = (bx0 - ox) * ix, t1x = (bx1 - ox) * ix;
                    const float t0y = (by0 - oy) * iy, t1y = (by1 - oy) * iy;
                    const float t0z = (bz0 - oz) * iz, t1z = (bz1 - oz) * iz;
                    const float tn = pmax(
                        pmax(pmax(pmin(t0x, t1x), pmin(t0y, t1y)),
                             pmin(t0z, t1z)), 0.0f);
                    const float tf = pmin(
                        pmin(pmin(pmax(t0x, t1x), pmax(t0y, t1y)),
                             pmax(t0z, t1z)), best_t);
                    const bool hit = (tn <= tf) && code != -1;
                    ts[k] = hit ? tn : -CUDART_INF_F;
                    cs[k] = code;
                }
                cswap(ts, cs, 0, 1); cswap(ts, cs, 2, 3);
                cswap(ts, cs, 4, 5); cswap(ts, cs, 6, 7);
                cswap(ts, cs, 0, 2); cswap(ts, cs, 1, 3);
                cswap(ts, cs, 4, 6); cswap(ts, cs, 5, 7);
                cswap(ts, cs, 1, 2); cswap(ts, cs, 5, 6);
                cswap(ts, cs, 0, 4); cswap(ts, cs, 3, 7);
                cswap(ts, cs, 1, 5); cswap(ts, cs, 2, 6);
                cswap(ts, cs, 1, 4); cswap(ts, cs, 3, 6);
                cswap(ts, cs, 2, 4); cswap(ts, cs, 3, 5);
                cswap(ts, cs, 3, 4);
                int off = 0;
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    if (ts[k] > -CUDART_INF_F) {
                        stack[min(sp + off, kStack - 1)] = cs[k];
                        ++off;
                    }
                }
                sp += off;
            } else {
                // ---- leaf: inlined triangles in order, then the OMM bit
                const int v = -top - 1;
                const int lrow = rtxpt::clamp_row(v >> 5, rows);
                const int count = min(v & kLeafMax, leaf_size);
                const float* row = table + (long long)lrow * width;
                const int32_t* masks = omm + (long long)lrow * leaf_size;
                for (int k = 0; k < count; ++k) {
                    const float* tr = row + 9 * k;
                    const float p0x = __ldg(tr + 0), p0y = __ldg(tr + 1),
                                p0z = __ldg(tr + 2);
                    const float e1x = __ldg(tr + 3), e1y = __ldg(tr + 4),
                                e1z = __ldg(tr + 5);
                    const float e2x = __ldg(tr + 6), e2y = __ldg(tr + 7),
                                e2z = __ldg(tr + 8);
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
                    const float vv = f * (dx * qx + dy * qy + dz * qz);
                    const float t = f * (e2x * qx + e2y * qy + e2z * qz);
                    if (!(fabsf(a) > 1e-12f) || !(u >= 0.0f) ||
                        !(vv >= 0.0f) || !(u + vv <= 1.0f) || !(t > 0.0f) ||
                        !(t < best_t))
                        continue;
                    int cu = static_cast<int>(u * 4.0f);
                    int cv = static_cast<int>(vv * 4.0f);
                    cu = cu < 0 ? 0 : (cu > 3 ? 3 : cu);
                    cv = cv < 0 ? 0 : (cv > 3 ? 3 : cv);
                    if (((__ldg(masks + k) >> (cu * 4 + cv)) & 1) == 0)
                        continue;
                    best_t = t;
                    best = lrow * leaf_size + k;
                    best_u = u;
                    best_v = vv;
                }
                if (ANY_HIT && best >= 0) break;
            }
        }
    }
    t_out[lane] = best_t;
    slot_out[lane] = best;
    uv_out[2 * lane + 0] = best_u;
    uv_out[2 * lane + 1] = best_v;
}

template <bool SUB>
int launch(const float* tables, int num_sub, int rows, int width,
           int leaf_size, const int32_t* leaf_omm, const int32_t* sub,
           const float* orig, const float* dirs, const float* t_max,
           const uint8_t* active, float* t_out, int32_t* slot_out,
           float* uv_out, int n, int any_hit, cudaStream_t stream) {
    const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
    if (any_hit)
        bvh8_kernel<true, SUB><<<blocks, kBlock, 0, stream>>>(
            tables, num_sub, rows, width, leaf_size, leaf_omm, sub, orig,
            dirs, t_max, active, t_out, slot_out, uv_out, n);
    else
        bvh8_kernel<false, SUB><<<blocks, kBlock, 0, stream>>>(
            tables, num_sub, rows, width, leaf_size, leaf_omm, sub, orig,
            dirs, t_max, active, t_out, slot_out, uv_out, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

RTXPT_API int rtxpt_bvh8_trace(const float* table, int rows, int width,
                               int leaf_size, const int32_t* leaf_omm,
                               const float* orig, const float* dirs,
                               const float* t_max, const uint8_t* active,
                               float* t_out, int32_t* slot_out,
                               float* uv_out, int n, int any_hit,
                               cudaStream_t stream) {
    return launch<false>(table, 1, rows, width, leaf_size, leaf_omm, nullptr,
                         orig, dirs, t_max, active, t_out, slot_out, uv_out,
                         n, any_hit, stream);
}

RTXPT_API int rtxpt_bvh8_trace_sub(const float* tables, int num_sub,
                                   int rows, int width, int leaf_size,
                                   const int32_t* leaf_omm,
                                   const int32_t* sub, const float* orig,
                                   const float* dirs, const float* t_max,
                                   const uint8_t* active, float* t_out,
                                   int32_t* slot_out, float* uv_out, int n,
                                   int any_hit, cudaStream_t stream) {
    return launch<true>(tables, num_sub, rows, width, leaf_size, leaf_omm,
                        sub, orig, dirs, t_max, active, t_out, slot_out,
                        uv_out, n, any_hit, stream);
}
