// K5 and K6, and the two-level trace in one launch: BVH8 closest-hit /
// any-hit traversal over the unified table of ops/bvh.py (node rows: 8
// child AABBs + 8 child codes as exact float values; leaf rows: up to
// leaf_size inlined triangles as p0, e1, e2).
//
// Replaces: rtxpt_tpu/ops/traverse_pallas.py `_make_kernel` (:119, the
// single-table kernel K5 launched by `_trace_pallas`, :279) and
// `_trace_pallas_bucketed` (:316, K6, the same kernel over a stack of
// subtree tables, :380), and the two-level composition around them in
// rtxpt_tpu/ops/bvh2l.py (a probe launch of K6, then one K5 launch per
// subtree). All of them compute what `_trace8` (rtxpt_tpu/ops/traverse.py
// :150) computes, so here they share one per-ray walk (`walk`) behind
// three entry points:
//   rtxpt_bvh8_trace      K5: one table, one thread per ray;
//   rtxpt_bvh8_trace_sub  K6: a (K, S, W) stack of tables and a per-ray
//                         subtree index, one thread per ray;
//   rtxpt_bvh8_trace_2l   a whole two-level trace (ops/bvh2l.py) in one
//                         launch: each thread slab-tests the K subtree
//                         boxes (staged once per block in shared memory),
//                         walks its nearest overlapped subtree first (the
//                         first minimal entry t, as torch.argmin picks it;
//                         only when `probe`), then every other subtree in
//                         ascending index whose box it hits and, for
//                         closest hits, enters strictly before its best t
//                         so far, and maps the winning leaf slot to the
//                         global triangle id itself. That is the order and
//                         the gates of `bvh2l.trace_two_level_plain`, so
//                         the nearest subtree wins ties, then the lowest
//                         index, and the result is the plain version's bit
//                         for bit. Any-hit stops at the first occluder.
// and `rtxpt_bvh8_trace_2l_variant`, the same two-level kernel in the lab
// modes of `Mode` (tools_torch/profile_bvh8.py; no main path reaches it).
//
// The walk: ray, inverse direction and the best t/slot/u/v live in
// registers; the 48-entry stack (the depth collapse_bvh8 guarantees) lives
// in shared memory, laid out [depth][thread] so that the 32 lanes of a
// warp touch 32 banks, and pushes clamp at slot 47 as in the reference. A
// node pop reads its 56 floats as 14 float4s, slab-tests all 8 children
// against the running best t, orders them with the reference's
// 19-comparator network (descending t, misses as -inf; the order of the
// comparators decides ties, so coplanar hits resolve to the reference's
// triangle) and pushes the valid ones far-to-near. A leaf pop reads its
// triangles four at a time as 9 float4s (36 floats: rows are 16-byte
// aligned, the wrapper requires width % 4 == 0), runs Möller–Trumbore on
// them in order and keeps a hit only if t < best t (the first smallest t
// wins, as argmin does) and its opacity micro-mask cell bit is set; the
// `kMaxIters` cap counts the pops of one walk. Built with --fmad=false and
// no fast math: the arithmetic is the plain version's, operation for
// operation, with NaN-propagating min/max.
//
// The two-level kernel runs persistent warps (Aila & Laine, HPG 2009,
// "persistent while-while"): a grid of the blocks that fit on the card at
// once, whose warps take their next 32 rays from a global counter (zeroed
// by the wrapper) once all 32 lanes have finished, so no block holds an SM
// while its last warp drains.
//
// Bound on the H100: the rows each walk fetches (224 bytes of node, up to
// 16 * 36 = 576 bytes of leaf) and the latency of those dependent loads.
// The city's stacked tables (26 x 2422 x 144 floats, 36.3 MB) fit in the
// 50 MB L2, so most fetches are L2 hits. The work is exact float32 slab
// and Möller–Trumbore tests on data-dependent addresses: no matrix
// product for the tensor cores and no tile for TMA to stream, so neither
// is used.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kStack = 48;          // ops/bvh.py STACK_DEPTH
constexpr int kMaxIters = 500000;   // pops per walk, ops/traverse_bvh8.py
constexpr int kLeafMax = 31;
constexpr int kMaxSubtrees = 1024;  // ops/traverse_bvh8.py MAX_SUBTREES

// lab modes of the two-level kernel: where the stack lives, and whether
// the warps are persistent or the grid has one thread per ray
enum Mode {
    kSharedPersistent = 0,   // the main path's
    kSharedFlat = 1,
    kLocalPersistent = 2,
    kLocalFlat = 3,
};

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

struct Ray {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ orig,
                                        const float* __restrict__ dirs,
                                        int lane) {
    Ray r;
    r.ox = orig[lane * 3 + 0];
    r.oy = orig[lane * 3 + 1];
    r.oz = orig[lane * 3 + 2];
    r.dx = dirs[lane * 3 + 0];
    r.dy = dirs[lane * 3 + 1];
    r.dz = dirs[lane * 3 + 2];
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    return r;
}

// slab test of the box b = (min xyz, max xyz) over [0, t_cap]: hit, and
// the entry t in tn (ops/intersect.py ray_aabb)
__device__ __forceinline__ bool slab(const Ray& r, const float* b,
                                     float t_cap, float& tn) {
    const float t0x = (b[0] - r.ox) * r.ix, t1x = (b[3] - r.ox) * r.ix;
    const float t0y = (b[1] - r.oy) * r.iy, t1y = (b[4] - r.oy) * r.iy;
    const float t0z = (b[2] - r.oz) * r.iz, t1z = (b[5] - r.oz) * r.iz;
    tn = pmax(pmax(pmax(pmin(t0x, t1x), pmin(t0y, t1y)), pmin(t0z, t1z)),
              0.0f);
    const float tf = pmin(
        pmin(pmin(pmax(t0x, t1x), pmax(t0y, t1y)), pmax(t0z, t1z)), t_cap);
    return tn <= tf;
}

// two-sided Möller–Trumbore on tr = (p0, e1, e2), every dot and cross
// product left to right as ops/intersect.py writes them: true for a hit
// in (0, best_t)
__device__ __forceinline__ bool moller_trumbore(const Ray& r,
                                                const float* tr,
                                                float best_t, float& t,
                                                float& u, float& v) {
    const float p0x = tr[0], p0y = tr[1], p0z = tr[2];
    const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
    const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
    const float hx = r.dy * e2z - r.dz * e2y;
    const float hy = r.dz * e2x - r.dx * e2z;
    const float hz = r.dx * e2y - r.dy * e2x;
    const float a = e1x * hx + e1y * hy + e1z * hz;
    const float f = 1.0f / (fabsf(a) < 1e-12f ? 1e-12f : a);
    const float sx = r.ox - p0x, sy = r.oy - p0y, sz = r.oz - p0z;
    u = f * (sx * hx + sy * hy + sz * hz);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
    t = f * (e2x * qx + e2y * qy + e2z * qz);
    return fabsf(a) > 1e-12f && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
           t > 0.0f && t < best_t;
}

// The traversal stack of one thread: in shared memory, entry i of thread
// t at word i * kBlock + t, or (the lab's comparison) a local array.
template <bool SHARED>
struct Stack;

template <>
struct Stack<true> {
    int* col;
    __device__ explicit Stack(int* smem) : col(smem + threadIdx.x) {}
    __device__ int& operator[](int i) { return col[i * kBlock]; }
};

template <>
struct Stack<false> {
    int e[kStack];
    __device__ explicit Stack(int*) {}
    __device__ int& operator[](int i) { return e[i]; }
};

// One BVH8 walk of one table for one ray, the core of every entry point:
// pops until the stack empties or kMaxIters. best_t, slot (row *
// leaf_size + k), u and v change only on a hit nearer than best_t;
// any-hit stops after the first leaf that hits.
template <bool ANY_HIT, class S>
__device__ __forceinline__ void walk(const float* __restrict__ table,
                                     const int32_t* __restrict__ omm,
                                     int rows, int width, int leaf_size,
                                     const Ray& r, S& stack, float& best_t,
                                     int& slot, float& best_u,
                                     float& best_v) {
    stack[0] = 0;
    int sp = 1;
    for (int it = 0; sp > 0 && it < kMaxIters; ++it) {
        const int top = stack[min(sp - 1, kStack - 1)];
        --sp;
        if (top >= 0) {
            // ---- node: slab-test the 8 children, push far-to-near
            const float4* row4 = reinterpret_cast<const float4*>(
                table + (long long)rtxpt::clamp_row(top, rows) * width);
            float nb[56];
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
                float tn;
                const bool hit = slab(r, nb + 6 * k, best_t, tn);
                cs[k] = static_cast<int>(nb[48 + k]);
                ts[k] = hit && cs[k] != -1 ? tn : -CUDART_INF_F;
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
            const float4* row4 = reinterpret_cast<const float4*>(
                table + (long long)lrow * width);
            const int32_t* masks = omm + (long long)lrow * leaf_size;
            const int quads = (9 * count + 3) >> 2;   // float4s of the leaf
            for (int g = 0; 4 * g < count; ++g) {
                // triangles 4g .. 4g+3: 36 floats in 9 aligned float4s
                float tri[36];
#pragma unroll
                for (int j = 0; j < 9; ++j) {
                    const float4 q = 9 * g + j < quads
                                         ? __ldg(row4 + 9 * g + j)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
                    tri[4 * j + 0] = q.x;
                    tri[4 * j + 1] = q.y;
                    tri[4 * j + 2] = q.z;
                    tri[4 * j + 3] = q.w;
                }
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    const int k = 4 * g + kk;
                    float t, u, vv;
                    if (k >= count ||
                        !moller_trumbore(r, tri + 9 * kk, best_t, t, u, vv))
                        continue;
                    int cu = static_cast<int>(u * 4.0f);
                    int cv = static_cast<int>(vv * 4.0f);
                    cu = cu < 0 ? 0 : (cu > 3 ? 3 : cu);
                    cv = cv < 0 ? 0 : (cv > 3 ? 3 : cv);
                    if (((__ldg(masks + k) >> (cu * 4 + cv)) & 1) == 0)
                        continue;
                    best_t = t;
                    slot = lrow * leaf_size + k;
                    best_u = u;
                    best_v = vv;
                }
            }
            if (ANY_HIT && slot >= 0) break;
        }
    }
}

// K5 (SUB false) and K6 (SUB true): one thread per ray, one walk each
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
    __shared__ int stack_words[kStack * kBlock];
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
        const Ray r = load_ray(orig, dirs, lane);
        Stack<true> stack(stack_words);
        walk<ANY_HIT>(table, omm, rows, width, leaf_size, r, stack, best_t,
                      best, best_u, best_v);
    }
    t_out[lane] = best_t;
    slot_out[lane] = best;
    uv_out[2 * lane + 0] = best_u;
    uv_out[2 * lane + 1] = best_v;
}

struct TwoLevel {
    const float* tables;      // (K, rows, width)
    int num_sub, rows, width, leaf_size;
    const int32_t* leaf_omm;  // (K, rows*leaf_size)
    const int32_t* leaf_tris; // (K, rows*leaf_size) global triangle ids
    const float* aabb;        // (K, 6)
    int probe;                // walk the nearest overlapped subtree first
    const float* orig;
    const float* dirs;
    const float* t_max;
    const uint8_t* active;
    float* t_out;             // closest hit: t, triangle id, (u, v)
    int32_t* prim_out;
    float* uv_out;
    uint8_t* occ_out;         // any-hit: occluded
    int* next_ray;            // persistent warps' ray counter, zeroed
    int n;
};

// the whole two-level trace of one ray (see the header)
template <bool ANY_HIT, class S>
__device__ __forceinline__ void trace_two_level(const TwoLevel& p,
                                                const float* boxes,
                                                S& stack, int lane) {
    const float t_max = p.t_max[lane];
    float best_t = t_max, best_u = 0.0f, best_v = 0.0f;
    int prim = -1;
    if (p.active[lane]) {
        const Ray r = load_ray(p.orig, p.dirs, lane);
        int first = -1;
        if (p.probe) {
            float near_t = CUDART_INF_F;
            int near = 0;
            bool overlapped = false;
            for (int s = 0; s < p.num_sub; ++s) {
                float tn;
                const bool hit = slab(r, boxes + 6 * s, t_max, tn);
                overlapped |= hit;
                if (hit && tn < near_t) {
                    near_t = tn;
                    near = s;
                }
            }
            if (overlapped) first = near;
        }
        const long long table_stride = (long long)p.rows * p.width;
        const long long leaf_stride = (long long)p.rows * p.leaf_size;
        for (int i = first >= 0 ? -1 : 0; i < p.num_sub; ++i) {
            const int s = i < 0 ? first : i;
            if (i >= 0) {
                if (s == first) continue;
                float tn;
                if (!slab(r, boxes + 6 * s, t_max, tn)) continue;
                if (!ANY_HIT && !(tn < best_t)) continue;
            }
            int slot = -1;
            walk<ANY_HIT>(p.tables + s * table_stride,
                          p.leaf_omm + s * leaf_stride, p.rows, p.width,
                          p.leaf_size, r, stack, best_t, slot, best_u,
                          best_v);
            if (slot >= 0) {
                prim = __ldg(p.leaf_tris + s * leaf_stride + slot);
                if (ANY_HIT) break;
            }
        }
    }
    if (ANY_HIT) {
        p.occ_out[lane] = prim >= 0;
    } else {
        p.t_out[lane] = best_t;
        p.prim_out[lane] = prim;
        p.uv_out[2 * lane + 0] = best_u;
        p.uv_out[2 * lane + 1] = best_v;
    }
}

template <bool ANY_HIT, bool SHARED_STACK, bool PERSISTENT>
__global__ void __launch_bounds__(kBlock) bvh8_2l_kernel(TwoLevel p) {
    // the K boxes, then (SHARED_STACK) the block's stacks
    extern __shared__ float smem[];
    for (int i = threadIdx.x; i < p.num_sub * 6; i += kBlock)
        smem[i] = p.aabb[i];
    __syncthreads();
    Stack<SHARED_STACK> stack(reinterpret_cast<int*>(smem + p.num_sub * 6));
    if (PERSISTENT) {
        const int wl = threadIdx.x & 31;
        for (;;) {
            int base = 0;
            if (wl == 0) base = atomicAdd(p.next_ray, 32);
            base = __shfl_sync(0xffffffffu, base, 0);
            if (base >= p.n) break;
            if (base + wl < p.n)
                trace_two_level<ANY_HIT>(p, smem, stack, base + wl);
        }
    } else {
        const int lane = blockIdx.x * kBlock + threadIdx.x;
        if (lane < p.n) trace_two_level<ANY_HIT>(p, smem, stack, lane);
    }
}

template <bool ANY_HIT, bool SHARED_STACK, bool PERSISTENT>
int launch_2l(const TwoLevel& p, cudaStream_t stream) {
    const auto kernel = bvh8_2l_kernel<ANY_HIT, SHARED_STACK, PERSISTENT>;
    const size_t smem = sizeof(float) * 6 * p.num_sub +
                        (SHARED_STACK ? sizeof(int) * kStack * kBlock : 0);
    long long blocks = (p.n + kBlock - 1) / kBlock;
    if (PERSISTENT) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, kBlock, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
        if (blocks > resident) blocks = resident;
    }
    kernel<<<static_cast<unsigned>(blocks), kBlock, smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <bool ANY_HIT>
int launch_2l_mode(const TwoLevel& p, int mode, cudaStream_t stream) {
    switch (mode) {
    case kSharedPersistent: return launch_2l<ANY_HIT, true, true>(p, stream);
    case kSharedFlat: return launch_2l<ANY_HIT, true, false>(p, stream);
    case kLocalPersistent: return launch_2l<ANY_HIT, false, true>(p, stream);
    case kLocalFlat: return launch_2l<ANY_HIT, false, false>(p, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
    }
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

RTXPT_API int rtxpt_bvh8_trace_2l_variant(
    const float* tables, int num_sub, int rows, int width, int leaf_size,
    const int32_t* leaf_omm, const int32_t* leaf_tris, const float* aabb,
    int probe, const float* orig, const float* dirs, const float* t_max,
    const uint8_t* active, float* t_out, int32_t* prim_out, float* uv_out,
    uint8_t* occ_out, int* next_ray, int n, int any_hit, int mode,
    cudaStream_t stream) {
    if (num_sub < 1 || num_sub > kMaxSubtrees)
        return static_cast<int>(cudaErrorInvalidValue);
    const TwoLevel p{tables, num_sub, rows, width, leaf_size, leaf_omm,
                     leaf_tris, aabb, probe, orig, dirs, t_max, active,
                     t_out, prim_out, uv_out, occ_out, next_ray, n};
    return any_hit ? launch_2l_mode<true>(p, mode, stream)
                   : launch_2l_mode<false>(p, mode, stream);
}

RTXPT_API int rtxpt_bvh8_trace_2l(
    const float* tables, int num_sub, int rows, int width, int leaf_size,
    const int32_t* leaf_omm, const int32_t* leaf_tris, const float* aabb,
    int probe, const float* orig, const float* dirs, const float* t_max,
    const uint8_t* active, float* t_out, int32_t* prim_out, float* uv_out,
    uint8_t* occ_out, int* next_ray, int n, int any_hit,
    cudaStream_t stream) {
    return rtxpt_bvh8_trace_2l_variant(
        tables, num_sub, rows, width, leaf_size, leaf_omm, leaf_tris, aabb,
        probe, orig, dirs, t_max, active, t_out, prim_out, uv_out, occ_out,
        next_ray, n, any_hit, kSharedPersistent, stream);
}
