// K1: dense closest-hit / any-hit ray-triangle trace (scenes of at most
// 8192 triangles, clusters of 64).
//
// Replaces: rtxpt_tpu/ops/mt_dense.py `_make_kernel` (dispatched by
// `_trace_dense`, used by `trace_closest` and `trace_anyhit`). On the TPU
// each (ray, triangle) pair's Möller–Trumbore numerators came out of a
// W(RC,16) @ x(16,TILE) matmul on the MXU and the winner was picked on a
// t with log2(CLUSTER) mantissa bits dropped; here each thread tests its
// ray against the triangles directly and keeps the exact smallest t (ties
// to the lowest slot), which is what the plain version computes.
//
// Bound on the H100: float32 arithmetic of the per-pair tests (about 40
// operations per pair; the 81 clusters x 64 rows of the programmer-art
// table are 32 KB and stay in L1/L2) and lane divergence, since a warp
// runs the union of its lanes' clusters. Design: one thread per ray,
// 128-thread blocks. Each cluster is slab-tested against the lane's
// running best t; a block skips a cluster no lane needs
// (__syncthreads_or), otherwise stages its 64 rows (p0, e1, e2, 2.3 KB)
// in shared memory once for the whole block. Any-hit is a template flag
// that stops a lane at its first hit. Near-to-far cluster order (the
// TPU's per-tile worklist prepass) is left to a later optimisation: with
// in-order visits the exact tie rule needs no extra state.
#include "common.cuh"

namespace {

constexpr int kCluster = 64;
constexpr int kBlock = 128;

__device__ __forceinline__ float safe_inv(float c) {
    float s = fabsf(c) < 1e-12f ? (c < 0.0f ? -1e-12f : 1e-12f) : c;
    return 1.0f / s;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(kBlock)
mt_dense_kernel(const float* __restrict__ aabb,   // (nc, 6) recentered
                const float* __restrict__ tri9,   // (nc*64, 10) recentered
                int nc,
                const float* __restrict__ orig,   // (n, 3) recentered
                const float* __restrict__ dirs,   // (n, 3)
                const float* __restrict__ t_max,  // (n,)
                const uint8_t* __restrict__ active,
                float* __restrict__ t_out, int32_t* __restrict__ slot_out,
                int n) {
    __shared__ float s_tri[kCluster * 9];
    const int lane = blockIdx.x * kBlock + threadIdx.x;
    const bool in_range = lane < n;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
    float tmax = 0.f;
    bool act = false;
    if (in_range) {
        ox = orig[lane * 3 + 0];
        oy = orig[lane * 3 + 1];
        oz = orig[lane * 3 + 2];
        dx = dirs[lane * 3 + 0];
        dy = dirs[lane * 3 + 1];
        dz = dirs[lane * 3 + 2];
        tmax = t_max[lane];
        act = active[lane] != 0;
    }
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    float best = tmax;
    int slot = -1;

    for (int c = 0; c < nc; ++c) {
        bool live = act && (!ANY_HIT || slot < 0);
        if (live) {
            const float* b = aabb + c * 6;
            float t0x = (b[0] - ox) * ix, t1x = (b[3] - ox) * ix;
            float t0y = (b[1] - oy) * iy, t1y = (b[4] - oy) * iy;
            float t0z = (b[2] - oz) * iz, t1z = (b[5] - oz) * iz;
            float lim = ANY_HIT ? tmax : best;
            float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fmaxf(fminf(t0z, t1z), 0.0f));
            float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), lim));
            live = tn <= tf;
        }
        if (!__syncthreads_or(live)) continue;   // uniform over the block
        for (int k = threadIdx.x; k < kCluster * 9; k += kBlock) {
            int r = k / 9;
            s_tri[k] = tri9[(long long)(c * kCluster + r) * 10 + (k - r * 9)];
        }
        __syncthreads();
        if (live) {
            const float lim = ANY_HIT ? tmax : best;
            float cbest = lim;
            int crow = -1;
            for (int r = 0; r < kCluster; ++r) {
                const float* tr = s_tri + r * 9;
                const float p0x = tr[0], p0y = tr[1], p0z = tr[2];
                const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
                const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
                const float hx = dy * e2z - dz * e2y;
                const float hy = dz * e2x - dx * e2z;
                const float hz = dx * e2y - dy * e2x;
                const float a = e1x * hx + e1y * hy + e1z * hz;
                const float sx = ox - p0x, sy = oy - p0y, sz = oz - p0z;
                const float uu = sx * hx + sy * hy + sz * hz;
                const float qx = sy * e1z - sz * e1y;
                const float qy = sz * e1x - sx * e1z;
                const float qz = sx * e1y - sy * e1x;
                const float vv = dx * qx + dy * qy + dz * qz;
                const float tt = e2x * qx + e2y * qy + e2z * qz;
                const bool neg = a < 0.0f;
                const float absa = neg ? -a : a;
                const float su = neg ? -uu : uu;
                const float sv = neg ? -vv : vv;
                const float st = neg ? -tt : tt;
                if (!(absa > 1e-12f) || !(su >= 0.0f) || !(sv >= 0.0f) ||
                    !(su + sv <= absa) || !(st > 0.0f))
                    continue;
                const float t = st / absa;
                if (ANY_HIT) {
                    if (t < lim) {
                        cbest = t;
                        crow = r;
                        break;
                    }
                } else if (t < cbest) {
                    cbest = t;
                    crow = r;
                }
            }
            if (crow >= 0) {
                best = cbest;
                slot = c * kCluster + crow;
            }
        }
        __syncthreads();
    }
    if (in_range) {
        t_out[lane] = best;
        slot_out[lane] = slot;
    }
}

}  // namespace

RTXPT_API int rtxpt_mt_dense(const float* aabb, const float* tri9, int nc,
                             const float* orig, const float* dirs,
                             const float* t_max, const uint8_t* active,
                             float* t_out, int32_t* slot_out, int n,
                             int any_hit, cudaStream_t stream) {
    unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
    if (any_hit)
        mt_dense_kernel<true><<<blocks, kBlock, 0, stream>>>(
            aabb, tri9, nc, orig, dirs, t_max, active, t_out, slot_out, n);
    else
        mt_dense_kernel<false><<<blocks, kBlock, 0, stream>>>(
            aabb, tri9, nc, orig, dirs, t_max, active, t_out, slot_out, n);
    return static_cast<int>(cudaGetLastError());
}
