// K1: dense closest-hit / any-hit ray-triangle trace (scenes of at most
// 8192 triangles, clusters of 64), and K7: the per-tile cluster worklist
// prepass it walks.
//
// K1 replaces rtxpt_tpu/ops/mt_dense.py `_make_kernel` (dispatched by
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
// 128-thread blocks; the block of tile b walks tile b's worklist (K7):
// the clusters some active lane of the tile can enter, nearest entry
// first, so the running best t tightens early. Each cluster is
// slab-tested against the lane's running best t; a block skips a cluster
// no lane needs (__syncthreads_or), otherwise stages its 64 rows (p0, e1,
// e2, 2.3 KB) in shared memory once for the whole block. Clusters come
// out of slot order, so the closest-hit update compares (t, slot): an
// equal t from a lower slot visited later still wins. Any-hit is a
// template flag that stops a lane at its first hit.
//
// K7 replaces rtxpt_tpu/ops/mt_dense.py `_make_prepass_kernel` (its
// `pallas_call` in `_tile_worklists_pallas`): for each tile of `tile`
// lanes and each cluster, the smallest slab entry t over the tile's
// active lanes whose slab test passes (+inf where none does), and the
// tile's worklist from them: counts (finite keys) and order (the
// clusters by key, ties by index, as a stable argsort). Bound: float32
// slab tests (25 operations per lane and cluster). Design: one block per
// tile, the cluster boxes in shared memory, each thread slab-tests its
// lane against every cluster; a warp-shuffle min and a min over the
// block's warps in shared memory give each cluster's key. No atomics on
// the keys: they can be negative (origins inside a box), and a float min
// is exact, so the keys equal the plain version's bit for bit. The
// block then sorts its (key, cluster) pairs in shared memory (bitonic,
// at most 128 of them), which costs less than a separate sort pass over
// all tiles.
//
// The modes of K1 beside kFull exist for the dense-trace lab
// (tools_torch/profile_mt_kernel.py, the counterpart of the reference's
// ablated variants in tools/profile_mt_kernel.py).
#include "common.cuh"

namespace {

constexpr int kCluster = 64;
constexpr int kBlock = 128;          // ops/mt_dense.py TILE
constexpr int kMaxClusters = 128;    // MAX_TRIS / kCluster

enum Mode {
    kFull = 0,     // K1
    kNoSkip = 1,   // no block-uniform skip: every worklist cluster staged
    kNoGate = 2,   // no slab gate: every active lane tests every cluster
    kGate = 3,     // worklist walk and gates only; slot_out = visit count
};

__device__ __forceinline__ float safe_inv(float c) {
    float s = fabsf(c) < 1e-12f ? (c < 0.0f ? -1e-12f : 1e-12f) : c;
    return 1.0f / s;
}

template <bool ANY_HIT, int MODE>
__global__ void __launch_bounds__(kBlock)
mt_dense_kernel(const float* __restrict__ aabb,   // (nc, 6) recentered
                const float* __restrict__ tri9,   // (nc*64, 10) recentered
                int nc,
                const int32_t* __restrict__ counts,  // (tiles,)
                const int32_t* __restrict__ order,   // (tiles, nc)
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
    int visits = 0;
    const int cnt = counts[blockIdx.x];
    const int32_t* list = order + (long long)blockIdx.x * nc;

    for (int j = 0; j < cnt; ++j) {
        const int c = list[j];
        bool live = act && (!ANY_HIT || slot < 0);
        if (MODE != kNoGate && live) {
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
        if (MODE == kGate) {
            visits += live ? 1 : 0;
            continue;
        }
        // uniform over the block; kNoSkip stages every cluster
        if (MODE != kNoSkip && !__syncthreads_or(live)) continue;
        for (int k = threadIdx.x; k < kCluster * 9; k += kBlock) {
            int r = k / 9;
            s_tri[k] = tri9[(long long)(c * kCluster + r) * 10 + (k - r * 9)];
        }
        __syncthreads();
        if (live) {
            float cbest = ANY_HIT ? tmax : best;
            int cslot = ANY_HIT ? -1 : slot;
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
                const int s = c * kCluster + r;
                if (ANY_HIT) {
                    if (t < cbest) {
                        cbest = t;
                        cslot = s;
                        break;
                    }
                } else if (t < cbest || (t == cbest && s < cslot)) {
                    // exact (t, slot) minimum over the out-of-order visits
                    cbest = t;
                    cslot = s;
                }
            }
            if (cslot >= 0) {
                best = cbest;
                slot = cslot;
            }
        }
        __syncthreads();
    }
    if (in_range) {
        t_out[lane] = best;
        slot_out[lane] = MODE == kGate ? visits : slot;
    }
}

__global__ void tile_keys_kernel(const float* __restrict__ aabb, int nc,
                                 const float* __restrict__ orig,
                                 const float* __restrict__ dirs,
                                 const float* __restrict__ t_max,
                                 const uint8_t* __restrict__ active,
                                 float* __restrict__ keys,
                                 int32_t* __restrict__ counts,
                                 int32_t* __restrict__ order, int n) {
    __shared__ float s_box[kMaxClusters * 6];
    __shared__ float s_min[32][kMaxClusters];   // [warp][cluster]
    __shared__ float s_key[kMaxClusters];
    __shared__ int s_idx[kMaxClusters];
    __shared__ int s_count;
    if (threadIdx.x == 0) s_count = 0;
    for (int k = threadIdx.x; k < nc * 6; k += blockDim.x) s_box[k] = aabb[k];
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
    float tm = 0.f;
    bool act = false;
    if (lane < n) {
        ox = orig[lane * 3 + 0];
        oy = orig[lane * 3 + 1];
        oz = orig[lane * 3 + 2];
        dx = dirs[lane * 3 + 0];
        dy = dirs[lane * 3 + 1];
        dz = dirs[lane * 3 + 2];
        tm = t_max[lane];
        act = active[lane] != 0;
    }
    const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
        float key = __int_as_float(0x7f800000);   // +inf
        if (act) {
            const float* b = s_box + c * 6;
            float t0x = (b[0] - ox) * ix, t1x = (b[3] - ox) * ix;
            float t0y = (b[1] - oy) * iy, t1y = (b[4] - oy) * iy;
            float t0z = (b[2] - oz) * iz, t1z = (b[5] - oz) * iz;
            float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fminf(t0z, t1z));
            float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), tm));
            // + 0.0f: -0.0 keys become +0.0, so the min's bits do not
            // depend on which of two equal zeros it met first
            if (fmaxf(tn, 0.0f) <= tf) key = tn + 0.0f;
        }
        for (int off = 16; off > 0; off >>= 1)
            key = fminf(key, __shfl_xor_sync(0xffffffffu, key, off));
        if (wl == 0) s_min[warp][c] = key;
    }
    __syncthreads();
    const int warps = blockDim.x >> 5;
    const long long row = (long long)blockIdx.x * nc;
    int p = 1;                       // the sort's width: a power of two
    while (p < nc) p <<= 1;
    int finite = 0;
    for (int c = threadIdx.x; c < p; c += blockDim.x) {
        float m = __int_as_float(0x7f800000);
        if (c < nc) {
            m = s_min[0][c];
            for (int w = 1; w < warps; ++w) m = fminf(m, s_min[w][c]);
            keys[row + c] = m;
            finite += isfinite(m) ? 1 : 0;
        }
        s_key[c] = m;                // padding: +inf after every cluster
        s_idx[c] = c;
    }
    atomicAdd(&s_count, finite);
    // bitonic sort of the (key, cluster) pairs, ascending; the pairs are
    // distinct, so the order is that of a stable argsort of the keys
    for (int k = 2; k <= p; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            __syncthreads();
            for (int i = threadIdx.x; i < p; i += blockDim.x) {
                const int l = i ^ j;
                if (l <= i) continue;
                const float ki = s_key[i], kl = s_key[l];
                const int ii = s_idx[i], il = s_idx[l];
                const bool after = ki > kl || (ki == kl && ii > il);
                if (after == ((i & k) == 0)) {
                    s_key[i] = kl;
                    s_key[l] = ki;
                    s_idx[i] = il;
                    s_idx[l] = ii;
                }
            }
        }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < nc; j += blockDim.x)
        order[row + j] = s_idx[j];
    if (threadIdx.x == 0) counts[blockIdx.x] = s_count;
}

template <bool ANY_HIT, int MODE>
void launch_k1(const float* aabb, const float* tri9, int nc,
               const int32_t* counts, const int32_t* order,
               const float* orig, const float* dirs, const float* t_max,
               const uint8_t* active, float* t_out, int32_t* slot_out, int n,
               cudaStream_t stream) {
    unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
    mt_dense_kernel<ANY_HIT, MODE><<<blocks, kBlock, 0, stream>>>(
        aabb, tri9, nc, counts, order, orig, dirs, t_max, active, t_out,
        slot_out, n);
}

}  // namespace

RTXPT_API int rtxpt_mt_dense(const float* aabb, const float* tri9, int nc,
                             const int32_t* counts, const int32_t* order,
                             const float* orig, const float* dirs,
                             const float* t_max, const uint8_t* active,
                             float* t_out, int32_t* slot_out, int n,
                             int any_hit, cudaStream_t stream) {
    if (any_hit)
        launch_k1<true, kFull>(aabb, tri9, nc, counts, order, orig, dirs,
                               t_max, active, t_out, slot_out, n, stream);
    else
        launch_k1<false, kFull>(aabb, tri9, nc, counts, order, orig, dirs,
                                t_max, active, t_out, slot_out, n, stream);
    return static_cast<int>(cudaGetLastError());
}

// the closest-hit K1 in one of its lab modes (enum Mode)
RTXPT_API int rtxpt_mt_dense_variant(const float* aabb, const float* tri9,
                                     int nc, const int32_t* counts,
                                     const int32_t* order, const float* orig,
                                     const float* dirs, const float* t_max,
                                     const uint8_t* active, float* t_out,
                                     int32_t* slot_out, int n, int mode,
                                     cudaStream_t stream) {
    switch (mode) {
    case kFull:
        launch_k1<false, kFull>(aabb, tri9, nc, counts, order, orig, dirs,
                                t_max, active, t_out, slot_out, n, stream);
        break;
    case kNoSkip:
        launch_k1<false, kNoSkip>(aabb, tri9, nc, counts, order, orig, dirs,
                                  t_max, active, t_out, slot_out, n, stream);
        break;
    case kNoGate:
        launch_k1<false, kNoGate>(aabb, tri9, nc, counts, order, orig, dirs,
                                  t_max, active, t_out, slot_out, n, stream);
        break;
    case kGate:
        launch_k1<false, kGate>(aabb, tri9, nc, counts, order, orig, dirs,
                                t_max, active, t_out, slot_out, n, stream);
        break;
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

RTXPT_API int rtxpt_tile_keys(const float* aabb, int nc, const float* orig,
                              const float* dirs, const float* t_max,
                              const uint8_t* active, float* keys,
                              int32_t* counts, int32_t* order, int n,
                              int tile, cudaStream_t stream) {
    if (nc < 1 || nc > kMaxClusters || tile < 32 || tile > 1024 ||
        tile % 32 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    unsigned blocks = static_cast<unsigned>((n + tile - 1) / tile);
    tile_keys_kernel<<<blocks, tile, 0, stream>>>(aabb, nc, orig, dirs, t_max,
                                                  active, keys, counts, order,
                                                  n);
    return static_cast<int>(cudaGetLastError());
}
