// The dense closest-hit / any-hit ray-triangle trace (scenes of at most
// 8192 triangles, clusters of 64): K1 and K7 fused into one launch per
// trace (`rtxpt_mt_dense_fused`), and the two kept as entry points of
// their own (`rtxpt_mt_dense`, K1 walking worklists it is given;
// `rtxpt_tile_keys`, K7).
//
// Replaces rtxpt_tpu/ops/mt_dense.py K1 `_make_kernel` (its `pallas_call`
// in `_trace_dense`, :947; used by `trace_closest` and `trace_anyhit`)
// and K7 `_make_prepass_kernel` (its `pallas_call` in
// `_tile_worklists_pallas`, :490). On the TPU each (ray, triangle) pair's
// Möller–Trumbore numerators came out of a W(RC,16) @ x(16,TILE) matmul on
// the MXU and the winner was picked on a t with log2(CLUSTER) mantissa
// bits dropped. The port's winners are exact (the smallest t, ties to the
// lowest slot, which is what the plain version computes), so each pair is
// an exact float32 test: no tensor cores, and no TMA for 3 KB of rows.
//
// Bound on the H100: the float32 arithmetic of the slab and per-pair
// tests. The port builds with --fmad=false (bit-equality with the plain
// version), so a multiply and an add take two issue slots and the kernel
// cannot run faster than about twice the operation bound counted at 67
// TFLOP/s. The rows of programmer-art are 81 x 64 x 48 B = 249 KB
// (`tri12`; `tri9` at a stride of 10 floats is 207 KB): they live in L2,
// and each visited cluster's 3 KB is staged in shared memory once per
// block.
//
// The fused kernel (one launch per trace): one block of 128 threads per
// tile of 128 consecutive lanes. First K7's work: each thread slab-tests
// its lane against the cluster boxes in shared memory, a group of 8
// clusters only where a lane of the warp passes the group's box
// (rounding is monotonic, so a box inside another passes only if the
// outer one does: the keys are exact); a cluster's key is the smallest
// entry t over the lanes that pass (-0.0 made +0.0, as the plain
// version); one `redux.sync` min per warp over order-preserving integer
// images of the keys and one shared-memory atomicMin per warp give the
// exact float minimum (no global atomics). The finite keys are compacted
// and ranked by (key, cluster) in one pass (at most 128, a count per
// thread), which is the order of a stable argsort. Then K1's walk, near
// to far. Tiles of active lanes only (a decoupled look-back gathering
// 128 active lanes a tile) measured no faster once the walk shared out
// its tests: a tile of active lanes from across the image has longer
// worklists (PERF.md). A tile with no active lane costs its block the
// group tests' votes.
//
// The walk (shared by the fused kernel and `rtxpt_mt_dense`): each lane
// slab-gates the list's next cluster against its running best t
// (any-hit: against t_max, and it stops at its first hit); a block skips
// a cluster no lane needs (__syncthreads_count); otherwise the cluster's
// 64 rows of `tri12` (p0.xyz + id, e1.xyz + 0, e2.xyz + 0: 192 float4s)
// are copied into shared memory with 16-byte cp.async and read back as
// three float4s per triangle. A row stops after its first test (u) where
// that already fails. Where at most kCoopMax lanes need the cluster, the
// block's 128 threads share out its (lane, row) tests, so a tile with a
// few live lanes does not wait on 64 tests in a row, and each lane's
// (t, slot) minimum comes from a shared-memory atomicMin; otherwise each
// live lane tests the 64 rows itself. Clusters come out of slot order,
// so the closest-hit update compares (t, slot): an equal t from a lower
// slot visited later still wins. A cluster's rows are copied when the
// block visits it: copying the next entry's rows in flight measured
// slower on the H100 (PERF.md), since the resident blocks hide the copy,
// and it is wasted where the block then skips the entry.
//
// The OMM channel (template flag OMM of the fused kernel; K1's
// `_make_kernel(has_omm=True)` epilogue, `_pair_test`, :536-568): a masked
// table carries each triangle's 16-bit opacity micro-mask as an exact
// float in the word after e1 (tri12 column 7, zero in unmasked tables),
// so it rides the row copies at no extra load. A pair that passes the
// Möller–Trumbore and t tests takes u and v as its sign-folded numerators
// over |a|, its cell as K5's leaf test does (csrc/bvh8_trace.cu: u * 4 and
// v * 4 truncated, clamped to 0..3) and is rejected where bit cu * 4 + cv
// is clear, before it can update the best t or end an any-hit lane: two
// divisions, two multiplies and a shift on the pairs that hit.
//
// Lab modes (tools_torch/profile_mt_kernel.py, the counterpart of the
// reference's ablated variants in tools/profile_mt_kernel.py): K1's
// (enum Mode, `rtxpt_mt_dense_variant`) and the fused kernel's (enum
// FusedMode, `rtxpt_mt_dense_fused_variant`).
#include "common.cuh"

#include <climits>

namespace {

constexpr int kCluster = 64;
constexpr int kBlock = 128;          // ops/mt_dense.py TILE
constexpr int kMaxClusters = 128;    // MAX_TRIS / kCluster
constexpr int kRowVecs = 3;          // float4s per tri12 row
constexpr int kClusterVecs = kCluster * kRowVecs;
constexpr int kWarps = kBlock / 32;
constexpr int kGroup = 8;            // clusters under one group box
constexpr int kMaxGroups = kMaxClusters / kGroup;
constexpr unsigned kFull = 0xffffffffu;

enum Mode {
    kWalk = 0,     // K1
    kNoSkip = 1,   // no block-uniform skip: every worklist cluster staged
    kNoGate = 2,   // no slab gate: every active lane tests every cluster
    kGate = 3,     // worklist walk and gates only; slot_out = visit count
};

enum FusedMode {
    kFused = 0,          // the main path
    kLists = 1,          // keys and worklists only; slot_out = list length
};
// a cluster that at most this many lanes need is tested cooperatively
constexpr int kCoopMax = 64;

__device__ __forceinline__ float safe_inv(float c) {
    float s = fabsf(c) < 1e-12f ? (c < 0.0f ? -1e-12f : 1e-12f) : c;
    return 1.0f / s;
}

// an int whose order is that of the (non-NaN) float; its own inverse
__device__ __forceinline__ int ordered(int bits) {
    return bits >= 0 ? bits : bits ^ 0x7fffffff;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::);
}

struct Ray {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmax;
};

__device__ __forceinline__ Ray load_ray(const float* orig, const float* dirs,
                                        const float* t_max, long long lane) {
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
    r.tmax = t_max[lane];
    return r;
}

__device__ __forceinline__ Ray idle_ray() {
    Ray r;
    r.ox = r.oy = r.oz = 0.0f;
    r.dx = r.dy = r.dz = 1.0f;
    r.ix = r.iy = r.iz = 1.0f;
    r.tmax = 0.0f;
    return r;
}

// one cluster's 64 rows into shared memory, as one cp.async group
__device__ __forceinline__ void stage_rows(float4* dst, const float4* tri12,
                                           int c) {
    const float4* src = tri12 + (long long)c * kClusterVecs;
    for (int k = threadIdx.x; k < kClusterVecs; k += kBlock)
        cp_async16(dst + k, src + k);
    cp_async_commit();
}

// one Möller–Trumbore test of the ray (o, d) against a tri12 row: true
// and its t where it hits, sign-folded by a (two-sided), in the plain
// version's operations and order; OMM: and where its cell's mask bit is set
template <bool OMM>
__device__ __forceinline__ bool mt_row(float ox, float oy, float oz,
                                       float dx, float dy, float dz,
                                       const float4* row, float& t) {
    const float4 p0 = row[0], e1 = row[1], e2 = row[2];
    const float hx = dy * e2.z - dz * e2.y;
    const float hy = dz * e2.x - dx * e2.z;
    const float hz = dx * e2.y - dy * e2.x;
    const float a = e1.x * hx + e1.y * hy + e1.z * hz;
    const float sx = ox - p0.x, sy = oy - p0.y, sz = oz - p0.z;
    const float uu = sx * hx + sy * hy + sz * hz;
    const bool neg = a < 0.0f;
    const float absa = neg ? -a : a;
    const float su = neg ? -uu : uu;
    // su > absa fails the test below too (sv >= 0 and the rounded su + sv
    // is at least su): most rows stop here
    if (!(absa > 1e-12f) || !(su >= 0.0f) || !(su <= absa)) return false;
    const float qx = sy * e1.z - sz * e1.y;
    const float qy = sz * e1.x - sx * e1.z;
    const float qz = sx * e1.y - sy * e1.x;
    const float vv = dx * qx + dy * qy + dz * qz;
    const float tt = e2.x * qx + e2.y * qy + e2.z * qz;
    const float sv = neg ? -vv : vv;
    const float st = neg ? -tt : tt;
    if (!(sv >= 0.0f) || !(su + sv <= absa) || !(st > 0.0f)) return false;
    if (OMM) {
        int cu = static_cast<int>(su / absa * 4.0f);
        int cv = static_cast<int>(sv / absa * 4.0f);
        cu = cu < 0 ? 0 : (cu > 3 ? 3 : cu);
        cv = cv < 0 ? 0 : (cv > 3 ? 3 : cv);
        if (((static_cast<int>(e1.w) >> (cu * 4 + cv)) & 1) == 0) return false;
    }
    t = st / absa;
    return true;
}

struct WalkShared {
    float4 rows[kClusterVecs];      // the staged cluster
    float4 o[kBlock];               // the live lanes' origins and best t
    float4 d[kBlock];               // their directions and best slot
    unsigned long long hit[kBlock]; // their (t, slot) minimum, packed
    int warp_sum[kWarps];
};

// K1's walk of a block's worklist s_list[0..cnt) (block-uniform), the
// boxes in s_box; updates the lane's (best, slot), or counts its visits
// (kGate). Where at most kCoopMax lanes need a cluster, the
// block's threads share out its (lane, row) tests and take each lane's
// (t, slot) minimum with a shared-memory atomicMin on (t bits, slot)
// (t > 0, so the bits order as the floats); otherwise each live lane
// tests the 64 rows itself.
template <bool ANY_HIT, int MODE, bool OMM>
__device__ __forceinline__ void walk(const float* s_box, const int* s_list,
                                     int cnt, const float4* tri12,
                                     WalkShared& ws, const Ray& r, bool act,
                                     float& best, int& slot, int& visits) {
    const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int j = 0; j < cnt; ++j) {
        const int c = s_list[j];
        bool live = act && (!ANY_HIT || slot < 0);
        if (MODE != kNoGate && live) {
            const float* b = s_box + c * 6;
            float t0x = (b[0] - r.ox) * r.ix, t1x = (b[3] - r.ox) * r.ix;
            float t0y = (b[1] - r.oy) * r.iy, t1y = (b[4] - r.oy) * r.iy;
            float t0z = (b[2] - r.oz) * r.iz, t1z = (b[5] - r.oz) * r.iz;
            float lim = ANY_HIT ? r.tmax : best;
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
        const int lanes = __syncthreads_count(live);
        if (MODE != kNoSkip && lanes == 0) continue;
        stage_rows(ws.rows, tri12, c);
        const bool coop = lanes <= kCoopMax;
        const unsigned ballot = __ballot_sync(kFull, live);
        if (coop && wl == 0) ws.warp_sum[warp] = __popc(ballot);
        cp_async_wait_all();
        __syncthreads();
        if (coop) {
            int q = __popc(ballot & ((1u << wl) - 1u));
            for (int w = 0; w < warp; ++w) q += ws.warp_sum[w];
            if (live) {
                ws.o[q] = make_float4(r.ox, r.oy, r.oz,
                                      ANY_HIT ? r.tmax : best);
                ws.d[q] = make_float4(r.dx, r.dy, r.dz,
                                      __int_as_float(ANY_HIT ? -1 : slot));
                ws.hit[q] = ~0ull;
            }
            __syncthreads();
            for (int p = threadIdx.x; p < lanes * kCluster; p += kBlock) {
                const int lq = p / kCluster, k = p - lq * kCluster;
                const float4 o = ws.o[lq], d = ws.d[lq];
                float t;
                if (!mt_row<OMM>(o.x, o.y, o.z, d.x, d.y, d.z,
                                 ws.rows + k * kRowVecs, t))
                    continue;
                const int s = c * kCluster + k;
                // the sequential update's acceptance (below)
                if (ANY_HIT ? t < o.w
                            : t < o.w || (t == o.w && s < __float_as_int(d.w)))
                    atomicMin(ws.hit + lq,
                              (static_cast<unsigned long long>(
                                   __float_as_uint(t)) << 32) |
                                  static_cast<unsigned>(s));
            }
            __syncthreads();
            if (live) {
                const unsigned long long h = ws.hit[q];
                if (h != ~0ull) {
                    best = __uint_as_float(static_cast<unsigned>(h >> 32));
                    slot = static_cast<int>(static_cast<unsigned>(h));
                }
            }
        } else if (live) {
            float cbest = ANY_HIT ? r.tmax : best;
            int cslot = ANY_HIT ? -1 : slot;
            for (int k = 0; k < kCluster; ++k) {
                float t;
                if (!mt_row<OMM>(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz,
                                 ws.rows + k * kRowVecs, t))
                    continue;
                const int s = c * kCluster + k;
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
}

template <bool ANY_HIT, int MODE>
__global__ void __launch_bounds__(kBlock)
mt_dense_kernel(const float* __restrict__ aabb,   // (nc, 6) recentered
                const float4* __restrict__ tri12, // (nc*64, 12) recentered
                int nc,
                const int32_t* __restrict__ counts,  // (tiles,)
                const int32_t* __restrict__ order,   // (tiles, nc)
                const float* __restrict__ orig,   // (n, 3) recentered
                const float* __restrict__ dirs,   // (n, 3)
                const float* __restrict__ t_max,  // (n,)
                const uint8_t* __restrict__ active,
                float* __restrict__ t_out, int32_t* __restrict__ slot_out,
                int n) {
    __shared__ float s_box[kMaxClusters * 6];
    __shared__ int s_list[kMaxClusters];
    __shared__ WalkShared ws;
    const int cnt = counts[blockIdx.x];
    const int32_t* list = order + (long long)blockIdx.x * nc;
    for (int k = threadIdx.x; k < nc * 6; k += kBlock) s_box[k] = aabb[k];
    for (int k = threadIdx.x; k < cnt; k += kBlock) s_list[k] = list[k];
    const int lane = blockIdx.x * kBlock + threadIdx.x;
    const bool in_range = lane < n;
    const Ray r = in_range ? load_ray(orig, dirs, t_max, lane) : idle_ray();
    const bool act = in_range && active[lane] != 0;
    float best = r.tmax;
    int slot = -1, visits = 0;
    __syncthreads();
    walk<ANY_HIT, MODE, false>(s_box, s_list, cnt, tri12, ws, r, act, best,
                               slot, visits);
    if (in_range) {
        t_out[lane] = best;
        slot_out[lane] = MODE == kGate ? visits : slot;
    }
}

struct Fused {
    const float* aabb;          // (nc, 6) recentered
    const float4* tri12;        // (nc*64, 12) recentered
    int nc;
    const float* orig;          // (n, 3) recentered
    const float* dirs;          // (n, 3)
    const float* t_max;         // (n,)
    const uint8_t* active;      // (n,)
    float* t_out;
    int32_t* slot_out;
    int n;
};

struct FusedShared {
    float box[kMaxClusters * 6];
    float group_box[kMaxGroups * 6];   // the union of kGroup boxes
    int key[kMaxClusters];      // ordered() images of the tile's keys
    int fkey[kMaxClusters];     // the finite ones, compacted
    int fidx[kMaxClusters];
    int list[kMaxClusters];     // the worklist, near to far
    int warp_sum[kWarps];
    int finite;
};

// K7's slab test of box `b`: whether it passes, and the entry t
__device__ __forceinline__ bool key_slab(const float* b, const Ray& r,
                                         float& tn) {
    float t0x = (b[0] - r.ox) * r.ix, t1x = (b[3] - r.ox) * r.ix;
    float t0y = (b[1] - r.oy) * r.iy, t1y = (b[4] - r.oy) * r.iy;
    float t0z = (b[2] - r.oz) * r.iz, t1z = (b[5] - r.oz) * r.iz;
    tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                     fminf(fmaxf(t0z, t1z), r.tmax));
    return fmaxf(tn, 0.0f) <= tf;
}

// K7's keys for the tile's lanes, and its worklist, near to far ->
// sh.list[0..sh.finite). A warp tests the clusters of a group only if
// one of its lanes passes the group's box: rounding is monotonic, so a
// box inside another passes the slab test only if the outer one does,
// and the skipped clusters are exactly those with no passing lane.
__device__ __forceinline__ void tile_list(const Fused& p, FusedShared& sh,
                                          const Ray& r, bool act) {
    const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int c = threadIdx.x; c < p.nc; c += kBlock) sh.key[c] = INT_MAX;
    __syncthreads();
    for (int g = 0; g * kGroup < p.nc; ++g) {
        float tn;
        if (!__any_sync(kFull, act && key_slab(sh.group_box + 6 * g, r, tn)))
            continue;
        const int last = min(p.nc, (g + 1) * kGroup);
        for (int c = g * kGroup; c < last; ++c) {
            const bool pass = act && key_slab(sh.box + c * 6, r, tn);
            if (__any_sync(kFull, pass)) {
                // + 0.0f: -0.0 keys become +0.0, as in the plain version
                const int key =
                    pass ? ordered(__float_as_int(tn + 0.0f)) : INT_MAX;
                const int m = __reduce_min_sync(kFull, key);
                if (wl == 0) atomicMin(sh.key + c, m);
            }
        }
    }
    __syncthreads();
    // the finite keys, compacted in cluster order, then ranked by (key,
    // cluster)
    const int c = threadIdx.x;
    bool finite = false;
    if (c < p.nc && sh.key[c] != INT_MAX)
        finite = isfinite(__int_as_float(ordered(sh.key[c])));
    const unsigned b = __ballot_sync(kFull, finite);
    if (wl == 0) sh.warp_sum[warp] = __popc(b);
    __syncthreads();
    int at = __popc(b & ((1u << wl) - 1u)), m = 0;
    for (int w = 0; w < kWarps; ++w) {
        at += w < warp ? sh.warp_sum[w] : 0;
        m += sh.warp_sum[w];
    }
    if (finite) {
        sh.fkey[at] = sh.key[c];
        sh.fidx[at] = c;
    }
    if (threadIdx.x == 0) sh.finite = m;
    __syncthreads();
    if (threadIdx.x < m) {
        const int k = sh.fkey[threadIdx.x], i = sh.fidx[threadIdx.x];
        int rank = 0;
        for (int q = 0; q < m; ++q) {
            const int kq = sh.fkey[q];
            rank += kq < k || (kq == k && sh.fidx[q] < i);
        }
        sh.list[rank] = i;
    }
    __syncthreads();
}

// one tile: its keys, its worklist and the walk, then each lane's result
template <bool ANY_HIT, int MODE, bool OMM>
__global__ void __launch_bounds__(kBlock) mt_dense_fused_kernel(Fused p) {
    __shared__ FusedShared sh;
    __shared__ WalkShared ws;
    for (int k = threadIdx.x; k < p.nc * 6; k += kBlock) sh.box[k] = p.aabb[k];
    __syncthreads();
    for (int g = threadIdx.x; g * kGroup < p.nc; g += kBlock) {
        const int last = min(p.nc, (g + 1) * kGroup);
        for (int k = 0; k < 6; ++k) {
            float v = sh.box[g * kGroup * 6 + k];
            for (int c = g * kGroup + 1; c < last; ++c)
                v = k < 3 ? fminf(v, sh.box[c * 6 + k])
                          : fmaxf(v, sh.box[c * 6 + k]);
            sh.group_box[g * 6 + k] = v;
        }
    }
    // tile_list's first barrier orders the group boxes before their reads
    const long long lane = (long long)blockIdx.x * kBlock + threadIdx.x;
    const bool in = lane < p.n;
    const Ray r = in ? load_ray(p.orig, p.dirs, p.t_max, lane) : idle_ray();
    const bool act = in && p.active[lane] != 0;
    tile_list(p, sh, r, act);
    float best = r.tmax;
    int slot = -1, visits = 0;
    if (MODE == kLists)
        slot = sh.finite;
    else
        walk<ANY_HIT, kWalk, OMM>(sh.box, sh.list, sh.finite, p.tri12, ws, r,
                                  act, best, slot, visits);
    if (in) {
        p.t_out[lane] = best;
        p.slot_out[lane] = slot;
    }
}

int fused(const float* aabb, const float* tri12, int nc, const float* orig,
          const float* dirs, const float* t_max, const uint8_t* active,
          float* t_out, int32_t* slot_out, int n, int any_hit, int omm,
          int mode, cudaStream_t stream) {
    if (nc < 1 || nc > kMaxClusters || n < 1 ||
        (mode != kFused && mode != kLists))
        return static_cast<int>(cudaErrorInvalidValue);
    const Fused p{aabb, reinterpret_cast<const float4*>(tri12), nc, orig,
                  dirs, t_max, active, t_out, slot_out, n};
    const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
    if (mode == kLists)   // the lists depend on neither any_hit nor omm
        mt_dense_fused_kernel<false, kLists, false>
            <<<blocks, kBlock, 0, stream>>>(p);
    else if (any_hit && omm)
        mt_dense_fused_kernel<true, kFused, true>
            <<<blocks, kBlock, 0, stream>>>(p);
    else if (any_hit)
        mt_dense_fused_kernel<true, kFused, false>
            <<<blocks, kBlock, 0, stream>>>(p);
    else if (omm)
        mt_dense_fused_kernel<false, kFused, true>
            <<<blocks, kBlock, 0, stream>>>(p);
    else
        mt_dense_fused_kernel<false, kFused, false>
            <<<blocks, kBlock, 0, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
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
int launch_k1(const float* aabb, const float* tri12, int nc,
              const int32_t* counts, const int32_t* order, const float* orig,
              const float* dirs, const float* t_max, const uint8_t* active,
              float* t_out, int32_t* slot_out, int n, cudaStream_t stream) {
    if (nc < 1 || nc > kMaxClusters)
        return static_cast<int>(cudaErrorInvalidValue);
    unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
    mt_dense_kernel<ANY_HIT, MODE><<<blocks, kBlock, 0, stream>>>(
        aabb, reinterpret_cast<const float4*>(tri12), nc, counts, order,
        orig, dirs, t_max, active, t_out, slot_out, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// one dense trace: each tile's worklist and the walk; omm: the table's
// rows carry opacity micro-masks, and the OMM channel tests them
RTXPT_API int rtxpt_mt_dense_fused(const float* aabb, const float* tri12,
                                   int nc, const float* orig,
                                   const float* dirs, const float* t_max,
                                   const uint8_t* active, float* t_out,
                                   int32_t* slot_out, int n, int any_hit,
                                   int omm, cudaStream_t stream) {
    return fused(aabb, tri12, nc, orig, dirs, t_max, active, t_out, slot_out,
                 n, any_hit, omm, kFused, stream);
}

// the fused kernel in one of its lab modes (enum FusedMode)
RTXPT_API int rtxpt_mt_dense_fused_variant(
    const float* aabb, const float* tri12, int nc, const float* orig,
    const float* dirs, const float* t_max, const uint8_t* active,
    float* t_out, int32_t* slot_out, int n, int any_hit, int mode,
    cudaStream_t stream) {
    return fused(aabb, tri12, nc, orig, dirs, t_max, active, t_out, slot_out,
                 n, any_hit, 0, mode, stream);
}

RTXPT_API int rtxpt_mt_dense(const float* aabb, const float* tri12, int nc,
                             const int32_t* counts, const int32_t* order,
                             const float* orig, const float* dirs,
                             const float* t_max, const uint8_t* active,
                             float* t_out, int32_t* slot_out, int n,
                             int any_hit, cudaStream_t stream) {
    return any_hit
        ? launch_k1<true, kWalk>(aabb, tri12, nc, counts, order, orig, dirs,
                                 t_max, active, t_out, slot_out, n, stream)
        : launch_k1<false, kWalk>(aabb, tri12, nc, counts, order, orig,
                                  dirs, t_max, active, t_out, slot_out, n,
                                  stream);
}

// the closest-hit K1 in one of its lab modes (enum Mode)
RTXPT_API int rtxpt_mt_dense_variant(const float* aabb, const float* tri12,
                                     int nc, const int32_t* counts,
                                     const int32_t* order, const float* orig,
                                     const float* dirs, const float* t_max,
                                     const uint8_t* active, float* t_out,
                                     int32_t* slot_out, int n, int mode,
                                     cudaStream_t stream) {
    switch (mode) {
    case kWalk:
        return launch_k1<false, kWalk>(aabb, tri12, nc, counts, order, orig,
                                       dirs, t_max, active, t_out, slot_out,
                                       n, stream);
    case kNoSkip:
        return launch_k1<false, kNoSkip>(aabb, tri12, nc, counts, order,
                                         orig, dirs, t_max, active, t_out,
                                         slot_out, n, stream);
    case kNoGate:
        return launch_k1<false, kNoGate>(aabb, tri12, nc, counts, order,
                                         orig, dirs, t_max, active, t_out,
                                         slot_out, n, stream);
    case kGate:
        return launch_k1<false, kGate>(aabb, tri12, nc, counts, order, orig,
                                       dirs, t_max, active, t_out, slot_out,
                                       n, stream);
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
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
