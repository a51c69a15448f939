// K2 row gather, K3 barycentric row blend, and the surface fetch (K2 + K3).
//
// Replaces: rtxpt_tpu/ops/gather_pallas.py `_make_kernel` (K2, via
// `_gather`/`gather_rows`) and `_make_interp_kernel` (K3, via
// `_gather_interp`/`gather_rows_interp`); the surface fetch replaces the
// four fetches of rtxpt_tpu/pt/shading.py `load_surface` (the triangle row,
// the blend of its three vertex rows, its geometry row and its material
// row) with one launch. The TPU versions fetch rows with one-hot bf16
// matmuls over three residual planes because XLA gathers are slow on that
// chip; here a gather is a load.
//
// Bound on the H100: the bytes written. The scene tables are small against
// the 50 MB L2 (the city's largest, vert_pack, is 10.3 MB), so after first
// touch the rows come from L2, and a gather costs its indices read once and
// its output written once (a surface fetch: 12 B in, 256 B out per lane).
// What the design does about it:
//  - A block takes a tile of lanes. Its threads read the tile's indices
//    once, coalesced, clamp them and keep them in shared memory.
//  - A row moves as 16-byte words where its byte stride and the table's
//    base allow, else as 8-byte words, else as 4-byte words (`Vec`; the
//    wrapper picks and says which, ops/gather.py `instance`).
//  - Thread j of a tile moves output word j: every store of a warp covers
//    consecutive addresses, and a warp's loads read consecutive words of a
//    few rows. For the surface fetch's 46-word material row this layout
//    was chosen over staging whole rows in shared memory: it gives the
//    same store pattern without a copy through shared memory or a barrier.
//  - Each thread issues kUnroll independent row loads (K3 and the vertex
//    blend: three each) before its first store.
//  - The row width in words is a template constant for the main paths'
//    tables (4, 5, 10, 12, 24, 46), so word j's lane is a 32-bit multiply
//    and shift; one instance per word size takes the width at run time (a
//    32-bit divide). The only 64-bit product is each row's and tile's base.
// Rows are moved as bits, so one K2 serves f32 and i32 tables. The blend is
// (w0*r0 + w1*r1) + w2*r2 in __fmul_rn/__fadd_rn, which are never
// contracted into a fused multiply-add: the float32 operations and order
// of the plain version and of the TPU kernel.
#include "common.cuh"

namespace {

constexpr int kUnroll = 4;

// lanes per tile: at least kUnroll row words per thread where rows are short
__host__ __device__ constexpr int tile_lanes(int c) {
    return c > 0 && c < kUnroll ? rtxpt::kThreads * (kUnroll / c)
                                : rtxpt::kThreads;
}

__device__ __forceinline__ float blend(float a, float b, float c, float w0,
                                       float w1, float w2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, w1)),
                     __fmul_rn(c, w2));
}

__device__ __forceinline__ float2 blend(float2 a, float2 b, float2 c,
                                        float w0, float w1, float w2) {
    return make_float2(blend(a.x, b.x, c.x, w0, w1, w2),
                       blend(a.y, b.y, c.y, w0, w1, w2));
}

__device__ __forceinline__ float4 blend(float4 a, float4 b, float4 c,
                                        float w0, float w1, float w2) {
    return make_float4(blend(a.x, b.x, c.x, w0, w1, w2),
                       blend(a.y, b.y, c.y, w0, w1, w2),
                       blend(a.z, b.z, c.z, w0, w1, w2),
                       blend(a.w, b.w, c.w, w0, w1, w2));
}

// out[l * c + k] = table[row[l] * c + k] for the tile's `lanes` lanes, in
// words of type Vec (c words a row: C when C > 0, else c_rt)
template <int C, typename Vec>
__device__ __forceinline__ void copy_rows(const Vec* __restrict__ table,
                                          int c_rt, const int* row,
                                          Vec* __restrict__ out, int lanes) {
    const unsigned c = C > 0 ? C : c_rt;
    const unsigned total = lanes * c;
    for (unsigned j0 = threadIdx.x; j0 < total;
         j0 += kUnroll * rtxpt::kThreads) {
        Vec v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            const unsigned j = j0 + k * rtxpt::kThreads;
            if (j < total) {
                const unsigned l = j / c;
                v[k] = __ldg(table + (size_t)(unsigned)row[l] * c
                             + (j - l * c));
            }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            const unsigned j = j0 + k * rtxpt::kThreads;
            if (j < total) out[j] = v[k];
        }
    }
}

// out[l * c + k] = (w0*T[r0] + w1*T[r1]) + w2*T[r2] over word k of the
// rows r = row[v][l] with weights w = wt[v][l] (K3's blend)
template <int C, typename Vec, int L>
__device__ __forceinline__ void blend_rows(const Vec* __restrict__ table,
                                           int c_rt, const int (*row)[L],
                                           const float (*wt)[L],
                                           Vec* __restrict__ out,
                                           int lanes) {
    const unsigned c = C > 0 ? C : c_rt;
    const unsigned total = lanes * c;
    for (unsigned j0 = threadIdx.x; j0 < total;
         j0 += kUnroll * rtxpt::kThreads) {
        Vec a[kUnroll], b[kUnroll], d[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            const unsigned j = j0 + k * rtxpt::kThreads;
            if (j < total) {
                const unsigned l = j / c, col = j - l * c;
                a[k] = __ldg(table + (size_t)(unsigned)row[0][l] * c + col);
                b[k] = __ldg(table + (size_t)(unsigned)row[1][l] * c + col);
                d[k] = __ldg(table + (size_t)(unsigned)row[2][l] * c + col);
            }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
            const unsigned j = j0 + k * rtxpt::kThreads;
            if (j < total) {
                const unsigned l = j / c;
                out[j] = blend(a[k], b[k], d[k], wt[0][l], wt[1][l],
                               wt[2][l]);
            }
        }
    }
}

// K2: one tile of tile_lanes(C) lanes per block iteration
template <int C, typename Vec>
__global__ void __launch_bounds__(rtxpt::kThreads)
gather_rows_kernel(const Vec* __restrict__ table, int rows, int c_rt,
                   const int32_t* __restrict__ idx, Vec* __restrict__ out,
                   int n) {
    constexpr int L = tile_lanes(C);
    __shared__ int s_row[L];
    const int c = C > 0 ? C : c_rt;
    const int tiles = n / L + (n % L != 0);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int base = t * L;
        const int lanes = min(L, n - base);
        for (int i = threadIdx.x; i < lanes; i += rtxpt::kThreads)
            s_row[i] = rtxpt::clamp_row(__ldg(idx + base + i), rows);
        __syncthreads();
        copy_rows<C, Vec>(table, c, s_row, out + (size_t)base * c, lanes);
        __syncthreads();
    }
}

// K3: the tile's three indices and weights a lane, read coalesced from the
// (N, 3) arrays
template <int C, typename Vec>
__global__ void __launch_bounds__(rtxpt::kThreads)
gather_interp_kernel(const Vec* __restrict__ table, int rows, int c_rt,
                     const int32_t* __restrict__ idx3,
                     const float* __restrict__ w3, Vec* __restrict__ out,
                     int n) {
    constexpr int L = rtxpt::kThreads;
    __shared__ int s_row[3][L];
    __shared__ float s_w[3][L];
    const int c = C > 0 ? C : c_rt;
    const int tiles = n / L + (n % L != 0);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int base = t * L;
        const int lanes = min(L, n - base);
        for (int i = threadIdx.x; i < 3 * lanes; i += rtxpt::kThreads) {
            const int l = i / 3, v = i - 3 * l;
            s_row[v][l] = rtxpt::clamp_row(__ldg(idx3 + 3 * base + i), rows);
            s_w[v][l] = __ldg(w3 + 3 * base + i);
        }
        __syncthreads();
        blend_rows<C, Vec, L>(table, c, s_row, s_w, out + (size_t)base * c,
                              lanes);
        __syncthreads();
    }
}

// The surface fetch, per lane: p = clamp(prim), tp = tri_pack[p] (one
// 16-byte load where tri_pack allows, else four 4-byte loads), w = ((1 -
// b0) - b1, b0, b1), then vi = K3's blend of vert_pack's rows tp.xyz,
// geom = tri_geom_pack[p] and mrow = mat_pack[tp.w] (rows clamped as K2 and
// K3 clamp them), and mid = tp.w as it is.
template <typename VecV, typename VecM>
__global__ void __launch_bounds__(rtxpt::kThreads)
gather_surface_kernel(const int32_t* __restrict__ tri_pack, int n_tris,
                      bool tri16, const VecV* __restrict__ vert, int n_verts,
                      const float* __restrict__ tri_geom,
                      const VecM* __restrict__ mat, int n_mats,
                      const int32_t* __restrict__ prim,
                      const float2* __restrict__ bary,
                      VecV* __restrict__ vi, float* __restrict__ geom,
                      VecM* __restrict__ mrow, int32_t* __restrict__ mid,
                      int n) {
    constexpr int L = rtxpt::kThreads;
    constexpr int CV = 12 * 4 / sizeof(VecV), CM = 46 * 4 / sizeof(VecM);
    __shared__ int s_tri[L], s_mat[L], s_vert[3][L];
    __shared__ float s_w[3][L];
    const int tiles = n / L + (n % L != 0);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int base = t * L;
        const int lanes = min(L, n - base);
        const int i = threadIdx.x;
        if (i < lanes) {
            const int p = rtxpt::clamp_row(__ldg(prim + base + i), n_tris);
            const float2 b = __ldg(bary + base + i);
            int4 tp;
            if (tri16) {
                tp = __ldg(reinterpret_cast<const int4*>(tri_pack) + p);
            } else {
                const int32_t* r = tri_pack + (size_t)(unsigned)p * 4;
                tp = make_int4(__ldg(r), __ldg(r + 1), __ldg(r + 2),
                               __ldg(r + 3));
            }
            s_tri[i] = p;
            s_vert[0][i] = rtxpt::clamp_row(tp.x, n_verts);
            s_vert[1][i] = rtxpt::clamp_row(tp.y, n_verts);
            s_vert[2][i] = rtxpt::clamp_row(tp.z, n_verts);
            s_mat[i] = rtxpt::clamp_row(tp.w, n_mats);
            s_w[0][i] = __fsub_rn(__fsub_rn(1.0f, b.x), b.y);
            s_w[1][i] = b.x;
            s_w[2][i] = b.y;
            mid[base + i] = tp.w;
        }
        __syncthreads();
        blend_rows<CV, VecV, L>(vert, CV, s_vert, s_w, vi + (size_t)base * CV,
                                lanes);
        copy_rows<5, float>(tri_geom, 5, s_tri, geom + (size_t)base * 5,
                            lanes);
        copy_rows<CM, VecM>(mat, CM, s_mat, mrow + (size_t)base * CM, lanes);
        __syncthreads();
    }
}

// 32-bit word indices within a tile: its lanes times a row's words
bool fits(int lanes, int c) {
    return c > 0 && (long long)lanes * c < (1LL << 31);
}

template <int C, typename Vec>
int launch_rows(const void* table, int rows, int c, const int32_t* idx,
                void* out, int n, cudaStream_t stream) {
    constexpr int L = tile_lanes(C);
    if (!fits(L, c)) return static_cast<int>(cudaErrorInvalidValue);
    gather_rows_kernel<C, Vec><<<rtxpt::grid_for(n, L), rtxpt::kThreads, 0,
                                 stream>>>(static_cast<const Vec*>(table),
                                           rows, c, idx,
                                           static_cast<Vec*>(out), n);
    return static_cast<int>(cudaGetLastError());
}

template <int C, typename Vec>
int launch_interp(const float* table, int rows, int c, const int32_t* idx3,
                  const float* w3, float* out, int n, cudaStream_t stream) {
    if (!fits(rtxpt::kThreads, c))
        return static_cast<int>(cudaErrorInvalidValue);
    gather_interp_kernel<C, Vec><<<rtxpt::grid_for(n), rtxpt::kThreads, 0,
                                   stream>>>(
        reinterpret_cast<const Vec*>(table), rows, c, idx3, w3,
        reinterpret_cast<Vec*>(out), n);
    return static_cast<int>(cudaGetLastError());
}

template <typename VecV, typename VecM>
int launch_surface(const int32_t* tri_pack, int n_tris, bool tri16,
                   const float* vert, int n_verts, const float* tri_geom,
                   const float* mat, int n_mats, const int32_t* prim,
                   const float* bary, float* vi, float* geom, float* mrow,
                   int32_t* mid, int n, cudaStream_t stream) {
    gather_surface_kernel<VecV, VecM><<<rtxpt::grid_for(n), rtxpt::kThreads,
                                        0, stream>>>(
        tri_pack, n_tris, tri16, reinterpret_cast<const VecV*>(vert), n_verts,
        tri_geom, reinterpret_cast<const VecM*>(mat), n_mats, prim,
        reinterpret_cast<const float2*>(bary), reinterpret_cast<VecV*>(vi),
        geom, reinterpret_cast<VecM*>(mrow), mid, n);
    return static_cast<int>(cudaGetLastError());
}

template <typename VecV>
int launch_surface_m(int mat_bytes, const int32_t* tri_pack, int n_tris,
                     bool tri16, const float* vert, int n_verts,
                     const float* tri_geom, const float* mat, int n_mats,
                     const int32_t* prim, const float* bary, float* vi,
                     float* geom, float* mrow, int32_t* mid, int n,
                     cudaStream_t stream) {
    if (mat_bytes == 8)
        return launch_surface<VecV, float2>(tri_pack, n_tris, tri16, vert,
                                            n_verts, tri_geom, mat, n_mats,
                                            prim, bary, vi, geom, mrow, mid,
                                            n, stream);
    if (mat_bytes == 4)
        return launch_surface<VecV, float>(tri_pack, n_tris, tri16, vert,
                                           n_verts, tri_geom, mat, n_mats,
                                           prim, bary, vi, geom, mrow, mid, n,
                                           stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// word_bytes: 16, 8 or 4, dividing width * 4 and the table's address
RTXPT_API int rtxpt_gather_rows(const void* table, int rows, int width,
                                const int32_t* idx, void* out, int n,
                                int word_bytes, cudaStream_t stream) {
    if (width <= 0 || word_bytes <= 0 || width * 4 % word_bytes != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int c = width * 4 / word_bytes;
    switch (word_bytes) {
    case 16:
        if (width == 4)
            return launch_rows<1, uint4>(table, rows, c, idx, out, n, stream);
        if (width == 12)
            return launch_rows<3, uint4>(table, rows, c, idx, out, n, stream);
        if (width == 24)
            return launch_rows<6, uint4>(table, rows, c, idx, out, n, stream);
        return launch_rows<0, uint4>(table, rows, c, idx, out, n, stream);
    case 8:
        if (width == 10)
            return launch_rows<5, uint2>(table, rows, c, idx, out, n, stream);
        if (width == 46)
            return launch_rows<23, uint2>(table, rows, c, idx, out, n,
                                          stream);
        return launch_rows<0, uint2>(table, rows, c, idx, out, n, stream);
    case 4:
        if (width == 5)
            return launch_rows<5, uint32_t>(table, rows, c, idx, out, n,
                                            stream);
        return launch_rows<0, uint32_t>(table, rows, c, idx, out, n, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

RTXPT_API int rtxpt_gather_rows_interp(const float* table, int rows,
                                       int width, const int32_t* idx3,
                                       const float* w3, float* out, int n,
                                       int word_bytes, cudaStream_t stream) {
    if (width <= 0 || word_bytes <= 0 || width * 4 % word_bytes != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int c = width * 4 / word_bytes;
    switch (word_bytes) {
    case 16:
        if (width == 12)
            return launch_interp<3, float4>(table, rows, c, idx3, w3, out, n,
                                            stream);
        return launch_interp<0, float4>(table, rows, c, idx3, w3, out, n,
                                        stream);
    case 8:
        return launch_interp<0, float2>(table, rows, c, idx3, w3, out, n,
                                        stream);
    case 4:
        return launch_interp<0, float>(table, rows, c, idx3, w3, out, n,
                                       stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// tri_bytes 16 or 4 (tri_pack's address), vert_bytes 16, 8 or 4 and
// mat_bytes 8 or 4 (the tables' addresses); bary 8-byte aligned
RTXPT_API int rtxpt_gather_surface(const int32_t* tri_pack, int n_tris,
                                   int tri_bytes, const float* vert,
                                   int n_verts, int vert_bytes,
                                   const float* tri_geom, const float* mat,
                                   int n_mats, int mat_bytes,
                                   const int32_t* prim, const float* bary,
                                   float* vi, float* geom, float* mrow,
                                   int32_t* mid, int n, cudaStream_t stream) {
    const bool tri16 = tri_bytes == 16;
    switch (vert_bytes) {
    case 16:
        return launch_surface_m<float4>(mat_bytes, tri_pack, n_tris, tri16,
                                        vert, n_verts, tri_geom, mat, n_mats,
                                        prim, bary, vi, geom, mrow, mid, n,
                                        stream);
    case 8:
        return launch_surface_m<float2>(mat_bytes, tri_pack, n_tris, tri16,
                                        vert, n_verts, tri_geom, mat, n_mats,
                                        prim, bary, vi, geom, mrow, mid, n,
                                        stream);
    case 4:
        return launch_surface_m<float>(mat_bytes, tri_pack, n_tris, tri16,
                                       vert, n_verts, tri_geom, mat, n_mats,
                                       prim, bary, vi, geom, mrow, mid, n,
                                       stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
