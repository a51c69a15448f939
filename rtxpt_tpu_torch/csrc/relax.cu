// ReLAX's image passes and the TAA resolve: one launch per temporal pass,
// variance pass, a-trous iteration and resolve.
//
// Replaces: no TPU kernel. The reference's ReLAX and TAA
// (rtxpt_tpu/denoise/relax.py, rtxpt_tpu/post/taa.py) are XLA code. The
// port's plain versions (denoise/relax.py and post/taa.py, the `*_plain`
// functions) issue one PyTorch launch per tap and operation, most of them
// over strided windows of edge-padded copies: ~2,600 launches per ReLAX
// channel and ~200 per TAA resolve, each a pass over every pixel.
//
// Bound on the H100: bytes for the temporal pass (100 B a pixel), the
// variance pass (28 B) and the resolve (48 B). An a-trous iteration reads
// each pixel's radiance, variance, normal and depth (and the specular
// channel's roughness) once and writes its radiance and variance once,
// 48-52 B a pixel, ~0.03 ms at 1920x1080 and 3.35 TB/s; but its 24 taps
// each take two expf, a powf and two IEEE divisions (a third expf on the
// specular channel), and that arithmetic, not the taps' reads, sets its
// time: the iteration takes as long at step 8 as at step 1 (PERF.md).
// What the design does about it:
//  - One thread a pixel in 32 x 8 blocks, so that a warp's taps read
//    neighbouring addresses of one row. Neighbours are read by clamped
//    index, which is what the plain version's edge-padded copies hold, so
//    nothing is padded, stacked or copied; every intermediate stays in
//    registers. The temporal pass reads the five history fields in place;
//    the variance pass and the a-trous taps recompute a neighbour's
//    luminance from its RGB instead of reading a luminance plane.
//  - The plain version's float32 operations in its order: --fmad=false, no
//    fast math, expf / powf / sqrtf as PyTorch's kernels call them, a
//    division by a host scalar as PyTorch's CUDA kernel computes it (a
//    multiply by the float reciprocal), a Python scalar rounded from
//    double as PyTorch rounds it, and `dot3` in the order of PyTorch's
//    reduction over a last dimension of 3. So the outputs are bit-equal
//    to the plain version's on the card.
//  - Sizes, the step and the filters' parameters are kernel arguments: no
//    host value is copied to the device and nothing synchronises.
#include "common.cuh"

namespace {

constexpr int kBX = 32, kBY = 8;

// a Python float operand of a PyTorch op, rounded to float32
#define F32(x) static_cast<float>(x)

// torch.clamp / clamp_min / clamp_max with scalar bounds: NaN passes
__device__ __forceinline__ float clamp_lo(float v, float lo) {
    return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_hi(float v, float hi) {
    return isnan(v) ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_s(float v, float lo, float hi) {
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// torch.clamp with tensor bounds, torch.minimum, torch.maximum
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
    if (isnan(v)) return v;
    if (isnan(lo)) return lo;
    if (isnan(hi)) return hi;
    return fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float minimum(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float maximum(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// mu.luminance
__device__ __forceinline__ float luminance(float r, float g, float b) {
    return (r * F32(0.2126) + g * F32(0.7152)) + b * F32(0.0722);
}
__device__ __forceinline__ float luminance(const float* rgb) {
    return luminance(rgb[0], rgb[1], rgb[2]);
}

// torch.sum(a * b, -1) over 3 channels: PyTorch's reduction gives a
// 3-wide last dimension two threads, element 0 and 2 on one, 1 on the
// other, and adds their sums
__device__ __forceinline__ float dot3(const float* a, const float* b) {
    return (a[0] * b[0] + a[2] * b[2]) + a[1] * b[1];
}

// x / k for a host scalar k on CUDA tensors: x * (1 / k) in float
constexpr float kInv9 = 1.0f / 9.0f;

__device__ __forceinline__ int clampi(int v, int n) {
    return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// ---- temporal reprojection and accumulation ------------------------------

__global__ void __launch_bounds__(kBX* kBY) relax_temporal_kernel(
    const float* __restrict__ h_rad, const float* __restrict__ h_mom,
    const float* __restrict__ h_hist, const float* __restrict__ h_nrm,
    const float* __restrict__ h_z, const float* __restrict__ rad,
    const float* __restrict__ nrm, const float* __restrict__ vz,
    const float* __restrict__ motion, float* __restrict__ o_rad,
    float* __restrict__ o_mom, float* __restrict__ o_hist, int h, int w,
    float max_history, float history_clamp) {
    const int x = blockIdx.x * kBX + threadIdx.x;
    const int y = blockIdx.y * kBY + threadIdx.y;
    if (x >= w || y >= h) return;
    const int i = y * w + x;
    const float px = static_cast<float>(x) + motion[2 * i];
    const float py = static_cast<float>(y) + motion[2 * i + 1];
    const bool in_bounds = px >= 0.0f && px <= static_cast<float>(w - 1) &&
                           py >= 0.0f && py <= static_cast<float>(h - 1);

    // _bilinear_gather of the history, its fields read in place
    const long long fx0 = static_cast<long long>(floorf(px));
    const long long fy0 = static_cast<long long>(floorf(py));
    const int x0 = static_cast<int>(fx0 < 0 ? 0 : (fx0 > w - 1 ? w - 1 : fx0));
    const int y0 = static_cast<int>(fy0 < 0 ? 0 : (fy0 > h - 1 ? h - 1 : fy0));
    const int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
    const float fx = clamp_s(px - static_cast<float>(x0), 0.0f, 1.0f);
    const float fy = clamp_s(py - static_cast<float>(y0), 0.0f, 1.0f);
    const int c00 = y0 * w + x0, c01 = y0 * w + x1, c10 = y1 * w + x0,
              c11 = y1 * w + x1;
    auto bil = [&](const float* f, int n, int k) {
        const float a = f[c00 * n + k] * (1.0f - fx) + f[c01 * n + k] * fx;
        const float b = f[c10 * n + k] * (1.0f - fx) + f[c11 * n + k] * fx;
        return a * (1.0f - fy) + b * fy;
    };
    float prev_rad[3], prev_mom[2], prev_nrm[3];
    for (int k = 0; k < 3; ++k) prev_rad[k] = bil(h_rad, 3, k);
    for (int k = 0; k < 2; ++k) prev_mom[k] = bil(h_mom, 2, k);
    float prev_hist = bil(h_hist, 1, 0);
    for (int k = 0; k < 3; ++k) prev_nrm[k] = bil(h_nrm, 3, k);
    const float prev_z = bil(h_z, 1, 0);

    // disocclusion tests
    const float* n_c = nrm + 3 * i;
    const float z_c = vz[i];
    const bool nrm_ok = dot3(n_c, prev_nrm) > F32(0.8);
    const bool z_ok =
        fabsf(z_c - prev_z) < clamp_lo(z_c, F32(1e-3)) * F32(0.1);
    const bool valid = in_bounds && nrm_ok && z_ok && z_c < F32(1e29);

    const float* r_c = rad + 3 * i;
    if (history_clamp > 0.0f) {
        // the anti-lag clamp to the current 3x3 box (edge clamp)
        float m1[3] = {0.0f, 0.0f, 0.0f}, m2[3] = {0.0f, 0.0f, 0.0f};
        for (int dy = -1; dy <= 1; ++dy) {
            const int yy = clampi(y - dy, h);
            for (int dx = -1; dx <= 1; ++dx) {
                const float* s = rad + 3 * (yy * w + clampi(x - dx, w));
                for (int k = 0; k < 3; ++k) {
                    m1[k] = m1[k] + s[k];
                    m2[k] = m2[k] + s[k] * s[k];
                }
            }
        }
        float moved_rgb[3], box_m[3];
        for (int k = 0; k < 3; ++k) {
            box_m[k] = m1[k] * kInv9;
            const float box_s = sqrtf(
                clamp_lo(m2[k] * kInv9 - box_m[k] * box_m[k], 0.0f));
            const float reach = box_s * history_clamp;
            const float c = clamp_t(prev_rad[k], box_m[k] - reach,
                                    box_m[k] + reach);
            moved_rgb[k] = fabsf(c - prev_rad[k]);
            prev_rad[k] = c;
        }
        const float moved = luminance(moved_rgb) /
            clamp_lo(luminance(box_m) + F32(1e-4), F32(1e-4));
        prev_hist = prev_hist * clamp_s(1.0f - moved, F32(0.25), 1.0f);
    }

    const float hist = valid ? clamp_hi(prev_hist + 1.0f, max_history) : 1.0f;
    const float alpha = 1.0f / hist;
    const float lum = luminance(r_c);
    const float mom_new[2] = {lum, lum * lum};
    for (int k = 0; k < 3; ++k) {
        const float a = valid ? prev_rad[k] : r_c[k];
        o_rad[3 * i + k] = a + (r_c[k] - a) * alpha;
    }
    for (int k = 0; k < 2; ++k) {
        const float a = valid ? prev_mom[k] : mom_new[k];
        o_mom[2 * i + k] = a + (mom_new[k] - a) * alpha;
    }
    o_hist[i] = hist;
}

// ---- variance: temporal, or a 7x7 zero-padded box for young pixels -------

__global__ void __launch_bounds__(kBX* kBY) relax_variance_kernel(
    const float* __restrict__ rad, const float* __restrict__ mom,
    const float* __restrict__ hist, float* __restrict__ out, int h, int w) {
    const int x = blockIdx.x * kBX + threadIdx.x;
    const int y = blockIdx.y * kBY + threadIdx.y;
    if (x >= w || y >= h) return;
    const int i = y * w + x;
    if (!(hist[i] < 4.0f)) {
        const float m1 = mom[2 * i], m2 = mom[2 * i + 1];
        out[i] = clamp_lo(m2 - m1 * m1, 0.0f);
        return;
    }
    // _box_blur_zero: each column summed over dy in order, then the
    // columns over dx in order, each sum from Python's `0 +`
    float b1 = 0.0f, b2 = 0.0f;
    for (int dx = -3; dx <= 3; ++dx) {
        const int xx = x + dx;
        float c1 = 0.0f, c2 = 0.0f;
        if (xx >= 0 && xx < w) {
            for (int dy = -3; dy <= 3; ++dy) {
                const int yy = y + dy;
                const float l = (yy >= 0 && yy < h)
                    ? luminance(rad + 3 * (yy * w + xx)) : 0.0f;
                c1 = c1 + l;
                c2 = c2 + l * l;
            }
        }
        b1 = b1 + c1;
        b2 = b2 + c2;
    }
    b1 = b1 * F32(1.0 / 49.0);
    b2 = b2 * F32(1.0 / 49.0);
    out[i] = clamp_lo(b2 - b1 * b1, 0.0f);
}

// ---- one edge-aware a-trous iteration ------------------------------------

template <bool SPEC>
__global__ void __launch_bounds__(kBX* kBY) relax_atrous_kernel(
    const float* __restrict__ rad, const float* __restrict__ var,
    const float* __restrict__ nrm, const float* __restrict__ vz,
    const float* __restrict__ rough, float* __restrict__ o_rad,
    float* __restrict__ o_var, int h, int w, int step, float phi_lum,
    float phi_normal, float phi_z) {
    const int x = blockIdx.x * kBX + threadIdx.x;
    const int y = blockIdx.y * kBY + threadIdx.y;
    if (x >= w || y >= h) return;
    const int i = y * w + x;
    // weights_5 = 1/16, 1/4, 3/8, 1/4, 1/16: every product of two exact.
    // An array indexed at run time (24 bytes of stack) measured faster than
    // a select chain or fully unrolled taps (PERF.md)
    const float k5[5] = {1.0f / 16, 1.0f / 4, 3.0f / 8, 1.0f / 4, 1.0f / 16};
    const float wc = k5[2] * k5[2];

    const float* r_c = rad + 3 * i;
    const float* n_c = nrm + 3 * i;
    const float z_c = vz[i], v_c = var[i];
    const float lum_c = luminance(r_c);
    float phi_n = phi_normal, sigma_l;
    float rough_c = 0.0f;
    if (SPEC) {
        rough_c = rough[i];
        phi_n = (1.0f / clamp_s(rough_c * rough_c, F32(1.0 / 64.0), 1.0f))
            * phi_normal;
        const float lum_scale = clamp_s(rough_c * 2.0f, F32(0.1), 1.0f);
        sigma_l = (lum_scale * phi_lum) * sqrtf(clamp_lo(v_c, F32(1e-10)))
            + F32(1e-4);
    } else {
        sigma_l = sqrtf(clamp_lo(v_c, F32(1e-10))) * phi_lum + F32(1e-4);
    }
    const float z_scale = clamp_lo(z_c, F32(1e-3)) * phi_z;

    float acc[3] = {r_c[0] * wc, r_c[1] * wc, r_c[2] * wc};
    float acc_v = v_c * (wc * wc);
    float acc_w = wc;
    for (int jy = -2; jy <= 2; ++jy) {
        const int yy = clampi(y - jy * step, h);
        for (int jx = -2; jx <= 2; ++jx) {
            if (jy == 0 && jx == 0) continue;
            const int j = yy * w + clampi(x - jx * step, w);
            const float* r_s = rad + 3 * j;
            const float w_l = expf(-fabsf(luminance(r_s) - lum_c) / sigma_l);
            const float w_n = powf(clamp_lo(dot3(n_c, nrm + 3 * j), 0.0f),
                                   phi_n);
            const float w_z = expf(-fabsf(vz[j] - z_c) / z_scale);
            float wgt = w_l * (k5[jy + 2] * k5[jx + 2]) * w_n * w_z;
            if (SPEC)
                wgt = wgt * expf(-fabsf(rough[j] - rough_c) *
                                 (1.0f / F32(0.3)));
            for (int k = 0; k < 3; ++k) acc[k] = acc[k] + r_s[k] * wgt;
            acc_v = acc_v + var[j] * wgt * wgt;
            acc_w = acc_w + wgt;
        }
    }
    const float norm = clamp_lo(acc_w, F32(1e-8));
    for (int k = 0; k < 3; ++k) o_rad[3 * i + k] = acc[k] / norm;
    o_var[i] = acc_v / clamp_lo(acc_w * acc_w, F32(1e-8));
}

// ---- TAA: Catmull-Rom history fetch, 3x3 variance clip, blend -------------

// Catmull-Rom weights of the offsets -1, 0, 1, 2 (taa._crw)
__device__ __forceinline__ void crw(float f, float* wt) {
    const float f2 = f * f;
    const float f3 = f2 * f;
    wt[0] = (f3 * F32(-0.5) + f2) - f * F32(0.5);
    wt[1] = (f3 * F32(1.5) - f2 * F32(2.5)) + 1.0f;
    wt[2] = (f3 * F32(-1.5) + f2 * 2.0f) + f * F32(0.5);
    wt[3] = f3 * F32(0.5) - f2 * F32(0.5);
}

__global__ void __launch_bounds__(kBX* kBY) taa_resolve_kernel(
    const float* __restrict__ history, const float* __restrict__ color,
    const float* __restrict__ motion, const float* __restrict__ mask,
    float* __restrict__ out, int h, int w, float blend, float clip_sigma) {
    const int x = blockIdx.x * kBX + threadIdx.x;
    const int y = blockIdx.y * kBY + threadIdx.y;
    if (x >= w || y >= h) return;
    const int i = y * w + x;
    const float px = static_cast<float>(x) + motion[2 * i];
    const float py = static_cast<float>(y) + motion[2 * i + 1];

    // _catmull_rom_gather: the 4x4 texels around the clamped base texel
    const float xc = floorf(px - 0.5f) + 0.5f;
    const float yc = floorf(py - 0.5f) + 0.5f;
    float wx[4], wy[4];
    crw(px - xc, wx);
    crw(py - yc, wy);
    const long long bx = static_cast<long long>(xc - 0.5f);
    const long long by = static_cast<long long>(yc - 0.5f);
    const int x0 = static_cast<int>(bx < 0 ? 0 : (bx > w - 1 ? w - 1 : bx));
    const int y0 = static_cast<int>(by < 0 ? 0 : (by > h - 1 ? h - 1 : by));
    float acc[3] = {0.0f, 0.0f, 0.0f}, wacc = 0.0f;
    for (int j = 0; j < 4; ++j) {
        const int yy = clampi(y0 + j - 1, h);
        for (int t = 0; t < 4; ++t) {
            const float* s = history + 3 * (yy * w + clampi(x0 + t - 1, w));
            const float tw = wx[t] * wy[j];
            for (int k = 0; k < 3; ++k) acc[k] = acc[k] + s[k] * tw;
            wacc = wacc + tw;
        }
    }
    const float wnorm = clamp_lo(wacc, F32(1e-8));
    const bool in_bounds = px >= 0.0f && px <= static_cast<float>(w - 1) &&
                           py >= 0.0f && py <= static_cast<float>(h - 1);

    // the variance clip to the 3x3 window: the centre, then 8 neighbours
    const float* c = color + 3 * i;
    float m1[3], m2[3], cmin[3], cmax[3];
    for (int k = 0; k < 3; ++k) {
        m1[k] = c[k];
        m2[k] = c[k] * c[k];
        cmin[k] = c[k];
        cmax[k] = c[k];
    }
    for (int jy = -1; jy <= 1; ++jy) {
        const int yy = clampi(y - jy, h);
        for (int jx = -1; jx <= 1; ++jx) {
            if (jy == 0 && jx == 0) continue;
            const float* s = color + 3 * (yy * w + clampi(x - jx, w));
            for (int k = 0; k < 3; ++k) {
                m1[k] = m1[k] + s[k];
                m2[k] = m2[k] + s[k] * s[k];
                cmin[k] = minimum(cmin[k], s[k]);
                cmax[k] = maximum(cmax[k], s[k]);
            }
        }
    }
    float b = blend;
    if (mask) b = maximum(b, clamp_s(mask[i], 0.0f, 1.0f));
    for (int k = 0; k < 3; ++k) {
        const float mean = m1[k] * kInv9;
        const float sigma =
            sqrtf(clamp_lo(m2[k] * kInv9 - mean * mean, 0.0f)) * clip_sigma;
        const float lo = maximum(mean - sigma, cmin[k]);
        const float hi = minimum(mean + sigma, cmax[k]);
        const float hist = clamp_t(acc[k] / wnorm, lo, hi);
        out[3 * i + k] = in_bounds ? hist + (c[k] - hist) * b : c[k];
    }
}

dim3 grid2d(int h, int w) {
    return dim3((w + kBX - 1) / kBX, (h + kBY - 1) / kBY);
}

}  // namespace

// Every image is a contiguous float32 (h, w[, c]) array; outputs are
// written whole and never alias an input.

RTXPT_API int rtxpt_relax_temporal(
    const float* h_rad, const float* h_mom, const float* h_hist,
    const float* h_nrm, const float* h_z, const float* rad, const float* nrm,
    const float* vz, const float* motion, float* o_rad, float* o_mom,
    float* o_hist, int h, int w, float max_history, float history_clamp,
    cudaStream_t stream) {
    relax_temporal_kernel<<<grid2d(h, w), dim3(kBX, kBY), 0, stream>>>(
        h_rad, h_mom, h_hist, h_nrm, h_z, rad, nrm, vz, motion, o_rad, o_mom,
        o_hist, h, w, max_history, history_clamp);
    return static_cast<int>(cudaGetLastError());
}

RTXPT_API int rtxpt_relax_variance(const float* rad, const float* mom,
                                   const float* hist, float* out, int h,
                                   int w, cudaStream_t stream) {
    relax_variance_kernel<<<grid2d(h, w), dim3(kBX, kBY), 0, stream>>>(
        rad, mom, hist, out, h, w);
    return static_cast<int>(cudaGetLastError());
}

// rough: the specular channel's roughness, or null for the diffuse channel
RTXPT_API int rtxpt_relax_atrous(const float* rad, const float* var,
                                 const float* nrm, const float* vz,
                                 const float* rough, float* o_rad,
                                 float* o_var, int h, int w, int step,
                                 float phi_lum, float phi_normal, float phi_z,
                                 cudaStream_t stream) {
    if (rough)
        relax_atrous_kernel<true><<<grid2d(h, w), dim3(kBX, kBY), 0,
                                    stream>>>(rad, var, nrm, vz, rough, o_rad,
                                              o_var, h, w, step, phi_lum,
                                              phi_normal, phi_z);
    else
        relax_atrous_kernel<false><<<grid2d(h, w), dim3(kBX, kBY), 0,
                                     stream>>>(rad, var, nrm, vz, rough,
                                               o_rad, o_var, h, w, step,
                                               phi_lum, phi_normal, phi_z);
    return static_cast<int>(cudaGetLastError());
}

// mask: the denoiser's history-reset signal, or null
RTXPT_API int rtxpt_taa_resolve(const float* history, const float* color,
                                const float* motion, const float* mask,
                                float* out, int h, int w, float blend,
                                float clip_sigma, cudaStream_t stream) {
    taa_resolve_kernel<<<grid2d(h, w), dim3(kBX, kBY), 0, stream>>>(
        history, color, motion, mask, out, h, w, blend, clip_sigma);
    return static_cast<int>(cudaGetLastError());
}
