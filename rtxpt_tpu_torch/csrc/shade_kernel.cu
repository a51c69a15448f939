// K4: the fused shade + NEE bounce, one thread per lane.
//
// Replaces: rtxpt_tpu/pt/shade_kernel.py `_make_kernel` (via
// `shade_nee_pallas`), the TPU megakernel that runs the whole post-trace
// bounce of PathTracer::HandleHit: emission x MIS + firefly filter,
// Russian roulette, FalcorBSDF make + sample, scatter ray + cone /
// firefly-k, NEE over distant (env) and local (light-row) samples with the
// fused BSDF eval + pdf, MIS and grazing fade, scatter-side emissive MIS.
// The plain version is pt/shade_kernel.py `shade_nee_plain`; both evaluate
// the same float32 operations in the same order (built without fast math
// and without FMA contraction).
//
// Bound on the H100: by the bytes-or-operations bound, bytes. A lane reads
// C_IN float rows and writes C_OUT (101 + 43 at NEE 1+1; 137 + 59 at 2+2,
// 137 + 77 in the FILL variant: 0.6-0.86 KB a lane), while its arithmetic,
// counted from the built kernel's SASS (chip_smoke.py `sass_ops`: float32
// instructions, an FFMA as two, MUFU and conversions as eight), is 5.6k
// operations a lane at NEE 1+1 and 8.0k at 2+2. That count understates
// the arithmetic's issue time about 2x: the 67 TFLOP/s peak counts an
// FFMA as two operations, and under --fmad=false the compiler fuses no
// multiply with an add, so each FADD or FMUL takes the issue slot of two.
// Issuing all its SASS instructions once (chip_smoke.py `dispatch_ms`,
// from the static count: a straight-line program, its copy loops and
// slow paths counted once) takes longer than its bytes on every
// main-path instantiation. So the floor is instruction issue, not bytes,
// and the kernel runs 1.8-1.9x (NEE 1+1) to 3.7-3.9x (2+2) above it
// (NVIDIA H100 80GB HBM3, 700 W; tools_torch/profile_shade.py); what holds
// the rest at 2+2 (128 registers at NEE 1+1 and 139-144 at 2+2, 4 or 3
// blocks of 128 threads an SM) is not known until stall reasons are
// measured.
//
// Design: a block takes a tile of TILE = 128 lanes, one thread each, and
// each thread first starts a 4-byte cp.async per input row for its lane
// into its column of the tile in shared memory (C_IN x 512 B a block,
// 70,144 B at NEE 2+2): the whole input is in flight before any
// arithmetic, in phases (the fixed rows, then each NEE sample's rows), one
// commit group each, so the shade / BSDF part runs while the NEE rows
// still arrive. A thread reads only what it copied, so no barrier is
// needed. The arithmetic reads its inputs from shared memory where the
// plain order uses them, so no loaded value holds a register across the
// program; outputs are stored from registers, each output row a
// warp-contiguous 512-B run per block. Row offsets are 32-bit (the
// wrapper requires C x N < 2^31). __launch_bounds__(TILE, 3): 3 blocks
// is what the 70 KB tile allows at NEE 2+2, and asking for 4 spills. The
// NEE sample counts and Russian roulette are template parameters (NEE
// 0..2 each), the bounce limits and thresholds are arguments; the RNG
// uniforms arrive as input rows, so the kernel is deterministic and needs
// no generator.
//
// The FILL variant (template flag FILL, entry point rtxpt_shade_nee_fill)
// is the reference kernel's `fill=True` body for the realtime mode's
// stable-planes FILL pass: emission goes to its own output rows instead of
// the radiance, the pre-scatter throughput is written out, and each NEE
// sample writes its diffuse and specular contributions apart (11 rows a
// sample instead of 8), so the plane routing can happen outside. At NEE
// 2+2 that is 77 output rows against 59. Same arithmetic otherwise.
#include <math.h>

#include "common.cuh"

namespace {

// ---- plane layout (pt/shade_kernel.py in_layout / out_layout; a CPU
// test checks these offsets against the Python layouts) ----------------
constexpr int IN_POS = 0;
constexpr int IN_N = 3;
constexpr int IN_T = 6;
constexpr int IN_B = 9;
constexpr int IN_FACE_N = 12;
constexpr int IN_VERTEX_N = 15;
constexpr int IN_V = 18;
constexpr int IN_EMISSION = 21;
constexpr int IN_FRONT_FACING = 24;
constexpr int IN_THIN = 25;
constexpr int IN_SHADOW_FADE = 26;
constexpr int IN_BD_DIFFUSE = 27;
constexpr int IN_BD_SPECULAR = 30;
constexpr int IN_BD_ROUGH = 33;
constexpr int IN_BD_METALLIC = 34;
constexpr int IN_BD_ETA = 35;
constexpr int IN_BD_TRANS = 36;
constexpr int IN_BD_DTRANS = 39;
constexpr int IN_BD_STRANS = 40;
constexpr int IN_THP = 41;
constexpr int IN_RADIANCE = 44;
constexpr int IN_ORIGIN = 47;
constexpr int IN_DIRECTION = 50;
constexpr int IN_FIREFLY_K = 53;
constexpr int IN_EMISSIVE_MIS = 54;
constexpr int IN_ENV_MIS = 55;
constexpr int IN_CONE_SPREAD = 56;
constexpr int IN_DIFFUSE_BOUNCES = 57;
constexpr int IN_VERTEX_INDEX = 58;
constexpr int IN_SHADE = 59;
constexpr int IN_NEE_SKIP = 60;
constexpr int IN_U_RR = 61;
constexpr int IN_U3 = 62;
constexpr int IN_FIXED = 65;
// per distant sample i at IN_FIXED + DIST_ROWS * i
constexpr int DIST_DIR = 0;
constexpr int DIST_DIST = 3;
constexpr int DIST_LI = 4;
constexpr int DIST_PDF = 7;
constexpr int DIST_VALID = 8;
constexpr int DIST_ROWS = 9;
// per local sample j at IN_FIXED + DIST_ROWS * ND + LOCAL_ROWS * j
constexpr int LOC_P0 = 0;
constexpr int LOC_E1 = 3;
constexpr int LOC_E2 = 6;
constexpr int LOC_POS = 9;
constexpr int LOC_RADIUS = 12;
constexpr int LOC_RAD = 13;
constexpr int LOC_INV_AREA = 16;
constexpr int LOC_KIND = 17;
constexpr int LOC_AXIS = 18;
constexpr int LOC_COS_CONE = 21;
constexpr int LOC_SOFT = 22;
constexpr int LOC_PICK_PDF = 23;
constexpr int LOC_U3L = 24;
constexpr int LOCAL_ROWS = 27;

constexpr int OUT_RADIANCE = 0;
constexpr int OUT_THP = 3;
constexpr int OUT_ORIGIN = 6;
constexpr int OUT_DIRECTION = 9;
constexpr int OUT_FIREFLY_K = 12;
constexpr int OUT_EMISSIVE_MIS = 13;
constexpr int OUT_ENV_MIS_PRE = 14;
constexpr int OUT_CONE_SPREAD = 15;
constexpr int OUT_DIFFUSE_BOUNCES = 16;
constexpr int OUT_LOBE = 17;
constexpr int OUT_BS_PDF = 18;
constexpr int OUT_LOBE_P = 19;
constexpr int OUT_SCATTER_VALID = 20;
constexpr int OUT_WILL_SCATTER = 21;
constexpr int OUT_RR_KILL = 22;
constexpr int OUT_NON_DELTA_SCATTER = 23;
constexpr int OUT_VIS_ORIGIN = 24;
constexpr int OUT_FIXED = 27;
// FILL only: two more fixed 3-rows, then the NEE samples
constexpr int OUT_EMISSION_TERM = 27;
constexpr int OUT_PRE_SCATTER_THP = 30;
constexpr int OUT_FIXED_FILL = 33;
// per NEE sample k at OUT_FIXED(_FILL) + NEE_OUT_ROWS(_FILL) * k
constexpr int NEE_DIR = 0;
constexpr int NEE_DIST = 3;
constexpr int NEE_NEED = 4;
constexpr int NEE_CONTRIB = 5;       // non-FILL: the sum
constexpr int NEE_CONTRIB_D = 5;     // FILL: diffuse
constexpr int NEE_CONTRIB_S = 8;     // FILL: specular
constexpr int NEE_OUT_ROWS = 8;
constexpr int NEE_OUT_ROWS_FILL = 11;

// ---- constants (float32 roundings of the Python doubles) ---------------
constexpr double kPiD = 3.14159265358979323846;
constexpr float kPi = (float)kPiD;
constexpr float k2Pi = (float)(2.0 * kPiD);
constexpr float k1Pi = (float)(1.0 / kPiD);
constexpr float kPi4 = (float)(kPiD / 4.0);
constexpr float kPi2 = (float)(kPiD / 2.0);
constexpr float kFltMax = 3.402823466e38f;
constexpr float kMinCos = 1e-6f;
constexpr float kMinGGXAlpha = 0.0064f;
constexpr float kOneMinusEps = 0x1.fffffep-1f;
constexpr float kMaxRayTravel = 1e15f;
constexpr float kEnergyFactor = (float)(1.0 / 1.51 - 1.0);

constexpr int LOBE_DIFFUSE_REFLECTION = 0x01;
constexpr int LOBE_SPECULAR_REFLECTION = 0x02;
constexpr int LOBE_DELTA_REFLECTION = 0x04;
constexpr int LOBE_DIFFUSE_TRANSMISSION = 0x10;
constexpr int LOBE_SPECULAR_TRANSMISSION = 0x20;
constexpr int LOBE_DELTA_TRANSMISSION = 0x40;
constexpr int LOBE_DELTA = 0x44;
constexpr int LOBE_REFLECTION = 0x0F;

constexpr int LIGHT_TRIANGLE = 0;
constexpr int LIGHT_POINT = 1;
constexpr int LIGHT_DIRECTIONAL = 2;
constexpr int LIGHT_SPHERE = 3;
constexpr int LIGHT_SPOT = 4;

// ---- scalar helpers with PyTorch's NaN semantics ------------------------
__device__ __forceinline__ float maxs(float x, float s) {   // clamp(min=)
    return x < s ? s : x;
}
__device__ __forceinline__ float mins(float x, float s) {   // clamp(max=)
    return x > s ? s : x;
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}
__device__ __forceinline__ float sat(float x) { return clampf(x, 0.f, 1.f); }
__device__ __forceinline__ float tmin(float a, float b) {  // torch.minimum
    return (isnan(a) || a < b) ? a : b;
}

struct V3 {
    float x, y, z;
};
__device__ __forceinline__ V3 mk(float x, float y, float z) {
    return V3{x, y, z};
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
    return mk(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
    return mk(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
    return mk(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
    return mk(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 normalize(V3 a) {
    float inv = 1.0f / maxs(sqrtf(dot(a, a)), 1e-20f);
    return scale(a, inv);
}
__device__ __forceinline__ V3 safe_normalize(V3 a) {
    float l = sqrtf(dot(a, a));
    V3 n = scale(a, 1.0f / maxs(l, 1e-20f));
    return l > 1e-20f ? n : mk(0.f, 0.f, 0.f);
}
__device__ __forceinline__ float luminance(V3 c) {
    return 0.2126f * c.x + 0.7152f * c.y + 0.0722f * c.z;
}
__device__ __forceinline__ V3 to_local(V3 v, V3 t, V3 b, V3 n) {
    return mk(dot(v, t), dot(v, b), dot(v, n));
}
__device__ __forceinline__ V3 from_local(V3 v, V3 t, V3 b, V3 n) {
    return mk(v.x * t.x + v.y * b.x + v.z * n.x,
              v.x * t.y + v.y * b.y + v.z * n.y,
              v.x * t.z + v.y * b.z + v.z * n.z);
}

// ---- plane access and staging --------------------------------------------
constexpr int TILE = 128;        // lanes per block, one thread each

template <int ND, int NL>
struct Shape {
    static constexpr int in_rows = IN_FIXED + DIST_ROWS * ND + LOCAL_ROWS * NL;
    // copy phases: the fixed rows, then each distant and each local sample
    static constexpr int phases = 1 + ND + NL;
    static constexpr int smem_bytes = in_rows * TILE * 4;
    __device__ static constexpr int phase_rows(int k) {
        return k == 0 ? IN_FIXED : (k <= ND ? DIST_ROWS : LOCAL_ROWS);
    }
    __device__ static constexpr int phase_start(int k) {
        return k == 0 ? 0
                      : (k <= ND ? IN_FIXED + DIST_ROWS * (k - 1)
                                 : IN_FIXED + DIST_ROWS * ND +
                                       LOCAL_ROWS * (k - 1 - ND));
    }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's commit groups are in
// flight (a constant once the NEE loops are unrolled)
__device__ __forceinline__ void cp_async_wait(int pending) {
    switch (pending) {
        case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
        case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
        case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
        case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
        default: asm volatile("cp.async.wait_group 4;\n" ::: "memory");
    }
}

// Copies lane `src`'s input rows into its column `col` of the staged
// tile, one commit group per phase. A thread reads only what it copied,
// so no barrier is needed. The loops stay loops: fully unrolled, a
// thread's copies leave as one burst, which measured slower at NEE 2+2.
template <int ND, int NL>
__device__ __forceinline__ void stage_rows(float* col, const float* src,
                                           int n) {
#pragma unroll 1
    for (int k = 0; k < Shape<ND, NL>::phases; ++k) {
        const int r0 = Shape<ND, NL>::phase_start(k);
        const int r1 = r0 + Shape<ND, NL>::phase_rows(k);
#pragma unroll 1
        for (int r = r0; r < r1; ++r) cp_async4(col + r * TILE, src + r * n);
        cp_async_commit();
    }
}

// Blocks until phase k's rows are in shared memory.
template <int ND, int NL>
__device__ __forceinline__ void wait_phase(int k) {
    cp_async_wait(Shape<ND, NL>::phases - 1 - k);
}

// One lane's view: inputs from its column of the staged tile, outputs to
// its column of the (C_OUT, N) planes (32-bit row offsets).
struct Planes {
    const float* s;
    float* o;
    int n;
    __device__ __forceinline__ float g(int r) const { return s[r * TILE]; }
    __device__ __forceinline__ V3 g3(int r) const {
        return mk(g(r), g(r + 1), g(r + 2));
    }
    __device__ __forceinline__ void p(int r, float v) const { o[r * n] = v; }
    __device__ __forceinline__ void p3(int r, V3 v) const {
        p(r, v.x);
        p(r + 1, v.y);
        p(r + 2, v.z);
    }
};

// ---- path-tracer helpers (PathTracerHelpers.hlsli) ----------------------
__device__ __forceinline__ float ray_origin_c(float p, float f) {
    int i_off = (int)(f * (3.0f * 256.0f));
    int shifted = __float_as_int(p) + (p < 0.0f ? -i_off : i_off);
    float i_pos = __int_as_float(shifted);
    return fabsf(p) < (1.0f / 16.0f) ? p + f * (3.0f / 65536.0f) : i_pos;
}
__device__ __forceinline__ V3 compute_ray_origin(V3 pos, V3 fn) {
    return mk(ray_origin_c(pos.x, fn.x), ray_origin_c(pos.y, fn.y),
              ray_origin_c(pos.z, fn.z));
}
__device__ __forceinline__ V3 firefly_filter(V3 sig, float threshold,
                                             float k) {
    float t = threshold * k;
    float lum = luminance(sig);
    float s = t / maxs(lum, 1e-30f);
    bool over = lum > t;
    V3 out = over ? scale(sig, s) : sig;
    return threshold > 0.0f ? out : sig;
}
__device__ __forceinline__ float acos_approx(float x) {
    float ax = fabsf(x);
    float p = 1.5707288f + ax * (-0.2121144f + ax * (0.0742610f
                                                     + ax * -0.0187293f));
    float r = sqrtf(maxs(1.0f - ax, 0.0f)) * p;
    return x >= 0.0f ? r : kPi - r;
}
__device__ __forceinline__ float spread_angle_from_pdf(float pdf,
                                                       float growth) {
    float safe = maxs(pdf, 1e-30f);
    return growth * 2.0f *
           acos_approx(clampf(1.0f - (1.0f / safe) / k2Pi, -1.0f, 1.0f));
}
__device__ __forceinline__ float new_firefly_k(float cur_k, float pdf,
                                               float lobe_p) {
    float angle = pdf == 0.0f ? 0.0f : spread_angle_from_pdf(pdf, 1.0f);
    float p = 32.0f / (32.0f + angle * angle);
    p = p * sqrtf(maxs(lobe_p, 0.0f));
    return maxs(cur_k * p, 1e-4f);
}
__device__ __forceinline__ float eval_mis(float n0, float p0, float n1,
                                          float p1) {
    float q0 = n0 * p0;
    float q1 = n1 * p1;
    return sat(q0 / maxs(q0 + q1, 1e-30f));
}

// ---- Fresnel / microfacet (pt/bsdf.py) -----------------------------------
__device__ __forceinline__ float schlick_c5(float cos_theta) {
    float c = maxs(1.0f - cos_theta, 0.0f);
    float c5 = c * c;
    return c5 * c5 * c;
}
__device__ __forceinline__ V3 fresnel_schlick3(V3 f0, float f90,
                                               float cos_theta) {
    float c5 = schlick_c5(cos_theta);
    return mk(f0.x + (f90 - f0.x) * c5, f0.y + (f90 - f0.y) * c5,
              f0.z + (f90 - f0.z) * c5);
}
__device__ __forceinline__ float fresnel_schlick1(float f0, float f90,
                                                  float cos_theta) {
    return f0 + (f90 - f0) * schlick_c5(cos_theta);
}
__device__ __forceinline__ void fresnel_dielectric(float eta, float cos_i,
                                                   float* f_out,
                                                   float* ct_out) {
    bool flip = cos_i < 0.0f;
    eta = flip ? 1.0f / maxs(eta, 1e-8f) : eta;
    float ci = fabsf(cos_i);
    float sin_t_sq = eta * eta * (1.0f - ci * ci);
    bool tir = sin_t_sq > 1.0f;
    float ct = sqrtf(maxs(1.0f - sin_t_sq, 0.0f));
    float denom_s = eta * ci + ct;
    float denom_p = eta * ct + ci;
    float rs = (eta * ci - ct) / (fabsf(denom_s) < 1e-12f ? 1e-12f : denom_s);
    float rp = (eta * ct - ci) / (fabsf(denom_p) < 1e-12f ? 1e-12f : denom_p);
    float f = 0.5f * (rs * rs + rp * rp);
    *f_out = tir ? 1.0f : f;
    *ct_out = tir ? 0.0f : ct;
}
__device__ __forceinline__ float bvndf_k(float alpha, V3 i) {
    float a = sat(alpha);
    float s = 1.0f + sqrtf(i.x * i.x + i.y * i.y);
    float a2 = a * a, s2 = s * s;
    return (1.0f - a2) * s2 / (s2 + a2 * i.z * i.z);
}
__device__ __forceinline__ V3 sample_ggx_bvndf(float alpha, V3 i, float u0,
                                               float u1) {
    V3 i_std = normalize(mk(i.x * alpha, i.y * alpha, i.z));
    float phi = k2Pi * u0;
    float k = bvndf_k(alpha, i);
    float bz = i.z > 0.0f ? k * i_std.z : i_std.z;
    float z = (1.0f - u1) * (1.0f + bz) - bz;
    float sin_t = sqrtf(sat(1.0f - z * z));
    V3 o_std = mk(sin_t * cosf(phi), sin_t * sinf(phi), z);
    V3 m_std = add(i_std, o_std);
    return normalize(mk(m_std.x * alpha, m_std.y * alpha, m_std.z));
}
__device__ __forceinline__ float eval_ndf_ggx(float alpha, float cos_theta) {
    float a2 = alpha * alpha;
    float d = (cos_theta * a2 - cos_theta) * cos_theta + 1.0f;
    return a2 / maxs(d * d * kPi, 1e-30f);
}
__device__ __forceinline__ float eval_lambda_ggx(float a2, float cos_theta) {
    float cs = maxs(cos_theta, 1e-12f);
    float cos_sqr = cs * cs;
    float tan_sqr = maxs(1.0f - cos_sqr, 0.0f) / cos_sqr;
    float lam = 0.5f * (-1.0f + sqrtf(1.0f + a2 * tan_sqr));
    return cos_theta <= 0.0f ? 0.0f : lam;
}
__device__ __forceinline__ float smith_ggx_correlated(float alpha,
                                                      float cos_i,
                                                      float cos_o) {
    float a2 = alpha * alpha;
    return 1.0f / maxs(1.0f + eval_lambda_ggx(a2, cos_i)
                       + eval_lambda_ggx(a2, cos_o), 1e-12f);
}
__device__ __forceinline__ float pdf_ggx_bvndf(float alpha, V3 i, V3 m) {
    float ndf = eval_ndf_ggx(alpha, m.z);
    float t = sqrtf((alpha * i.x) * (alpha * i.x)
                    + (alpha * i.y) * (alpha * i.y) + i.z * i.z);
    float k = bvndf_k(alpha, i);
    return ndf / maxs(2.0f * (k * i.z + t), 1e-20f);
}

// ---- FalcorBSDF ------------------------------------------------------------
struct Bsdf {
    V3 diff_albedo, spec_albedo, trans_albedo;
    float alpha, alpha_t, eta, roughness, diff_trans, spec_trans;
    float p_diffuse, p_diffuse_t, p_specular, p_specular_t;
};

__device__ __forceinline__ Bsdf make_bsdf(V3 diffuse, V3 specular,
                                          float rough, float metallic,
                                          float eta, V3 trans, float dtrans,
                                          float strans, float cos_v,
                                          bool thin) {
    Bsdf b;
    b.trans_albedo = thin ? trans
                          : mk(sqrtf(maxs(trans.x, 0.f)),
                               sqrtf(maxs(trans.y, 0.f)),
                               sqrtf(maxs(trans.z, 0.f)));
    float alpha = rough * rough;
    alpha = alpha < kMinGGXAlpha ? 0.0f : alpha;
    b.alpha = alpha;
    b.alpha_t = eta == 1.0f ? 0.0f : alpha;
    float metallic_brdf = metallic * (1.0f - strans);
    float dielectric = (1.0f - metallic) * (1.0f - strans);
    float diffuse_w = luminance(diffuse);
    float specular_w = luminance(fresnel_schlick3(specular, 1.0f, cos_v));
    float p_diff = diffuse_w * dielectric * (1.0f - dtrans);
    float p_diff_t = diffuse_w * dielectric * dtrans;
    float p_spec = specular_w * (metallic_brdf + dielectric);
    float p_spec_t = strans;
    float norm = p_diff + p_diff_t + p_spec + p_spec_t;
    float inv = norm > 0.0f ? 1.0f / maxs(norm, 1e-30f) : 0.0f;
    b.diff_albedo = diffuse;
    b.spec_albedo = specular;
    b.eta = eta;
    b.roughness = rough;
    b.diff_trans = dtrans;
    b.spec_trans = strans;
    b.p_diffuse = p_diff * inv;
    b.p_diffuse_t = p_diff_t * inv;
    b.p_specular = p_spec * inv;
    b.p_specular_t = p_spec_t * inv;
    return b;
}

__device__ __forceinline__ float frostbite_weight(V3 wi, V3 wo,
                                                  float roughness) {
    V3 h = safe_normalize(add(wi, wo));
    float wo_dot_h = dot(wo, h);
    float energy_bias = 0.5f * roughness;
    float energy_factor = 1.0f + kEnergyFactor * roughness;
    float fd90 = energy_bias + 2.0f * wo_dot_h * wo_dot_h * roughness;
    float wi_sc = fresnel_schlick1(1.0f, fd90, wi.z);
    float wo_sc = fresnel_schlick1(1.0f, fd90, wo.z);
    return wi_sc * wo_sc * energy_factor;
}

__device__ __forceinline__ V3 trans_half(const Bsdf& b, V3 wi, V3 wo,
                                         bool* is_refl) {
    *is_refl = wo.z > 0.0f;
    V3 h = add(wo, scale(wi, *is_refl ? 1.0f : b.eta));
    h = safe_normalize(h);
    return scale(h, h.z >= 0.0f ? 1.0f : -1.0f);
}

__device__ __forceinline__ V3 spec_eval(const Bsdf& b, V3 wi, V3 wo) {
    bool ok = (tmin(wi.z, wo.z) >= kMinCos) && (b.alpha > 0.0f);
    V3 h = safe_normalize(add(wi, wo));
    float wi_dot_h = dot(wi, h);
    float d = eval_ndf_ggx(b.alpha, h.z);
    float g = smith_ggx_correlated(b.alpha, wi.z, wo.z);
    V3 f = fresnel_schlick3(b.spec_albedo, 1.0f, wi_dot_h);
    float s = d * g * 0.25f / maxs(wi.z, 1e-12f);
    return ok ? scale(f, s) : mk(0.f, 0.f, 0.f);
}

__device__ __forceinline__ float spec_pdf(const Bsdf& b, V3 wi, V3 wo) {
    bool ok = (tmin(wi.z, wo.z) >= kMinCos) && (b.alpha > 0.0f);
    V3 h = safe_normalize(add(wi, wo));
    float pdf = pdf_ggx_bvndf(b.alpha, wi, h);
    return ok ? pdf : 0.0f;
}

__device__ __forceinline__ V3 spec_trans_eval(const Bsdf& b, V3 wi, V3 wo) {
    bool ok = (tmin(wi.z, fabsf(wo.z)) >= kMinCos) && (b.alpha_t > 0.0f);
    bool is_refl;
    V3 h = trans_half(b, wi, wo, &is_refl);
    float wi_dot_h = dot(wi, h);
    float wo_dot_h = dot(wo, h);
    float d = eval_ndf_ggx(b.alpha_t, h.z);
    float g = smith_ggx_correlated(b.alpha_t, wi.z, fabsf(wo.z));
    float f, ct;
    fresnel_dielectric(b.eta, wi_dot_h, &f, &ct);
    float refl = f * d * g * 0.25f / maxs(wi.z, 1e-12f);
    float sqrt_denom = wo_dot_h + b.eta * wi_dot_h;
    float sd = fabsf(sqrt_denom) < 1e-12f ? 1e-12f : sqrt_denom;
    float tterm = b.eta * b.eta * wi_dot_h * wo_dot_h /
                  (maxs(wi.z, 1e-12f) * (sd * sd));
    float tr = (1.0f - f) * d * g * fabsf(tterm);
    if (!ok) return mk(0.f, 0.f, 0.f);
    return is_refl ? mk(refl, refl, refl) : scale(b.trans_albedo, tr);
}

__device__ __forceinline__ float spec_trans_pdf(const Bsdf& b, V3 wi, V3 wo) {
    bool ok = (tmin(wi.z, fabsf(wo.z)) >= kMinCos) && (b.alpha_t > 0.0f);
    bool is_refl;
    V3 h = trans_half(b, wi, wo, &is_refl);
    float wi_dot_h = dot(wi, h);
    float wo_dot_h = dot(wo, h);
    float f, ct;
    fresnel_dielectric(b.eta, wi_dot_h, &f, &ct);
    float pdf = pdf_ggx_bvndf(b.alpha_t, wi, h);
    float pdf_r = wo_dot_h <= 0.0f ? 0.0f
                                   : pdf * wi_dot_h / maxs(wo_dot_h, 1e-12f);
    float sqrt_denom = wo_dot_h + b.eta * wi_dot_h;
    float denom = maxs(sqrt_denom * sqrt_denom, 1e-20f);
    float pdf_t = wo_dot_h > 0.0f
                      ? 0.0f
                      : pdf * wi_dot_h * 4.0f * fabsf(wo_dot_h) / denom;
    pdf = is_refl ? pdf_r : pdf_t;
    pdf = pdf * (is_refl ? f : 1.0f - f);
    return ok ? clampf(pdf, 0.0f, kFltMax) : 0.0f;
}

__device__ __forceinline__ float bsdf_eval_pdf(const Bsdf& b, V3 wi, V3 wo) {
    bool ok_d = tmin(wi.z, wo.z) >= kMinCos;
    float pdf = b.p_diffuse * (ok_d ? k1Pi * wo.z : 0.0f);
    bool ok_dt = tmin(wi.z, -wo.z) >= kMinCos;
    pdf = pdf + b.p_diffuse_t * (ok_dt ? k1Pi * -wo.z : 0.0f);
    pdf = pdf + b.p_specular * spec_pdf(b, wi, wo);
    pdf = pdf + b.p_specular_t * spec_trans_pdf(b, wi, wo);
    return pdf;
}

// fused NEE eval: diffuse and specular f*cos and the mixture pdf
__device__ __forceinline__ void bsdf_eval_split_pdf(const Bsdf& b, V3 wi,
                                                    V3 wo, V3* diffuse,
                                                    V3* specular,
                                                    float* pdf_out) {
    float wi_z = wi.z, wo_z = wo.z;
    bool ok_d = (tmin(wi_z, wo_z) >= kMinCos) && (b.p_diffuse > 0.0f);
    float w_fb = frostbite_weight(wi, wo, b.roughness);
    float base_d = ok_d ? k1Pi * wo_z : 0.0f;
    V3 f_diff = mk(b.diff_albedo.x * base_d * w_fb,
                   b.diff_albedo.y * base_d * w_fb,
                   b.diff_albedo.z * base_d * w_fb);
    float pdf = b.p_diffuse * base_d;

    bool ok_dt = (tmin(wi_z, -wo_z) >= kMinCos) && (b.p_diffuse_t > 0.0f);
    float base_dt = ok_dt ? k1Pi * -wo_z : 0.0f;
    V3 f_diff_t = scale(b.trans_albedo, base_dt);
    pdf = pdf + b.p_diffuse_t * base_dt;

    bool ok_s = (tmin(wi_z, wo_z) >= kMinCos) && (b.alpha > 0.0f);
    V3 h = safe_normalize(add(wi, wo));
    float wi_dot_h = dot(wi, h);
    float d_s = eval_ndf_ggx(b.alpha, h.z);
    float g_s = smith_ggx_correlated(b.alpha, wi_z, wo_z);
    V3 f_s = fresnel_schlick3(b.spec_albedo, 1.0f, wi_dot_h);
    float sv = d_s * g_s * 0.25f / maxs(wi_z, 1e-12f);
    bool okp = ok_s && (b.p_specular > 0.0f);
    V3 f_spec = okp ? scale(f_s, sv) : mk(0.f, 0.f, 0.f);
    float pdf_s = b.p_specular * pdf_ggx_bvndf(b.alpha, wi, h);
    pdf = pdf + (ok_s ? pdf_s : 0.0f);

    bool ok_t = (tmin(wi_z, fabsf(wo_z)) >= kMinCos) && (b.alpha_t > 0.0f);
    bool is_refl;
    V3 h_t = trans_half(b, wi, wo, &is_refl);
    float wi_dot_ht = dot(wi, h_t);
    float wo_dot_ht = dot(wo, h_t);
    float d_t = eval_ndf_ggx(b.alpha_t, h_t.z);
    float g_t = smith_ggx_correlated(b.alpha_t, wi_z, fabsf(wo_z));
    float f_t, ct;
    fresnel_dielectric(b.eta, wi_dot_ht, &f_t, &ct);
    float refl = f_t * d_t * g_t * 0.25f / maxs(wi_z, 1e-12f);
    float sqrt_denom = wo_dot_ht + b.eta * wi_dot_ht;
    float sd = fabsf(sqrt_denom) < 1e-12f ? 1e-12f : sqrt_denom;
    float tterm = b.eta * b.eta * wi_dot_ht * wo_dot_ht /
                  (maxs(wi_z, 1e-12f) * (sd * sd));
    float tr = (1.0f - f_t) * d_t * g_t * fabsf(tterm);
    bool okt = ok_t && (b.p_specular_t > 0.0f);
    V3 f_spec_t = !okt ? mk(0.f, 0.f, 0.f)
                       : (is_refl ? mk(refl, refl, refl)
                                  : scale(b.trans_albedo, tr));
    float pdf_m = pdf_ggx_bvndf(b.alpha_t, wi, h_t);
    float pdf_r = wo_dot_ht <= 0.0f
                      ? 0.0f
                      : pdf_m * wi_dot_ht / maxs(wo_dot_ht, 1e-12f);
    float denom = maxs(sqrt_denom * sqrt_denom, 1e-20f);
    float pdf_tr = wo_dot_ht > 0.0f
                       ? 0.0f
                       : pdf_m * wi_dot_ht * 4.0f * fabsf(wo_dot_ht) / denom;
    float pdf_st = is_refl ? pdf_r : pdf_tr;
    pdf_st = pdf_st * (is_refl ? f_t : 1.0f - f_t);
    float pdf_t_term = b.p_specular_t * clampf(pdf_st, 0.0f, kFltMax);
    pdf = pdf + (ok_t ? pdf_t_term : 0.0f);

    float wd = (1.0f - b.spec_trans) * (1.0f - b.diff_trans);
    float wdt = (1.0f - b.spec_trans) * b.diff_trans;
    float ws = 1.0f - b.spec_trans;
    float wst = b.spec_trans;
    *diffuse = add(scale(f_diff, wd), scale(f_diff_t, wdt));
    *specular = add(scale(f_spec, ws), scale(f_spec_t, wst));
    *pdf_out = pdf;
}

struct BsdfSample {
    V3 wo, weight;
    float pdf, lobe, lobe_p;
    bool valid;
};

__device__ __forceinline__ V3 sample_cosine_hemisphere(float u0, float u1) {
    float ux = 2.0f * u0 - 1.0f;
    float uy = 2.0f * u1 - 1.0f;
    bool use_x = fabsf(ux) > fabsf(uy);
    float r = use_x ? ux : uy;
    float phi = use_x ? (uy / (ux == 0.0f ? 1.0f : ux)) * kPi4
                      : kPi2 - (ux / (uy == 0.0f ? 1.0f : uy)) * kPi4;
    float dx = r * cosf(phi);
    float dy = r * sinf(phi);
    bool zero = (ux == 0.0f) && (uy == 0.0f);
    dx = zero ? ux : dx;
    dy = zero ? uy : dy;
    float z = sqrtf(maxs(1.0f - (dx * dx + dy * dy), 0.0f));
    return mk(dx, dy, z);
}

__device__ __forceinline__ BsdfSample bsdf_sample(const Bsdf& b, V3 wi,
                                                  V3 u3) {
    const float u0 = u3.x, u1 = u3.y, u_sel = u3.z;
    float c1 = b.p_diffuse;
    float c2 = c1 + b.p_diffuse_t;
    float c3 = c2 + b.p_specular;
    bool sel_diff = u_sel < c1;
    bool sel_difft = !sel_diff && (u_sel < c2);
    bool sel_spec = !sel_diff && !sel_difft && (u_sel < c3);
    bool sel_spect = !sel_diff && !sel_difft && !sel_spec &&
                     (b.p_specular_t > 0.0f);
    bool wi_z_ok = wi.z >= kMinCos;

    V3 wo_cos = sample_cosine_hemisphere(u0, u1);
    V3 wo_dt = mk(wo_cos.x, wo_cos.y, -wo_cos.z);

    V3 h_r = sample_ggx_bvndf(maxs(b.alpha, 1e-8f), wi, u0, u1);
    float wi_dot_hr = dot(wi, h_r);
    V3 wo_sr = sub(scale(h_r, 2.0f * wi_dot_hr), wi);
    bool delta_r = b.alpha == 0.0f;
    wo_sr = delta_r ? mk(-wi.x, -wi.y, wi.z) : wo_sr;
    bool sr_valid = wi_z_ok && (delta_r || (wo_sr.z >= kMinCos));
    float sr_pdf = delta_r ? 0.0f : spec_pdf(b, wi, wo_sr);
    V3 se = spec_eval(b, wi, wo_sr);
    float inv_srp = 1.0f / maxs(sr_pdf, 1e-20f);
    V3 fs_d = fresnel_schlick3(b.spec_albedo, 1.0f, wi.z);
    V3 sr_weight = delta_r ? fs_d : scale(se, inv_srp);
    float sr_lobe = delta_r ? (float)LOBE_DELTA_REFLECTION
                            : (float)LOBE_SPECULAR_REFLECTION;

    float u_sel_st = clampf((u_sel - c3) / maxs(b.p_specular_t, 1e-20f),
                            0.0f, kOneMinusEps);
    bool delta_t = b.alpha_t == 0.0f;
    V3 h_t = sample_ggx_bvndf(maxs(b.alpha_t, 1e-8f), wi, u0, u1);
    h_t = delta_t ? mk(0.f, 0.f, 1.f) : h_t;
    float wi_dot_ht = dot(wi, h_t);
    float f_t, cos_theta_t;
    fresnel_dielectric(b.eta, wi_dot_ht, &f_t, &cos_theta_t);
    bool is_refl_t = u_sel_st < f_t;
    float st_lobe_p = delta_t ? (is_refl_t ? f_t : 1.0f - f_t) : 1.0f;
    V3 wo_st_r = sub(scale(h_t, 2.0f * wi_dot_ht), wi);
    V3 wo_st_t = sub(scale(h_t, b.eta * wi_dot_ht - cos_theta_t),
                     scale(wi, b.eta));
    V3 wo_st = is_refl_t ? wo_st_r : wo_st_t;
    bool st_valid = wi_z_ok && (fabsf(wo_st.z) >= kMinCos) &&
                    ((wo_st.z > 0.0f) == is_refl_t);
    float st_pdf = delta_t ? 0.0f : spec_trans_pdf(b, wi, wo_st);
    V3 delta_w = is_refl_t ? mk(1.f, 1.f, 1.f) : b.trans_albedo;
    V3 ste = spec_trans_eval(b, wi, wo_st);
    float inv_stp = 1.0f / maxs(st_pdf, 1e-20f);
    bool rough_ok = st_pdf > 0.0f;
    V3 st_weight = delta_t ? delta_w
                           : (rough_ok ? scale(ste, inv_stp)
                                       : mk(0.f, 0.f, 0.f));
    float st_lobe = is_refl_t
                        ? (delta_t ? (float)LOBE_DELTA_REFLECTION
                                   : (float)LOBE_SPECULAR_REFLECTION)
                        : (delta_t ? (float)LOBE_DELTA_TRANSMISSION
                                   : (float)LOBE_SPECULAR_TRANSMISSION);

    V3 wo = sel_diff ? wo_cos
                     : (sel_difft ? wo_dt : (sel_spec ? wo_sr : wo_st));

    bool d_valid = wi_z_ok && (wo_cos.z >= kMinCos);
    float wfb = frostbite_weight(wi, wo_cos, b.roughness);
    float wd = (1.0f - b.spec_trans) * (1.0f - b.diff_trans) /
               maxs(b.p_diffuse, 1e-20f);
    V3 d_weight = mk(b.diff_albedo.x * wfb * wd, b.diff_albedo.y * wfb * wd,
                     b.diff_albedo.z * wfb * wd);
    bool dt_valid = wi_z_ok && (-wo_dt.z >= kMinCos);
    float wdt = (1.0f - b.spec_trans) * b.diff_trans /
                maxs(b.p_diffuse_t, 1e-20f);
    V3 dt_weight = scale(b.trans_albedo, wdt);
    float ws = (1.0f - b.spec_trans) / maxs(b.p_specular, 1e-20f);
    V3 s_weight = scale(sr_weight, ws);
    float wst = b.spec_trans / maxs(b.p_specular_t, 1e-20f);
    V3 t_weight = scale(st_weight, wst);

    BsdfSample out;
    out.valid = (sel_diff && d_valid) || (sel_difft && dt_valid) ||
                (sel_spec && sr_valid) || (sel_spect && st_valid);
    V3 weight = sel_diff ? d_weight
                         : (sel_difft ? dt_weight
                                      : (sel_spec ? s_weight
                                                  : (sel_spect
                                                         ? t_weight
                                                         : mk(0.f, 0.f,
                                                              0.f))));
    float pdf = bsdf_eval_pdf(b, wi, wo);
    out.lobe = sel_diff ? (float)LOBE_DIFFUSE_REFLECTION
                        : (sel_difft ? (float)LOBE_DIFFUSE_TRANSMISSION
                                     : (sel_spec ? sr_lobe : st_lobe));
    out.lobe_p = sel_diff ? b.p_diffuse
                          : (sel_difft ? b.p_diffuse_t
                                       : (sel_spec ? b.p_specular
                                                   : st_lobe_p *
                                                         b.p_specular_t));
    bool is_delta = ((int)out.lobe & LOBE_DELTA) != 0;
    out.pdf = (is_delta || !out.valid) ? 0.0f : pdf;
    out.weight = out.valid ? weight : mk(0.f, 0.f, 0.f);
    out.wo = wo;
    return out;
}

// ---- local light sample (light row fetched outside) -----------------------
struct LightSample {
    V3 dir, li;
    float dist, pdf;
    bool valid, delta;
};

__device__ __forceinline__ LightSample local_light_sample(const Planes& P,
                                                          int base, V3 pos) {
    float kind_f = P.g(base + LOC_KIND);
    V3 p0 = P.g3(base + LOC_P0), e1 = P.g3(base + LOC_E1);
    V3 e2 = P.g3(base + LOC_E2), pos_l = P.g3(base + LOC_POS);
    float r_s = P.g(base + LOC_RADIUS);
    V3 rad = P.g3(base + LOC_RAD);
    float inv_area = P.g(base + LOC_INV_AREA);
    float pick_pdf = P.g(base + LOC_PICK_PDF);
    float u2 = P.g(base + LOC_U3L + 1), u3 = P.g(base + LOC_U3L + 2);

    // triangle: uniform area sample
    float su = sqrtf(u2);
    float b1 = 1.0f - su;
    float b2 = u3 * su;
    V3 lp = add(p0, add(scale(e1, b1), scale(e2, b2)));
    V3 fn = safe_normalize(cross(e1, e2));
    V3 to_l = sub(lp, pos);
    float dist_sq = maxs(dot(to_l, to_l), 1e-12f);
    float dist = sqrtf(dist_sq);
    V3 dir_t = scale(to_l, 1.0f / dist);
    float cos_l = -dot(fn, dir_t);
    float pdf_tri = dist_sq * inv_area / maxs(cos_l, 1e-12f);
    bool tri_visible = cos_l > 1e-6f;

    // point / spot
    V3 to_p = sub(pos_l, pos);
    float dist_p_sq = maxs(dot(to_p, to_p), 1e-12f);
    float dist_p = sqrtf(dist_p_sq);
    V3 dir_p = scale(to_p, 1.0f / dist_p);

    // sphere: uniform area sample over the surface
    float z = 1.0f - 2.0f * u2;
    float s_ = sqrtf(maxs(1.0f - z * z, 0.0f));
    float phi = k2Pi * u3;
    V3 n_s = mk(s_ * cosf(phi), s_ * sinf(phi), z);
    V3 lp_s = add(pos_l, scale(n_s, r_s));
    V3 to_s = sub(lp_s, pos);
    float dist_s_sq = maxs(dot(to_s, to_s), 1e-12f);
    float dist_s = sqrtf(dist_s_sq);
    V3 dir_s = scale(to_s, 1.0f / dist_s);
    float cos_s = -dot(n_s, dir_s);
    float pdf_sph = dist_s_sq * inv_area / maxs(cos_s, 1e-12f);
    bool sph_visible = cos_s > 1e-6f;

    V3 dir_d = scale(safe_normalize(pos_l), -1.0f);

    bool is_tri = kind_f == (float)LIGHT_TRIANGLE;
    bool is_sph = kind_f == (float)LIGHT_SPHERE;
    bool is_spot = kind_f == (float)LIGHT_SPOT;
    bool is_pt = (kind_f == (float)LIGHT_POINT) || is_spot;
    bool is_dir = kind_f == (float)LIGHT_DIRECTIONAL;

    LightSample ls;
    ls.dir = is_tri ? dir_t : (is_sph ? dir_s : (is_pt ? dir_p : dir_d));
    ls.dist = is_tri ? dist
                     : (is_sph ? dist_s : (is_pt ? dist_p : kMaxRayTravel));
    ls.pdf = is_tri ? pdf_tri * pick_pdf
                    : (is_sph ? pdf_sph * pick_pdf : pick_pdf);
    V3 axis = P.g3(base + LOC_AXIS);
    float cos_theta = -dot(axis, dir_p);
    float soft = P.g(base + LOC_SOFT);
    float cos_cone = P.g(base + LOC_COS_CONE);
    float tshape = clampf((cos_theta - cos_cone) / maxs(soft, 1e-6f),
                          0.0f, 1.0f);
    float shape_s = soft > 1e-6f ? tshape * tshape * (3.0f - 2.0f * tshape)
                                 : (cos_theta >= cos_cone ? 1.0f : 0.0f);
    float shape = is_spot ? shape_s : 1.0f;
    float inv_pick = 1.0f / maxs(pick_pdf, 1e-20f);
    float inv_pdf = 1.0f / maxs(ls.pdf, 1e-20f);
    float rc[3] = {rad.x, rad.y, rad.z};
    float lc[3];
    for (int i = 0; i < 3; ++i)
        lc[i] = (is_tri || is_sph)
                    ? rc[i] * inv_pdf
                    : (is_pt ? rc[i] * shape / dist_p_sq * inv_pick
                             : rc[i] * inv_pick);
    ls.li = mk(lc[0], lc[1], lc[2]);
    ls.valid = (is_tri && tri_visible) || (is_sph && sph_visible) || is_pt ||
               is_dir;
    ls.delta = is_pt || is_dir;
    return ls;
}

template <int ND, int NL, bool RR, bool FILL>
__global__ void __launch_bounds__(TILE, 3)
shade_nee_kernel(const float* __restrict__ in, const float* __restrict__ c4,
                 float* __restrict__ out, int n, int max_bounces,
                 int max_diffuse_bounces, float spec_rough_threshold,
                 float local_pdf_k) {
    extern __shared__ float tile[];
    const int lane = blockIdx.x * TILE + threadIdx.x;
    if (lane >= n) return;
    stage_rows<ND, NL>(tile + threadIdx.x, in + lane, n);
    const Planes P{tile + threadIdx.x, out + lane, n};
    wait_phase<ND, NL>(0);             // the fixed rows
    const float firefly_threshold = c4[0];
    const float atten = c4[1];
    const float nee_min_rad = c4[2];

    const bool shade = P.g(IN_SHADE) != 0.0f;
    V3 thp = P.g3(IN_THP);
    V3 radiance = P.g3(IN_RADIANCE);
    const float firefly_k0 = P.g(IN_FIREFLY_K);

    // emission with MIS (PathTracer.hlsli:456-468)
    V3 em = scale(P.g3(IN_EMISSION), P.g(IN_EMISSIVE_MIS));
    em = firefly_filter(em, firefly_threshold, firefly_k0);
    em = scale(em, atten);
    V3 addv = mul(thp, em);
    addv = mk(shade ? maxs(addv.x, 0.f) : 0.f, shade ? maxs(addv.y, 0.f) : 0.f,
              shade ? maxs(addv.z, 0.f) : 0.f);
    if (FILL) {
        // emission on and off the stable branch is routed outside
        P.p3(OUT_EMISSION_TERM, addv);
    } else {
        radiance = mk(radiance.x + addv.x, radiance.y + addv.y,
                      radiance.z + addv.z);
    }

    const float vertex_index = P.g(IN_VERTEX_INDEX);
    const float diffuse_bounces0 = P.g(IN_DIFFUSE_BOUNCES);
    const bool finished = (vertex_index > (float)max_bounces) ||
                          (diffuse_bounces0 > (float)max_diffuse_bounces);

    // Russian roulette (:125-149)
    bool rr_kill = false;
    if (RR) {
        float prob = sat(0.8f - luminance(thp));
        prob = prob * prob;
        prob = prob * prob;
        rr_kill = P.g(IN_U_RR) < prob;
        bool keep = shade && !rr_kill;
        float inv1p = 1.0f / (1.0f - prob);
        thp = keep ? scale(thp, inv1p) : thp;
    }
    const V3 pre_scatter_thp = thp;
    const bool will_scatter = shade && !finished && !rr_kill;

    // BSDF make + sample (GenerateScatterRay)
    const V3 nn = P.g3(IN_N), tt = P.g3(IN_T), bt = P.g3(IN_B);
    const V3 v = P.g3(IN_V);
    const bool thin = P.g(IN_THIN) != 0.0f;
    const Bsdf bb = make_bsdf(P.g3(IN_BD_DIFFUSE), P.g3(IN_BD_SPECULAR),
                              P.g(IN_BD_ROUGH), P.g(IN_BD_METALLIC),
                              P.g(IN_BD_ETA), P.g3(IN_BD_TRANS),
                              P.g(IN_BD_DTRANS), P.g(IN_BD_STRANS),
                              dot(v, nn), thin);
    const V3 wi = to_local(v, tt, bt, nn);
    const BsdfSample bs = bsdf_sample(bb, wi, P.g3(IN_U3));
    const V3 wo_world = from_local(bs.wo, tt, bt, nn);
    const int lobe_i = (int)bs.lobe;
    const bool is_delta = (lobe_i & LOBE_DELTA) != 0;
    const bool is_reflection = (lobe_i & LOBE_REFLECTION) != 0;
    const V3 scatter_thp = mul(thp, bs.weight);
    const bool scatter_valid = bs.valid &&
                               ((scatter_thp.x > 0.0f) ||
                                (scatter_thp.y > 0.0f) ||
                                (scatter_thp.z > 0.0f));
    const float rough_props = bb.alpha < kMinGGXAlpha ? 0.0f : bb.roughness;
    const bool is_diffuse_bounce =
        is_reflection && (((lobe_i & LOBE_DIFFUSE_REFLECTION) != 0) ||
                          (rough_props > spec_rough_threshold));
    const float diffuse_bounces =
        diffuse_bounces0 + ((will_scatter && is_diffuse_bounce) ? 1.0f : 0.0f);

    const float cone_spread0 = P.g(IN_CONE_SPREAD);
    const float cone_spread =
        (will_scatter && !is_delta)
            ? mins(cone_spread0 + spread_angle_from_pdf(bs.pdf, 0.15f), k2Pi)
            : cone_spread0;
    const float firefly_k = will_scatter
                                ? new_firefly_k(firefly_k0, bs.pdf, bs.lobe_p)
                                : firefly_k0;

    const V3 face_n = P.g3(IN_FACE_N);
    const bool front = P.g(IN_FRONT_FACING) != 0.0f;
    const V3 neg_fn = scale(face_n, -1.0f);
    const V3 pos = P.g3(IN_POS);
    const V3 fn_r = (front == is_reflection) ? face_n : neg_fn;
    const V3 origin = will_scatter ? compute_ray_origin(pos, fn_r)
                                   : P.g3(IN_ORIGIN);
    const V3 direction = will_scatter ? wo_world : P.g3(IN_DIRECTION);
    thp = will_scatter ? scatter_thp : thp;
    // visibility-ray origin: view side of the surface
    const V3 vis_origin = compute_ray_origin(pos, front ? face_n : neg_fn);

    // NEE (PathTracerNEE.hlsli:155-344)
    float emissive_mis = shade ? 1.0f : P.g(IN_EMISSIVE_MIS);
    const float env_mis_pre = shade ? 1.0f : P.g(IN_ENV_MIS);
    const V3 vertex_n = P.g3(IN_VERTEX_N);
    const float shadow_fade = P.g(IN_SHADOW_FADE);
    const bool nee_ok = shade && !finished && !rr_kill &&
                        (P.g(IN_NEE_SKIP) == 0.0f);

    auto nee_one = [&](V3 ls_dir, float ls_dist, V3 ls_li,
                       float light_mis_pdf, float ls_pdf, bool ls_valid,
                       float sample_weight, int idx, bool has_delta,
                       bool ls_delta) {
        V3 wo_nee = to_local(ls_dir, tt, bt, nn);
        V3 fd, fs;
        float scatter_pdf;
        bsdf_eval_split_pdf(bb, wi, wo_nee, &fd, &fs, &scatter_pdf);
        float mis = eval_mis(1.0f, light_mis_pdf / sample_weight, 1.0f,
                             scatter_pdf);
        if (has_delta && ls_delta) mis = 1.0f;
        V3 li = scale(ls_li, mis * sample_weight);
        float pdf_ff = ls_pdf / sample_weight;
        float lum = luminance(mul(add(fd, fs), li));
        bool need = nee_ok && ls_valid && (lum > nee_min_rad);
        float nee_k = new_firefly_k(firefly_k0, pdf_ff, 1.0f);
        float grazing =
            shadow_fade > 0.0f
                ? sat((dot(ls_dir, vertex_n) - shadow_fade) /
                      (2.0f * shadow_fade))
                : 1.0f;
        V3 dr = firefly_filter(mul(fd, li), firefly_threshold, nee_k);
        V3 sr = firefly_filter(mul(fs, li), firefly_threshold, nee_k);
        auto finish = [&](V3 sig) {
            V3 c = scale(sig, grazing);
            c = mul(pre_scatter_thp, c);
            c = scale(c, atten);
            return need ? mk(maxs(c.x, 0.f), maxs(c.y, 0.f), maxs(c.z, 0.f))
                        : mk(0.f, 0.f, 0.f);
        };
        const int o = FILL ? OUT_FIXED_FILL + NEE_OUT_ROWS_FILL * idx
                           : OUT_FIXED + NEE_OUT_ROWS * idx;
        P.p3(o + NEE_DIR, ls_dir);
        P.p(o + NEE_DIST, ls_dist * (1.0f - 1e-4f));
        P.p(o + NEE_NEED, need ? 1.0f : 0.0f);
        if (FILL) {
            // diffuse and specular apart, for the per-plane channels
            P.p3(o + NEE_CONTRIB_D, finish(dr));
            P.p3(o + NEE_CONTRIB_S, finish(sr));
        } else {
            P.p3(o + NEE_CONTRIB, finish(add(dr, sr)));
        }
    };

#pragma unroll
    for (int i = 0; i < ND; ++i) {
        wait_phase<ND, NL>(1 + i);
        const int base = IN_FIXED + DIST_ROWS * i;
        const float ls_pdf = P.g(base + DIST_PDF);
        nee_one(P.g3(base + DIST_DIR), P.g(base + DIST_DIST),
                P.g3(base + DIST_LI), ls_pdf, ls_pdf,
                P.g(base + DIST_VALID) != 0.0f, 1.0f / (float)ND, i, false,
                false);
    }
#pragma unroll
    for (int j = 0; j < NL; ++j) {
        wait_phase<ND, NL>(1 + ND + j);
        const int base = IN_FIXED + DIST_ROWS * ND + LOCAL_ROWS * j;
        const LightSample ls = local_light_sample(P, base, pos);
        nee_one(ls.dir, ls.dist, ls.li, local_pdf_k, ls.pdf, ls.valid,
                1.0f / (float)NL, ND + j, true, ls.delta);
    }

    // scatter-side MIS for the next segment (NEE.hlsli:248-280)
    const bool non_delta_scatter = scatter_valid && !is_delta;
    if (NL > 0) {
        float em_w = eval_mis(1.0f, bs.pdf, (float)NL, local_pdf_k);
        emissive_mis = (shade && non_delta_scatter) ? em_w : emissive_mis;
    }

    P.p3(OUT_RADIANCE, radiance);
    P.p3(OUT_THP, thp);
    P.p3(OUT_ORIGIN, origin);
    P.p3(OUT_DIRECTION, direction);
    P.p(OUT_FIREFLY_K, firefly_k);
    P.p(OUT_EMISSIVE_MIS, emissive_mis);
    P.p(OUT_ENV_MIS_PRE, env_mis_pre);
    P.p(OUT_CONE_SPREAD, cone_spread);
    P.p(OUT_DIFFUSE_BOUNCES, diffuse_bounces);
    P.p(OUT_LOBE, bs.lobe);
    P.p(OUT_BS_PDF, bs.pdf);
    P.p(OUT_LOBE_P, bs.lobe_p);
    P.p(OUT_SCATTER_VALID, scatter_valid ? 1.0f : 0.0f);
    P.p(OUT_WILL_SCATTER, will_scatter ? 1.0f : 0.0f);
    P.p(OUT_RR_KILL, rr_kill ? 1.0f : 0.0f);
    P.p(OUT_NON_DELTA_SCATTER, (shade && non_delta_scatter) ? 1.0f : 0.0f);
    P.p3(OUT_VIS_ORIGIN, vis_origin);
    if (FILL) P.p3(OUT_PRE_SCATTER_THP, pre_scatter_thp);
}

using LaunchFn = int (*)(const float*, const float*, float*, int, int, int,
                         float, float, cudaStream_t);

// one instantiation: allow its dynamic shared memory (once), then launch
template <int ND, int NL, bool RR, bool FILL>
int launch_one(const float* planes_in, const float* consts4,
               float* planes_out, int n, int max_bounces,
               int max_diffuse_bounces, float spec_rough_threshold,
               float local_pdf_k, cudaStream_t stream) {
    constexpr int smem = Shape<ND, NL>::smem_bytes;
    static const cudaError_t allowed = cudaFuncSetAttribute(
        shade_nee_kernel<ND, NL, RR, FILL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (allowed != cudaSuccess) return static_cast<int>(allowed);
    const unsigned blocks = static_cast<unsigned>((n + TILE - 1) / TILE);
    shade_nee_kernel<ND, NL, RR, FILL><<<blocks, TILE, smem, stream>>>(
        planes_in, consts4, planes_out, n, max_bounces, max_diffuse_bounces,
        spec_rough_threshold, local_pdf_k);
    return static_cast<int>(cudaGetLastError());
}

template <int ND, int NL, bool FILL>
LaunchFn pick_rr(bool rr) {
    return rr ? launch_one<ND, NL, true, FILL>
              : launch_one<ND, NL, false, FILL>;
}

template <int ND, bool FILL>
LaunchFn pick_nl(int nl, bool rr) {
    switch (nl) {
        case 0: return pick_rr<ND, 0, FILL>(rr);
        case 1: return pick_rr<ND, 1, FILL>(rr);
        case 2: return pick_rr<ND, 2, FILL>(rr);
    }
    return nullptr;
}

template <bool FILL>
LaunchFn pick(int nd, int nl, bool rr) {
    switch (nd) {
        case 0: return pick_nl<0, FILL>(nl, rr);
        case 1: return pick_nl<1, FILL>(nl, rr);
        case 2: return pick_nl<2, FILL>(nl, rr);
    }
    return nullptr;
}

int launch(LaunchFn fn, const float* planes_in, const float* consts4,
           float* planes_out, int n, int max_bounces,
           int max_diffuse_bounces, float spec_rough_threshold,
           float local_pdf_k, cudaStream_t stream) {
    if (fn == nullptr || n <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    return fn(planes_in, consts4, planes_out, n, max_bounces,
              max_diffuse_bounces, spec_rough_threshold, local_pdf_k, stream);
}

}  // namespace

RTXPT_API int rtxpt_shade_nee(const float* planes_in, const float* consts4,
                              float* planes_out, int n, int nee_distant,
                              int nee_local, int rr, int max_bounces,
                              int max_diffuse_bounces,
                              float spec_rough_threshold, float local_pdf_k,
                              cudaStream_t stream) {
    return launch(pick<false>(nee_distant, nee_local, rr != 0), planes_in,
                  consts4, planes_out, n, max_bounces, max_diffuse_bounces,
                  spec_rough_threshold, local_pdf_k, stream);
}

RTXPT_API int rtxpt_shade_nee_fill(const float* planes_in,
                                   const float* consts4, float* planes_out,
                                   int n, int nee_distant, int nee_local,
                                   int rr, int max_bounces,
                                   int max_diffuse_bounces,
                                   float spec_rough_threshold,
                                   float local_pdf_k, cudaStream_t stream) {
    return launch(pick<true>(nee_distant, nee_local, rr != 0), planes_in,
                  consts4, planes_out, n, max_bounces, max_diffuse_bounces,
                  spec_rough_threshold, local_pdf_k, stream);
}
