// The stateless sample generator: make, start_effect and next_uint /
// next_1d / next_2d / next_3d, one launch per call.
//
// Replaces: the chains of int64 tensor ops of core/rng.py's plain version
// on CUDA tensors (the reference computes these hashes inline in
// rtxpt_tpu/core/rng.py under XLA; it has no TPU kernel for them). The
// plain version carries every uint32 in an int64 masked with 0xFFFFFFFF
// after each operation and takes a Sobol' point as a float32 GF(2) matmul
// of the index's bits against the direction-number bit matrix: tens to
// hundreds of launches a call and, for the Sobol' point, several
// kilobytes of traffic a lane, on every lane whether it draws in a
// low-discrepancy dimension or not.
//
// Bound on the H100: the bytes of the generator's state. A lane's work is
// a few dozen integer operations; its state is six int64 fields (the
// plain version's layout, kept so that no caller changes).
// What the design does about it:
//  - One thread per lane, native uint32 arithmetic (wrap-around is the
//    plain version's masking), the state read once and the changed
//    fields written once, masked to 32 bits in their int64 words.
//  - The Sobol' point only on lanes in a low-discrepancy dimension, as the
//    XOR of the direction numbers of the index's set bits (the GF(2)
//    product the plain version's matmul computes), the 5 x 32 numbers in
//    __constant__ memory; bit reversal by __brev.
//  - Scalar operands (a vertex index, a sample index, a low-discrepancy
//    flag) come as kernel arguments, never as tensors copied from the host;
//    an operand broadcast from one element is read from that element.
//  - next_*: the k draws of a call in registers, one launch writing the
//    (..., k) float32 samples (or next_uint's uint32 in int64) and the
//    advanced effect and dimension.
#include "common.cuh"

namespace {

// an operand's source (`mode`): a scalar argument, or a tensor of int32,
// int64 or uint8/bool per lane; kBroadcast: every lane reads element 0
constexpr int kScalar = 0, kI32 = 1, kI64 = 2, kU8 = 3, kBroadcast = 4;

struct Src {
    const void* p;
    int mode;
    uint32_t value;
};

__device__ __forceinline__ uint32_t load(const Src& s, long long i) {
    const long long j = (s.mode & kBroadcast) ? 0 : i;
    switch (s.mode & 3) {
    case kI32:
        return static_cast<uint32_t>(static_cast<const int32_t*>(s.p)[j]);
    case kI64:
        return static_cast<uint32_t>(static_cast<const int64_t*>(s.p)[j]);
    case kU8:
        return static_cast<const uint8_t*>(s.p)[j];
    }
    return s.value;
}

__device__ __forceinline__ void store(int64_t* out, long long i, uint32_t v) {
    out[i] = static_cast<int64_t>(v);
}

constexpr uint32_t kNonLD = 0xFFFFFFFFu;
constexpr uint32_t kSupportedLD = 5;
constexpr uint32_t kHQFinalizeKey = 0x6C62272Eu;

// Sobol' direction numbers, dims 0..4 (NoiseAndSequences.hlsli:92-137)
__constant__ uint32_t kSobol[5][32] = {
    {0x80000000, 0x40000000, 0x20000000, 0x10000000,
     0x08000000, 0x04000000, 0x02000000, 0x01000000,
     0x00800000, 0x00400000, 0x00200000, 0x00100000,
     0x00080000, 0x00040000, 0x00020000, 0x00010000,
     0x00008000, 0x00004000, 0x00002000, 0x00001000,
     0x00000800, 0x00000400, 0x00000200, 0x00000100,
     0x00000080, 0x00000040, 0x00000020, 0x00000010,
     0x00000008, 0x00000004, 0x00000002, 0x00000001},
    {0x80000000, 0xc0000000, 0xa0000000, 0xf0000000,
     0x88000000, 0xcc000000, 0xaa000000, 0xff000000,
     0x80800000, 0xc0c00000, 0xa0a00000, 0xf0f00000,
     0x88880000, 0xcccc0000, 0xaaaa0000, 0xffff0000,
     0x80008000, 0xc000c000, 0xa000a000, 0xf000f000,
     0x88008800, 0xcc00cc00, 0xaa00aa00, 0xff00ff00,
     0x80808080, 0xc0c0c0c0, 0xa0a0a0a0, 0xf0f0f0f0,
     0x88888888, 0xcccccccc, 0xaaaaaaaa, 0xffffffff},
    {0x80000000, 0xc0000000, 0x60000000, 0x90000000,
     0xe8000000, 0x5c000000, 0x8e000000, 0xc5000000,
     0x68800000, 0x9cc00000, 0xee600000, 0x55900000,
     0x80680000, 0xc09c0000, 0x60ee0000, 0x90550000,
     0xe8808000, 0x5cc0c000, 0x8e606000, 0xc5909000,
     0x6868e800, 0x9c9c5c00, 0xeeee8e00, 0x5555c500,
     0x8000e880, 0xc0005cc0, 0x60008e60, 0x9000c590,
     0xe8006868, 0x5c009c9c, 0x8e00eeee, 0xc5005555},
    {0x80000000, 0xc0000000, 0x20000000, 0x50000000,
     0xf8000000, 0x74000000, 0xa2000000, 0x93000000,
     0xd8800000, 0x25400000, 0x59e00000, 0xe6d00000,
     0x78080000, 0xb40c0000, 0x82020000, 0xc3050000,
     0x208f8000, 0x51474000, 0xfbea2000, 0x75d93000,
     0xa0858800, 0x914e5400, 0xdbe79e00, 0x25db6d00,
     0x58800080, 0xe54000c0, 0x79e00020, 0xb6d00050,
     0x800800f8, 0xc00c0074, 0x200200a2, 0x50050093},
    {0x80000000, 0x40000000, 0x20000000, 0xb0000000,
     0xf8000000, 0xdc000000, 0x7a000000, 0x9d000000,
     0x5a800000, 0x2fc00000, 0xa1600000, 0xf0b00000,
     0xda880000, 0x6fc40000, 0x81620000, 0x40bb0000,
     0x22878000, 0xb3c9c000, 0xfb65a000, 0xddb2d000,
     0x78022800, 0x9c0b3c00, 0x5a0fb600, 0x2d0ddb00,
     0xa2878080, 0xf3c9c040, 0xdb65a020, 0x6db2d0b0,
     0x800228f8, 0x400b3cdc, 0x200fb67a, 0xb00ddb9d},
};

// lowbias32 (Utils.hlsli:96-110)
__device__ __forceinline__ uint32_t hash32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    x ^= x >> 16;
    return x;
}

// boost-style hash_combine (Utils.hlsli:127-130)
__device__ __forceinline__ uint32_t hash32_combine(uint32_t seed,
                                                   uint32_t value) {
    return seed ^ (hash32(value) + 0x9E3779B9u + (seed << 6) + (seed >> 2));
}

// improved Laine-Karras hash (NoiseAndSequences.hlsli:162-178)
__device__ __forceinline__ uint32_t owen_hash(uint32_t x, uint32_t seed) {
    x ^= x * 0x3D20ADEAu;
    x += seed;
    x *= (seed >> 16) | 1u;
    x ^= x * 0x05526C56u;
    x ^= x * 0x53A22864u;
    return x;
}

// nested_uniform_scramble_base2 (NoiseAndSequences.hlsli:180-186)
__device__ __forceinline__ uint32_t owen_scramble(uint32_t x, uint32_t seed) {
    return __brev(owen_hash(__brev(x), seed));
}

// Sobol' point of `index` in dimension d in [1, 4]: the XOR of the
// direction numbers of the index's set bits
__device__ __forceinline__ uint32_t sobol(uint32_t index, uint32_t d) {
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i)
        if ((index >> i) & 1u) x ^= kSobol[d][i];
    return x;
}

// upper 24 bits -> [0, 1) (Utils.hlsli:137-142); exact in float32
__device__ __forceinline__ float to_float(uint32_t h) {
    return __fmul_rn(__uint2float_rn(h >> 8), 1.0f / 16777216.0f);
}

// start_effect's three fields from (base, sample_index, ld)
struct Effect {
    uint32_t effect, dimension, active;
};

__device__ __forceinline__ Effect start_effect(uint32_t base, uint32_t si,
                                               bool ld, uint32_t effect_seed,
                                               uint32_t sub_index,
                                               uint32_t sub_count) {
    const uint32_t active = si * sub_count + sub_index;
    const uint32_t eff_ld = hash32_combine(base, effect_seed);
    return ld ? Effect{eff_ld, 0u, active}
              : Effect{hash32_combine(eff_ld, active), kNonLD, active};
}

__global__ void rng_make_kernel(Src px, Src py, Src vi, Src si, Src ld,
                                uint32_t hq, int64_t* __restrict__ base,
                                int64_t* __restrict__ effect,
                                int64_t* __restrict__ sample_index,
                                int64_t* __restrict__ dimension,
                                int64_t* __restrict__ active,
                                int64_t* __restrict__ hq_out, long long n) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        const uint32_t b = hash32_combine(hash32(load(vi, i) + 0x035F9F29u),
                                          (load(px, i) << 16) | load(py, i));
        const uint32_t s = load(si, i);
        const Effect e = start_effect(b, s, load(ld, i) != 0, 0u, 0u, 1u);
        store(base, i, b);
        store(effect, i, e.effect);
        store(sample_index, i, s);
        store(dimension, i, e.dimension);
        store(active, i, e.active);
        store(hq_out, i, hq);
    }
}

__global__ void rng_start_effect_kernel(Src base, Src si, Src ld,
                                        uint32_t effect_seed,
                                        uint32_t sub_index,
                                        uint32_t sub_count,
                                        int64_t* __restrict__ effect,
                                        int64_t* __restrict__ dimension,
                                        int64_t* __restrict__ active,
                                        long long n) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        const Effect e = start_effect(load(base, i), load(si, i),
                                      load(ld, i) != 0, effect_seed,
                                      sub_index, sub_count);
        store(effect, i, e.effect);
        store(dimension, i, e.dimension);
        store(active, i, e.active);
    }
}

// K draws of next_uint (StatelessSampleGenerators.hlsli:122-159); LD:
// allow_ld; UINT: next_uint's full-range samples (K = 1) written as int64,
// else next_1d/2d/3d's floats
template <int K, bool LD, bool UINT>
__global__ void rng_next_kernel(Src effect, Src dimension, Src active,
                                Src hq, int64_t* __restrict__ effect_out,
                                int64_t* __restrict__ dimension_out,
                                void* __restrict__ samples, long long n) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
        uint32_t eff = load(effect, i);
        uint32_t dim = LD ? load(dimension, i) : 0u;
        const uint32_t act = LD ? load(active, i) : 0u;
        const bool hq_on = load(hq, i) != 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
            uint32_t out;
            if (LD && dim != kNonLD) {
                const uint32_t shuffled =
                    owen_scramble(act, hash32_combine(eff, 0u));
                const uint32_t dim_seed = hash32_combine(eff, dim + 1u);
                // dim 0: the Laine-Karras permutation (reversed bits); the
                // plain version clamps a dimension to [0, 4]
                const uint32_t ld = dim == 0u
                    ? __brev(shuffled)
                    : sobol(shuffled, min(dim, kSupportedLD - 1u));
                out = owen_scramble(ld, dim_seed);
                const uint32_t next = dim + 1u;
                if (next >= kSupportedLD) {
                    eff = hash32_combine(eff, act);
                    dim = kNonLD;
                } else {
                    dim = next;
                }
            } else {
                eff = hash32(eff);
                out = hq_on ? hash32(eff ^ kHQFinalizeKey) : eff;
            }
            if (UINT)
                store(static_cast<int64_t*>(samples), i, out);
            else
                static_cast<float*>(samples)[i * K + k] = to_float(out);
        }
        store(effect_out, i, eff);
        if (LD) store(dimension_out, i, dim);
    }
}

template <int K, bool LD, bool UINT>
int launch_next(Src effect, Src dimension, Src active, Src hq,
                int64_t* effect_out, int64_t* dimension_out, void* samples,
                int n, cudaStream_t stream) {
    rng_next_kernel<K, LD, UINT><<<rtxpt::grid_for(n), rtxpt::kThreads, 0,
                                   stream>>>(effect, dimension, active, hq,
                                             effect_out, dimension_out,
                                             samples, n);
    return static_cast<int>(cudaGetLastError());
}

template <bool LD>
int dispatch_next(int k, int uint_out, Src effect, Src dimension, Src active,
                  Src hq, int64_t* effect_out, int64_t* dimension_out,
                  void* samples, int n, cudaStream_t stream) {
    if (uint_out)
        return k == 1 ? launch_next<1, LD, true>(effect, dimension, active,
                                                 hq, effect_out,
                                                 dimension_out, samples, n,
                                                 stream)
                      : static_cast<int>(cudaErrorInvalidValue);
    switch (k) {
    case 1:
        return launch_next<1, LD, false>(effect, dimension, active, hq,
                                         effect_out, dimension_out, samples,
                                         n, stream);
    case 2:
        return launch_next<2, LD, false>(effect, dimension, active, hq,
                                         effect_out, dimension_out, samples,
                                         n, stream);
    case 3:
        return launch_next<3, LD, false>(effect, dimension, active, hq,
                                         effect_out, dimension_out, samples,
                                         n, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Each operand is (pointer, mode, scalar value): see `Src`; every output is
// an int64 tensor of n uint32 values
RTXPT_API int rtxpt_rng_make(const void* px, int px_mode, uint32_t px_v,
                             const void* py, int py_mode, uint32_t py_v,
                             const void* vi, int vi_mode, uint32_t vi_v,
                             const void* si, int si_mode, uint32_t si_v,
                             const void* ld, int ld_mode, uint32_t ld_v,
                             uint32_t hq, int64_t* base, int64_t* effect,
                             int64_t* sample_index, int64_t* dimension,
                             int64_t* active, int64_t* hq_out, int n,
                             cudaStream_t stream) {
    rng_make_kernel<<<rtxpt::grid_for(n), rtxpt::kThreads, 0, stream>>>(
        Src{px, px_mode, px_v}, Src{py, py_mode, py_v},
        Src{vi, vi_mode, vi_v}, Src{si, si_mode, si_v},
        Src{ld, ld_mode, ld_v}, hq, base, effect, sample_index, dimension,
        active, hq_out, n);
    return static_cast<int>(cudaGetLastError());
}

RTXPT_API int rtxpt_rng_start_effect(const void* base, int base_mode,
                                     const void* si, int si_mode,
                                     const void* ld, int ld_mode,
                                     uint32_t ld_v, uint32_t effect_seed,
                                     uint32_t sub_index, uint32_t sub_count,
                                     int64_t* effect, int64_t* dimension,
                                     int64_t* active, int n,
                                     cudaStream_t stream) {
    rng_start_effect_kernel<<<rtxpt::grid_for(n), rtxpt::kThreads, 0,
                              stream>>>(
        Src{base, base_mode, 0u}, Src{si, si_mode, 0u},
        Src{ld, ld_mode, ld_v}, effect_seed, sub_index, sub_count, effect,
        dimension, active, n);
    return static_cast<int>(cudaGetLastError());
}

// k draws (1-3; uint_out: next_uint's one draw as int64); dimension_out is
// written only with allow_ld
RTXPT_API int rtxpt_rng_next(const void* effect, int effect_mode,
                             const void* dimension, int dimension_mode,
                             const void* active, int active_mode,
                             const void* hq, int hq_mode, int k, int allow_ld,
                             int uint_out, int64_t* effect_out,
                             int64_t* dimension_out, void* samples, int n,
                             cudaStream_t stream) {
    const Src e{effect, effect_mode, 0u}, d{dimension, dimension_mode, 0u},
        a{active, active_mode, 0u}, h{hq, hq_mode, 0u};
    return allow_ld
        ? dispatch_next<true>(k, uint_out, e, d, a, h, effect_out,
                              dimension_out, samples, n, stream)
        : dispatch_next<false>(k, uint_out, e, d, a, h, effect_out,
                               dimension_out, samples, n, stream);
}
