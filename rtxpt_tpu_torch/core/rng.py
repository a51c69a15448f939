"""Stateless counter-based sample generators (counterpart of
rtxpt_tpu/core/rng.py), bit-exact with the reference.

`make`, `start_effect` and `next_uint` / `next_1d` / `next_2d` / `next_3d`
decide by their tensors' device (`cuda_lib.on_cuda`): CUDA tensors launch
one kernel a call (``csrc/rng.cu``: native uint32 arithmetic, the Sobol'
point only on lanes in a low-discrepancy dimension, scalar operands as
kernel arguments), CPU tensors take the plain version (the ``*_plain``
functions), which the tests hold against the reference.

In the plain version every value is a uint32 of the reference carried in
an int64 tensor and masked with 0xFFFFFFFF after each operation that can
leave 32 bits: PyTorch's CPU build has no ``>>``, ``<<`` or ``+`` on
uint32. Products of two 32-bit values are split into 16-bit halves so no
intermediate leaves int64's positive range. Sobol' points are computed as
a GF(2) matrix product: the bits of the index times the direction-number
bit matrix, with the parities taken from a float32 matmul of 0/1 values
(exact: every sum is at most 32).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import cuda_lib
from ..utils import profiling

M32 = 0xFFFFFFFF

# SampleGeneratorEffectSeed (reference: Sampling.hlsli:16-24)
EFFECT_BASE = 0
EFFECT_SCATTER_BSDF = 1
EFFECT_NEE = 2
EFFECT_NEE_LOCAL = 3
EFFECT_NEE_DISTANT = 4
EFFECT_RUSSIAN_ROULETTE = 5

# LD sampling is disabled after this many diffuse bounces
# (reference: Sampling.hlsli:27)
DISABLE_LD_AFTER_DIFFUSE_BOUNCES = 2

_SUPPORTED_LD_DIMENSIONS = 5
_NON_LD = 0xFFFFFFFF
_HQ_FINALIZE_KEY = 0x6C62272E


def u32(x, device=None) -> torch.Tensor:
    """A python int, numpy array or tensor as an int64 tensor of uint32
    values."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    with profiling.span("sync"):
        return torch.as_tensor(np.asarray(x, np.int64) & M32,
                               dtype=torch.int64, device=device)


def mul32(a, b):
    """(a * b) mod 2^32 for uint32 values in int64, without overflow."""
    lo, hi = b & 0xFFFF, (b >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def hash32(x):
    """lowbias32 hash (Utils.hlsli:96-110; Chris Wellons)."""
    x = x & M32
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash32_combine(seed, value):
    """boost-style hash_combine (Utils.hlsli:127-130)."""
    return seed ^ ((hash32(value) + 0x9E3779B9 + ((seed << 6) & M32)
                    + (seed >> 2)) & M32)


def hash32_to_float(h):
    """Upper 24 bits -> [0,1) (Utils.hlsli:137-142)."""
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def reverse_bits32(x):
    x = ((x & 0xAAAAAAAA) >> 1) | ((x & 0x55555555) << 1)
    x = ((x & 0xCCCCCCCC) >> 2) | ((x & 0x33333333) << 2)
    x = ((x & 0xF0F0F0F0) >> 4) | ((x & 0x0F0F0F0F) << 4)
    x = ((x & 0xFF00FF00) >> 8) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & M32


def owen_hash(x, seed):
    """Improved Laine-Karras hash (NoiseAndSequences.hlsli:162-178)."""
    x = x ^ mul32(x, 0x3D20ADEA)
    x = (x + seed) & M32
    x = mul32(x, (seed >> 16) | 1)
    x = x ^ mul32(x, 0x05526C56)
    x = x ^ mul32(x, 0x53A22864)
    return x


def owen_scramble(x, seed):
    """nested_uniform_scramble_base2 (NoiseAndSequences.hlsli:180-186)."""
    return reverse_bits32(owen_hash(reverse_bits32(x), seed))


# Sobol' direction numbers, dims 0..4 (NoiseAndSequences.hlsli:92-137)
_SOBOL_DIRECTIONS = np.array([
    [0x80000000 >> i for i in range(32)],
    [0x80000000, 0xc0000000, 0xa0000000, 0xf0000000,
     0x88000000, 0xcc000000, 0xaa000000, 0xff000000,
     0x80800000, 0xc0c00000, 0xa0a00000, 0xf0f00000,
     0x88880000, 0xcccc0000, 0xaaaa0000, 0xffff0000,
     0x80008000, 0xc000c000, 0xa000a000, 0xf000f000,
     0x88008800, 0xcc00cc00, 0xaa00aa00, 0xff00ff00,
     0x80808080, 0xc0c0c0c0, 0xa0a0a0a0, 0xf0f0f0f0,
     0x88888888, 0xcccccccc, 0xaaaaaaaa, 0xffffffff],
    [0x80000000, 0xc0000000, 0x60000000, 0x90000000,
     0xe8000000, 0x5c000000, 0x8e000000, 0xc5000000,
     0x68800000, 0x9cc00000, 0xee600000, 0x55900000,
     0x80680000, 0xc09c0000, 0x60ee0000, 0x90550000,
     0xe8808000, 0x5cc0c000, 0x8e606000, 0xc5909000,
     0x6868e800, 0x9c9c5c00, 0xeeee8e00, 0x5555c500,
     0x8000e880, 0xc0005cc0, 0x60008e60, 0x9000c590,
     0xe8006868, 0x5c009c9c, 0x8e00eeee, 0xc5005555],
    [0x80000000, 0xc0000000, 0x20000000, 0x50000000,
     0xf8000000, 0x74000000, 0xa2000000, 0x93000000,
     0xd8800000, 0x25400000, 0x59e00000, 0xe6d00000,
     0x78080000, 0xb40c0000, 0x82020000, 0xc3050000,
     0x208f8000, 0x51474000, 0xfbea2000, 0x75d93000,
     0xa0858800, 0x914e5400, 0xdbe79e00, 0x25db6d00,
     0x58800080, 0xe54000c0, 0x79e00020, 0xb6d00050,
     0x800800f8, 0xc00c0074, 0x200200a2, 0x50050093],
    [0x80000000, 0x40000000, 0x20000000, 0xb0000000,
     0xf8000000, 0xdc000000, 0x7a000000, 0x9d000000,
     0x5a800000, 0x2fc00000, 0xa1600000, 0xf0b00000,
     0xda880000, 0x6fc40000, 0x81620000, 0x40bb0000,
     0x22878000, 0xb3c9c000, 0xfb65a000, 0xddb2d000,
     0x78022800, 0x9c0b3c00, 0x5a0fb600, 0x2d0ddb00,
     0xa2878080, 0xf3c9c040, 0xdb65a020, 0x6db2d0b0,
     0x800228f8, 0x400b3cdc, 0x200fb67a, 0xb00ddb9d],
], dtype=np.uint64)

# (32 index bits) x (5 dims * 32 output bits) 0/1 matrix: entry
# [i, d*32 + j] is bit j of direction number i of dimension d
_SOBOL_BITS = ((_SOBOL_DIRECTIONS[:, :, None]
                >> np.arange(32, dtype=np.uint64)[None, None, :]) & 1
               ).transpose(1, 0, 2).reshape(32, 5 * 32).astype(np.float32)
_sobol_cache = {}


def _sobol_matrix(device):
    key = str(device)
    if key not in _sobol_cache:
        _sobol_cache[key] = torch.as_tensor(_SOBOL_BITS, device=device)
    return _sobol_cache[key]


def sobol(index, dimension):
    """Sobol' sample for (index, dimension in [0, 4]) per lane
    (NoiseAndSequences.hlsli bhos_sobol)."""
    shape = index.shape
    idx = index.reshape(-1)
    shifts = torch.arange(32, device=idx.device, dtype=torch.int64)
    bits = ((idx[:, None] >> shifts[None, :]) & 1).to(torch.float32)
    counts = bits @ _sobol_matrix(idx.device)               # (n, 160)
    parity = (counts.to(torch.int64) & 1).reshape(-1, 5, 32)
    words = (parity << shifts[None, None, :]).sum(-1)         # (n, 5)
    dim = dimension.reshape(-1).clamp(0, _SUPPORTED_LD_DIMENSIONS - 1)
    out = torch.gather(words, 1, dim[:, None])[:, 0]
    return out.reshape(shape)


class SampleGenerator(NamedTuple):
    """StatelessLowDiscrepancySampleGenerator state
    (StatelessSampleGenerators.hlsli:74-160); every field an int64 tensor
    of uint32 values, all of one shape."""
    base: torch.Tensor
    effect: torch.Tensor
    sample_index: torch.Tensor
    dimension: torch.Tensor
    active: torch.Tensor
    hq: torch.Tensor


def make_plain(pixel_x, pixel_y, vertex_index, sample_index,
               low_discrepancy=False, hq=False) -> SampleGenerator:
    """Seed a generator from (pixel, path vertex, sample index)
    (StatelessSampleGenerators.hlsli:85-93)."""
    dev = pixel_x.device if isinstance(pixel_x, torch.Tensor) else None
    px = u32(pixel_x, dev)
    py = u32(pixel_y, dev)
    vi = u32(vertex_index, dev)
    base = hash32_combine(hash32((vi + 0x035F9F29) & M32),
                          ((px << 16) & M32) | py)
    si = u32(sample_index, dev)
    shape = torch.broadcast_shapes(base.shape, si.shape)
    base = base.expand(shape)
    g = SampleGenerator(
        base=base,
        effect=torch.zeros_like(base),
        sample_index=si.expand(shape),
        dimension=torch.full_like(base, _NON_LD),
        active=torch.zeros_like(base),
        hq=torch.full_like(base, 1 if hq else 0))
    return start_effect_plain(g, EFFECT_BASE, low_discrepancy)


def start_effect_plain(g: SampleGenerator, effect_seed: int,
                       low_discrepancy=False, sub_index: int = 0,
                       sub_count: int = 1) -> SampleGenerator:
    """Rebase onto a decorrelated per-effect stream
    (StatelessSampleGenerators.hlsli:102-116). `low_discrepancy` may be a
    per-lane bool tensor."""
    active = (mul32(g.sample_index, sub_count) + sub_index) & M32
    eff_ld = hash32_combine(g.base, effect_seed)
    eff_nold = hash32_combine(eff_ld, active)
    if isinstance(low_discrepancy, torch.Tensor):
        ld = low_discrepancy.to(g.base.device)
    else:
        with profiling.span("sync"):
            ld = torch.as_tensor(low_discrepancy, device=g.base.device)
    ld = ld.expand(g.base.shape)
    return SampleGenerator(
        base=g.base,
        effect=torch.where(ld, eff_ld, eff_nold),
        sample_index=g.sample_index,
        dimension=torch.where(ld, torch.zeros_like(g.base),
                              torch.full_like(g.base, _NON_LD)),
        active=active.expand(g.base.shape),
        hq=g.hq)


def next_uint_plain(g: SampleGenerator, allow_ld: bool = True):
    """Advance and return a full-range uint32 sample
    (StatelessSampleGenerators.hlsli:122-159). allow_ld=False is the
    fast path for streams started without low discrepancy."""
    eff_hashed = hash32(g.effect)
    out_nold = torch.where(g.hq != 0,
                           hash32(eff_hashed ^ _HQ_FINALIZE_KEY),
                           eff_hashed)
    if not allow_ld:
        return g._replace(effect=eff_hashed), out_nold

    in_ld = g.dimension != _NON_LD
    shuffle_seed = hash32_combine(g.effect, 0)
    dim_seed = hash32_combine(g.effect, (g.dimension + 1) & M32)
    shuffled = owen_scramble(g.active, shuffle_seed)
    # dim 0 uses the Laine-Karras permutation (reversed bits); dims 1+ Sobol'
    ld_sample = torch.where(g.dimension == 0, reverse_bits32(shuffled),
                            sobol(shuffled, g.dimension))
    ld_sample = owen_scramble(ld_sample, dim_seed)

    new_dim = (g.dimension + 1) & M32
    exhausted = new_dim >= _SUPPORTED_LD_DIMENSIONS
    eff_after_ld = torch.where(exhausted, hash32_combine(g.effect, g.active),
                               g.effect)
    new_dim = torch.where(exhausted, torch.full_like(new_dim, _NON_LD),
                          new_dim)
    out = torch.where(in_ld, ld_sample, out_nold)
    g2 = g._replace(effect=torch.where(in_ld, eff_after_ld, eff_hashed),
                    dimension=torch.where(in_ld, new_dim, g.dimension))
    return g2, out


def next_1d_plain(g: SampleGenerator, allow_ld: bool = True):
    g, u = next_uint_plain(g, allow_ld)
    return g, hash32_to_float(u)


def next_2d_plain(g: SampleGenerator, allow_ld: bool = True):
    g, x = next_1d_plain(g, allow_ld)
    g, y = next_1d_plain(g, allow_ld)
    return g, torch.stack([x, y], dim=-1)


def next_3d_plain(g: SampleGenerator, allow_ld: bool = True):
    g, x = next_1d_plain(g, allow_ld)
    g, y = next_1d_plain(g, allow_ld)
    g, z = next_1d_plain(g, allow_ld)
    return g, torch.stack([x, y, z], dim=-1)


# ---- the kernels (csrc/rng.cu) on CUDA tensors ----------------------------

# an operand's mode in csrc/rng.cu: a scalar argument, or a tensor of int32,
# int64 or uint8/bool per lane; _BROADCAST: every lane reads element 0
_SCALAR, _I32, _I64, _U8, _BROADCAST = 0, 1, 2, 3, 4
_MODES = {torch.int32: _I32, torch.int64: _I64, torch.bool: _U8,
          torch.uint8: _U8}


def _operand(x, shape, device):
    """(pointer, mode, scalar value) of a kernel operand broadcast to
    `shape`, and the tensor that holds its values (None for a scalar).
    Scalars stay on the host as kernel arguments; an array is copied to
    the device, as the plain version copies it."""
    if isinstance(x, (int, np.integer, np.bool_)):
        return (None, _SCALAR, int(x) & M32), None
    if not isinstance(x, torch.Tensor):
        x = u32(x, device)
    if x.dtype not in _MODES:
        x = x.to(torch.int64)
    if x.shape == shape and x.is_contiguous():
        return (x.data_ptr(), _MODES[x.dtype], 0), x
    x = x.expand(shape)
    if all(s == 0 for s in x.stride()):
        return (x.data_ptr(), _MODES[x.dtype] | _BROADCAST, 0), x
    x = x.contiguous()
    return (x.data_ptr(), _MODES[x.dtype], 0), x


def _fields(n_fields, shape, device):
    """n_fields int64 state fields of `shape` in one allocation."""
    return torch.empty((n_fields, *shape), dtype=torch.int64,
                       device=device).unbind(0)


@cuda_lib.counted("rng_make")
def make(pixel_x, pixel_y, vertex_index, sample_index,
         low_discrepancy=False, hq=False) -> SampleGenerator:
    """Seed a generator from (pixel, path vertex, sample index)
    (StatelessSampleGenerators.hlsli:85-93) and start its EFFECT_BASE
    stream; on CUDA tensors one launch, scalar indices and flags passed as
    kernel arguments."""
    args = (pixel_x, pixel_y, vertex_index, sample_index, low_discrepancy)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not tensors or not cuda_lib.on_cuda(*tensors):
        return make_plain(*args[:4], low_discrepancy, hq)
    dev = tensors[0].device
    shapes = {a.shape for a in args[:4] if isinstance(a, torch.Tensor)}
    shape = shapes.pop() if len(shapes) == 1 else \
        torch.broadcast_shapes(*shapes)
    ops = [_operand(a, shape, dev) for a in args]
    out = _fields(6, shape, dev)
    n = shape.numel()
    if n:
        cuda_lib.bump("rng_make")
        cuda_lib.launch("rtxpt_rng_make", *(v for op, _ in ops for v in op),
                        1 if hq else 0, *(f.data_ptr() for f in out), n)
    return SampleGenerator(*out)


@cuda_lib.counted("rng_start_effect")
def start_effect(g: SampleGenerator, effect_seed: int, low_discrepancy=False,
                 sub_index: int = 0, sub_count: int = 1) -> SampleGenerator:
    """Rebase onto a decorrelated per-effect stream
    (StatelessSampleGenerators.hlsli:102-116). `low_discrepancy` may be a
    per-lane bool tensor; on CUDA tensors one launch, a host flag passed as
    a kernel argument."""
    tensors = [g.base, g.sample_index]
    if isinstance(low_discrepancy, torch.Tensor):
        tensors.append(low_discrepancy)
    if not cuda_lib.on_cuda(*tensors):
        return start_effect_plain(g, effect_seed, low_discrepancy, sub_index,
                                  sub_count)
    shape, dev = g.base.shape, g.base.device
    ops = [_operand(a, shape, dev)
           for a in (g.base, g.sample_index, low_discrepancy)]
    effect, dimension, active = _fields(3, shape, dev)
    n = shape.numel()
    if n:
        cuda_lib.bump("rng_start_effect")
        cuda_lib.launch("rtxpt_rng_start_effect", *ops[0][0][:2],
                        *ops[1][0][:2], *ops[2][0], effect_seed & M32,
                        sub_index & M32, sub_count & M32, effect.data_ptr(),
                        dimension.data_ptr(), active.data_ptr(), n)
    return g._replace(effect=effect, dimension=dimension, active=active)


@cuda_lib.counted("rng_next")
def _next(g: SampleGenerator, k: int, allow_ld: bool, uint_out: bool):
    """k draws in one launch on CUDA tensors: (advanced generator, the
    (..., k) float32 samples, or next_uint's int64 values for uint_out)."""
    shape, dev = g.effect.shape, g.effect.device
    ops = [_operand(a, shape, dev)
           for a in (g.effect, g.dimension, g.active, g.hq)]
    fields = _fields(2 if allow_ld else 1, shape, dev)
    samples = torch.empty(shape if uint_out else (*shape, k),
                          dtype=torch.int64 if uint_out else torch.float32,
                          device=dev)
    n = shape.numel()
    if n:
        cuda_lib.bump("rng_next")
        cuda_lib.launch("rtxpt_rng_next",
                        *(v for op, _ in ops for v in op[:2]), k,
                        int(allow_ld), int(uint_out), fields[0].data_ptr(),
                        fields[-1].data_ptr() if allow_ld else None,
                        samples.data_ptr(), n)
    g = g._replace(effect=fields[0],
                   dimension=fields[1] if allow_ld else g.dimension)
    return g, samples


def _on_cuda(g: SampleGenerator) -> bool:
    return cuda_lib.on_cuda(g.effect, g.dimension, g.active, g.hq)


def next_uint(g: SampleGenerator, allow_ld: bool = True):
    """Advance and return a full-range uint32 sample
    (StatelessSampleGenerators.hlsli:122-159). allow_ld=False is the
    fast path for streams started without low discrepancy."""
    if not _on_cuda(g):
        return next_uint_plain(g, allow_ld)
    return _next(g, 1, allow_ld, True)


def next_1d(g: SampleGenerator, allow_ld: bool = True):
    if not _on_cuda(g):
        return next_1d_plain(g, allow_ld)
    g, u = _next(g, 1, allow_ld, False)
    return g, u[..., 0]


def next_2d(g: SampleGenerator, allow_ld: bool = True):
    if not _on_cuda(g):
        return next_2d_plain(g, allow_ld)
    return _next(g, 2, allow_ld, False)


def next_3d(g: SampleGenerator, allow_ld: bool = True):
    if not _on_cuda(g):
        return next_3d_plain(g, allow_ld)
    return _next(g, 3, allow_ld, False)
