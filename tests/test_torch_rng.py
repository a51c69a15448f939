"""The port's stateless RNG (rtxpt_tpu_torch/core/rng.py) is bit-exact with
the reference (rtxpt_tpu/core/rng.py) on the same seeded inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.core import rng as R
from rtxpt_tpu_torch.core import rng as T

N = 4096


def _u32(seed, n=N):
    r = np.random.RandomState(seed)
    x = r.randint(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    # the edges of the range
    x[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    return x


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


def _same(ref, got):
    return np.array_equal(np.asarray(ref).astype(np.int64), got.numpy())


@pytest.mark.parametrize("name", ["hash32", "reverse_bits32"])
def test_unary_hashes_bit_exact(name):
    x = _u32(1)
    assert _same(getattr(R, name)(jnp.asarray(x)), getattr(T, name)(_t(x)))


@pytest.mark.parametrize("name", ["hash32_combine", "owen_hash",
                                  "owen_scramble"])
def test_binary_hashes_bit_exact(name):
    x, y = _u32(2), _u32(3)
    assert _same(getattr(R, name)(jnp.asarray(x), jnp.asarray(y)),
                 getattr(T, name)(_t(x), _t(y)))


def test_sobol_bit_exact():
    x = _u32(4)
    dim = np.random.RandomState(5).randint(0, 5, N).astype(np.uint32)
    assert _same(R.sobol(jnp.asarray(x), jnp.asarray(dim)),
                 T.sobol(_t(x), _t(dim)))


def test_hash32_to_float_bit_exact():
    x = _u32(6)
    ref = np.asarray(R.hash32_to_float(jnp.asarray(x)))
    got = T.hash32_to_float(_t(x)).numpy()
    assert got.dtype == np.float32 and np.array_equal(ref, got)


@pytest.mark.parametrize("hq", [False, True])
@pytest.mark.parametrize("ld", [False, True, "mixed"])
def test_generator_streams_bit_exact(ld, hq):
    """make -> start_effect -> next_1d/2d/3d, through the LD dimensions
    and past their exhaustion, with per-lane LD flags."""
    r = np.random.RandomState(7)
    px = r.randint(0, 800, N).astype(np.uint32)
    py = r.randint(0, 600, N).astype(np.uint32)
    vi = r.randint(0, 30, N).astype(np.uint32)
    si = r.randint(0, 1 << 20, N).astype(np.uint32)
    flag = (r.rand(N) < 0.5) if ld == "mixed" else ld
    g = R.make(jnp.asarray(px), jnp.asarray(py), jnp.asarray(vi),
               jnp.asarray(si), hq=hq)
    tg = T.make(_t(px), _t(py), _t(vi), _t(si), hq=hq)
    for effect in (R.EFFECT_SCATTER_BSDF, R.EFFECT_NEE):
        g = R.start_effect(g, effect, jnp.asarray(flag))
        tg = T.start_effect(tg, effect, torch.as_tensor(flag))
        for draw in ("next_1d", "next_3d", "next_2d", "next_3d"):
            g, u = getattr(R, draw)(g)
            tg, tu = getattr(T, draw)(tg)
            assert np.array_equal(np.asarray(u), tu.numpy()), draw
        g, u = R.next_2d(g, allow_ld=False)
        tg, tu = T.next_2d(tg, allow_ld=False)
        assert np.array_equal(np.asarray(u), tu.numpy())
    for field in R.SampleGenerator._fields:
        assert _same(getattr(g, field), getattr(tg, field)), field


def test_scalar_seeds_broadcast_like_reference():
    """Scalar vertex and sample indices (the camera-ray seeding)."""
    px = np.arange(64, dtype=np.uint32)
    py = np.arange(64, dtype=np.uint32)[::-1].copy()
    g, u = R.next_2d(R.make(jnp.asarray(px), jnp.asarray(py),
                            jnp.uint32(0), jnp.uint32(5)))
    tg, tu = T.next_2d(T.make(_t(px), _t(py), 0, 5))
    assert np.array_equal(np.asarray(u), tu.numpy())
