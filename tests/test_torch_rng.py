"""The port's stateless RNG (rtxpt_tpu_torch/core/rng.py) is bit-exact with
the reference (rtxpt_tpu/core/rng.py) on the same seeded inputs, and its
kernels (csrc/rng.cu) with its plain version.

The tests marked `cuda` hold the kernels against the plain version on the
card and skip without a GPU; on a machine with one (and without JAX), run
them with

    python -m pytest --noconftest -m cuda tests/test_torch_rng.py -q
"""
import numpy as np
import pytest
import torch

from rtxpt_tpu_torch.core import rng as T
from rtxpt_tpu_torch.ops import cuda_lib

try:
    import jax.numpy as jnp
    from rtxpt_tpu.core import rng as R
except ImportError:     # a GPU machine without JAX runs the `cuda` tests
    jnp = R = None

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


def _sobol_xor(index, dim):
    """The kernel's Sobol' point: the XOR of the direction numbers of the
    index's set bits (csrc/rng.cu `sobol`), in numpy."""
    dirs = T._SOBOL_DIRECTIONS.astype(np.uint32)[dim]           # (n, 32)
    bits = (index[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    return np.bitwise_xor.reduce(np.where(bits == 1, dirs, 0), axis=1)


@pytest.mark.parametrize("dim", range(T._SUPPORTED_LD_DIMENSIONS))
def test_sobol_xor_form_equals_matmul_form(dim):
    """The kernel's formulation of the Sobol' point equals `rng.sobol`'s
    GF(2) matmul on 100,000 random indices in every dimension."""
    index = _u32(100 + dim, 100_000)
    dims = np.full(index.shape, dim, np.uint32)
    assert _same(_sobol_xor(index, dims), T.sobol(_t(index), _t(dims)))


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the generator is the plain version, with no launch."""
    px, py = _t(_u32(20)), _t(_u32(21))
    cuda_lib.reset_launch_counts()
    g = T.start_effect(T.make(px, py, 3, 11), T.EFFECT_NEE,
                       torch.as_tensor(_u32(22) % 2 == 0), 2, 5)
    gp = T.start_effect_plain(T.make_plain(px, py, 3, 11), T.EFFECT_NEE,
                              torch.as_tensor(_u32(22) % 2 == 0), 2, 5)
    for draw in ("next_uint", "next_1d", "next_2d", "next_3d"):
        g, u = getattr(T, draw)(g)
        gp, up = getattr(T, draw + "_plain")(gp)
        assert torch.equal(u, up), draw
    assert all(torch.equal(a, b) for a, b in zip(g, gp))
    counts = cuda_lib.launch_counts()
    assert [counts[k] for k in ("rng_make", "rng_start_effect",
                                "rng_next")] == [0, 0, 0]


# ---- the kernels on the card ---------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _equal_state(g, gp):
    """Every field of the kernels' state equals the plain version's (either
    side's fields may be broadcast views)."""
    for name in T.SampleGenerator._fields:
        a, b = getattr(g, name), getattr(gp, name)
        assert a.dtype == torch.int64 and a.shape == g.base.shape, name
        assert torch.equal(a, b.expand(a.shape)), name


def _seeds(dev, shape, seed=7):
    r = np.random.RandomState(seed)
    n = int(np.prod(shape))

    def t(x, dtype=torch.int64):
        return torch.as_tensor(np.asarray(x).astype(np.int64).reshape(shape),
                               device=dev).to(dtype)
    return dict(px=t(r.randint(0, 1920, n)),
                py=t(r.randint(0, 1080, n), torch.int32),
                vi=t(r.randint(0, 30, n), torch.int32),
                si=t(_u32(seed + 1, n)),
                flag=t(r.rand(n) < 0.5, torch.bool))


def _ld(flag, ld):
    return flag if ld == "mixed" else ld


# (draw, allow_ld): through the 5 LD dimensions and past their exhaustion
DRAWS = (("next_1d", True), ("next_3d", True), ("next_uint", True),
         ("next_2d", True), ("next_3d", True), ("next_2d", False),
         ("next_uint", False), ("next_1d", False), ("next_3d", False))

SHAPES = [(4099,), (61, 67)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("hq", [False, True])
@pytest.mark.parametrize("ld", [False, True, "mixed"])
@pytest.mark.parametrize("scalar", [False, True])
def test_make_kernel_matches_plain(dev, shape, hq, ld, scalar):
    """make (fused with start_effect(EFFECT_BASE)): per-lane or scalar
    vertex and sample indices, hq on and off, LD off, on and per lane."""
    s = _seeds(dev, shape)
    vi, si = (1, 0xFFFFFFFF) if scalar else (s["vi"], s["si"])
    args = (s["px"], s["py"], vi, si, _ld(s["flag"], ld), hq)
    _equal_state(T.make(*args), T.make_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ld", [False, True, "mixed"])
def test_start_effect_kernel_matches_plain(dev, shape, ld):
    s = _seeds(dev, shape)
    g = T.make_plain(s["px"], s["py"], s["vi"], 5)
    for effect, sub in ((T.EFFECT_SCATTER_BSDF, (0, 1)),
                        (T.EFFECT_NEE, (3, 7))):
        _equal_state(T.start_effect(g, effect, _ld(s["flag"], ld), *sub),
                     T.start_effect_plain(g, effect, _ld(s["flag"], ld),
                                          *sub))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("hq", [False, True])
@pytest.mark.parametrize("ld", [False, True, "mixed"])
def test_next_kernels_match_plain(dev, shape, hq, ld):
    """Every draw bit-equal to the plain version, with allow_ld true and
    false, through the LD dimensions and past their exhaustion."""
    s = _seeds(dev, shape)
    g = T.make(s["px"], s["py"], s["vi"], s["si"], hq=hq)
    g = T.start_effect(g, T.EFFECT_SCATTER_BSDF, _ld(s["flag"], ld))
    gp = g
    for draw, allow_ld in DRAWS:
        g, u = getattr(T, draw)(g, allow_ld)
        gp, up = getattr(T, draw + "_plain")(gp, allow_ld)
        assert u.dtype == up.dtype and u.shape == up.shape, draw
        assert torch.equal(u, up), (draw, allow_ld)
        _equal_state(g, gp)


@pytest.mark.cuda
def test_kernels_on_broadcast_state(dev):
    """A state whose fields are broadcast views (the plain make's, with a
    scalar sample index) gives the kernels the plain version's draws."""
    s = _seeds(dev, (1000,))
    gp = T.make_plain(s["px"], s["py"], 0, 9)
    assert gp.sample_index.stride() == (0,)
    g, u = T.next_2d(T.start_effect(gp, T.EFFECT_NEE, True))
    gp, up = T.next_2d_plain(T.start_effect_plain(gp, T.EFFECT_NEE, True))
    assert torch.equal(u, up)
    _equal_state(g, gp)


@pytest.mark.cuda
def test_kernels_raise_on_mixed_devices(dev):
    s = _seeds(dev, (64,))
    with pytest.raises(ValueError):
        T.make(s["px"], s["py"].cpu(), 0, 1)
    g = T.make(s["px"], s["py"], 0, 1)
    with pytest.raises(ValueError):
        T.start_effect(g, T.EFFECT_NEE, s["flag"].cpu())
    with pytest.raises(ValueError):
        T.next_1d(g._replace(hq=g.hq.cpu()))


@pytest.mark.cuda
def test_one_launch_per_generator_call(dev):
    s = _seeds(dev, (4099,))
    cuda_lib.reset_launch_counts()
    g = T.make(s["px"], s["py"], s["vi"], 3, True)
    g = T.start_effect(g, T.EFFECT_NEE, s["flag"])
    for draw in ("next_uint", "next_1d", "next_2d", "next_3d"):
        g, _ = getattr(T, draw)(g)
    g, _ = T.next_3d(g, allow_ld=False)
    counts = cuda_lib.launch_counts()
    assert [counts[k] for k in ("rng_make", "rng_start_effect",
                                "rng_next")] == [1, 1, 5]
