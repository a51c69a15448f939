"""ReLAX (rtxpt_tpu_torch/denoise/relax.py) and TAA (post/taa.py) against
the reference package on the CPU, over two frames.

Inputs come from a seed with numpy: noisy radiance, a normal field with a
crease, a depth field with a step (so the edge-stopping weights cut), and
sub-pixel motion (so the history fetches interpolate). Frame 1 starts
without history; frame 2 takes the reference's frame-1 state, converted by
`interop`, so each frame is held on identical inputs. The filters are
float32 stencils that both packages evaluate in the same order:
tolerance rtol 1e-5 / atol 1e-6.

On CPU tensors the port's wrappers take the plain version and launch
nothing. The tests marked `cuda` hold the kernels of csrc/relax.cu against
the plain version on the same CUDA tensors, bit for bit, and skip without a
GPU; on a machine with one (and without JAX), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_relax_taa.py -q -s

(`-s` prints each comparison's max |diff|)."""
import numpy as np
import pytest
import torch

from rtxpt_tpu_torch.denoise import relax as TRX
from rtxpt_tpu_torch.ops import cuda_lib
from rtxpt_tpu_torch.post import taa as TTAA

try:
    import jax.numpy as jnp
    from rtxpt_tpu.denoise import relax as JRX
    from rtxpt_tpu.post import taa as JTAA
    from rtxpt_tpu_torch import interop
except ImportError:     # a GPU machine without JAX runs the `cuda` tests
    jnp = JRX = JTAA = interop = None

H, W = 20, 28
RTOL, ATOL = 1e-5, 1e-6


def _frame(seed, h=H, w=W):
    """Noisy radiance, normals with a crease, depth with a step, sub-pixel
    motion and roughness, as float32 numpy arrays of an (h, w) frame."""
    H, W = h, w
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    rad = (rs.gamma(1.0, 1.0, (H, W, 3))
           * (1.0 + (xx > W / 2))[..., None]).astype(np.float32)
    nrm = np.stack([np.where(xx > W / 3, 0.6, 0.0), 0.1 * np.sin(yy),
                    np.ones_like(xx)], -1)
    nrm = (nrm + 0.02 * rs.normal(size=nrm.shape))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)) \
        .astype(np.float32)
    z = (4.0 + 0.05 * yy + np.where(yy > H / 2, 3.0, 0.0)).astype(np.float32)
    motion = rs.uniform(-1.5, 1.5, (H, W, 2)).astype(np.float32)
    rough = rs.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    return rad, nrm, z, motion, rough


def _close(got, ref, name=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL, err_msg=name)


@pytest.mark.parametrize("channel", ["diffuse", "specular"])
def test_relax_denoise_two_frames(channel):
    """Diffuse: 4 a-trous iterations, no roughness; specular: 3 with the
    roughness-aware weights (the realtime pipeline's two channels)."""
    j_state = t_state = None
    for frame in range(2):
        rad, nrm, z, motion, rough = _frame(frame)
        kw = dict(iterations=4) if channel == "diffuse" else dict(
            iterations=3)
        ref, j_state = JRX.denoise(
            j_state, jnp.asarray(rad), jnp.asarray(nrm), jnp.asarray(z),
            jnp.asarray(motion),
            roughness=None if channel == "diffuse" else jnp.asarray(rough),
            **kw)
        got, t_state = TRX.denoise(
            t_state, torch.as_tensor(rad), torch.as_tensor(nrm),
            torch.as_tensor(z), torch.as_tensor(motion),
            roughness=None if channel == "diffuse" else torch.as_tensor(
                rough), **kw)
        _close(got, ref, f"frame {frame}")
        for f in TRX.DenoiserState._fields:
            _close(getattr(t_state, f), getattr(j_state, f), f)
        # the next frame starts from the reference's state
        t_state = interop.denoiser_state_from_reference(j_state, "cpu")
    assert float(t_state.history.max()) >= 2.0


def test_taa_resolve_two_frames():
    """Frame 1 passes the colour through and starts the history; frame 2
    fetches it (Catmull-Rom), clips it to the 3x3 neighbourhood and
    blends, with and without the denoiser's relax mask."""
    j_state = t_state = None
    for frame in range(2):
        color, _, _, motion, rough = _frame(10 + frame)
        for mask in (None, rough):
            ref, j_new = JTAA.resolve(
                j_state, jnp.asarray(color), jnp.asarray(motion),
                relax_mask=None if mask is None else jnp.asarray(mask))
            got, t_new = TTAA.resolve(
                t_state, torch.as_tensor(color), torch.as_tensor(motion),
                relax_mask=None if mask is None else torch.as_tensor(mask))
            _close(got, ref, f"frame {frame}")
            _close(t_new.history, j_new.history, "history")
            assert t_new.valid == bool(j_new.valid)
        if frame == 1:
            assert not np.allclose(got.numpy(), color)
        j_state = j_new
        t_state = interop.taa_state_from_reference(j_state, "cpu")


# ---- the wrappers on CPU tensors -----------------------------------------

COUNTERS = ("relax_temporal", "relax_variance", "relax_atrous", "taa_resolve")


def _t(arrays, dev="cpu"):
    return [torch.as_tensor(a, device=dev) for a in arrays]


def _counts():
    c = cuda_lib.launch_counts()
    return [c[k] for k in COUNTERS]


@pytest.mark.parametrize("channel", ["diffuse", "specular"])
def test_cpu_tensors_take_the_plain_version(channel):
    """On CPU tensors every pass equals its `*_plain` function bit for bit
    over two frames, and no launch is counted."""
    cuda_lib.reset_launch_counts()
    state = None
    for frame in range(2):
        rad, nrm, z, motion, rough = _t(_frame(frame))
        rough = None if channel == "diffuse" else rough
        state = state or TRX.DenoiserState.create(H, W, "cpu")
        new = TRX.temporal_accumulate(state, rad, nrm, z, motion)
        ref = TRX.temporal_accumulate_plain(state, rad, nrm, z, motion)
        assert all(torch.equal(a, b) for a, b in zip(new, ref))
        var = TRX.estimate_variance(new)
        assert torch.equal(var, TRX.estimate_variance_plain(new))
        assert torch.equal(
            TRX.atrous_filter(new.radiance, var, nrm, z, rough, 3),
            TRX.atrous_filter_plain(new.radiance, var, nrm, z, rough, 3))
        state = new
    assert _counts() == [0, 0, 0, 0]


def test_cpu_taa_takes_the_plain_version():
    cuda_lib.reset_launch_counts()
    color, _, _, motion, mask = _t(_frame(3))
    state = TTAA.TAAState(history=_t(_frame(4))[0], valid=True)
    for m in (None, mask):
        out, new = TTAA.resolve(state, color, motion, relax_mask=m)
        ref, _ = TTAA.resolve_plain(state, color, motion, relax_mask=m)
        assert torch.equal(out, ref) and new.history is out
    assert _counts() == [0, 0, 0, 0]


# ---- the kernels on the card ---------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _same(got, ref, name):
    """Bit-equal, with the max |diff| printed (-s)."""
    diff = (got - ref).abs().max().item() if got.numel() else 0.0
    print(f"{name}: max |diff| {diff:.3g}")
    assert got.shape == ref.shape and got.dtype == ref.dtype, name
    assert torch.equal(got, ref), (name, diff)


def _inputs(dev, seed, h, w):
    """A frame's inputs on the card; the guides as strided views, as the
    stable-planes pipeline passes them (a plane of a (pixels, planes, c)
    tensor)."""
    rad, nrm, z, motion, rough = _frame(seed, h, w)
    plane = lambda a: torch.as_tensor(
        np.stack([a - 7, a, a + 7], 2), device=dev)[:, :, 1]
    return (torch.as_tensor(rad, device=dev), plane(nrm), plane(z),
            plane(motion), plane(rough))


SHAPES = [(1080, 1920), (37, 61)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("channel", ["diffuse", "specular"])
def test_relax_kernels_match_plain(dev, shape, channel):
    """Each pass against its plain version on the same CUDA inputs, on a
    first frame (no history), a second (the plain first frame's history)
    and a third whose history holds ages on both sides of the variance
    pass's 4-frame switch and at and past the 32-frame cap: temporal,
    variance, the a-trous iterations (diffuse 4, specular 3 with
    roughness), and `denoise` whole; one launch per pass and per
    iteration."""
    h, w = shape
    iters = 4 if channel == "diffuse" else 3
    state = TRX.DenoiserState.create(h, w, dev)
    ages = torch.tensor([0.0, 1.0, 2.0, 3.0, 3.5, 4.0, 5.0, 9.0, 31.0, 31.5,
                         32.0, 40.0], device=dev)
    for frame in range(3):
        if frame == 2:
            state = state._replace(history=ages[
                torch.arange(h * w, device=dev) % len(ages)].reshape(h, w))
        rad, nrm, z, motion, rough = _inputs(dev, frame, h, w)
        rough = None if channel == "diffuse" else rough
        assert not nrm.is_contiguous()
        c0 = _counts()
        new = TRX.temporal_accumulate(state, rad, nrm, z, motion)
        ref = TRX.temporal_accumulate_plain(state, rad, nrm, z, motion)
        for f in TRX.DenoiserState._fields:
            _same(getattr(new, f), getattr(ref, f), f"{shape} {channel} "
                  f"frame {frame} temporal {f}")
        var = TRX.estimate_variance(ref)
        _same(var, TRX.estimate_variance_plain(ref), "variance")
        out = TRX.atrous_filter(ref.radiance, var, nrm, z, rough, iters)
        _same(out, TRX.atrous_filter_plain(ref.radiance, var, nrm, z, rough,
                                           iters), "atrous")
        got, got_state = TRX.denoise(state, rad, nrm, z, motion, rough,
                                     iters)
        _same(got, out, "denoise")
        assert _counts() == [c0[0] + 2, c0[1] + 2, c0[2] + 2 * iters, c0[3]]
        state = ref
    # the third frame took both variance branches and the cap
    young = state.history < 4.0
    assert bool(young.any()) and not bool(young.all())
    assert float(state.history.max()) == 32.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_taa_kernel_matches_plain(dev, shape):
    """With a valid history, with and without the relax mask, one launch
    a call; an absent or invalid history passes the colour through and
    launches nothing."""
    h, w = shape
    color, _, _, motion, mask = _inputs(dev, 10, h, w)
    hist = _inputs(dev, 11, h, w)[0]
    for state in (None, TTAA.TAAState(history=hist, valid=False)):
        c0 = _counts()
        out, new = TTAA.resolve(state, color, motion)
        assert out is color and new.history is color and new.valid
        assert _counts() == c0
    state = TTAA.TAAState(history=hist, valid=True)
    for m in (None, mask):
        c0 = _counts()
        out, new = TTAA.resolve(state, color, motion, relax_mask=m)
        ref, _ = TTAA.resolve_plain(state, color, motion, relax_mask=m)
        _same(out, ref, f"{shape} taa mask={m is not None}")
        assert new.history is out and new.valid
        assert _counts() == [*c0[:3], c0[3] + 1]


@pytest.mark.cuda
def test_sharded_slab_matches_plain(dev):
    """The slab a rank of the sharded pipeline (parallel/meshutils.py
    denoise_taa_sharded) denoises: 1080p on 4 ranks, 270 rows and 34 halo
    rows each side; both channels, then TAA."""
    h, w = 270 + 2 * 34, 1920
    rad, nrm, z, motion, rough = _inputs(dev, 20, h, w)
    state = TRX.DenoiserState.create(h, w, dev)
    ref_state = state
    for r, it in ((None, 4), (rough, 3)):
        c0 = _counts()
        got, _ = TRX.denoise(state, rad, nrm, z, motion, r, it)
        ref_state = TRX.temporal_accumulate_plain(state, rad, nrm, z, motion)
        ref = TRX.atrous_filter_plain(
            ref_state.radiance, TRX.estimate_variance_plain(ref_state), nrm,
            z, r, it)
        _same(got, ref, f"slab {h}x{w} iterations {it}")
        assert _counts() == [c0[0] + 1, c0[1] + 1, c0[2] + it, c0[3]]
    taa = TTAA.TAAState(history=rad, valid=True)
    out, _ = TTAA.resolve(taa, got, motion)
    _same(out, TTAA.resolve_plain(taa, got, motion)[0], "slab taa")


@pytest.mark.cuda
def test_kernels_raise_on_mixed_devices(dev):
    rad, nrm, z, motion, _ = _inputs(dev, 30, 16, 24)
    state = TRX.DenoiserState.create(16, 24, dev)
    with pytest.raises(ValueError):
        TRX.temporal_accumulate(state, rad, nrm.cpu(), z, motion)
    with pytest.raises(ValueError):
        TRX.atrous_filter(rad, z.cpu(), nrm, z)
    with pytest.raises(ValueError):
        TTAA.resolve(TTAA.TAAState(history=rad, valid=True), rad,
                     motion.cpu())
