"""The port's texture stack (rtxpt_tpu_torch/scene/textures.py) against the
reference's on the same seeded numpy inputs: the texel pool, its offsets
and mips bit for bit (uint8, uint16 and float images, sRGB on and off,
sizes that are not powers of two, the max_size cap); `sample_stack` at
random and wrapped UVs, at mip 0 and at ray-cone LODs, within 1e-6 (XLA
may contract the bilinear blend into FMAs); `ray_cone_lod` and
`perturb_normal`. The texel rows go through K2's plain version here."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rtxpt_tpu.scene import textures as JTX
from rtxpt_tpu_torch.ops import cuda_lib
from rtxpt_tpu_torch.scene import textures as TTX

ATOL = 1e-6


def _images(seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 256, (37, 50, 4)).astype(np.uint8),
            rs.randint(0, 65536, (16, 16, 3)).astype(np.uint16),
            rs.uniform(0, 4, (9, 5, 1)).astype(np.float32),
            rs.randint(0, 256, (1, 1)).astype(np.uint8),
            rs.randint(0, 256, (200, 90, 4)).astype(np.uint8)]


def _stacks(seed=0, srgb=None, max_size=64):
    imgs = _images(seed)
    return (JTX.build_texture_stack(imgs, srgb=srgb, max_size=max_size),
            TTX.build_texture_stack(imgs, srgb=srgb, max_size=max_size,
                                    device="cpu"))


@pytest.mark.parametrize("srgb", [None, [True, False, True, False, False]],
                         ids=["srgb-all", "srgb-mixed"])
def test_stack_bit_equal(srgb):
    js, ts = _stacks(1, srgb)
    for name in ("pool", "mip_offset", "mip_size", "n_mips"):
        ref = np.asarray(getattr(js, name))
        got = getattr(ts, name).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert np.array_equal(got.view(np.int32), ref.view(np.int32)), name
    # the caps: 200x90 -> 64 (max_size), 37x50 -> 64, 9x5 -> 16, 1x1 -> 1
    assert ts.mip_size[:, 0].tolist() == [64, 16, 16, 1, 64]
    assert ts.n_mips.tolist() == [7, 5, 5, 1, 7]
    assert TTX.build_texture_stack([], device="cpu") is None


@pytest.mark.parametrize("lod", [False, True], ids=["mip0", "cone-lod"])
def test_sample_stack_matches(lod):
    js, ts = _stacks(2)
    rs = np.random.RandomState(3)
    n = 4000
    tex = rs.randint(-1, 5, n).astype(np.int32)
    uv = rs.uniform(-3.0, 3.0, (n, 2)).astype(np.float32)
    uv[:8] = [[0, 0], [1, 1], [-1, 0.5], [0.999999, 0], [2, -2],
              [1e-7, -1e-7], [0.5, 0.5], [-0.25, 3.0]]
    lv = rs.uniform(-9.0, 1.0, n).astype(np.float32) if lod else None
    ref = np.asarray(JTX.sample_stack(
        js, jnp.asarray(tex), jnp.asarray(uv),
        None if lv is None else jnp.asarray(lv)))
    cuda_lib.reset_launch_counts()
    got = TTX.sample_stack(ts, torch.as_tensor(tex), torch.as_tensor(uv),
                           None if lv is None else torch.as_tensor(lv))
    assert not any(cuda_lib.launch_counts().values())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    assert (got[torch.as_tensor(tex) < 0] == 1.0).all()


def test_ray_cone_lod_and_perturb_normal():
    rs = np.random.RandomState(4)
    n = 512
    cw = rs.uniform(0, 0.1, n).astype(np.float32)
    cos = rs.uniform(-1, 1, n).astype(np.float32)
    cos[:4] = [0.0, 0.01, -0.04, 1.0]
    uva = rs.uniform(0, 1, n).astype(np.float32)
    wa = rs.uniform(0, 4, n).astype(np.float32)
    uva[:2] = wa[2:4] = 0.0
    ref = np.asarray(JTX.ray_cone_lod(*map(jnp.asarray, (cw, cos, uva, wa))))
    got = TTX.ray_cone_lod(*map(torch.as_tensor, (cw, cos, uva, wa)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)
    f = lambda: rs.normal(size=(n, 3)).astype(np.float32)
    nrm, t, b = f(), f(), f()
    smp = rs.uniform(0, 1, (n, 4)).astype(np.float32)
    smp[0, :3] = 0.5                      # a zero perturbation: n kept
    ref = np.asarray(JTX.perturb_normal(*map(jnp.asarray, (nrm, t, b, smp))))
    got = TTX.perturb_normal(*map(torch.as_tensor, (nrm, t, b, smp)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[0].numpy(), nrm[0])
