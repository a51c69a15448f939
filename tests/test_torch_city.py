"""The slice as a whole: the port's Renderer on the CPU against the
reference's Renderer on the procedural city, 16x12, the bench config
(6 bounces, 4 diffuse, NEE 1 distant + 1 local), 1 and 2 spp, in the two
BVH tiers: build_city(blocks=3) (28,910 triangles, one BVH8: K5) and
build_city(blocks=4) (55,196 triangles, two-level BVH8: the K5 sweep;
fewer than 8 subtrees, so no K6 probe).

As in tests/test_torch_integrator.py the reference runs its shade
megakernel in interpret mode; its traces take `_trace8`, its CPU path.
Tolerance rtol 2e-4 / atol 5e-5 on the HDR image, test_torch_integrator's:
the trees differ in rare split choices and XLA fuses multiply-adds, so
hit t/u/v differ by float32 rounding, and XLA and PyTorch round the
shading's sin/cos/sqrt a few ulps apart (measured: at most 1.3% of the
tolerance). Also once on the reference's own tables carried across with
`interop`."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.models.renderer import Renderer as JRenderer
from rtxpt_tpu.models.renderer import reference_config as j_reference_config
from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu.scene import lights as JLI
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
from rtxpt_tpu_torch.ops.bvh import BVH8
from rtxpt_tpu_torch.ops.bvh2l import BVH8TwoLevel
from rtxpt_tpu_torch.scene import envmap as TEM
from rtxpt_tpu_torch.scene import lights as TLI
from rtxpt_tpu_torch.scene import procedural as TP

W, H = 16, 12
BENCH = dict(max_bounces=6, max_diffuse_bounces=4, nee_distant_samples=1,
             nee_local_samples=1)


@pytest.fixture(scope="module", params=[3, 4], ids=["bvh8", "two_level"])
def renderers(request):
    blocks = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("RTXPT_SHADE_KERNEL", "1")
    mp.setenv("RTXPT_SHADE_KERNEL_INTERPRET", "1")
    jr = JRenderer(JP.build_city(blocks=blocks).finish(),
                   JP.city_camera(W, H, blocks), j_reference_config(**BENCH),
                   env_radiance=JEM.bake_procedural_sky(height=32))
    port = Renderer(TP.build_city(blocks=blocks).finish(),
                    TP.city_camera(W, H, blocks), reference_config(**BENCH),
                    env_radiance=TEM.bake_procedural_sky(height=32),
                    device="cpu")
    yield blocks, jr, port
    mp.undo()


def test_tiers_match_reference(renderers):
    blocks, jr, port = renderers
    assert jr.dense is None
    if blocks == 3:
        assert type(jr.bvh).__name__ == "BVH8"
        assert isinstance(port.accel, BVH8)
    else:
        assert type(jr.bvh).__name__ == "BVH8TwoLevel"
        assert isinstance(port.accel, BVH8TwoLevel)
        assert port.accel.num_subtrees == jr.bvh.num_subtrees < 8


@pytest.mark.parametrize("spp", [1, 2])
def test_city_render_matches_reference(renderers, spp):
    _, jr, port = renderers
    jr.reset_accumulation()
    port.reset_accumulation()
    ref = np.asarray(jr.render(W, H, spp))
    got = port.render(W, H, spp).numpy()
    assert got.shape == ref.shape == (H, W, 3)
    assert np.isfinite(got).all() and got.mean() > 0.0
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=5e-5)
    if spp == 1:
        own = port.assets
        port.assets = interop.assets_from_reference(
            jr.scene, jr.bvh, jr.env, jr.lights, device="cpu")
        port.reset_accumulation()
        shared = port.render(W, H, spp).numpy()
        port.assets = own
        np.testing.assert_allclose(shared, ref, rtol=2e-4, atol=5e-5)


def test_city_light_table_matches_reference():
    """The default city's 64,066 emissive lamp and sign triangles: the
    same packed rows and power CDF as the reference's table, and the same
    picks (the searchsorted path of tables over 1024 lights)."""
    host = TP.build_city().finish()
    jl = JLI.build_light_table(host)
    tl = TLI.build_light_table(host, device="cpu")
    assert tl.count == np.asarray(jl.pack).shape[0] == 64066
    np.testing.assert_allclose(tl.pack.numpy(), np.asarray(jl.pack),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tl.cdf.numpy(), np.asarray(jl.cdf),
                               rtol=1e-6, atol=0)
    u = np.random.RandomState(3).rand(5000).astype(np.float32)
    assert np.array_equal(TLI.pick_light(tl, torch.as_tensor(u)).numpy(),
                          np.asarray(JLI.pick_light(jl, jnp.asarray(u))))
