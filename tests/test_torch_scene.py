"""The port's host build (scene packs, dense trace tables, environment and
light tables, camera rays) equals the reference's build of the same scene:
packs exactly, float tables within float32 rtol 1e-6 (numpy and XLA round
a few transcendentals differently)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.ops import mt_dense as JMT
from rtxpt_tpu.scene import build as JB
from rtxpt_tpu.scene import camera as JC
from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu.scene import lights as JLI
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.ops import mt_dense as TMT
from rtxpt_tpu_torch.scene import build as TB
from rtxpt_tpu_torch.scene import camera as TC
from rtxpt_tpu_torch.scene import envmap as TEM
from rtxpt_tpu_torch.scene import lights as TLI
from rtxpt_tpu_torch.scene import procedural as TP

ANALYTIC = [
    dict(kind=JLI.LIGHT_POINT, position=(1.0, 3.0, 0.5),
         radiance=(5.0, 4.0, 3.0)),
    dict(kind=JLI.LIGHT_SPOT, position=(-1.0, 2.5, 1.0),
         radiance=(8.0, 8.0, 6.0), axis=(0.2, -1.0, 0.1),
         outer_angle=0.6, inner_angle=0.3),
    dict(kind=JLI.LIGHT_SPHERE, position=(0.5, 2.0, -1.0), radius=0.2,
         radiance=(3.0, 2.0, 1.0)),
]


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize("diffuse_only", [False, True])
def test_scene_packs_exact(diffuse_only):
    j_host = JP.build_programmer_art(diffuse_only=diffuse_only).finish()
    t_host = TP.build_programmer_art(diffuse_only=diffuse_only).finish()
    for key in ("positions", "normals", "tangents", "uvs", "indices",
                "tri_mat"):
        assert np.array_equal(j_host[key], t_host[key]), key
    js = JB.to_device(j_host)
    ts = TB.to_device(t_host, "cpu")
    via = interop.scene_from_arrays(
        positions=js.positions, indices=js.indices, vert_pack=js.vert_pack,
        tri_pack=js.tri_pack, tri_geom_pack=js.tri_geom_pack,
        mat_pack=js.mat_pack, material_ior=js.materials.ior,
        volume_absorption=js.materials.volume_absorption)
    for field in ("positions", "indices", "vert_pack", "tri_pack",
                  "tri_geom_pack", "mat_pack", "mat_ior",
                  "volume_absorption"):
        a, b = getattr(ts, field), getattr(via, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field


def test_dense_tables_exact():
    host = TP.build_programmer_art().finish()
    jd = JMT.build_dense(host["positions"], host["indices"])
    td = TMT.build_dense(host["positions"], host["indices"])
    via = interop.dense_from_arrays(aabb=jd.aabb, tri9=jd.tri9,
                                    center=jd.center,
                                    num_clusters=jd.num_clusters)
    assert td.num_clusters == via.num_clusters == 81
    for field in ("aabb", "tri9", "center"):
        assert torch.equal(getattr(td, field), getattr(via, field)), field


@pytest.mark.parametrize("height", [32, 64])
def test_sky_bake_matches(height):
    ref = np.asarray(JEM.bake_procedural_sky(height=height))
    got = TEM.bake_procedural_sky(height=height)
    assert got.shape == ref.shape == (height, 2 * height, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_env_tables_match():
    radiance = np.asarray(JEM.bake_procedural_sky(height=64))
    je = JEM.make_envmap(radiance)
    te = TEM.make_envmap(radiance)
    via = interop.env_from_arrays(
        radiance_quad=je.radiance_quad, alias_pack=je.alias_pack,
        height=je.height, width=je.width, intensity=je.intensity,
        enabled=je.enabled)
    assert (te.height, te.width) == (via.height, via.width) == (64, 128)
    np.testing.assert_allclose(_np(te.radiance_quad), _np(via.radiance_quad),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(_np(te.alias_pack), _np(via.alias_pack),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("analytic", [None, ANALYTIC])
def test_light_tables_match(analytic):
    host = TP.build_programmer_art().finish()
    jl = JLI.build_light_table(host, analytic)
    tl = TLI.build_light_table(host, analytic)
    via = interop.lights_from_arrays(pack=jl.pack, cdf=jl.cdf,
                                     total_power=jl.total_power)
    np.testing.assert_allclose(_np(tl.pack), _np(via.pack), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(_np(tl.cdf), _np(via.cdf), rtol=1e-6, atol=0)
    assert tl.total_power == pytest.approx(via.total_power, rel=1e-6)
    # power-CDF pick and row fetch on the same uniforms
    u = np.random.RandomState(3).rand(1000).astype(np.float32)
    j_idx = np.asarray(JLI.pick_light(jl, jnp.asarray(u)))
    t_idx = TLI.pick_light(tl, torch.as_tensor(u)).numpy()
    assert np.array_equal(j_idx, t_idx)
    np.testing.assert_allclose(TLI.fetch_rows(tl, torch.as_tensor(t_idx))
                               .numpy(), np.asarray(JLI.fetch_rows(
                                   jl, jnp.asarray(j_idx))), rtol=1e-6)


def test_camera_rays_match():
    w, h = 40, 30
    jc = JP.default_camera(w, h)._replace(
        jitter=jnp.asarray([0.25, -0.125], jnp.float32))
    tc = TP.default_camera(w, h)._replace(
        jitter=torch.tensor([0.25, -0.125]))
    for f in TC.CameraData._fields:
        np.testing.assert_allclose(_np(getattr(tc, f)),
                                   np.asarray(getattr(jc, f)), rtol=1e-6)
    yy, xx = np.mgrid[0:h, 0:w]
    px, py = xx.reshape(-1), yy.reshape(-1)
    u2 = np.random.RandomState(1).rand(px.size, 2).astype(np.float32)
    jo, jd = JC.compute_rays(jc, jnp.asarray(px.astype(np.uint32)),
                             jnp.asarray(py.astype(np.uint32)),
                             jnp.asarray(u2))
    to, td = TC.compute_rays(tc, torch.as_tensor(px), torch.as_tensor(py),
                             torch.as_tensor(u2))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)
