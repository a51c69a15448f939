"""The Renderer's live edits (rtxpt_tpu_torch/models/renderer.py
`set_material`, `material_info`, `update_environment`) against the
reference package on the CPU.

The same edits on programmer-art (base colour, roughness, metalness, and
an emissive edit of the emissive panel) leave the port's `mat_pack` equal
to the reference's bit for bit, and the light table rebuilt by the
emissive edit equal to the reference's (through `interop` on the
reference's LightTable, at test_torch_scene.py's rtol 1e-6), with and
without the scene's analytic lights, which the edit keeps.
`material_info()` equals the reference's. `update_environment` leaves the
environment equal to a fresh `make_envmap` of the same radiance, and the
port's renders pass the reference's animated-sun check
(tests/test_dynamic_env.py: the mean falls below 0.8x). An emissive edit
on a posed glTF figure (tools_torch/animated_scenes.py) keeps the posed
light rows."""
import copy

import numpy as np
import pytest
import torch

from rtxpt_tpu.models.renderer import Renderer as JRenderer
from rtxpt_tpu.models.renderer import reference_config as j_reference_config
from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu.scene import lights as JLI
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
from rtxpt_tpu_torch.scene import envmap as TEM
from rtxpt_tpu_torch.scene import lights as TLI
from rtxpt_tpu_torch.scene import procedural as TP

W, H = 24, 16
ANALYTIC = [dict(kind=JLI.LIGHT_POINT, position=(1.0, 3.0, 0.5),
                 radiance=(5.0, 4.0, 3.0)),
            dict(kind=JLI.LIGHT_SPHERE, position=(0.5, 2.0, -1.0),
                 radius=0.2, radiance=(3.0, 2.0, 1.0))]


def _emissive_material(host) -> int:
    em = np.asarray(host["materials"]["emissive"])
    return int(np.argmax(em.max(-1)))


def _edits(host):
    """The edit sequence: (index, keywords) pairs."""
    panel = _emissive_material(host)
    return [(0, dict(base_color=[1.0, 0.0, 0.0], roughness=0.9)),
            (2, dict(metalness=0.7)),
            (1, dict(base_color=(0.1, 0.2, 0.3), roughness=0.05,
                     metalness=0.25)),
            (panel, dict(emissive=[3.5, 2.0, 0.75]))]


def _pair(analytic=None):
    host = TP.build_programmer_art().finish()
    env = TEM.bake_procedural_sky(height=32)
    jr = JRenderer(copy.deepcopy(host), JP.default_camera(W, H),
                   j_reference_config(max_bounces=2), env_radiance=env,
                   analytic_lights=analytic)
    r = Renderer(copy.deepcopy(host), TP.default_camera(W, H),
                 reference_config(max_bounces=2), env_radiance=env,
                 analytic_lights=analytic, device="cpu")
    return jr, r, host


def _same_lights(got, ref):
    via = interop.lights_from_arrays(pack=ref.pack, cdf=ref.cdf,
                                     total_power=ref.total_power,
                                     device="cpu")
    assert got.pack.shape == via.pack.shape
    np.testing.assert_allclose(got.pack.numpy(), via.pack.numpy(),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.cdf.numpy(), via.cdf.numpy(), rtol=1e-6,
                               atol=0)
    assert got.total_power == pytest.approx(via.total_power, rel=1e-6)


@pytest.mark.parametrize("analytic", [None, ANALYTIC],
                         ids=["emissive", "analytic"])
def test_set_material_matches_reference(analytic):
    jr, r, host = _pair(analytic)
    np.testing.assert_array_equal(r.scene.mat_pack.numpy(),
                                  np.asarray(jr.scene.mat_pack))
    lights_before = r.lights.pack.clone()
    mp_before = r.scene.mat_pack
    for index, kw in _edits(host):
        jr.set_material(index, **kw)
        r.set_material(index, **kw)
        np.testing.assert_array_equal(r.scene.mat_pack.numpy(),
                                      np.asarray(jr.scene.mat_pack))
    # edited in place: the surface fetch reads the same contiguous table
    assert r.scene.mat_pack is mp_before and mp_before.is_contiguous()
    assert r.assets.scene.mat_pack is mp_before
    assert r.assets.lights is r.lights
    _same_lights(r.lights, jr.lights)
    assert not torch.equal(r.lights.pack[:, TLI.LP_POWER],
                           lights_before[:, TLI.LP_POWER])
    kinds = r.lights.pack[:, TLI.LP_KIND].numpy()
    n_analytic = int((kinds != TLI.LIGHT_TRIANGLE).sum())
    assert n_analytic == (0 if analytic is None else len(analytic))
    assert r.material_info() == jr.material_info()


def test_material_info_matches_reference():
    jr, r, _ = _pair()
    info = r.material_info()
    assert info == jr.material_info()
    assert [m["index"] for m in info] == list(range(len(info)))
    assert {"index", "name", "base_color", "roughness", "metalness",
            "emissive"} == set(info[0])


def test_set_material_on_realtime_renderer():
    """RealtimeRenderer inherits the edits; its histories stay."""
    host = TP.build_programmer_art().finish()
    r = RealtimeRenderer(host, TP.default_camera(16, 12),
                         env_radiance=TEM.bake_procedural_sky(height=32),
                         device="cpu")
    r.render_frame(16, 12)
    prev = r.prev_reservoir
    r.set_material(0, base_color=(0.0, 1.0, 0.0))
    assert r.prev_reservoir is prev
    assert r.material_info()[0]["base_color"] == [0.0, 1.0, 0.0]
    img = r.render_frame(16, 12)
    assert torch.isfinite(img).all()


def test_update_environment_swaps_the_envmap():
    _, r, _ = _pair()
    sky = TEM.bake_procedural_sky(height=32, sun_dir=(-0.5, 0.2, -0.8),
                                  sky_scale=0.2)
    r.update_environment(sky, intensity=1.5)
    fresh = TEM.make_envmap(sky, intensity=1.5, device="cpu")
    assert r.assets.env is r.env
    for name in ("radiance_quad", "alias_pack"):
        assert torch.equal(getattr(r.env, name), getattr(fresh, name)), name
    for name in ("height", "width", "intensity", "enabled"):
        assert getattr(r.env, name) == getattr(fresh, name), name


def test_animated_sun_updates_running_renderer():
    """tests/test_dynamic_env.py's check on the port's renders."""
    host = TP.build_programmer_art(with_emissive=False).finish()
    cfg = reference_config(max_bounces=2, max_diffuse_bounces=1,
                           nee_local_samples=0)
    r = Renderer(host, TP.default_camera(W, H), cfg,
                 env_radiance=TEM.bake_procedural_sky(
                     height=32, sun_dir=(0.35, 0.65, 0.2)), device="cpu")
    img0 = r.render(W, H, 2).numpy().copy()
    r.update_environment(TEM.bake_procedural_sky(
        height=32, sun_dir=(-0.5, 0.2, -0.8), sky_scale=0.2))
    r.reset_accumulation()
    img1 = r.render(W, H, 2).numpy()
    assert np.isfinite(img1).all()
    assert img1.mean() < img0.mean() * 0.8, (img0.mean(), img1.mean())
    # the reference's renderer takes the same step on the same skies
    jr = JRenderer(host, JP.default_camera(W, H),
                   j_reference_config(max_bounces=2, max_diffuse_bounces=1,
                                      nee_local_samples=0),
                   env_radiance=JEM.bake_procedural_sky(
                       height=32, sun_dir=(0.35, 0.65, 0.2)))
    jr.update_environment(JEM.bake_procedural_sky(
        height=32, sun_dir=(-0.5, 0.2, -0.8), sky_scale=0.2))
    np.testing.assert_allclose(r.env.radiance_quad.numpy(),
                               np.asarray(jr.env.radiance_quad), rtol=1e-6)


def test_emissive_edit_keeps_the_pose(tmp_path):
    """An emissive edit after `animate` rebuilds the light rows on the
    posed triangles, not the rest pose."""
    from rtxpt_tpu_torch.scene import gltf as TG
    from tools_torch import animated_scenes as AS
    path = AS.skinned_figure(str(tmp_path / "f.gltf"), rings=16, sides=8,
                             joints=8)
    host, info = TG.load_gltf(path)
    r = Renderer(host, TG.camera_from_info(info, W, H),
                 reference_config(max_bounces=2), device="cpu")
    rest = r.lights.pack.clone()
    r.animate(info, 0.5)
    posed = r.lights.pack.clone()
    geom = slice(TLI.LP_P0, TLI.LP_E2 + 3)
    assert not torch.equal(posed[:, geom], rest[:, geom])
    tip = _emissive_material(host)
    r.set_material(tip, emissive=[2.0, 1.0, 0.5])
    assert torch.equal(r.lights.pack[:, geom], posed[:, geom])
    assert not torch.equal(r.lights.pack[:, TLI.LP_RAD:TLI.LP_RAD + 3],
                           posed[:, TLI.LP_RAD:TLI.LP_RAD + 3])
