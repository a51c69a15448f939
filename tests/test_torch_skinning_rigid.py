"""Skinned and rigid animation end to end in the port (scene/animation.py
`refresh_skinned`, models/renderer.py `Renderer.animate`): the oracles of
the reference's tests/test_skinning.py (a two-bone arm: the rest pose is
the identity, a bent elbow moves the tip and the trace structure follows)
and tests/test_rigid.py (a node translation re-flattens one instance's
range; a rotation turns its normals and tangents; on the instanced TLAS
only the instance rows change), on the port's tiers; then one posed
render against the reference's `Renderer.animate` render: the skinned
figure of tools_torch/animated_scenes.py at 176 segments x 24 sides
(8,450 triangles, the single-BVH8 tier, refitted after skinning) posed
at 0.5 s, 16x12, the bench config, 2 spp; HDR rtol 2e-4 / atol 5e-5, as
tests/test_torch_city.py (the reference runs its shade megakernel in
interpret mode and `_trace8` on its own refitted BVH8)."""
import types

import numpy as np
import pytest
import torch

from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
from rtxpt_tpu_torch.ops import bvh as TBVH
from rtxpt_tpu_torch.ops import instanced as TI
from rtxpt_tpu_torch.ops import mt_dense as TMT
from rtxpt_tpu_torch.scene import animation as TA
from rtxpt_tpu_torch.scene.build import Mesh, SceneBuilder, to_device
from rtxpt_tpu_torch.scene.camera import make_camera
from tools_torch import animated_scenes as AS


def _skinned_host():
    """tests/test_skinning.py's arm: a quad strip from y = 0 to 2, lower
    vertices bound to joint 0 (node 1), upper to joint 1 (node 2)."""
    sb = SceneBuilder()
    sb.add_material(base_color=(0.8, 0.2, 0.2), roughness=1.0)
    pos = np.asarray([[x, y, 0.0] for y in np.linspace(0.0, 2.0, 5)
                      for x in (-0.2, 0.2)], np.float32)
    idx = np.asarray([t for r in range(4) for t in
                      ([2 * r, 2 * r + 1, 2 * r + 2],
                       [2 * r + 1, 2 * r + 3, 2 * r + 2])], np.int32)
    w_up = np.clip(pos[:, 1] / 2.0, 0.0, 1.0)
    weights = np.stack([1.0 - w_up, w_up, np.zeros_like(w_up),
                        np.zeros_like(w_up)], -1).astype(np.float32)
    joints = np.tile(np.asarray([[0, 1, 0, 0]], np.int32), (len(pos), 1))
    sb.add_instance(sb.add_mesh(Mesh(positions=pos, indices=idx,
                                     joints=joints, weights=weights)),
                    None, skin=0)
    host = sb.finish()
    assert len(host["skin_bindings"]) == 1 and not host["rigid_bindings"]
    nodes = [{"mesh": 0, "skin": 0},
             {"translation": [0, 0, 0], "children": [2]},
             {"translation": [0, 1, 0]}]
    gf = types.SimpleNamespace(json={"nodes": nodes, "scene": 0,
                                     "scenes": [{"nodes": [0, 1]}],
                                     "animations": []})
    inv_bind = np.stack([np.eye(3, 4, dtype=np.float32),
                         np.asarray([[1, 0, 0, 0], [0, 1, 0, -1],
                                     [0, 0, 1, 0]], np.float32)])
    return host, dict(gltf=gf, skins=[dict(joints=[1, 2],
                                           inverse_bind=inv_bind)])


def _arm_renderer(host):
    return Renderer(host, make_camera(32, 24, pos=(0, 1, 4),
                                      look_dir=(0, 0, -1)),
                    reference_config(max_bounces=2), device="cpu")


def test_rest_pose_identity():
    host, info = _skinned_host()
    r = _arm_renderer(host)
    before = r.scene.positions.clone()
    r.animate(info, 0.0)
    np.testing.assert_allclose(r.scene.positions.numpy(), before.numpy(),
                               atol=1e-5)
    assert r.assets.scene is r.scene and r.assets.accel is r.accel


def test_bent_elbow_moves_vertices_and_refits():
    host, info = _skinned_host()
    r = _arm_renderer(host)
    assert isinstance(r.accel, TMT.DenseMT)
    s, c = np.sin(np.pi / 4), np.cos(np.pi / 4)
    info["gltf"].json["nodes"][2]["rotation"] = [0.0, 0.0, float(s),
                                                float(c)]
    r.animate(info, 0.0)
    tip = r.scene.positions.numpy()[-2:]
    assert abs(tip[:, 1].max() - 1.2) < 0.05, tip
    assert tip[:, 0].min() < -0.7, tip
    # the surface fetch's tables follow: vert_pack positions and the face
    # normals of tri_geom_pack
    assert torch.equal(r.scene.vert_pack[:, 0:3], r.scene.positions)
    assert np.isfinite(r.render(32, 24, 2).numpy()).all()
    # the dense planes hold the moved vertices
    assert float(r.accel.aabb[:, 4].max()) < 1.6
    # and so does a BVH8 refitted by the same refresh
    scene = to_device(host, "cpu")
    b8 = TBVH.collapse_bvh8(TBVH.build_bvh(host["positions"],
                                           host["indices"]),
                            host["positions"], host["indices"],
                            device="cpu")
    assert float(b8.table[0, :48].reshape(8, 6)[:, 4].max()) > 1.9
    _, b8 = TA.refresh_skinned(host, info, scene, b8, 0.0)
    assert float(b8.table[0, :48].reshape(8, 6)[:, 4].max()) < 1.6


class _GF:
    """Minimal GltfFile stand-in: json + accessor(i)."""

    def __init__(self, json, accessors):
        self.json, self._acc = json, accessors

    def accessor(self, i):
        return self._acc[i]


def _rigid_host(path="translation"):
    """tests/test_rigid.py's two instances of one quad: node 1 animated,
    node 2 static."""
    sb = SceneBuilder()
    sb.add_material(base_color=(0.8, 0.2, 0.2), roughness=1.0)
    pos = np.asarray([[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.5, 0.5, 0],
                      [-0.5, 0.5, 0]], np.float32)
    mesh = sb.add_mesh(Mesh(positions=pos, indices=np.asarray(
        [[0, 1, 2], [0, 2, 3]], np.int32)))
    sb.add_instance(mesh, np.eye(3, 4, dtype=np.float32), node=1)
    x2 = np.eye(3, 4, dtype=np.float32)
    x2[:, 3] = [0.0, 0.0, -3.0]
    sb.add_instance(mesh, x2, node=2)
    host = sb.finish()
    assert len(host["rigid_bindings"]) == 2
    if path == "translation":
        out = np.asarray([[0, 0, 0], [2, 0, 0]], np.float32)
    else:                                  # 90 degrees about +y
        s, c = np.sin(np.pi / 4), np.cos(np.pi / 4)
        out = np.asarray([[0, s, 0, c]] * 2, np.float32)
    gjson = {"nodes": [{"children": [1, 2]}, {"translation": [0, 0, 0]},
                       {"translation": [0, 0, -3]}],
             "scenes": [{"nodes": [0]}], "scene": 0,
             "animations": [{"channels": [{"sampler": 0, "target": {
                 "node": 1, "path": path}}],
                 "samplers": [{"input": 0, "output": 1,
                               "interpolation": "LINEAR"}]}]}
    return host, dict(gltf=_GF(gjson, [np.asarray([0.0, 1.0], np.float32),
                                       out]), skins=[])


def test_rigid_refresh_moves_range_end_to_end():
    host, info = _rigid_host()
    r = Renderer(host, make_camera(32, 24, pos=(0, 0, 4),
                                   look_dir=(0, 0, -1)),
                 reference_config(max_bounces=2), device="cpu")
    before = r.scene.positions.numpy().copy()
    r.animate(info, 0.0)                    # t = 0: nothing moves
    np.testing.assert_allclose(r.scene.positions.numpy(), before, atol=1e-6)
    r.animate(info, 1.0)                    # t = 1: instance 0 moves +2 x
    p = r.scene.positions.numpy()
    np.testing.assert_allclose(p[0:4, 0], before[0:4, 0] + 2.0, atol=1e-6)
    np.testing.assert_allclose(p[4:8], before[4:8], atol=1e-6)
    np.testing.assert_allclose(r.scene.vert_pack[0:4, 0].numpy(), p[0:4, 0],
                               atol=1e-6)
    assert np.isfinite(r.render(32, 24, 1).numpy()).all()
    np.testing.assert_allclose(host["instancing"]["transforms"][0][:, 3],
                               [2, 0, 0], atol=1e-6)
    # the dense planes hold the moved quad: a ray at x = +2 meets it
    hit = TMT.trace_closest(r.accel, torch.tensor([[2.0, 0.0, 5.0]]),
                            torch.tensor([[0.0, 0.0, -1.0]]))
    assert float(hit.t[0]) == pytest.approx(5.0, abs=1e-4)


def test_rigid_rotation_transforms_normals_and_tangents():
    host, info = _rigid_host(path="rotation")
    scene = to_device(host, "cpu")
    b8 = TBVH.collapse_bvh8(TBVH.build_bvh(host["positions"],
                                           host["indices"]),
                            host["positions"], host["indices"],
                            device="cpu")
    s1, _ = TA.refresh_skinned(host, info, scene, b8, 1.0)
    n = s1.vert_pack[0:4, 3:6].numpy()
    # the quad's normal (0, 0, 1) turned 90 degrees about y: (1, 0, 0)
    np.testing.assert_allclose(np.abs(n[:, 0]), 1.0, atol=1e-5)
    np.testing.assert_allclose(n[:, 2], 0.0, atol=1e-5)
    t = s1.vert_pack[0:4, 6:9].numpy()
    np.testing.assert_allclose(np.linalg.norm(t, axis=-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(np.abs((t * n).sum(-1)), 0.0, atol=1e-4)
    # the face normals follow too
    np.testing.assert_allclose(np.abs(s1.tri_geom_pack[0:2, 0].numpy()), 1.0,
                               atol=1e-5)


def test_rigid_refresh_instanced_tlas_rows():
    host, info = _rigid_host()
    tl = TI.build_instanced(host["instancing"], "cpu")
    s1, tl1 = TA.refresh_skinned(host, info, to_device(host, "cpu"), tl, 1.0)
    assert tl1.mesh_tables is tl.mesh_tables      # no BLAS rebuild
    d = torch.tensor([[0.0, 0.0, -1.0]])
    hit = TI.trace_closest(tl1, torch.tensor([[2.0, 0.0, 5.0]]), d)
    assert int(hit.prim[0]) >= 0
    np.testing.assert_allclose(float(hit.t[0]), 5.0, atol=1e-4)
    # through the old place the ray reaches the static instance at z = -3
    thr = TI.trace_closest(tl1, torch.tensor([[0.0, 0.0, 5.0]]), d)
    np.testing.assert_allclose(float(thr.t[0]), 8.0, atol=1e-4)


def test_posed_render_matches_reference(tmp_path, monkeypatch):
    from rtxpt_tpu.models.renderer import Renderer as JRenderer
    from rtxpt_tpu.models.renderer import reference_config as j_config
    from rtxpt_tpu.scene import envmap as JEM
    from rtxpt_tpu.scene import gltf as JG
    from rtxpt_tpu_torch.ops import cuda_lib
    from rtxpt_tpu_torch.scene import envmap as TEM
    from rtxpt_tpu_torch.scene import gltf as TG
    monkeypatch.setenv("RTXPT_SHADE_KERNEL", "1")
    monkeypatch.setenv("RTXPT_SHADE_KERNEL_INTERPRET", "1")
    w, h, spp = 16, 12, 2
    bench = dict(max_bounces=6, max_diffuse_bounces=4, nee_distant_samples=1,
                 nee_local_samples=1)
    path = AS.skinned_figure(str(tmp_path / "fig.gltf"), rings=176,
                             joints=8)
    jhost, jinfo = JG.load_gltf(path)
    jr = JRenderer(jhost, JG.camera_from_info(jinfo, w, h), j_config(**bench),
                   env_radiance=JEM.bake_procedural_sky(height=32))
    assert jr.dense is None and type(jr.bvh).__name__ == "BVH8"
    jr.animate(jinfo, 0.5)
    ref = np.asarray(jr.render(w, h, spp))
    host, info = TG.load_gltf(path)
    r = Renderer(host, TG.camera_from_info(info, w, h),
                 reference_config(**bench),
                 env_radiance=TEM.bake_procedural_sky(height=32),
                 device="cpu")
    assert isinstance(r.accel, TBVH.BVH8)
    rest = r.render(w, h, spp).numpy().copy()
    r.reset_accumulation()
    cuda_lib.reset_launch_counts()
    r.animate(info, 0.5)
    got = r.render(w, h, spp).numpy()
    assert not any(cuda_lib.launch_counts().values())
    assert np.isfinite(got).all() and got.mean() > 0.0
    assert not np.allclose(got, rest, rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=5e-5)
