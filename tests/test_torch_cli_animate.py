"""The CLI's animation flags and the glTF loader's animation data in the
port (rtxpt_tpu_torch/app/cli.py, scene/gltf.py), against the reference
where it has them:

  * `--animate-time` on the reference's moving-quad scene
    (tests/test_cli_animate.py, written by tools_torch/animated_scenes.py):
    the quad moves between t = 0 and t = 1, and the port's posed HDR
    (`--dump-npy`) matches the reference CLI's, rtol 2e-4 / atol 5e-5 (the
    reference's dense trace in interpret mode and its chain of XLA ops,
    tests/reference_configs.py);
  * two realtime `--animate` frames: frame i posed at i / --animate-fps;
  * the loader's skin_bindings, rigid_bindings and instancing equal the
    reference loader's, and its `animations` lists the animated nodes;
  * the instanced gate: a rigid-animated glTF over 45,000 triangles takes
    the instanced TLAS, the same file without animations the two-level
    BVH8, a skinned one never the TLAS;
  * the two-level tier's stale-structure warning, kept from the
    reference."""
import numpy as np
import pytest

from reference_configs import reference_env
from rtxpt_tpu_torch.app import cli
from rtxpt_tpu_torch.models import renderer as TR
from rtxpt_tpu_torch.ops import bvh2l, instanced
from rtxpt_tpu_torch.scene import gltf as TG
from tools_torch import animated_scenes as AS

COMMON = ["--width", "48", "--height", "36", "--spp", "1", "--mode",
          "reference", "--max-bounces", "2", "--no-jitter",
          "--no-auto-expose", "--quiet"]


def test_cli_animate_time_moves_geometry_like_reference(tmp_path,
                                                        monkeypatch):
    from rtxpt_tpu.app import cli as jcli
    scene = AS.moving_quad(str(tmp_path / "anim.gltf"))
    outs = {}
    for t in ("0.0", "1.0"):
        outs[t] = tmp_path / f"t{t}.npy"
        assert cli.main(["--scene", scene, "--device", "cpu"] + COMMON
                        + ["--animate-time", t, "--output",
                           str(tmp_path / f"t{t}.png"),
                           "--dump-npy", str(outs[t])]) == 0
    a, b = np.load(outs["0.0"]), np.load(outs["1.0"])
    assert a.shape == b.shape == (36, 48, 3)
    assert np.isfinite(a).all() and np.isfinite(b).all()
    # at t = 0 the quad covers the image centre; at t = 1 the centre ray
    # escapes to the sky
    assert not np.allclose(a[18, 24], b[18, 24])
    reference_env(monkeypatch)
    ref = tmp_path / "ref.npy"
    assert jcli.main(["--scene", scene] + COMMON
                     + ["--animate-time", "1.0", "--output",
                        str(tmp_path / "ref.png"),
                        "--dump-npy", str(ref)]) == 0
    np.testing.assert_allclose(b, np.load(ref), rtol=2e-4, atol=5e-5)


def test_realtime_animate_frames(tmp_path, monkeypatch):
    scene = AS.moving_quad(str(tmp_path / "anim.gltf"))
    times = []
    orig = TR.Renderer.animate

    def record(self, info, time, animation_index=0):
        times.append((time, animation_index))
        return orig(self, info, time, animation_index)
    monkeypatch.setattr(TR.Renderer, "animate", record)
    args = ["--scene", scene, "--device", "cpu", "--mode", "realtime",
            "--width", "24", "--height", "18", "--spp", "2",
            "--max-bounces", "2", "--no-auto-expose", "--quiet"]
    out = {}
    for name, extra in (("still", []),
                        ("animated", ["--animate", "--animate-fps", "1"])):
        out[name] = tmp_path / f"{name}.npy"
        assert cli.main(args + extra + ["--output", str(tmp_path / "o.png"),
                                        "--dump-npy", str(out[name])]) == 0
    assert times == [(0.0, 0), (1.0, 0)]
    still, moved = np.load(out["still"]), np.load(out["animated"])
    assert np.isfinite(moved).all() and moved.shape == (18, 24, 3)
    assert not np.allclose(still, moved)


def test_loader_animation_data_matches_reference(tmp_path):
    from rtxpt_tpu.scene import gltf as JG
    for path in (AS.skinned_figure(str(tmp_path / "f.gltf"), rings=16,
                                   sides=8, joints=8),
                 AS.rigid_city(str(tmp_path / "c.gltf"), blocks=2,
                               moving=8)):
        jh, ji = JG.load_gltf(path)
        th, ti = TG.load_gltf(path)
        for key in ("skin_bindings", "rigid_bindings"):
            assert len(th[key]) == len(jh[key])
            for r, g in zip(jh[key], th[key]):
                assert r.keys() == g.keys()
                for k, v in r.items():
                    np.testing.assert_array_equal(g[k], v, err_msg=k)
        ri, gi = jh["instancing"], th["instancing"]
        for k in ("mesh_of_instance", "transforms", "tri_offset"):
            np.testing.assert_array_equal(gi[k], ri[k], err_msg=k)
        assert len(gi["meshes"]) == len(ri["meshes"])
        for r, g in zip(ri["meshes"], gi["meshes"]):
            for k in ("positions", "indices"):
                np.testing.assert_array_equal(g[k], r[k])
        targets = sorted({ch["target"]["node"] for a in
                          ti["gltf"].json["animations"]
                          for ch in a["channels"]})
        assert th["animations"] == targets and targets
        assert "animations" not in jh       # no reference loader sets it


def test_instanced_gate(tmp_path):
    moving = TG.load_gltf(AS.rigid_city(str(tmp_path / "a.gltf"),
                                        blocks=4, moving=8))[0]
    still = TG.load_gltf(AS.rigid_city(str(tmp_path / "s.gltf"), blocks=4,
                                       animated=False))[0]
    assert moving["indices"].shape[0] > TR.BVH8_MAX_TRIS
    assert TR.uses_instanced(moving) and not TR.uses_instanced(still)
    assert isinstance(TR.build_trace_structure(moving, "cpu"),
                      instanced.InstancedTL)
    assert isinstance(TR.build_trace_structure(still, "cpu"),
                      bvh2l.BVH8TwoLevel)
    # skins keep a scene off the TLAS
    skinned = dict(moving, skin_bindings=[{}])
    assert not TR.uses_instanced(skinned)


def test_two_level_animation_warns_stale(tmp_path):
    """Rigid motion without the instanced gate (here: a scene whose
    loader data lacks `animations`) leaves the two-level BVH8 stale; the
    port warns, as the reference does."""
    from rtxpt_tpu_torch.scene import camera as TC
    path = AS.rigid_city(str(tmp_path / "a.gltf"), blocks=4, moving=8)
    host, info = TG.load_gltf(path)
    host.pop("animations")
    r = TR.Renderer(host, TC.look_at(8, 6, (30, 14, 30), (0, 2, 0)),
                    TR.reference_config(max_bounces=1), device="cpu")
    assert isinstance(r.accel, bvh2l.BVH8TwoLevel)
    before = r.accel
    with pytest.warns(UserWarning, match="stale"):
        r.animate(info, 1.0)
    assert r.accel is before
    assert np.isfinite(r.render(8, 6, 1).numpy()).all()
