"""Keyframes and skinning (rtxpt_tpu_torch/scene/animation.py) against
the reference's (rtxpt_tpu/scene/animation.py, rtxpt_tpu/scene/gltf.py) on
the same inputs: the skinned figure of tools_torch/animated_scenes.py
(16 segments x 8 sides over 8 joints) and seeded numpy channels.

Tolerances: the host code (channel sampling, slerp, node TRS, world
transforms, joint matrices) is the same numpy in both and is held to
1e-7; skinning runs on torch against XLA, which sum the four weighted
joint matrices in different orders, so posed positions and normals are
held to rtol 1e-6 / atol 1e-6."""
import copy

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rtxpt_tpu.scene import animation as JA
from rtxpt_tpu.scene import gltf as JG
from rtxpt_tpu_torch.scene import animation as TA
from rtxpt_tpu_torch.scene import gltf as TG
from tools_torch import animated_scenes as AS


@pytest.fixture(scope="module")
def figure(tmp_path_factory):
    path = AS.skinned_figure(str(tmp_path_factory.mktemp("fig") / "f.gltf"),
                             rings=16, sides=8, joints=8)
    return JG.load_gltf(path), TG.load_gltf(path)


def _channel(mod, path, interp, values):
    return mod.Channel(node=0, path=path,
                       times=np.asarray([0.0, 0.5, 1.5], np.float32),
                       values=np.asarray(values, np.float32),
                       interpolation=interp)


def _quats(seed, near: bool):
    r = np.random.RandomState(seed)
    q0 = r.normal(size=4)
    q1 = q0 + (1e-3 if near else 1.5) * r.normal(size=4)
    q2 = -r.normal(size=4)                 # the sign flip of the shorter arc
    q = np.stack([q0, q1, q2])
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("case", ["linear", "step", "slerp_near",
                                  "slerp_far"])
def test_sample_channel_matches_reference(case):
    if case.startswith("slerp"):
        args = ("rotation", "LINEAR", _quats(3, case == "slerp_near"))
    else:
        vals = np.random.RandomState(4).normal(size=(3, 3))
        args = ("translation", "LINEAR" if case == "linear" else "STEP",
                vals)
    ref_ch, got_ch = _channel(JA, *args), _channel(TA, *args)
    for t in (-1.0, 0.0, 0.2, 0.5, 0.9, 1.49, 1.5, 3.0):
        ref = np.asarray(JA.sample_channel(ref_ch, t), np.float64)
        got = np.asarray(TA.sample_channel(got_ch, t), np.float64)
        np.testing.assert_allclose(got, ref, rtol=1e-7, atol=1e-7)


def test_parse_apply_and_world_transforms(figure):
    (jh, ji), (th, ti) = figure
    ref_anims = JA.parse_animations(ji["gltf"])
    got_anims = TA.parse_animations(ti["gltf"])
    assert len(got_anims) == len(ref_anims) == 1
    for r, g in zip(ref_anims[0], got_anims[0]):
        assert (g.node, g.path, g.interpolation) == (r.node, r.path,
                                                     r.interpolation)
        assert np.array_equal(g.times, r.times)
        assert np.array_equal(g.values, r.values)
    assert th["animations"] == sorted({c.node for c in got_anims[0]})
    for t in (0.0, 0.5, 1.7):
        jn = copy.deepcopy(ji["gltf"].json["nodes"])
        tn = [dict(n) for n in ti["gltf"].json["nodes"]]
        JA.apply_animation(jn, ref_anims[0], t)
        TA.apply_animation(tn, got_anims[0], t)
        ref_w = JG.compute_world_transforms(ji["gltf"].json, jn)
        got_w = TG.compute_world_transforms(ti["gltf"].json, tn)
        assert len(ref_w) == len(got_w)
        for r, g in zip(ref_w, got_w):
            np.testing.assert_allclose(g, r, rtol=1e-7, atol=1e-7)
        ref_j = JA.joint_matrices(ref_w, ji["skins"][0])
        got_j = TA.joint_matrices(got_w, ti["skins"][0])
        np.testing.assert_allclose(got_j, ref_j, rtol=1e-7, atol=1e-7)
    # the file's nodes are not touched by posing
    assert ti["gltf"].json["nodes"] == ji["gltf"].json["nodes"]


def test_skins_and_bindings_match_reference(figure):
    (jh, ji), (th, ti) = figure
    assert len(ti["skins"]) == len(ji["skins"]) == 1
    assert ti["skins"][0]["joints"] == ji["skins"][0]["joints"]
    np.testing.assert_array_equal(ti["skins"][0]["inverse_bind"],
                                  ji["skins"][0]["inverse_bind"])
    assert len(th["skin_bindings"]) == len(jh["skin_bindings"]) == 2
    for r, g in zip(jh["skin_bindings"], th["skin_bindings"]):
        assert r.keys() == g.keys()
        for k, v in r.items():
            np.testing.assert_array_equal(g[k], v, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_skin_vertices_matches_reference(seed):
    r = np.random.RandomState(seed)
    v, j = 500, 12
    pos = r.normal(size=(v, 3)).astype(np.float32)
    nrm = r.normal(size=(v, 3)).astype(np.float32)
    joints = r.randint(0, j, (v, 4)).astype(np.int32)
    w = r.uniform(0, 1, (v, 4)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    jm = r.normal(size=(j, 3, 4)).astype(np.float32)
    ref_p, ref_n = JA.skin_vertices(*(jnp.asarray(a) for a in
                                      (pos, nrm, joints, w, jm)))
    got_p, got_n = TA.skin_vertices(*(torch.as_tensor(a) for a in
                                      (pos, nrm, joints, w, jm)))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(ref_p), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got_n.numpy(), np.asarray(ref_n), rtol=1e-6,
                               atol=1e-6)


def test_cubicspline_raises_naming_the_channel(figure):
    (_, _), (_, ti) = figure
    gf = copy.copy(ti["gltf"])
    gf.json = copy.deepcopy(ti["gltf"].json)
    gf.json["animations"][0]["samplers"][2]["interpolation"] = "CUBICSPLINE"
    with pytest.raises(ValueError, match=r"animation 0 channel 2 .*"
                                         r"CUBICSPLINE"):
        TA.parse_animations(gf)
