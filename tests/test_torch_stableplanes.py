"""Stable planes (rtxpt_tpu_torch/pt/stableplanes.py) against the reference
package on the CPU.

Branch-id arithmetic is integer: the port's int64 ids must equal the
reference's uint32 ids bit for bit. The BUILD pass runs on the same tables
(interop) and on the port's own build, at 16x12: programmer-art and a
glass wall in front of a diffuse wall (a two-lobe junction at every
primary hit, so all three plane slots fill). Integer outputs (branch id,
vertex index, prim, nested stack, dominant plane) must be equal; float
outputs agree within rtol 1e-4 / atol 1e-5 (motion, in pixels, atol
1e-4): the reference's dense trace drops low mantissa bits of t when it
picks a winner, the port picks exactly, so hit points differ by float
rounding only. The reference runs its dense trace in interpret mode, as
its own CPU tests do."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtxpt_tpu.models.renderer import Renderer as JRenderer
from rtxpt_tpu.models.renderer import realtime_config as j_realtime_config
from rtxpt_tpu.pt import stableplanes as JSP
from rtxpt_tpu.scene import build as JB
from rtxpt_tpu.scene import camera as JC
from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.models.renderer import Renderer, realtime_config
from rtxpt_tpu_torch.pt import stableplanes as TSP
from rtxpt_tpu_torch.scene import build as TB
from rtxpt_tpu_torch.scene import camera as TC
from rtxpt_tpu_torch.scene import envmap as TEM
from rtxpt_tpu_torch.scene import procedural as TP

W, H = 16, 12
INTS = ("branch_id", "vertex_index", "prim", "interior", "dominant")


def _random_branches(rs, n):
    """Valid prefix codes of 0-15 delta vertices, and INVALID_BRANCH."""
    depth = rs.randint(0, 16, n)
    ids = np.ones(n, np.uint64)
    for k in range(15):
        step = depth > k
        ids = np.where(step, (ids << np.uint64(2)) | rs.randint(0, 2, n)
                       .astype(np.uint64), ids)
    ids = np.where(rs.rand(n) < 0.1, np.uint64(0xFFFFFFFF), ids)
    return ids.astype(np.uint32)


def test_branch_ids_bit_equal():
    rs = np.random.RandomState(3)
    n = 4096
    plane = _random_branches(rs, n)
    vert = np.where(rs.rand(n) < 0.5, plane >> np.uint32(
        2 * rs.randint(0, 4, n)), _random_branches(rs, n)).astype(np.uint32)
    lobe = rs.randint(0, 2, n).astype(np.uint32)
    vidx = rs.randint(0, 17, n).astype(np.int32)
    jp, jv = jnp.asarray(plane), jnp.asarray(vert)
    tp = torch.as_tensor(plane.astype(np.int64))
    tv = torch.as_tensor(vert.astype(np.int64))
    got = TSP.advance_branch_id(tv, torch.as_tensor(lobe.astype(np.int64)))
    ref = np.asarray(JSP.advance_branch_id(jv, jnp.asarray(lobe)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    np.testing.assert_array_equal(
        TSP.branch_vertex_index(tp).numpy(),
        np.asarray(JSP.branch_vertex_index(jp)))
    np.testing.assert_array_equal(
        TSP.is_on_plane(tp, tv).numpy(), np.asarray(JSP.is_on_plane(jp, jv)))
    np.testing.assert_array_equal(
        TSP.is_on_stable_path(tp, tv, torch.as_tensor(vidx).long()).numpy(),
        np.asarray(JSP.is_on_stable_path(jp, jv, jnp.asarray(vidx))))


def test_hit_t_helpers_match_reference():
    rs = np.random.RandomState(4)
    n = 1024
    cur = rs.uniform(0.0, 20.0, n).astype(np.float32)
    seg = rs.uniform(0.0, 20.0, n).astype(np.float32)
    bounces = rs.randint(0, 5, n)
    delta = rs.rand(n) < 0.5
    got = TSP.accumulate_hit_t(torch.as_tensor(cur), torch.as_tensor(seg),
                               torch.as_tensor(bounces),
                               torch.as_tensor(delta))
    ref = JSP.accumulate_hit_t(jnp.asarray(cur), jnp.asarray(seg),
                               jnp.asarray(bounces), jnp.asarray(delta))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    cur4 = rs.uniform(0.0, 2.0, (n, 4)).astype(np.float32)
    cur4[::7, :3] = 0.0
    new3 = rs.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    new3[::5] = 0.0
    got = TSP.combine_hit_t(torch.as_tensor(cur4), torch.as_tensor(new3),
                            torch.as_tensor(seg))
    ref = JSP.combine_hit_t(jnp.asarray(cur4), jnp.asarray(new3),
                            jnp.asarray(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def _glass_wall(B):
    """A glass wall 1 unit in front of a diffuse wall (the reference's
    tests/test_stableplanes.py scene), with either package's builder."""
    sb = B.SceneBuilder()
    white = sb.add_material(base_color=(0.7, 0.7, 0.7), roughness=1.0)
    glass = sb.add_material(base_color=(0.98, 0.98, 0.98), roughness=0.0,
                            transmission=1.0, ior=1.5)
    pos = np.asarray([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                     np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    wall = sb.add_mesh(B.Mesh(positions=pos * 8.0, indices=idx))
    gl = sb.add_mesh(B.Mesh(positions=pos * 4.0, indices=idx, material=1))
    back = np.eye(3, 4, dtype=np.float32)
    back[2, 3] = -3.0
    front = np.eye(3, 4, dtype=np.float32)
    front[2, 3] = -1.0
    sb.add_instance(wall, back, white)
    sb.add_instance(gl, front, glass)
    return sb.finish()


SCENES = {
    "programmer-art": (
        lambda: (JP.build_programmer_art().finish(), JP.default_camera(W, H)),
        lambda: (TP.build_programmer_art().finish(),
                 TP.default_camera(W, H))),
    "glass-wall": (
        lambda: (_glass_wall(JB), JC.make_camera(
            W, H, pos=(0.0, 0.0, 2.0), look_dir=(0.0, 0.0, -1.0))),
        lambda: (_glass_wall(TB), TC.make_camera(
            W, H, pos=(0.0, 0.0, 2.0), look_dir=(0.0, 0.0, -1.0)))),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def builds(request):
    """(reference StablePlanes as numpy, the port's on shared tables, the
    port's on its own build) for one scene."""
    j_scene, t_scene = SCENES[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTXPT_DENSE_INTERPRET", "1")
        host, cam = j_scene()
        jr = JRenderer(host, cam, j_realtime_config(),
                       env_radiance=JEM.bake_procedural_sky(height=32))
        jcam = cam._replace(jitter=jnp.zeros(2),
                            viewport=jnp.asarray([W, H], jnp.float32))
        jpx, jpy = jr._pixel_grid(W, H)
        ref = JSP.build_stable_planes(jr.assets, jcam, jcam, jpx, jpy)
        ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    host, cam = t_scene()
    out = {}
    for name in ("shared", "own"):
        tr = Renderer(host, cam, realtime_config(),
                      env_radiance=TEM.bake_procedural_sky(height=32),
                      device="cpu")
        if name == "shared":
            tr.assets = interop.assets_from_reference(
                jr.scene, jr.dense, jr.env, jr.lights, device="cpu")
        tcam = tr._camera(W, H, (0.0, 0.0))
        px, py = tr._pixel_grid(W, H)
        out[name] = TSP.build_stable_planes(tr.assets, tcam, tcam, px, py)
    return request.param, ref, out


@pytest.mark.parametrize("tables", ["shared", "own"])
def test_build_matches_reference(builds, tables):
    scene, ref, out = builds
    sp = out[tables]
    # a ray through the shared edge of two coplanar triangles hits both at
    # one t; the reference's quantized winner selection and the port's
    # exact one may report either triangle (ROADMAP §3). Such pixels keep
    # every other output; their prim and bary are left out, and their
    # share is bounded.
    tie = (sp.prim.numpy() != ref["prim"]).any(1)
    assert tie.mean() <= 0.02, tie.sum()
    for name, val in sp._asdict().items():
        got = val.numpy()
        assert got.shape == ref[name].shape, name
        if name in ("prim", "bary"):
            got, want = got[~tie], ref[name][~tie]
            if name == "prim":
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                           err_msg=name)
        elif name in INTS:
            np.testing.assert_array_equal(
                got, ref[name].astype(got.dtype), err_msg=name)
        else:
            atol = 1e-4 if name == "motion" else 1e-5
            np.testing.assert_allclose(got, ref[name], rtol=1e-4, atol=atol,
                                       err_msg=name)
    valid = sp.branch_id != TSP.INVALID_BRANCH
    assert valid[:, 0].all()
    if scene == "glass-wall":
        # the junction forks the reflection and the refraction lobes
        assert valid.all(1).float().mean() > 0.5


def test_build_compaction_is_exact():
    """The tail compaction of a 16384-lane BUILD walk gives the planes of
    the uncompacted walk, bit for bit."""
    w, h = 128, 128
    r = Renderer(TP.build_programmer_art().finish(), TP.default_camera(w, h),
                 realtime_config(),
                 env_radiance=TEM.bake_procedural_sky(height=32),
                 device="cpu")
    cam = r._camera(w, h, (0.0, 0.0))
    px, py = r._pixel_grid(w, h)
    on = TSP.build_stable_planes(r.assets, cam, cam, px, py,
                                 compaction_min=w * h)
    off = TSP.build_stable_planes(r.assets, cam, cam, px, py,
                                  compaction=False)
    for a, b in zip(on, off):
        assert torch.equal(a, b)
