"""Opacity micro-masks in the port (rtxpt_tpu_torch/scene/omm.py and the
traces that test them) against the reference: the bake bit for bit;
tests/test_omm.py's four shadow cases on the port's BVH8 and dense tiers
(plain versions); K1's OMM channel (the plain version of the fused dense
trace) with random 16-bit masks against the reference's dense kernel in
interpret mode; the BVH8 and two-level tables with masks.

K1's cell rule is K5's: u and v (the sign-folded numerators over |a|)
times 4, truncated, clamped to 0..3. The reference's kernel takes u and
v from its matmul-form numerators times 1/|a|, so the two may round
apart where u or v lies on a cell edge: such lanes (u, v or 1 - u - v
within 1e-5 of a multiple of 1/4 on either winner; 0 is the triangle's
own edge, where the two forms disagree even without masks) are the only
ones excused, and are counted. The scene's triangles lie in parallel
planes 0.02 apart, one each, so no two candidates of a ray are near a
tie in t, which the reference's quantized winner selection would
otherwise break apart from the port's exact one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_omm import _scene_with_mask
from rtxpt_tpu.ops import bvh as JB
from rtxpt_tpu.ops import bvh2l as JL
from rtxpt_tpu.ops import mt_dense as JMT
from rtxpt_tpu.scene import omm as JOMM
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch.ops import bvh as TB
from rtxpt_tpu_torch.ops import bvh2l as TL
from rtxpt_tpu_torch.ops import cuda_lib, traverse
from rtxpt_tpu_torch.ops import mt_dense as TMT
from rtxpt_tpu_torch.scene import omm as TOMM

EDGE = 1e-5


def _bake_host(seed):
    """Triangles of every size (sub-texel to several wraps) over three
    materials: opaque, MASK on a 37x64 texture, MASK on a 128x128 one."""
    rs = np.random.RandomState(seed)
    n = 400
    uvs = (rs.rand(3 * n, 2) * 3 - 1).astype(np.float32)
    uvs[:n] *= 0.01
    img0 = rs.randint(0, 256, (37, 64, 4)).astype(np.uint8)
    img0[..., 3] = np.where(rs.rand(37, 64) < 0.9, 0, 255)
    img1 = rs.randint(0, 256, (128, 128, 4)).astype(np.uint8)
    mats = dict(alpha_mode=np.array([0, 1, 1, 1], np.int32),
                base_tex=np.array([-1, 0, 1, 2], np.int32),
                alpha_cutoff=np.array([0.5, 0.3, 0.7, 0.5], np.float32))
    return dict(indices=np.arange(3 * n).reshape(n, 3).astype(np.int32),
                uvs=uvs, tri_mat=rs.randint(0, 4, n).astype(np.int32),
                materials=mats, texture_images=[
                    img0, img1, np.zeros((4, 4, 3), np.uint8)])


@pytest.mark.parametrize("seed", [0, 1])
def test_bake_bit_equal(seed):
    host = _bake_host(seed)
    ref = JOMM.bake_opacity_masks(host)
    got = TOMM.bake_opacity_masks(host)
    assert got.dtype == np.int32 and np.array_equal(got, ref)
    assert len(np.unique(got)) > 10
    # the RGB texture (no alpha) and the opaque material bake to all ones
    mat = host["tri_mat"]
    assert (got[(mat == 0) | (mat == 3)] == 0xFFFF).all()
    img = np.zeros((8, 8, 4), np.uint8)
    h = _scene_with_mask(img)
    assert np.array_equal(TOMM.bake_opacity_masks(h),
                          JOMM.bake_opacity_masks(h))
    u = torch.tensor([0.0, 0.2499, 0.25, 0.99, 1.0, 0.5])
    v = torch.tensor([0.0, 0.0, 0.74, 0.0, 0.0, 0.5])
    assert TOMM.mask_bit_index(u, v).tolist() == [0, 0, 6, 12, 12, 10]


def _shadow_rays():
    g = np.linspace(-0.9, 0.9, 16)
    gx, gz = np.meshgrid(g, g)
    o = np.stack([gx.reshape(-1), np.full(gx.size, 0.01),
                  gz.reshape(-1)], -1).astype(np.float32)
    d = np.tile(np.asarray([[0, 1, 0]], np.float32), (o.shape[0], 1))
    return torch.as_tensor(o), torch.as_tensor(d)


def _alpha(case):
    img = np.full((8, 8, 4), 255, np.uint8)
    if case == "masked":
        img[..., 3] = 0
    elif case == "half":
        img[:, 4:, 3] = 0
    return img


@pytest.mark.parametrize("tier", ["bvh8", "dense"])
@pytest.mark.parametrize("case", ["masked", "opaque", "half"])
def test_shadow_fraction(tier, case):
    """test_omm.py's shadow cases: a fully masked occluder casts no shadow,
    an opaque one a full shadow, a half-masked one a partial shadow."""
    host = _scene_with_mask(_alpha(case))
    masks = TOMM.bake_opacity_masks(host)
    pos, idx = host["positions"], host["indices"]
    if tier == "bvh8":
        accel = TB.collapse_bvh8(TB.build_bvh(pos, idx), pos, idx,
                                 tri_omm=masks, device="cpu")
    else:
        accel = TMT.build_dense(pos, idx, tri_omm=masks, device="cpu")
        # even an opaque texture clears the cells outside the triangle
        assert accel.has_omm
    o, d = _shadow_rays()
    frac = float(traverse.trace_anyhit(accel, o, d, t_max=10.0).float()
                 .mean())
    want = {"masked": (0.0, 0.0), "opaque": (1.0, 1.0),
            "half": (0.25, 0.75)}[case]
    assert want[0] <= frac <= want[1], frac


def _layered(seed, n_tris=500):
    """Triangles each in its own plane z = 0.02 k, spread over x, y; and
    rays along +z from z = -3."""
    r = np.random.RandomState(seed)
    c = np.stack([r.uniform(-2, 2, n_tris), r.uniform(-2, 2, n_tris),
                  0.02 * r.permutation(n_tris)], -1)
    v = [c + np.concatenate([r.uniform(-0.7, 0.7, (n_tris, 2)),
                             np.zeros((n_tris, 1))], -1) for _ in range(3)]
    pos = np.concatenate(v).astype(np.float32)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T
    n = 2048
    o = np.stack([r.uniform(-2, 2, n), r.uniform(-2, 2, n),
                  np.full(n, -3.0)], -1).astype(np.float32)
    d = np.concatenate([r.normal(0, 0.1, (n, 2)), np.ones((n, 1))], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    masks = r.randint(0, 1 << 16, n_tris).astype(np.int32)
    masks[:50] = 0xFFFF
    return pos, idx, o, d, masks


def _near_edge(bary):
    """Lanes whose u, v or 1 - u - v lies within EDGE of a cell edge, a
    multiple of 1/4 (0: the triangle's own edge)."""
    b = np.asarray(bary, np.float64)
    b = np.concatenate([b, 1.0 - b.sum(-1, keepdims=True)], -1)[..., None]
    return (np.abs(b - np.arange(5) / 4.0) < EDGE).any((-1, -2))


def test_dense_omm_matches_reference_kernel(record_property):
    pos, idx, o, d, masks = _layered(5)
    jd = JMT.build_dense(pos, idx, tri_omm=masks)
    td = TMT.build_dense(pos, idx, tri_omm=masks, device="cpu")
    assert jd.has_omm and td.has_omm
    # the masks ride tri12's word after e1, in slot order
    order = td.tri9[:len(masks), 9].long().numpy()
    assert np.array_equal(TMT.omm_from_tri12(td.tri12)[:len(masks)].numpy(),
                          masks[order])
    ref = JMT.trace_closest(jd, jnp.asarray(o), jnp.asarray(d),
                            interpret=True)
    cuda_lib.reset_launch_counts()
    got = TMT.trace_closest(td, torch.as_tensor(o), torch.as_tensor(d))
    assert cuda_lib.launch_counts().get("mt_dense_fused") == 0
    rp, gp = np.asarray(ref.prim), got.prim.numpy()
    excused = (_near_edge(ref.bary) & (rp >= 0)) | (
        _near_edge(got.bary.numpy()) & (gp >= 0))
    differ = rp != gp
    record_property("excused_lanes", int(excused.sum()))
    print(f"closest: {int(differ.sum())} of {len(rp)} lanes differ, all "
          f"excused; {int(excused.sum())} lanes near a cell edge")
    assert not (differ & ~excused).any(), np.nonzero(differ & ~excused)
    assert (gp >= 0).mean() > 0.3
    # the masks reject hits: without them the winners change
    plain = TMT.trace_closest(TMT.build_dense(pos, idx, device="cpu"),
                              torch.as_tensor(o), torch.as_tensor(d))
    assert (plain.prim.numpy() != gp).mean() > 0.1
    occ_ref = np.asarray(JMT.trace_anyhit(jd, jnp.asarray(o), jnp.asarray(d),
                                          interpret=True))
    occ = TMT.trace_anyhit(td, torch.as_tensor(o), torch.as_tensor(d))
    assert np.array_equal(occ.numpy()[~excused], occ_ref[~excused])
    assert np.array_equal(occ.numpy(), gp >= 0)


def test_dense_omm_wrappers():
    pos, idx, o, d, masks = _layered(7, n_tris=200)
    td = TMT.build_dense(pos, idx, tri_omm=masks, device="cpu")
    o_c = torch.as_tensor(o) - td.center
    args = (td.aabb_c, td.tri12, o_c, torch.as_tensor(d),
            torch.full((len(o),), 1e30), torch.ones(len(o), dtype=torch.bool))
    for any_hit in (False, True):
        t, slot = TMT.trace_dense_fused(*args, any_hit, omm=True)
        t2, slot2 = TMT.trace_dense_plain(
            td.aabb_c, td.tri9, *args[2:], any_hit, omm=td.omm)
        assert torch.equal(slot, slot2) and torch.equal(t, t2)
        assert TMT.trace_dense_fused(*args, any_hit)[1].ne(slot).any()
    # K1 walking given worklists and the lab's kernels refuse the masked
    # table: its rows carry the masks, with no flag passed
    from tools_torch import profile_mt_kernel as PM
    assert TMT.has_masks(td.tri12)
    with pytest.raises(ValueError, match="no OMM channel"):
        TMT.trace_dense(*args, False)
    with pytest.raises(ValueError, match="no OMM channel"):
        PM.trace_variant(*args, mode="full")
    with pytest.raises(ValueError, match="no OMM channel"):
        PM.trace_fused_variant(*args, mode="fused", any_hit=False)
    # all-ones masks: no OMM channel, and tri12 as without masks
    full = TMT.build_dense(pos, idx, tri_omm=np.full(200, 0xFFFF),
                           device="cpu")
    assert not full.has_omm and not TMT.has_masks(full.tri12)
    assert torch.equal(full.tri12, TMT.build_dense(pos, idx,
                                                   device="cpu").tri12)
    t, slot = TMT.trace_dense(full.aabb_c, full.tri12, *args[2:], False)
    assert torch.equal(slot, TMT.trace_dense_fused(
        full.aabb_c, full.tri12, *args[2:], False)[1])


def test_bvh_tables_with_masks_equal():
    host = JP.build_programmer_art().finish()
    pos, idx = host["positions"], host["indices"]
    omm = np.random.RandomState(3).randint(0, 1 << 16, idx.shape[0]) \
        .astype(np.int32)
    ref = JB.collapse_bvh8(JB.build_bvh(pos, idx), pos, idx, tri_omm=omm)
    got = TB.collapse_bvh8(TB.build_bvh(pos, idx), pos, idx, tri_omm=omm,
                           device="cpu")
    # the trees may split apart in rare cases (ROADMAP §3); the masks
    # follow each leaf slot's triangle either way
    lt = got.leaf_tris.numpy()
    assert np.array_equal(got.leaf_omm.numpy()[lt >= 0], omm[lt[lt >= 0]])
    assert (got.leaf_omm.numpy()[lt < 0] == 0xFFFF).all()
    assert np.array_equal(np.sort(lt), np.sort(np.asarray(ref.leaf_tris)))
    jl = JL.build_two_level(pos, idx, cap_tris=300, tri_omm=omm)
    tl = TL.build_two_level(pos, idx, cap_tris=300, tri_omm=omm,
                            device="cpu")
    for t in (tl, jl):
        lt, lo = np.asarray(t.sub_leaf_tris), np.asarray(t.sub_leaf_omm)
        assert np.array_equal(lo[lt >= 0], omm[lt[lt >= 0]])
        assert (lo[lt < 0] == 0xFFFF).all()
    assert np.array_equal(np.sort(tl.sub_leaf_tris.numpy(), None),
                          np.sort(np.asarray(jl.sub_leaf_tris), None))
