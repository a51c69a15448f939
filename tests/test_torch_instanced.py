"""The instanced TLAS (rtxpt_tpu_torch/ops/instanced.py) against the
reference's (rtxpt_tpu/ops/instanced.py, its XLA rounds on the CPU) and
the brute-force oracle of the flat scene (rtxpt_tpu/ops/intersect.py
`bruteforce_closest`).

The reference's oracles (tests/test_instanced.py: one BLAS per shared
mesh, the flat trace, mirrored barycentrics, a rigid move) on the port's
own build, and each also against the reference's trace of its own
InstancedTL carried across with `interop`, on the same rays: the same
prim and occlusion on every lane, t within rtol 1e-5 and barycentrics
within 1e-5 (XLA contracts the Möller–Trumbore multiply-adds into FMAs,
K5's plain version does not; tests/test_torch_traverse_bvh8.py). Then a
wavefront over more than INST_CHUNK instances (the blocks=4 city's 534),
and the tie case: rays that start inside two overlapping instance boxes,
whose entries both clamp to t_min; the reference visits only the first
(its strict `tn > tn_prev`), the port does the same, and the lanes where
that misses a nearer hit of the second instance are counted against
brute force."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.ops import instanced as JI
from rtxpt_tpu.ops.intersect import TriSoup, bruteforce_closest
from rtxpt_tpu.scene import build as JB
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.ops import cuda_lib
from rtxpt_tpu_torch.ops import instanced as TI
from rtxpt_tpu_torch.scene import build as TB
from rtxpt_tpu_torch.scene import procedural as TP


def _host(mod, prims, xforms):
    sb = mod.SceneBuilder()
    sb.add_material()
    box = sb.add_mesh(prims.make_box((0.5, 0.5, 0.5)))
    for xf in xforms:
        sb.add_instance(box, xf, 0)
    return sb.finish()


def _two_xforms(mirror=False):
    xf1 = np.eye(3, 4, dtype=np.float32)
    xf2 = np.eye(3, 4, dtype=np.float32)
    if mirror:
        xf2[0, 0] = -1.0
        xf2[:, 3] = [1.5, 0, 0]
    else:
        xf2[:, 3] = [2.0, 0.0, 0.5]
        xf2[:, :3] *= 0.7
    return [xf1, xf2]


def _rays(n=400, seed=5):
    r = np.random.RandomState(seed)
    o = r.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _aimed_rays(n=600, seed=9, second=(1.5, 0.0, 0.0)):
    """Rays from a sphere of radius 5 at points near the origin (odd
    lanes) and near `second` (even lanes)."""
    r = np.random.RandomState(seed)
    o = r.normal(size=(n, 3)).astype(np.float32)
    o = 5.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    tgt = r.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    tgt[::2] += np.float32(second)
    d = tgt - o
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _against_reference(jhost, o, d, t_max=1e30):
    """(port hit on the reference's carried TL, reference hit, the
    port's occlusion, the reference's) on rays o, d."""
    jtl = JI.build_instanced(jhost["instancing"])
    tl = interop.accel_from_reference(jtl, "cpu")
    ref = JI.trace_closest(jtl, jnp.asarray(o), jnp.asarray(d))
    got = TI.trace_closest(tl, _t(o), _t(d))
    j_occ = np.asarray(JI.trace_anyhit(jtl, jnp.asarray(o), jnp.asarray(d),
                                       t_max=t_max))
    occ = TI.trace_anyhit(tl, _t(o), _t(d), t_max=t_max).numpy()
    return got, ref, occ, j_occ


def _assert_same(got, ref, occ=None, j_occ=None):
    gp, rp = got.prim.numpy(), np.asarray(ref.prim)
    assert np.array_equal(gp, rp)
    hit = rp >= 0
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.bary.numpy()[hit],
                               np.asarray(ref.bary)[hit], atol=1e-5)
    assert np.array_equal(got.t.numpy()[~hit], np.asarray(ref.t)[~hit])
    if occ is not None:
        assert np.array_equal(occ, j_occ)


def test_shared_mesh_stores_one_blas():
    tl = TI.build_instanced(_host(TB, TP, _two_xforms())["instancing"],
                            "cpu")
    assert tl.num_meshes == 1 and tl.num_instances == 2
    assert tl.mesh_tables.shape[:2] == (1, tl.rows)
    assert bool((tl.mesh_leaf_omm == 0xFFFF).all())


def test_instanced_matches_flat_trace_and_reference():
    host = _host(TB, TP, _two_xforms())
    tl = TI.build_instanced(host["instancing"], "cpu")
    o, d = (np.concatenate(x) for x in zip(
        _rays(), _aimed_rays(300, second=(2.0, 0.0, 0.5))))
    ref = bruteforce_closest(TriSoup.build(host["positions"],
                                           host["indices"]),
                             jnp.asarray(o), jnp.asarray(d))
    cuda_lib.reset_launch_counts()
    got = TI.trace_closest(tl, _t(o), _t(d))
    assert not any(cuda_lib.launch_counts().values())
    rp, gp = np.asarray(ref.prim), got.prim.numpy()
    assert ((rp >= 0) == (gp >= 0)).all() and (rp >= 0).sum() > 50
    both = rp >= 0
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=1e-4, atol=1e-5)
    same = both & (rp == gp)
    assert same.sum() >= 0.999 * both.sum()
    np.testing.assert_allclose(got.bary.numpy()[same],
                               np.asarray(ref.bary)[same], atol=1e-4)
    occ = TI.trace_anyhit(tl, _t(o), _t(d), t_max=100.0).numpy()
    assert (occ == (rp >= 0)).all()
    _assert_same(*_against_reference(_host(JB, JP, _two_xforms()), o, d,
                                     100.0))


def test_mirrored_instance_bary_remap():
    host = _host(TB, TP, [np.eye(3, 4, dtype=np.float32)]
                 + _two_xforms(mirror=True)[1:])
    tl = TI.build_instanced(host["instancing"], "cpu")
    assert tl.inst_flip.tolist() == [False, True]
    o, d = _aimed_rays()
    ref = bruteforce_closest(TriSoup.build(host["positions"],
                                           host["indices"]),
                             jnp.asarray(o), jnp.asarray(d))
    got = TI.trace_closest(tl, _t(o), _t(d))
    rp = np.asarray(ref.prim)
    same = (rp >= 0) & (rp == got.prim.numpy())
    assert same[1::2].sum() > 50 and same[0::2].sum() > 50
    np.testing.assert_allclose(got.bary.numpy()[same],
                               np.asarray(ref.bary)[same], atol=1e-4)
    jhost = _host(JB, JP, [np.eye(3, 4, dtype=np.float32)]
                  + _two_xforms(mirror=True)[1:])
    _assert_same(*_against_reference(jhost, o, d))


def test_rigid_move_updates_rows_only():
    host = _host(TB, TP, _two_xforms())
    tl = TI.build_instanced(host["instancing"], "cpu")
    o, d = _t([[2.0, 0.0, -5.0]]), _t([[0.0, 0.0, 1.0]])
    assert int(TI.trace_closest(tl, o, d).prim[0]) >= 0
    xf = np.eye(3, 4, dtype=np.float32)
    xf[:, 3] = [10.0, 0.0, 0.0]
    tl2 = TI.set_instance_transform(tl, host["instancing"], 1, xf)
    assert tl2.mesh_tables is tl.mesh_tables
    assert int(TI.trace_closest(tl2, o, d).prim[0]) < 0
    assert int(TI.trace_closest(tl2, _t([[10.0, 0.0, -5.0]]), d).prim[0]) \
        >= 0
    # the same rows as the reference's set_instance_transform
    jhost = _host(JB, JP, _two_xforms())
    jtl = JI.set_instance_transform(JI.build_instanced(jhost["instancing"]),
                                    jhost["instancing"], 1, xf)
    np.testing.assert_array_equal(tl2.inst_inv.numpy(),
                                  np.asarray(jtl.inst_inv))
    np.testing.assert_array_equal(tl2.inst_aabb.numpy(),
                                  np.asarray(jtl.inst_aabb))
    np.testing.assert_array_equal(tl2.inst_flip.numpy(),
                                  np.asarray(jtl.inst_flip))


def test_more_than_one_chunk_of_instances():
    host = TP.build_city(blocks=4).finish()
    jhost = JP.build_city(blocks=4).finish()
    assert len(host["instancing"]["mesh_of_instance"]) > TI.INST_CHUNK
    tl = TI.build_instanced(host["instancing"], "cpu")
    assert tl.inst_by_mesh.shape[1] > TI.INST_CHUNK
    o, d = _rays(n=256, seed=11)
    o = o * np.float32([8.0, 2.0, 8.0]) + np.float32([0.0, 3.0, 0.0])
    ref = bruteforce_closest(TriSoup.build(host["positions"],
                                           host["indices"]),
                             jnp.asarray(o), jnp.asarray(d))
    stats = {}
    got = TI.trace_closest(tl, _t(o), _t(d), stats=stats)
    assert stats["chunks"] == sum(-(-c // TI.INST_CHUNK)
                                  for c in tl.mesh_instances) > tl.num_meshes
    assert stats["rounds"] >= stats["chunks"]
    rp, gp = np.asarray(ref.prim), got.prim.numpy()
    assert ((rp >= 0) == (gp >= 0)).all() and (rp >= 0).sum() > 30
    both = rp >= 0
    np.testing.assert_allclose(got.t.numpy()[both], np.asarray(ref.t)[both],
                               rtol=1e-4, atol=1e-5)
    _assert_same(*_against_reference(jhost, o, d, 100.0))


def test_overlapping_boxes_tie():
    """Rays from inside the overlap of two instance boxes: both entries
    clamp to t_min = 0, so each ray visits the first instance only (the
    reference's strict tn > tn_prev); the port keeps that rule."""
    xf2 = np.eye(3, 4, dtype=np.float32)
    xf2[:, 3] = [0.3, 0.0, 0.0]           # boxes [-.25, .25], [.05, .55]
    xforms = [np.eye(3, 4, dtype=np.float32), xf2]
    host = _host(TB, TP, xforms)
    r = np.random.RandomState(13)
    o = np.stack([r.uniform(0.07, 0.23, 300), r.uniform(-0.23, 0.23, 300),
                  r.uniform(-0.23, 0.23, 300)], -1).astype(np.float32)
    d = r.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got, ref, occ, j_occ = _against_reference(_host(JB, JP, xforms), o, d)
    _assert_same(got, ref, occ, j_occ)
    own = TI.trace_closest(TI.build_instanced(host["instancing"], "cpu"),
                           _t(o), _t(d))
    assert np.array_equal(own.prim.numpy(), got.prim.numpy())
    # every prim found is of instance 0 (triangles 0-11); brute force
    # finds instance 1's nearer walls on the lanes leaving through them
    gp = got.prim.numpy()
    assert ((gp >= 0) & (gp < 12)).all()
    bf = np.asarray(bruteforce_closest(TriSoup.build(host["positions"],
                                                     host["indices"]),
                                       jnp.asarray(o), jnp.asarray(d)).prim)
    missed = bf != gp
    assert missed.sum() > 20 and (bf[missed] >= 12).all()
