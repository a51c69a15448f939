"""Refits after animation against the reference's, on the reference's own
tables carried across with `interop` and the same seeded deformations:

  * `refit_bvh8` (rtxpt_tpu_torch/scene/animation.py) on a reference
    BVH8: table bit-equal to rtxpt_tpu/scene/animation.py `refit_bvh8`'s
    (node bounds are mins and maxes, leaf rows differences of float32
    positions), its topology (ops/bvh.py `refit_topology`, read from the
    table's code columns) equal to the reference's `refit_info`, every
    leaf's triangles inside its parent slot's box;
  * the BVH2 `refit` (ops/bvh.py) bit-equal to the reference's `refit`;
  * `mt_dense.refresh_dense` on the reference's dense planes: cluster
    boxes and rows bit-equal to the reference's `refresh_dense`, slot
    order, padding, centre and opacity masks kept; the port's plain trace
    on the refreshed planes against the reference's kernel (interpret
    mode) on its refreshed planes, with tests/test_torch_mt_dense.py's
    tolerances;
  * `lights.refresh_pack` against the reference's `refresh_pack`, rtol
    1e-6 (a norm and a division in torch against XLA)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.ops import bvh as JB
from rtxpt_tpu.ops import mt_dense as JMT
from rtxpt_tpu.scene import animation as JA
from rtxpt_tpu.scene import lights as JL
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.ops import bvh as TB
from rtxpt_tpu_torch.ops import mt_dense as TMT
from rtxpt_tpu_torch.scene import animation as TA
from rtxpt_tpu_torch.scene import lights as TL


def _soup(seed, n_tris, spread=3.0):
    r = np.random.RandomState(seed)
    c = r.uniform(-spread, spread, (n_tris, 3))
    pos = np.concatenate([c + r.uniform(-0.3, 0.3, (n_tris, 3))
                          for _ in range(3)]).astype(np.float32)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T
    return pos, np.ascontiguousarray(idx)


def _deform(pos, seed):
    r = np.random.RandomState(seed)
    bend = np.stack([np.sin(pos[:, 1]), np.zeros(len(pos)),
                     np.cos(pos[:, 0])], -1) * 0.3
    return (pos + bend + r.normal(0, 0.02, pos.shape)).astype(np.float32)


@pytest.mark.parametrize("seed,n_tris", [(0, 3000), (1, 9)])
def test_refit_bvh8_bit_equal_to_reference(seed, n_tris):
    pos, idx = _soup(seed, n_tris)
    jb = JB.collapse_bvh8(JB.build_bvh(pos, idx), jnp.asarray(pos),
                          jnp.asarray(idx))
    tb = interop.accel_from_reference(jb, "cpu")
    codes, levels = TB.refit_topology(tb)
    assert np.array_equal(codes.numpy(), jb.refit_info["codes"])
    assert len(levels) == len(jb.refit_info["levels"])
    for g, r in zip(levels, jb.refit_info["levels"]):
        assert np.array_equal(np.sort(g.numpy()), np.sort(r))
    for k in range(2):          # a refit of a refitted table keeps going
        pos = _deform(pos, seed + 10 * k)
        jb = JA.refit_bvh8(jb, jnp.asarray(pos), jnp.asarray(idx))
        tb = TA.refit_bvh8(tb, torch.as_tensor(pos), torch.as_tensor(idx))
        assert np.array_equal(tb.table.numpy(), np.asarray(jb.table))
    # every leaf's triangles lie inside its parent slot's box
    table = tb.table.numpy()
    lt = tb.leaf_tris.numpy().reshape(table.shape[0], -1)
    for row in range(tb.num_nodes):
        for k, c in enumerate(table[row, 48:56].astype(np.int64)):
            if c >= -1:
                continue
            leaf = (-c - 1) >> 5
            pts = pos[idx[lt[leaf][lt[leaf] >= 0]]].reshape(-1, 3)
            box = table[row, 6 * k:6 * k + 6]
            assert (pts >= box[:3]).all() and (pts <= box[3:]).all()


def test_refit_bvh2_bit_equal_to_reference():
    pos, idx = _soup(2, 500)
    b2 = TB.build_bvh(pos, idx)
    new = _deform(pos, 3)
    ref = JB.refit(JB.BVH2(jnp.asarray(b2.child_bounds),
                           jnp.asarray(b2.child_idx), jnp.asarray(b2.order),
                           b2.levels), jnp.asarray(new), jnp.asarray(idx))
    got = TB.refit(b2, new, idx)
    assert np.array_equal(got.child_bounds, np.asarray(ref.child_bounds))
    assert got.child_idx is b2.child_idx and got.order is b2.order


@pytest.mark.parametrize("masked", [False, True])
def test_refresh_dense_matches_reference(masked):
    pos, idx = _soup(4, 300)
    n = idx.shape[0]
    omm = np.random.RandomState(5).randint(0, 0x10000, n).astype(np.int32) \
        if masked else None
    jd = JMT.build_dense(pos, idx, tri_omm=omm)
    td = interop.accel_from_reference(jd, "cpu")
    assert td.has_omm == masked
    new = _deform(pos, 6)
    jr = JMT.refresh_dense(jd, jnp.asarray(new), jnp.asarray(idx))
    tr = TMT.refresh_dense(td, torch.as_tensor(new), torch.as_tensor(idx))
    assert np.array_equal(tr.aabb.numpy(), np.asarray(jr.aabb))
    assert np.array_equal(tr.tri9.numpy(), np.asarray(jr.tri9))
    # slot order, padding, centre and masks kept
    assert torch.equal(tr.tri9[:, 9], td.tri9[:, 9])
    assert torch.equal(tr.center, td.center)
    assert tr.num_clusters == td.num_clusters
    if masked:
        assert torch.equal(tr.omm, td.omm)
        assert torch.equal(TMT.omm_from_tri12(tr.tri12), td.omm)
    else:
        assert tr.omm is None and not TMT.has_masks(tr.tri12)
    # traces on the refreshed planes against the reference's kernel
    r = np.random.RandomState(7)
    o = r.uniform(-6, 6, (513, 3)).astype(np.float32)
    aim = new[idx[r.randint(0, n, 513)]].mean(1)        # at triangles
    d = (aim + r.normal(0, 0.2, aim.shape) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jk = JMT.trace_closest(jr, jnp.asarray(o), jnp.asarray(d),
                           interpret=True)
    got = TMT.trace_closest(tr, torch.as_tensor(o), torch.as_tensor(d))
    kp, gp = np.asarray(jk.prim), got.prim.numpy()
    assert (gp >= 0).sum() > 50
    assert ((kp >= 0) == (gp >= 0)).mean() > 0.995
    both = (kp >= 0) & (gp >= 0)
    assert (kp == gp)[both].mean() > 0.99
    same = both & (kp == gp)
    np.testing.assert_allclose(got.t.numpy()[same], np.asarray(jk.t)[same],
                               rtol=1e-3, atol=1e-4)
    j_occ = np.asarray(JMT.trace_anyhit(jr, jnp.asarray(o), jnp.asarray(d),
                                        interpret=True))
    occ = TMT.trace_anyhit(tr, torch.as_tensor(o), torch.as_tensor(d))
    assert (occ.numpy() == j_occ).mean() > 0.995


def test_refresh_pack_matches_reference():
    host = JP.build_programmer_art().finish()
    analytic = [dict(kind=JL.LIGHT_POINT, position=(0.5, 2.0, 0.5),
                     radiance=(3.0, 2.0, 1.0)),
                dict(kind=JL.LIGHT_SPHERE, position=(-1.0, 2.0, 0.0),
                     radiance=(1.0, 1.0, 1.0), radius=0.2)]
    jl = JL.build_light_table(host, analytic)
    tl = interop.lights_from_arrays(pack=jl.pack, cdf=jl.cdf,
                                    total_power=jl.total_power, tri=jl.tri,
                                    device="cpu")
    new = _deform(host["positions"], 8)
    ref = JL.refresh_pack(jl, jnp.asarray(new), jnp.asarray(host["indices"]))
    got = TL.refresh_pack(tl, torch.as_tensor(new),
                          torch.as_tensor(host["indices"]))
    np.testing.assert_allclose(got.pack.numpy(), np.asarray(ref.pack),
                               rtol=1e-6, atol=1e-7)
    assert not np.allclose(got.pack.numpy(), np.asarray(jl.pack))
    assert torch.equal(got.cdf, tl.cdf)
    # the port's own build keeps the triangle ids refresh_pack reads
    from rtxpt_tpu_torch.scene import procedural as TP
    own = TL.build_light_table(TP.build_programmer_art().finish(), analytic,
                               device="cpu")
    assert np.array_equal(own.tri.numpy(), np.asarray(jl.tri))
    assert TL.refresh_pack(None, None, None) is None
