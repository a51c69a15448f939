"""The port's BVH builds (rtxpt_tpu_torch/ops/bvh.py, csrc/bvh_builder.cpp)
and procedural city against the reference package's.

The reference builds its native BVH2 library with -march=native, which on
an FMA host contracts the SAH cost's multiply-adds; the port builds with
-ffp-contract=off so every machine gets the same tree. The two trees may
then differ in rare split choices, so the BVH2s are compared through
their closest hits, and `collapse_bvh8` is compared bit for bit on one
and the same BVH2."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rtxpt_tpu.ops import bvh as JB
from rtxpt_tpu.ops import traverse as JT
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch.ops import bvh as TB
from rtxpt_tpu_torch.ops import traverse_bvh8 as T8
from rtxpt_tpu_torch.scene import procedural as TP
from test_torch_traverse_bvh8 import mt_tolerance


def _city_rays(n, seed, blocks=3):
    """Rays from above the city's ground slab (blocks * 7 either side of
    the centre), heading down into it."""
    r = np.random.RandomState(seed)
    half = blocks * 3.0
    o = np.stack([r.uniform(-half, half, n), r.uniform(1.0, 12.0, n),
                  r.uniform(-half, half, n)], -1).astype(np.float32)
    d = r.normal(size=(n, 3))
    d[:, 1] = -np.abs(d[:, 1]) - 0.2
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _j2np(b2) -> TB.BVH2:
    return TB.BVH2(np.asarray(b2.child_bounds), np.asarray(b2.child_idx),
                   np.asarray(b2.order), b2.levels)


@pytest.fixture(scope="module")
def city3():
    return JP.build_city(blocks=3).finish()


def test_native_bvh_gives_reference_hits(city3):
    """Port BVH2 -> port BVH8 -> plain K5 against reference BVH2 -> BVH8 ->
    `_trace8`: the same triangle on every lane except where two triangles
    tie on t, and t within the float32 rounding bound of
    test_torch_traverse_bvh8 (XLA fuses multiply-adds in the
    Möller–Trumbore products, the port does not)."""
    pos, idx = city3["positions"], city3["indices"]
    tb = TB.collapse_bvh8(TB.build_bvh(pos, idx), pos, idx, device="cpu")
    jb = JB.collapse_bvh8(JB.build_bvh(pos, idx), pos, idx)
    o, d = _city_rays(4096, 5)
    n = o.shape[0]
    tmax = np.full(n, 1e30, np.float32)
    jt, jp, _, _ = JT._trace8(jb.table, jnp.asarray(o), jnp.asarray(d),
                              jnp.float32(0.0), jnp.asarray(tmax),
                              jnp.ones((n,), bool), leaf_size=16,
                              leaf_omm=jb.leaf_omm)
    jt, jp = np.asarray(jt), np.asarray(jp)
    jprim = np.where(jp >= 0, np.asarray(jb.leaf_tris)[np.maximum(jp, 0)],
                     -1)
    t, slot, uv = T8.trace_bvh8(tb.table, tb.leaf_omm, torch.as_tensor(o),
                                torch.as_tensor(d), torch.as_tensor(tmax),
                                torch.ones(n, dtype=torch.bool),
                                leaf_size=16, any_hit=False)
    t, slot, uv = t.numpy(), slot.numpy(), uv.numpy()
    prim = np.where(slot >= 0, tb.leaf_tris.numpy()[np.maximum(slot, 0)],
                    -1)
    hit = jprim >= 0
    assert hit.mean() > 0.5
    assert np.array_equal(prim >= 0, hit)
    assert np.array_equal(t[~hit], jt[~hit])
    p = pos[idx[prim[hit]]].astype(np.float64)
    tri = np.concatenate([p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], 1)
    tol_t, _, _ = mt_tolerance(o[hit].astype(np.float64),
                               d[hit].astype(np.float64), tri, t[hit],
                               uv[hit, 0], uv[hit, 1])
    assert (abs(t[hit].astype(np.float64) - jt[hit]) <= tol_t).all()
    assert (prim != jprim).mean() < 0.01


@pytest.mark.parametrize("scene", ["programmer-art", "city"])
def test_collapse_bvh8_bit_equal(scene, city3):
    """The same BVH2 collapses to the reference's table, leaf_tris and
    leaf_omm bit for bit (with a random opacity mask per triangle)."""
    host = city3 if scene == "city" else \
        JP.build_programmer_art().finish()
    pos, idx = host["positions"], host["indices"]
    omm = np.random.RandomState(2).randint(
        0, 1 << 16, idx.shape[0]).astype(np.int32)
    b2 = JB.build_bvh(pos, idx)
    ref = JB.collapse_bvh8(b2, pos, idx, tri_omm=omm)
    table, leaf_tris, leaf_omm, n_nodes = TB.collapse_bvh8_np(
        _j2np(b2), pos, idx, tri_omm=omm)
    assert n_nodes == ref.num_nodes
    assert table.shape == (np.asarray(ref.table).shape[0], 144)
    assert np.array_equal(table, np.asarray(ref.table))
    assert np.array_equal(leaf_tris, np.asarray(ref.leaf_tris))
    assert np.array_equal(leaf_omm, np.asarray(ref.leaf_omm))


def _chain_bvh2(n_tris: int) -> TB.BVH2:
    """A caterpillar BVH2: node i holds a 1-triangle leaf and node i+1, the
    last node two leaves; 8-wide collapse can flatten only 7 levels of it
    per BVH8 level."""
    n_nodes = n_tris - 1
    bounds = np.tile(np.asarray([0, 0, 0, 1, 1, 1] * 2, np.float32),
                     (n_nodes, 1))
    child = np.zeros((n_nodes, 2), np.int32)
    for i in range(n_nodes):
        child[i, 0] = TB.encode_leaf(i, 1)
        child[i, 1] = i + 1 if i + 1 < n_nodes else TB.encode_leaf(i + 1, 1)
    levels = tuple(np.asarray([i]) for i in range(n_nodes))
    return TB.BVH2(bounds, child, np.arange(n_tris, dtype=np.int32), levels)


def test_stack_depth_contract_raises_as_reference(monkeypatch):
    r = np.random.RandomState(0)
    pos = r.rand(3 * 120, 3).astype(np.float32)
    idx = np.arange(3 * 120, dtype=np.int32).reshape(120, 3)
    deep = _chain_bvh2(120)
    with pytest.raises(ValueError, match="needs stack"):
        JB.collapse_bvh8(deep, pos, idx)
    with pytest.raises(ValueError, match="needs stack"):
        TB.collapse_bvh8_np(deep, pos, idx)
    # a shallower chain passes both
    ok = _chain_bvh2(40)
    ref = JB.collapse_bvh8(ok, pos, idx[:40])
    table, *_ = TB.collapse_bvh8_np(ok, pos, idx[:40])
    assert np.array_equal(table, np.asarray(ref.table))


def test_code_range_contract_raises(monkeypatch):
    """Codes ride the table as f32 values, exact below 2^24: the port
    raises with the reference's message past that limit (lowered here so
    a small scene reaches it)."""
    host = JP.build_programmer_art().finish()
    pos, idx = host["positions"], host["indices"]
    b2 = _j2np(JB.build_bvh(pos, idx))
    assert TB.CODE_LIMIT == 1 << 24
    table, *_ = TB.collapse_bvh8_np(b2, pos, idx)
    # leaf codes of the table reach rows * 32 + count
    monkeypatch.setattr(TB, "CODE_LIMIT", table.shape[0] << 5)
    with pytest.raises(ValueError, match="not exactly representable"):
        TB.collapse_bvh8_np(b2, pos, idx)


@pytest.mark.parametrize("blocks", [2, 3])
def test_city_geometry_bit_equal(blocks):
    ref = JP.build_city(blocks=blocks).finish()
    got = TP.build_city(blocks=blocks).finish()
    for key in ("positions", "normals", "tangents", "uvs", "indices",
                "tri_mat", "tri_instance"):
        assert got[key].dtype == ref[key].dtype, key
        assert np.array_equal(got[key], ref[key]), key
    for key, val in ref["materials"].items():
        assert np.array_equal(np.asarray(got["materials"][key]),
                              np.asarray(val)), key
