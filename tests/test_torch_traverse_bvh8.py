"""Plain version of K5/K6 (rtxpt_tpu_torch/ops/traverse_bvh8.py) against the
reference's `_trace8` (rtxpt_tpu/ops/traverse.py), the loop the reference
runs off the TPU, on the reference's own BVH8 tables carried across with
`interop`, and the same seeded rays.

Tolerance: the same leaf slot (triangle) on every lane, misses bit-equal,
and t, u, v of hits within 4 float32 epsilons times the condition number
of their Möller–Trumbore evaluation (`mt_tolerance`). They are not
bit-equal: XLA on a CPU with FMA contracts the multiply-adds of the dot
and cross products (checked on single lanes against a numpy float32
evaluation with and without fused multiply-adds), while the port, like
its CUDA kernel, rounds every product. u and v are ratios of dot products
that cancel when a ray starts far from a small triangle, so a plain rtol
does not fit them: measured |du| reached 2.8e-5 on these rays, while
|diff| / (eps * condition) stayed below 0.68 for t, u and v over 14,700
hits of ten seeds."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rtxpt_tpu.ops import bvh as JB
from rtxpt_tpu.ops import bvh2l as JL
from rtxpt_tpu.ops import traverse as JT
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.ops import cuda_lib
from rtxpt_tpu_torch.ops import traverse_bvh8 as T8

N = 3000


@pytest.fixture(scope="module")
def city():
    host = JP.build_city(blocks=2).finish()
    pos, idx = host["positions"], host["indices"]
    jb = JB.collapse_bvh8(JB.build_bvh(pos, idx), pos, idx)
    return host, jb


def _rays(seed, n=N, half=6.0):
    r = np.random.RandomState(seed)
    o = np.stack([r.uniform(-half, half, n), r.uniform(0.5, 12.0, n),
                  r.uniform(-half, half, n)], -1).astype(np.float32)
    d = r.normal(size=(n, 3))
    d[:, 1] -= 0.6
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _ref(table, omm, o, d, t_max, active, any_hit):
    t, slot, uv, _ = JT._trace8(
        jnp.asarray(table), jnp.asarray(o), jnp.asarray(d),
        jnp.float32(0.0), jnp.asarray(t_max), jnp.asarray(active),
        leaf_size=16, any_hit=any_hit, leaf_omm=jnp.asarray(omm))
    return np.asarray(t), np.asarray(slot), np.asarray(uv)


def _port(bvh, o, d, t_max, active, any_hit):
    t, slot, uv = T8.trace_bvh8(
        bvh.table, bvh.leaf_omm, torch.as_tensor(o), torch.as_tensor(d),
        torch.as_tensor(t_max), torch.as_tensor(active), leaf_size=16,
        any_hit=any_hit)
    return t.numpy(), slot.numpy(), uv.numpy()


def mt_tolerance(o, d, tri, t, u, v, k=4.0):
    """Per-hit bounds on |dt|, |du|, |dv| between two float32 evaluations
    of Möller–Trumbore that round the same products differently: k
    epsilons times each quantity's condition number (sum of the
    magnitudes of the products behind it over |a|). o, d (M,3), tri (M,9)
    p0, e1, e2; all float64."""
    eps = float(np.finfo(np.float32).eps)
    e1, e2 = tri[:, 3:6], tri[:, 6:9]
    s = (o.astype(np.float32) - tri[:, 0:3].astype(np.float32)).astype(
        np.float64)

    def mag(a, b):          # |a_j b_k| + |a_k b_j| per cross component
        return np.stack([abs(a[:, 1] * b[:, 2]) + abs(a[:, 2] * b[:, 1]),
                         abs(a[:, 2] * b[:, 0]) + abs(a[:, 0] * b[:, 2]),
                         abs(a[:, 0] * b[:, 1]) + abs(a[:, 1] * b[:, 0])],
                        -1)

    h, q = np.cross(d, e2), np.cross(s, e1)
    hm, qm = mag(d, e2), mag(s, e1)
    a = abs(np.sum(e1 * h, -1))
    den = (np.sum(abs(e1) * hm, -1) + np.sum(abs(e1 * h), -1)) / a

    def cond(x, y, ym, val):
        return (np.sum(abs(x) * ym, -1) + np.sum(abs(x * y), -1)) / a \
            + abs(val) * den
    return (k * eps * cond(e2, q, qm, t), k * eps * cond(s, h, hm, u),
            k * eps * cond(d, q, qm, v))


def assert_hits_close(got, ref, tris_of, o, d):
    """Same slots; misses bit-equal; hits within `mt_tolerance`.
    tris_of(lanes, slots) -> (M,9) triangles of the hit slots."""
    (t, slot, uv), (jt, jslot, juv) = got, ref
    assert np.array_equal(slot, jslot)
    miss = slot < 0
    assert np.array_equal(t[miss], jt[miss])
    assert np.array_equal(uv[miss], juv[miss])
    hit = ~miss
    tri = tris_of(np.nonzero(hit)[0], slot[hit]).astype(np.float64)
    tol = mt_tolerance(o[hit].astype(np.float64),
                       d[hit].astype(np.float64), tri, t[hit], uv[hit, 0],
                       uv[hit, 1])
    for g, r, tl in zip((t[hit], uv[hit, 0], uv[hit, 1]),
                        (jt[hit], juv[hit, 0], juv[hit, 1]), tol):
        assert (abs(g.astype(np.float64) - r) <= tl).all()


def _tris(table):
    rows = np.asarray(table).reshape(-1, np.asarray(table).shape[-1])
    return lambda lanes, slots: rows[slots // 16].reshape(
        -1, 16, 9)[np.arange(slots.size), slots % 16]


@pytest.mark.parametrize("case", ["closest", "anyhit_tmax", "partly_active",
                                  "omm"])
def test_plain_matches_trace8(city, case):
    _, jb = city
    omm = np.asarray(jb.leaf_omm)
    if case == "omm":
        omm = np.random.RandomState(4).randint(
            0, 1 << 16, omm.shape).astype(np.int32)
    bvh = interop.bvh8_from_arrays(
        table=jb.table, leaf_tris=jb.leaf_tris, leaf_omm=omm,
        leaf_size=jb.leaf_size, num_nodes=jb.num_nodes, device="cpu")
    o, d = _rays(7)
    r = np.random.RandomState(8)
    t_max = np.full(N, 1e30, np.float32)
    active = np.ones(N, bool)
    any_hit = case == "anyhit_tmax"
    if any_hit:
        t_max = r.uniform(0.5, 15.0, N).astype(np.float32)
    if case == "partly_active":
        active = r.rand(N) < 0.6
    ref = _ref(jb.table, omm, o, d, t_max, active, any_hit)
    got = _port(bvh, o, d, t_max, active, any_hit)
    hits = ref[1] >= 0
    assert 0.2 < hits.mean() < 1.0
    assert_hits_close(got, ref, _tris(jb.table), o, d)
    if case == "partly_active":
        assert (got[1][~active] == -1).all()
        assert np.array_equal(got[0][~active], t_max[~active])


def test_stacked_tables_with_per_ray_subtree():
    """K6's plain version: each ray walks the subtree `sub` names, and
    returns that subtree's `_trace8` answer."""
    host = JP.build_programmer_art().finish()
    tl = JL.build_two_level(host["positions"], host["indices"], cap_tris=300)
    k = tl.num_subtrees
    assert k >= 8
    tables = np.asarray(tl.sub_tables)
    omms = np.asarray(tl.sub_leaf_omm)
    port = interop.two_level_from_arrays(
        sub_tables=tables, sub_leaf_tris=tl.sub_leaf_tris,
        sub_leaf_omm=omms, sub_aabb=tl.sub_aabb, leaf_size=tl.leaf_size,
        rows=tl.rows, device="cpu")
    r = np.random.RandomState(9)
    o = r.uniform(-4, 4, (N, 3)).astype(np.float32)
    o[:, 1] = r.uniform(0.2, 4.0, N)
    sub = r.randint(0, k, N).astype(np.int32)
    # aim each ray at a point of its own subtree's box
    box = np.asarray(tl.sub_aabb)[sub]
    d = box[:, 0:3] + r.rand(N, 3) * (box[:, 3:6] - box[:, 0:3]) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = np.full(N, 1e30, np.float32)
    active = r.rand(N) < 0.9
    ref_t = np.zeros(N, np.float32)
    ref_slot = np.zeros(N, np.int32)
    ref_uv = np.zeros((N, 2), np.float32)
    for s in range(k):
        m = sub == s
        t, slot, uv = _ref(tables[s], omms[s], o, d, t_max, active & m,
                           False)
        ref_t[m], ref_slot[m], ref_uv[m] = t[m], slot[m], uv[m]
    t, slot, uv = T8.trace_bvh8_sub(
        port.sub_tables, port.sub_leaf_omm, torch.as_tensor(sub),
        torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(t_max),
        torch.as_tensor(active), leaf_size=16, any_hit=False)
    assert (ref_slot >= 0).mean() > 0.3
    rows = tables.reshape(k * tl.rows, -1)
    assert_hits_close(
        (t.numpy(), slot.numpy(), uv.numpy()), (ref_t, ref_slot, ref_uv),
        lambda lanes, slots: rows[sub[lanes] * tl.rows + slots // 16]
        .reshape(-1, 16, 9)[np.arange(slots.size), slots % 16], o, d)


def test_cpu_takes_plain_version_and_counts_steps(city):
    _, jb = city
    bvh = interop.bvh8_from_arrays(
        table=jb.table, leaf_tris=jb.leaf_tris, leaf_omm=jb.leaf_omm,
        leaf_size=16, num_nodes=jb.num_nodes, device="cpu")
    o, d = (torch.as_tensor(a) for a in _rays(3, n=256))
    t_max = torch.full((256,), 1e30)
    act = torch.ones(256, dtype=torch.bool)
    cuda_lib.reset_launch_counts()
    got = T8.trace_bvh8(bvh.table, bvh.leaf_omm, o, d, t_max, act,
                        leaf_size=16, any_hit=False)
    assert cuda_lib.launch_counts()["bvh8_trace"] == 0
    stats = {}
    plain = T8.trace_bvh8_plain(bvh.table, bvh.leaf_omm, o, d, t_max, act,
                                leaf_size=16, any_hit=False, stats=stats)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    # every ray pops the root; leaves hold 1..16 triangles
    assert stats["node_rows"] >= 256
    assert stats["leaf_rows"] <= stats["leaf_tris"] \
        <= 16 * stats["leaf_rows"]
    # the root is one distinct row; no row is fetched fewer times than once
    assert 1 <= stats["distinct_node_rows"] <= min(stats["node_rows"],
                                                   bvh.num_nodes)
    assert 0 < stats["distinct_leaf_tris"] <= stats["leaf_tris"]


def test_other_devices_raise():
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    with pytest.raises(ValueError, match="meta"):
        T8.trace_bvh8(m(4, 144), m(64, dt=torch.int32), m(2, 3), m(2, 3),
                      m(2), m(2, dt=torch.bool), leaf_size=16, any_hit=False)
