"""Per-tile cluster worklists of the dense trace (rtxpt_tpu_torch/ops/
mt_dense.py: the plain version of the prepass K7, the interval prepass,
and the plain K1 walking the worklists) against the reference's
prepasses (`_tile_worklists_exact`, `_tile_worklists_pallas` in interpret
mode, `_tile_worklists_interval`) and its dense trace, on seeded rays
through the programmer-art dense table. Counts and orders must be equal:
the keys are min-reductions of the same float32 slab tests."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.ops import mt_dense as JMT
from rtxpt_tpu_torch.ops import mt_dense as TMT
from rtxpt_tpu_torch.scene import procedural

N = 2000            # two reference tiles of 1024, the second one partial


@pytest.fixture(scope="module")
def art():
    host = procedural.build_programmer_art().finish()
    pos, idx = host["positions"], host["indices"]
    return (JMT.build_dense(pos, idx),
            TMT.build_dense(pos, idx, device="cpu"))


def _rays(aabb, seed, n=N):
    """Origins over the scene (a quarter at cluster centers: inside a box,
    negative keys), unit directions with some zero components (+0.0 and
    -0.0), finite and infinite t_max, 15% inactive lanes."""
    r = np.random.RandomState(seed)
    lo, hi = aabb[:, 0:3].min(0), aabb[:, 3:6].max(0)
    o = r.uniform(lo - 1.0, hi + 1.0, (n, 3))
    inside = r.rand(n) < 0.25
    c = r.randint(0, aabb.shape[0], n)
    o[inside] = 0.5 * (aabb[c, 0:3] + aabb[c, 3:6])[inside]
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    zero = r.rand(n, 3) < 0.1
    d[zero] = np.where(r.rand(int(zero.sum())) < 0.5, 0.0, -0.0)
    tmax = np.where(r.rand(n) < 0.5, 1e30, r.uniform(0.5, 12.0, n))
    act = r.rand(n) < 0.85
    return (o.astype(np.float32), d.astype(np.float32),
            tmax.astype(np.float32), act)


def _padded(o, d, tmax, act, tile=1024):
    """The padding of the reference's `_trace_dense`."""
    pad = -o.shape[0] % tile
    return (jnp.pad(jnp.asarray(o), ((0, pad), (0, 0))),
            jnp.pad(jnp.asarray(d), ((0, pad), (0, 0)), constant_values=1.0),
            jnp.pad(jnp.asarray(tmax), (0, pad)),
            jnp.pad(jnp.asarray(act), (0, pad)))


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


def _lists(counts, order):
    counts, order = np.asarray(counts), np.asarray(order)
    return [set(order[t, :counts[t]].tolist()) for t in range(len(counts))]


def test_worklists_match_reference_prepasses(art):
    """World-frame inputs at tile 1024: counts and order equal the
    reference's exact prepass and its Pallas prepass (interpret mode)."""
    jd, td = art
    nc = jd.num_clusters
    rays = _rays(np.asarray(jd.aabb), 1)
    counts, order = TMT.tile_worklists(td.aabb, *_t(*rays), tile=1024)
    keys = TMT.tile_keys_plain(td.aabb, *_t(*rays), tile=1024)
    assert keys.shape == (2, nc)
    assert (keys < 0).any(), "no origin inside a box: no negative key"
    for ref in (JMT._tile_worklists_exact(jd.aabb, *_padded(*rays), nc=nc),
                JMT._tile_worklists_pallas(jd.aabb, *_padded(*rays), nc=nc,
                                           interpret=True)):
        assert np.array_equal(counts.numpy(), np.asarray(ref[0]))
        assert np.array_equal(order.numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("tile", [128, 1024])
def test_interval_worklists_match_reference_and_contain_exact(art, tile):
    """tile_worklists_interval equals `_tile_worklists_interval` (at the
    reference's tile, 1024) and admits every cluster of the exact lists
    (the port's copy of tests/test_mt_dense.py::
    test_tile_worklists_conservative_superset); the plain K1 walking
    either gives the same hits."""
    jd, td = art
    rays = _rays(np.asarray(jd.aabb), 2)
    got = TMT.tile_worklists_interval(td.aabb, *_t(*rays), tile=tile)
    if tile == 1024:
        ref = JMT._tile_worklists_interval(jd.aabb, *_padded(*rays),
                                           nc=jd.num_clusters)
        assert np.array_equal(got[0].numpy(), np.asarray(ref[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    exact = TMT.tile_worklists(td.aabb, *_t(*rays), tile=tile)
    for t, (ex, cv) in enumerate(zip(_lists(*exact), _lists(*got))):
        assert ex <= cv, f"tile {t} dropped {ex - cv}"
    o, d, tmax, act = _t(*rays)
    o_c = o - td.center
    wl = TMT.tile_worklists(td.aabb_c, o_c, d, tmax, act, tile=tile)
    a = TMT.trace_dense_plain(td.aabb_c, td.tri9, o_c, d, tmax, act, False,
                              wl, tile)
    b = TMT.trace_dense_plain(td.aabb_c, td.tri9, o_c, d, tmax, act, False,
                              TMT.tile_worklists_interval(
                                  td.aabb_c, o_c, d, tmax, act, tile), tile)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("tile", [128, 1024])
@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_trace_with_worklists_keeps_winners(art, tile, any_hit):
    """The plain K1 restricted to its tiles' worklists gives the same
    (t, slot) as over all clusters; its closest hits agree with the
    reference's dense trace (interpret mode; the reference selects on a
    quantized t, hence the agreement thresholds of
    tests/test_torch_mt_dense.py)."""
    jd, td = art
    o, d, tmax, act = _rays(np.asarray(jd.aabb), 3)
    ot, dt, tt, at = _t(o, d, tmax, act)
    o_c = ot - td.center
    wl = TMT.tile_worklists(td.aabb_c, o_c, dt, tt, at, tile=tile)
    # random rays: at tile 1024 every list holds all 81 clusters
    assert tile == 1024 or (wl[0] < td.num_clusters).any()
    args = (td.aabb_c, td.tri9, o_c, dt, tt, at, any_hit)
    t_all, s_all = TMT.trace_dense_plain(*args)
    t_wl, s_wl = TMT.trace_dense_plain(*args, wl, tile)
    assert torch.equal(t_all, t_wl) and torch.equal(s_all, s_wl)
    if any_hit or tile != 1024:
        return
    hit = TMT.trace_closest(td, ot, dt, t_max=tt, active=at)
    ref = JMT.trace_closest(jd, jnp.asarray(o), jnp.asarray(d),
                            t_max=jnp.asarray(tmax), active=jnp.asarray(act),
                            interpret=True)
    rp, gp = np.asarray(ref.prim), hit.prim.numpy()
    assert ((rp >= 0) == (gp >= 0)).mean() > 0.995
    both = (rp >= 0) & (gp >= 0)
    assert (rp == gp)[both].mean() > 0.99
    assert np.allclose(np.asarray(ref.t)[both], hit.t.numpy()[both],
                       rtol=1e-3, atol=1e-4)


def test_worklist_order_and_tie_rule():
    """Two clusters whose coincident triangles tie at t = 1: the nearer
    box (cluster 1) comes first on the worklist, and the winner is still
    the lower slot (0), as on the card (tests/test_torch_cuda.py)."""
    aabb_c, tri9 = tie_tables()
    o = torch.tensor([[0.2, 0.2, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    tmax, act = torch.tensor([1e30]), torch.tensor([True])
    counts, order = TMT.tile_worklists(aabb_c, o, d, tmax, act)
    assert counts.tolist() == [2] and order[0, :2].tolist() == [1, 0]
    t, slot = TMT.trace_dense(aabb_c, tri9, o, d, tmax, act, any_hit=False)
    assert slot.tolist() == [0] and t.tolist() == [1.0]


def tie_tables(device="cpu"):
    """Recentered tables of two clusters: slot 0 and slot 64 hold the
    same triangle in the plane z = 0; cluster 0's box reaches down to
    z = -5, cluster 1's up to z = 0.5, so a ray down from z = 1 enters
    cluster 1 first."""
    tri9 = torch.zeros((2 * TMT.CLUSTER, 10))
    tri9[:, 9] = -1.0
    tri = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    tri9[0, 0:9] = tri9[TMT.CLUSTER, 0:9] = tri
    tri9[0, 9], tri9[TMT.CLUSTER, 9] = 0.0, 1.0
    aabb_c = torch.tensor([[-1.0, -1.0, -5.0, 1.0, 1.0, 0.0],
                           [-1.0, -1.0, 0.0, 1.0, 1.0, 0.5]])
    return aabb_c.to(device), tri9.to(device)
