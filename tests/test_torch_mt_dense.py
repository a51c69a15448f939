"""Dense trace (rtxpt_tpu_torch/ops/mt_dense.py, plain version of K1)
against the reference: its Pallas kernel in interpret mode and its
brute-force oracle, with the tolerances of tests/test_mt_dense.py. The
port selects the winner exactly (smallest t, ties to the lowest slot),
so it agrees with the brute-force oracle at least as well as the
reference kernel does."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.ops import mt_dense as JMT
from rtxpt_tpu.ops.intersect import TriSoup, bruteforce_closest
from rtxpt_tpu_torch.ops import cuda_lib, traverse
from rtxpt_tpu_torch.ops import mt_dense as TMT


def _random_scene(seed, n_tris=300, spread=4.0):
    r = np.random.RandomState(seed)
    centers = r.uniform(-spread, spread, (n_tris, 3))
    v0 = centers + r.uniform(-0.4, 0.4, (n_tris, 3))
    v1 = centers + r.uniform(-0.4, 0.4, (n_tris, 3))
    v2 = centers + r.uniform(-0.4, 0.4, (n_tris, 3))
    positions = np.concatenate([v0, v1, v2]).astype(np.float32)
    indices = np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T
    return positions, indices


def _random_rays(seed, n=257, spread=4.0):
    r = np.random.RandomState(seed)
    o = r.uniform(-2 * spread, 2 * spread, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("seed", [3, 11])
def test_closest_matches_reference_kernel_and_oracle(seed):
    positions, indices = _random_scene(seed)
    o, d = _random_rays(seed + 4, n=513)
    ref = bruteforce_closest(TriSoup.build(positions, indices),
                             jnp.asarray(o), jnp.asarray(d))
    jk = JMT.trace_closest(JMT.build_dense(positions, indices),
                           jnp.asarray(o), jnp.asarray(d), interpret=True)
    got = TMT.trace_closest(TMT.build_dense(positions, indices, device="cpu"),
                            torch.as_tensor(o), torch.as_tensor(d))
    rp, gp, kp = np.asarray(ref.prim), got.prim.numpy(), np.asarray(jk.prim)
    for other in (rp, kp):
        hit_match = (other >= 0) == (gp >= 0)
        assert hit_match.mean() > 0.995
        both = hit_match & (other >= 0)
        same = both & (other == gp)
        assert same.sum() > 0.9 * both.sum()
    ref_t, got_t = np.asarray(ref.t), got.t.numpy()
    both = (rp >= 0) & (gp >= 0)
    assert np.allclose(ref_t[both], got_t[both], rtol=1e-3, atol=1e-4)
    same = both & (rp == gp)
    assert np.allclose(np.asarray(ref.bary)[same], got.bary.numpy()[same],
                       atol=2e-3)
    # misses keep t_max, as the reference reports
    assert np.all(got_t[gp < 0] == np.float32(1e30))


def test_anyhit_and_tmax():
    positions, indices = _random_scene(11)
    dmt = TMT.build_dense(positions, indices, device="cpu")
    o, d = _random_rays(13)
    ref = bruteforce_closest(TriSoup.build(positions, indices),
                             jnp.asarray(o), jnp.asarray(d))
    has = np.asarray(ref.prim) >= 0
    t_ref = np.asarray(ref.t)
    t_far = np.where(has, t_ref + 1.0, 1e6).astype(np.float32)
    t_near = np.maximum(t_ref - 0.5, 1e-3).astype(np.float32)
    occ_far = TMT.trace_anyhit(dmt, torch.as_tensor(o), torch.as_tensor(d),
                               t_max=torch.as_tensor(t_far)).numpy()
    occ_near = TMT.trace_anyhit(dmt, torch.as_tensor(o), torch.as_tensor(d),
                                t_max=torch.as_tensor(t_near)).numpy()
    j_far = np.asarray(JMT.trace_anyhit(
        JMT.build_dense(positions, indices), jnp.asarray(o), jnp.asarray(d),
        t_max=jnp.asarray(t_far), interpret=True))
    assert (occ_far[has]).mean() > 0.99
    assert (occ_far == j_far).mean() > 0.995
    assert (~occ_near[has] | occ_far[has]).all()
    assert (occ_near[has]).mean() < 0.25


def test_active_mask_and_padding():
    positions, indices = _random_scene(17, n_tris=70)   # forces padding
    dmt = TMT.build_dense(positions, indices, device="cpu")
    assert dmt.num_clusters == 2
    o, d = _random_rays(19, n=64)
    act = torch.as_tensor((np.arange(64) % 2) == 0)
    got = TMT.trace_closest(dmt, torch.as_tensor(o), torch.as_tensor(d),
                            active=act)
    assert (got.prim.numpy()[~act.numpy()] == -1).all()
    assert not TMT.trace_anyhit(dmt, torch.as_tensor(o), torch.as_tensor(d),
                                active=act).numpy()[~act.numpy()].any()


def test_plain_chunking_is_seamless(monkeypatch):
    positions, indices = _random_scene(23)
    dmt = TMT.build_dense(positions, indices, device="cpu")
    o, d = _random_rays(29, n=300)
    whole = TMT.trace_closest(dmt, torch.as_tensor(o), torch.as_tensor(d))
    monkeypatch.setattr(TMT, "_PLAIN_CHUNK", 64)
    chunked = TMT.trace_closest(dmt, torch.as_tensor(o), torch.as_tensor(d))
    assert torch.equal(whole.prim, chunked.prim)
    assert torch.equal(whole.t, chunked.t)


def test_ties_go_to_the_lowest_slot():
    """Two coincident triangles: the winner is the lower tri9 slot."""
    tri = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    positions = np.concatenate([tri, tri]).astype(np.float32)
    indices = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    dmt = TMT.build_dense(positions, indices, device="cpu")
    o = torch.tensor([[0.2, 0.2, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    t, slot = TMT.trace_dense(dmt.aabb_c, dmt.tri12,
                              o - dmt.center[None], d, torch.tensor([1e30]),
                              torch.tensor([True]), any_hit=False)
    assert slot.item() == 0 and t.item() == pytest.approx(1.0)


def test_dispatch_needs_dense_planes_and_counts_no_cpu_launch():
    positions, indices = _random_scene(31, n_tris=20)
    dmt = TMT.build_dense(positions, indices, device="cpu")
    o, d = _random_rays(37, n=16)
    cuda_lib.reset_launch_counts()
    traverse.trace_closest(dmt, torch.as_tensor(o), torch.as_tensor(d))
    assert cuda_lib.launch_counts()["mt_dense"] == 0
    # no trace structure: no trace path
    with pytest.raises(TypeError):
        traverse.trace_anyhit(None, torch.as_tensor(o), torch.as_tensor(d))
