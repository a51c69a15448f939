"""The visit order of the port's two-level trace, and its one-launch
wrapper on the CPU (rtxpt_tpu_torch/ops/bvh2l.py trace_two_level_plain,
ops/traverse_bvh8.py trace_bvh8_2l).

On the scene of tests/two_level_tie.py (one triangle duplicated in
several subtrees, K >= 8) every copy lies at the same t, so the copy a ray
returns shows which subtree it walked first: its nearest overlapped
subtree, then the lowest index. The JAX package's XLA two-level path
(`RTXPT_BVH2L_INTERPRET` unset: rtxpt_tpu/ops/bvh2l.py, the masked probe
then the sweep) visits in the same order, so it must return the same
copy on every lane; t/u/v agree within `mt_tolerance` of
tests/test_torch_traverse_bvh8.py, since XLA contracts the
multiply-adds. A separate file because tests/test_torch_bvh2l.py sets
`RTXPT_BVH2L_INTERPRET=1` for its whole module."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import two_level_tie as TIE
from rtxpt_tpu.ops import bvh2l as JL
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.ops import bvh2l as TL
from rtxpt_tpu_torch.ops import cuda_lib
from rtxpt_tpu_torch.ops import traverse_bvh8 as T8
from test_torch_traverse_bvh8 import mt_tolerance


@pytest.fixture(scope="module")
def tie():
    pos, idx = TIE.scene()
    ref = JL.build_two_level(pos, idx, cap_tris=TIE.CAP_TRIS)
    port = {"carried": interop.accel_from_reference(ref, device="cpu"),
            "own": TL.build_two_level(pos, idx, cap_tris=TIE.CAP_TRIS,
                                      device="cpu")}
    return pos, idx, ref, port


@pytest.mark.parametrize("which", ["carried", "own"])
def test_tie_goes_to_nearest_subtree_then_lowest_index(tie, which):
    *_, port = tie
    tl = port[which]
    assert tl.num_subtrees >= TL.PROBE_MIN_SUBTREES
    o, d = TIE.rays()
    sub, near_first, lowest_first = TIE.expected(tl, o, d)
    # both rules decide some lanes, so the order is really tested
    assert near_first.sum() > 50 and lowest_first.sum() > 50
    h = TL.trace_two_level_plain(tl, torch.as_tensor(o), torch.as_tensor(d),
                                 any_hit=False)
    got = TIE.subtree_of(tl, h.prim.numpy())
    copy = got >= 0
    assert copy.mean() > 0.99
    assert np.array_equal(got[copy], sub[copy])


@pytest.mark.parametrize("any_hit", [False, True])
def test_tie_matches_reference_xla_path(tie, monkeypatch, any_hit):
    monkeypatch.delenv("RTXPT_BVH2L_INTERPRET", raising=False)
    pos, idx, ref, port = tie
    o, d = TIE.rays(seed=2)
    act = np.arange(o.shape[0]) % 9 != 0
    args = (torch.as_tensor(o), torch.as_tensor(d))
    if any_hit:
        t_max = np.random.default_rng(4).uniform(3, 12, o.shape[0]).astype(
            np.float32)
        occ_ref = np.asarray(JL.trace_anyhit(
            ref, jnp.asarray(o), jnp.asarray(d), t_max=jnp.asarray(t_max),
            active=jnp.asarray(act)))
        occ = TL.trace_two_level_plain(port["carried"], *args,
                                       torch.as_tensor(t_max),
                                       torch.as_tensor(act), any_hit=True)
        assert 0.2 < occ_ref.mean() < 0.9
        assert np.array_equal(occ.numpy(), occ_ref)
        return
    h_ref = JL.trace_closest(ref, jnp.asarray(o), jnp.asarray(d),
                             active=jnp.asarray(act))
    h = TL.trace_two_level_plain(port["carried"], *args,
                                 active=torch.as_tensor(act), any_hit=False)
    pr, pg = np.asarray(h_ref.prim), h.prim.numpy()
    assert np.array_equal(pg, pr)
    assert (TIE.subtree_of(port["carried"], pg) >= 0)[act].mean() > 0.99
    miss = pg < 0
    assert np.array_equal(h.t.numpy()[miss], np.asarray(h_ref.t)[miss])
    hit = ~miss
    p = pos[idx[pg[hit]]].astype(np.float64)
    tri = np.concatenate([p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], 1)
    t, uv = h.t.numpy()[hit], h.bary.numpy()[hit]
    tol = mt_tolerance(o[hit].astype(np.float64), d[hit].astype(np.float64),
                       tri, t, uv[:, 0], uv[:, 1])
    for g, r, bound in zip((t, uv[:, 0], uv[:, 1]),
                           (np.asarray(h_ref.t)[hit],
                            np.asarray(h_ref.bary)[hit, 0],
                            np.asarray(h_ref.bary)[hit, 1]), tol):
        assert (abs(g.astype(np.float64) - r) <= bound).all()


@pytest.mark.parametrize("any_hit", [False, True])
def test_one_launch_wrapper_takes_plain_version_on_cpu(tie, any_hit):
    *_, port = tie
    tl = port["own"]
    o, d = (torch.as_tensor(a) for a in TIE.rays(n=512, seed=5))
    t_max = torch.full((512,), 9.0)
    act = torch.arange(512) % 4 != 0
    cuda_lib.reset_launch_counts()
    got = T8.trace_bvh8_2l(tl, o, d, t_max, act, any_hit=any_hit)
    assert cuda_lib.launch_counts()["bvh8_trace_2l"] == 0
    ref = TL.trace_two_level_plain(tl, o, d, t_max, act, any_hit=any_hit)
    if any_hit:
        assert got.dtype == torch.bool and torch.equal(got, ref)
        assert not got[~act].any()
    else:
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert (got.prim[~act] == -1).all()


def _replace(tl, **fields):
    return TL.BVH8TwoLevel(**{**tl.__dict__, **fields})


@pytest.mark.parametrize("bad", ["tables_f64", "aabb_shape", "tris_dtype",
                                 "rays_shape", "width", "too_many"])
def test_one_launch_wrapper_rejects_bad_arguments(tie, bad):
    """The checks `launch_two_level` makes before any launch (it raises
    on these CPU tensors before reaching the kernel library)."""
    *_, port = tie
    tl = port["own"]
    n = 64
    o, d = torch.zeros((n, 3)), torch.ones((n, 3))
    t_max, act = torch.ones(n), torch.ones(n, dtype=torch.bool)
    if bad == "tables_f64":
        tl = _replace(tl, sub_tables=tl.sub_tables.double())
    elif bad == "aabb_shape":
        tl = _replace(tl, sub_aabb=tl.sub_aabb[:, :5].contiguous())
    elif bad == "tris_dtype":
        tl = _replace(tl, sub_leaf_tris=tl.sub_leaf_tris.long())
    elif bad == "rays_shape":
        d = torch.ones((n + 1, 3))
    elif bad == "width":
        tl = _replace(tl, sub_tables=tl.sub_tables[..., :142].contiguous())
    else:
        k = T8.MAX_SUBTREES + 1
        tl = _replace(tl, sub_tables=torch.zeros((k, 1, 144)),
                      sub_leaf_omm=torch.zeros((k, 16), dtype=torch.int32),
                      sub_leaf_tris=torch.zeros((k, 16), dtype=torch.int32),
                      sub_aabb=torch.zeros((k, 6)), rows=1)
    with pytest.raises((TypeError, ValueError)):
        T8.launch_two_level("rtxpt_bvh8_trace_2l", "bvh8_trace_2l", tl, o, d,
                            t_max, act, False)
    m = lambda *s, dt=torch.float32: torch.empty(s, dtype=dt, device="meta")
    with pytest.raises(ValueError, match="meta"):
        T8.trace_bvh8_2l(_replace(port["own"], sub_aabb=m(
            port["own"].num_subtrees, 6)), m(2, 3), m(2, 3), m(2),
            m(2, dt=torch.bool), any_hit=False)
