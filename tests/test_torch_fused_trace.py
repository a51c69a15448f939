"""The fused dense trace (rtxpt_tpu_torch/ops/mt_dense.py
`trace_dense_fused`) on the CPU: its row table `tri12`, its wrapper's
dispatch and checks, and the worklists its kernel builds for its tiles
of TILE lanes (`tile_worklists`) when few of the lanes are active: the
plain trace walking them keeps the winners of the trace over all
clusters, and both agree with the reference's dense trace (its Pallas
kernel in interpret mode) at 5% and 50% active lanes, with the
tolerances of tests/test_torch_mt_dense.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtxpt_tpu.ops import mt_dense as JMT
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.ops import cuda_lib
from rtxpt_tpu_torch.ops import mt_dense as TMT
from rtxpt_tpu_torch.scene import procedural


def _scene(seed, n_tris=300, spread=4.0):
    r = np.random.RandomState(seed)
    c = r.uniform(-spread, spread, (n_tris, 3))
    pos = np.concatenate([c + r.uniform(-0.4, 0.4, (n_tris, 3))
                          for _ in range(3)]).astype(np.float32)
    return pos, np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T


def _rays(seed, n, share, spread=4.0):
    """A fan of rays from in front of the scene whose direction turns
    with the lane index (nearby lanes are coherent, as a camera's are),
    origins jittered, finite and infinite t_max, a share `share` of the
    lanes active."""
    r = np.random.RandomState(seed)
    o = np.array([0.0, 0.0, -3.0 * spread]) + r.uniform(-0.5, 0.5, (n, 3))
    yaw = np.linspace(-0.6, 0.6, n) + r.uniform(-0.02, 0.02, n)
    pitch = r.uniform(-0.4, 0.4, n)
    d = np.stack([np.sin(yaw) * np.cos(pitch), np.sin(pitch),
                  np.cos(yaw) * np.cos(pitch)], -1)
    o, d = o.astype(np.float32), d.astype(np.float32)
    tmax = np.where(r.rand(n) < 0.5, 1e30, r.uniform(2, 12, n))
    return o, d, tmax.astype(np.float32), r.rand(n) < share


def test_tri12_holds_tri9_rows_bit_for_bit():
    """p0 + id, e1 + 0, e2 + 0 (three 16-byte vectors a row), on the
    programmer-art table and on one rebuilt from the reference's arrays;
    tri9_from_tri12 gives tri9 back."""
    host = procedural.build_programmer_art().finish()
    dmt = TMT.build_dense(host["positions"], host["indices"], device="cpu")
    jd = JMT.build_dense(host["positions"], host["indices"])
    via = interop.dense_from_arrays(
        aabb=np.asarray(jd.aabb), tri9=np.asarray(jd.tri9),
        center=np.asarray(jd.center), num_clusters=jd.num_clusters,
        device="cpu")
    for d in (dmt, via):
        t9, t12 = d.tri9.view(torch.int32), d.tri12.view(torch.int32)
        assert t12.shape == (d.num_clusters * TMT.CLUSTER, 12)
        assert d.tri12.is_contiguous()
        assert torch.equal(t12[:, 0:3], t9[:, 0:3])
        assert torch.equal(t12[:, 3], t9[:, 9])
        assert torch.equal(t12[:, 4:7], t9[:, 3:6])
        assert torch.equal(t12[:, 8:11], t9[:, 6:9])
        assert (t12[:, 7] == 0).all() and (t12[:, 11] == 0).all()
        assert torch.equal(TMT.tri9_from_tri12(d.tri12).view(torch.int32),
                           t9)
    # padding rows: zero edges, id -1
    assert (dmt.tri12[-1, 3] == -1.0) and (dmt.tri12[-1, 4:] == 0).all()


def test_fused_wrapper_takes_plain_on_cpu_and_checks_arguments():
    pos, idx = _scene(5)
    dmt = TMT.build_dense(pos, idx, device="cpu")
    o, d, tmax, act = (torch.as_tensor(a) for a in _rays(6, 300, 0.5))
    args = (dmt.aabb_c, dmt.tri12, o - dmt.center, d, tmax, act)
    cuda_lib.reset_launch_counts()
    t, slot = TMT.trace_dense_fused(*args, any_hit=False)
    assert sum(cuda_lib.launch_counts().values()) == 0
    t_p, s_p = TMT.trace_dense_plain(args[0], dmt.tri9, *args[2:],
                                     any_hit=False)
    assert torch.equal(slot, s_p) and torch.equal(t, t_p)
    assert (slot[act] >= 0).any() and (slot[~act] == -1).all()
    bad = [(TypeError, 4, tmax.double()),          # dtype
           (ValueError, 1, dmt.tri9),               # shape: tri9's
           (ValueError, 3, d[:, :2].contiguous()),  # shape
           (ValueError, 2, args[2].T.contiguous().T),   # layout
           (ValueError, 5, torch.empty(300, dtype=torch.bool,
                                       device="meta"))]   # device mix
    for err, i, arg in bad:
        with pytest.raises(err):
            TMT.trace_dense_fused(*args[:i], arg, *args[i + 1:],
                                  any_hit=True)


@pytest.mark.parametrize("share", [0.05, 0.5])
@pytest.mark.parametrize("any_hit", [False, True])
def test_active_tiles_keep_winners_and_match_reference(share, any_hit):
    pos, idx = _scene(7, n_tris=2000)
    n = 6000                # 47 tiles, the last one partial
    o, d, tmax, act = _rays(11, n, share)
    dmt = TMT.build_dense(pos, idx, device="cpu")
    o_c = torch.as_tensor(o) - dmt.center
    dt, tt, at = (torch.as_tensor(a) for a in (d, tmax, act))
    counts, order = TMT.tile_worklists(dmt.aabb_c, o_c, dt, tt, at)
    tiles = (n + TMT.TILE - 1) // TMT.TILE
    assert counts.shape == (tiles,) and order.shape == (tiles,
                                                        dmt.num_clusters)
    assert (counts > 0).any() and (counts < dmt.num_clusters).any()
    busy = torch.zeros(tiles, dtype=torch.bool)
    busy[torch.nonzero(at)[:, 0] // TMT.TILE] = True
    assert (counts[~busy] == 0).all()   # no active lane: an empty list
    t_w, s_w = TMT.trace_dense_plain(dmt.aabb_c, dmt.tri9, o_c, dt, tt, at,
                                     any_hit, (counts, order))
    t_all, s_all = TMT.trace_dense_plain(dmt.aabb_c, dmt.tri9, o_c, dt, tt,
                                         at, any_hit)
    assert (s_all[~at] == -1).all() and (s_all[at] >= 0).any()
    assert torch.equal(s_w >= 0, s_all >= 0)
    jd = JMT.build_dense(pos, idx)
    ja = (jd, jnp.asarray(o), jnp.asarray(d))
    jkw = dict(t_max=jnp.asarray(tmax), active=jnp.asarray(act),
               interpret=True)
    if any_hit:
        ref = np.asarray(JMT.trace_anyhit(*ja, **jkw))
        got = (s_all >= 0).numpy()
        assert (got == ref).mean() > 0.995
        assert not got[~act].any()
        return
    assert torch.equal(s_w, s_all) and torch.equal(t_w, t_all)
    ref = JMT.trace_closest(*ja, **jkw)
    hit = TMT.resolve_hits(dmt, o_c, dt, t_all, s_all)
    rp, gp = np.asarray(ref.prim), hit.prim.numpy()
    hit_match = (rp >= 0) == (gp >= 0)
    assert hit_match.mean() > 0.995
    both = hit_match & (rp >= 0)
    assert (both & (rp == gp)).sum() > 0.9 * both.sum()
    assert np.allclose(np.asarray(ref.t)[both], hit.t.numpy()[both],
                       rtol=1e-3, atol=1e-4)
