"""Two-level traversal (rtxpt_tpu_torch/ops/bvh2l.py: K6 probe + K5 sweep,
plain versions) against the reference's bvh2l.trace_closest/trace_anyhit.

Two cuts: programmer-art with cap_tris=300 (>= 8 subtrees, so the probe
engages; the reference runs its bucketed K6 in interpret mode, as
tests/test_bvh2l.py does) and the default cut of build_city(blocks=4)
(55,196 triangles, fewer than 8 subtrees: the sweep alone). Each on the
port's own build and on the reference's tables carried across with
`interop`. Hits agree as tests/test_bvh2l.py holds the reference's own
two-level trace to its flat one: t within rtol 1e-4 (the reference's
probe reads bf16 planes and fuses multiply-adds; the builds differ in
rare split choices), the same number of hits, the same triangle on more
than 99.5% of lanes (coplanar ties across subtrees resolve by visit
order); occlusion equal on every lane."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rtxpt_tpu.ops import bvh2l as JL
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.ops import bvh2l as TL
from rtxpt_tpu_torch.ops import cuda_lib

N = 2048


def _rays(scene, seed=3):
    r = np.random.default_rng(seed)
    if scene == "programmer-art":
        o = r.uniform(-4, 4, (N, 3)).astype(np.float32)
        o[:, 1] = r.uniform(0.2, 4.0, N)
        d = r.normal(size=(N, 3))
    else:                                # city, 4 blocks
        o = np.stack([r.uniform(-12, 12, N), r.uniform(0.5, 14.0, N),
                      r.uniform(-12, 12, N)], -1).astype(np.float32)
        d = r.normal(size=(N, 3))
        d[:, 1] -= 0.5
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.fixture(scope="module", params=["programmer-art", "city"])
def built(request):
    scene = request.param
    if scene == "programmer-art":
        host, cap = JP.build_programmer_art().finish(), 300
    else:
        host, cap = JP.build_city(blocks=4).finish(), TL.CAP_TRIS
    pos, idx = host["positions"], host["indices"]
    ref = JL.build_two_level(pos, idx, cap_tris=cap)
    own = TL.build_two_level(pos, idx, cap_tris=cap, device="cpu")
    carried = interop.accel_from_reference(ref, device="cpu")
    return scene, ref, {"own": own, "carried": carried}


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setenv("RTXPT_BVH2L_INTERPRET", "1")


@pytest.mark.parametrize("which", ["own", "carried"])
def test_closest_matches_reference(built, which):
    scene, ref, port = built
    tl = port[which]
    probe = scene == "programmer-art"
    assert (tl.num_subtrees >= TL.PROBE_MIN_SUBTREES) == probe
    assert (ref.num_subtrees >= 8) == probe
    o, d = _rays(scene)
    act = np.arange(N) % 5 != 0
    h_ref = JL.trace_closest(ref, jnp.asarray(o), jnp.asarray(d),
                             active=jnp.asarray(act))
    cuda_lib.reset_launch_counts()
    h = TL.trace_closest(tl, torch.as_tensor(o), torch.as_tensor(d),
                         active=torch.as_tensor(act))
    assert cuda_lib.launch_counts()["bvh8_trace_sub"] == 0
    pr, pg = np.asarray(h_ref.prim), h.prim.numpy()
    assert (pg[~act] == -1).all()
    assert (pr >= 0).mean() > 0.3
    assert (pr >= 0).sum() == (pg >= 0).sum()
    assert (pr == pg).mean() > 0.995
    hit = pr >= 0
    np.testing.assert_allclose(h.t.numpy()[hit], np.asarray(h_ref.t)[hit],
                               rtol=1e-4)
    same = hit & (pr == pg)
    np.testing.assert_allclose(h.bary.numpy()[same],
                               np.asarray(h_ref.bary)[same], atol=1e-4)


@pytest.mark.parametrize("which", ["own", "carried"])
def test_anyhit_matches_reference(built, which):
    scene, ref, port = built
    o, d = _rays(scene, seed=4)
    t_max = np.random.default_rng(5).uniform(0.5, 8.0, N).astype(np.float32)
    act = np.arange(N) % 7 != 0
    occ_ref = np.asarray(JL.trace_anyhit(ref, jnp.asarray(o), jnp.asarray(d),
                                         t_max=jnp.asarray(t_max),
                                         active=jnp.asarray(act)))
    occ = TL.trace_anyhit(port[which], torch.as_tensor(o),
                          torch.as_tensor(d), t_max=torch.as_tensor(t_max),
                          active=torch.as_tensor(act)).numpy()
    assert 0.1 < occ_ref.mean() < 0.9
    assert np.array_equal(occ, occ_ref)
    assert not occ[~act].any()
