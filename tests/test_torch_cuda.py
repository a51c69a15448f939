"""CUDA kernels of the port against their plain versions, on the card.

Marked `cuda`; each test skips without a GPU. On a machine with one (and
without JAX, which the tests' conftest needs), run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

This file imports nothing of JAX or of the reference package."""
import numpy as np
import pytest
import torch

from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
from rtxpt_tpu_torch.ops import bvh2l, cuda_lib, gather, mt_dense
from rtxpt_tpu_torch.ops import traverse_bvh8 as T8
from rtxpt_tpu_torch.pt import shade_kernel as SK
from rtxpt_tpu_torch.scene import envmap as EM
from rtxpt_tpu_torch.scene import procedural

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _renderer(device, w=32, h=24, **cfg):
    return Renderer(procedural.build_programmer_art().finish(),
                    procedural.default_camera(w, h), reference_config(**cfg),
                    env_radiance=EM.bake_procedural_sky(height=32),
                    device=device)


def test_gather_kernels_match_plain(dev):
    r = np.random.RandomState(0)
    f = torch.as_tensor(r.normal(size=(700, 12)).astype(np.float32),
                        device=dev)
    i = torch.as_tensor(r.randint(-1000, 1000, (700, 4)).astype(np.int32),
                        device=dev)
    idx = torch.as_tensor(r.randint(-3, 703, (50, 40)), device=dev)
    for table in (f, i):
        assert torch.equal(gather.gather_rows(table, idx),
                           gather.gather_rows_plain(table, idx))
    i3 = torch.as_tensor(r.randint(0, 700, (999, 3)).astype(np.int32),
                         device=dev)
    w3 = torch.as_tensor(r.rand(999, 3).astype(np.float32), device=dev)
    torch.testing.assert_close(gather.gather_rows_interp(f, i3, w3),
                               gather.gather_rows_interp_plain(f, i3, w3),
                               rtol=1e-6, atol=1e-6)


def _dense_rays(dev, n, seed=1):
    """A 1000-triangle dense table and n rays through it: origins inside
    and around it (some at cluster centers), finite and infinite t_max,
    10% inactive lanes."""
    r = np.random.RandomState(seed)
    n_tris = 1000
    c = r.uniform(-4, 4, (n_tris, 3))
    pos = np.concatenate([c + r.uniform(-0.4, 0.4, (n_tris, 3))
                          for _ in range(3)]).astype(np.float32)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T
    dmt = mt_dense.build_dense(pos, idx, device=dev)
    o = r.uniform(-8, 8, (n, 3))
    aabb = dmt.aabb.cpu().numpy()
    inside = r.rand(n) < 0.2
    k = r.randint(0, aabb.shape[0], n)
    o[inside] = (0.5 * (aabb[k, 0:3] + aabb[k, 3:6]))[inside]
    o = torch.as_tensor(o.astype(np.float32), device=dev) - dmt.center
    d = torch.nn.functional.normalize(torch.as_tensor(
        r.normal(size=(n, 3)).astype(np.float32), device=dev), dim=-1)
    tmax = torch.as_tensor(np.where(r.rand(n) < 0.5, 1e30, r.uniform(
        1, 12, n)).astype(np.float32), device=dev)
    act = torch.as_tensor(r.rand(n) < 0.9, device=dev)
    return dmt, (dmt.aabb_c, dmt.tri9, o.contiguous(), d.contiguous(), tmax,
                 act)


@pytest.mark.parametrize("tile", [128, 1024])
def test_tile_keys_kernel_bit_equal_to_plain(dev, tile):
    """K7's keys (a tile size that does not divide N; negative keys from
    origins inside boxes) equal the plain version's bit for bit, and its
    in-kernel worklists those of a stable argsort of them."""
    _, (aabb_c, _, o, d, tmax, act) = _dense_rays(dev, 20037)
    cuda_lib.reset_launch_counts()
    got, counts, order = mt_dense.tile_keys(aabb_c, o, d, tmax, act, tile)
    assert cuda_lib.launch_counts()["tile_keys"] == 1
    ref = mt_dense.tile_keys_plain(aabb_c, o, d, tmax, act, tile)
    assert got.shape == ref.shape == ((20037 + tile - 1) // tile,
                                      aabb_c.shape[0])
    assert (ref < 0).any()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    c_ref, o_ref = mt_dense.worklists_from_keys(ref)
    assert torch.equal(counts, c_ref) and torch.equal(order, o_ref)
    # tiles whose lanes are all inactive: +inf keys, empty lists, the
    # clusters in index order
    half = act & (torch.arange(act.shape[0], device=dev) >= 10000)
    got, counts, order = mt_dense.tile_keys(aabb_c, o, d, tmax, half, tile)
    ref = mt_dense.tile_keys_plain(aabb_c, o, d, tmax, half, tile)
    assert torch.isinf(ref).any() and (counts == 0).any()
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    c_ref, o_ref = mt_dense.worklists_from_keys(ref)
    assert torch.equal(counts, c_ref) and torch.equal(order, o_ref)


@pytest.mark.parametrize("n", [20000, 20037])
@pytest.mark.parametrize("any_hit", [False, True])
def test_trace_kernel_matches_plain(dev, any_hit, n):
    """K1 walking K7's worklists (N not a multiple of the 128-lane tile)
    against the plain version over all clusters in slot order."""
    _, args = _dense_rays(dev, n)
    t_k, s_k = mt_dense.trace_dense(*args, any_hit=any_hit)
    t_p, s_p = mt_dense.trace_dense_plain(*args, any_hit=any_hit)
    act = args[-1]
    assert ((s_k >= 0) == (s_p >= 0))[act].float().mean() >= 0.9999
    if not any_hit:
        same = s_k == s_p
        assert same[act].float().mean() >= 0.9999
        torch.testing.assert_close(t_k[same], t_p[same], rtol=1e-5,
                                   atol=1e-6)


def test_trace_kernel_tie_goes_to_lower_slot_visited_later(dev):
    """Slots 0 and 64 hold the same triangle (t = 1); cluster 1's box is
    nearer, so the worklist visits it first, and slot 0 must still win."""
    tri9 = torch.zeros((2 * mt_dense.CLUSTER, 10))
    tri9[:, 9] = -1.0
    tri = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    tri9[0, 0:9] = tri9[mt_dense.CLUSTER, 0:9] = tri
    aabb_c = torch.tensor([[-1.0, -1.0, -5.0, 1.0, 1.0, 0.0],
                           [-1.0, -1.0, 0.0, 1.0, 1.0, 0.5]])
    n = 300
    o = torch.tensor([[0.2, 0.2, 1.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1)
    args = [a.to(dev) for a in (aabb_c, tri9, o, d, torch.full((n,), 1e30),
                                torch.ones(n, dtype=torch.bool))]
    counts, order = mt_dense.tile_worklists(args[0], *args[2:])
    assert counts.tolist() == [2, 2, 2]
    assert order[:, :2].tolist() == [[1, 0]] * 3
    t, slot = mt_dense.trace_dense(*args, any_hit=False)
    assert (slot == 0).all() and (t == 1.0).all()


def test_shade_kernel_matches_plain(dev):
    r = _renderer(dev, max_bounces=4, nee_distant_samples=1,
                  nee_local_samples=1)
    calls = []
    orig = SK.shade_nee

    def capture(planes, consts4, **kw):
        calls.append((planes.clone(), consts4.clone(), kw))
        return orig(planes, consts4, **kw)

    SK.shade_nee = capture
    try:
        r.render(32, 24, 1)
    finally:
        SK.shade_nee = orig
    assert calls
    for planes, consts4, kw in calls[:3]:
        got = SK.shade_nee(planes, consts4, **kw)
        ref = SK.shade_nee_plain(planes, consts4, **kw)
        torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-5)


def _realtime(device, w=32, h=24):
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    return RealtimeRenderer(procedural.build_programmer_art().finish(),
                            procedural.default_camera(w, h),
                            env_radiance=EM.bake_procedural_sky(height=32),
                            device=device)


def test_shade_fill_kernel_matches_plain(dev):
    """K4's FILL variant on the launches of a realtime frame (NEE 2+2,
    ReSTIR DI lanes marked nee_skip): lobe and flags equal on >= 99.99%
    of lanes, the rest within rtol 2e-4 / atol 2e-5 on those lanes."""
    calls = []
    orig = SK.shade_nee_fill

    def capture(planes, consts4, **kw):
        calls.append((planes.clone(), consts4.clone(), kw))
        return orig(planes, consts4, **kw)

    SK.shade_nee_fill = capture
    try:
        _realtime(dev).render_frame(32, 24)
    finally:
        SK.shade_nee_fill = orig
    assert calls
    for planes, consts4, kw in calls[:3]:
        got = SK.shade_nee_fill(planes, consts4, **kw)
        ref = SK.shade_nee_plain(planes, consts4, fill=True, **kw)
        L = SK.out_layout(kw["nee_distant"], kw["nee_local"], fill=True)
        flags = [L.map[k][0] for k in ("lobe", "scatter_valid",
                                       "will_scatter", "rr_kill")]
        same = (got[flags] == ref[flags]).all(0)
        assert same.float().mean() >= 0.9999
        torch.testing.assert_close(got[:, same], ref[:, same], rtol=2e-4,
                                   atol=2e-5)


def test_realtime_frame_launches_fill_and_matches_cpu(dev):
    """A default realtime frame on the card goes through K1-K3 and K4's
    FILL variant (not the non-FILL K4), and its second frame agrees with
    the CPU port's."""
    cuda_lib.reset_launch_counts()
    r = _realtime(dev)
    r.render_frame(32, 24)
    gpu = r.render_frame(32, 24).cpu()
    counts = cuda_lib.launch_counts()
    for k in ("mt_dense", "tile_keys", "gather_rows", "gather_rows_interp",
              "shade_nee_fill"):
        assert counts[k] > 0, counts
    assert counts["shade_nee"] == 0, counts
    c = _realtime("cpu")
    c.render_frame(32, 24)
    torch.testing.assert_close(gpu, c.render_frame(32, 24), rtol=1e-3,
                               atol=1e-3)


def test_render_launches_every_kernel_and_matches_cpu(dev):
    """Programmer-art takes the dense tier: K1-K4, and neither K5 nor K6."""
    cuda_lib.reset_launch_counts()
    gpu = _renderer(dev, max_bounces=3).render(32, 24, 2).cpu()
    counts = cuda_lib.launch_counts()
    dense_path = ("mt_dense", "tile_keys", "gather_rows",
                  "gather_rows_interp", "shade_nee")
    assert all(counts[k] > 0 for k in dense_path), counts
    assert counts["bvh8_trace"] == counts["bvh8_trace_sub"] == 0, counts
    cpu = _renderer("cpu", max_bounces=3).render(32, 24, 2)
    torch.testing.assert_close(gpu, cpu, rtol=1e-3, atol=1e-3)


def _city_rays(n, seed, blocks):
    r = np.random.RandomState(seed)
    half = blocks * 3.0
    o = np.stack([r.uniform(-half, half, n), r.uniform(0.5, 12.0, n),
                  r.uniform(-half, half, n)], -1).astype(np.float32)
    d = r.normal(size=(n, 3))
    d[:, 1] -= 0.5
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _same_hits(got, ref, active, any_hit):
    (t, slot, uv), (tp, sp, uvp) = got, ref
    if any_hit:
        assert ((slot >= 0) == (sp >= 0))[active].float().mean() >= 0.9999
        return
    same = slot == sp
    assert same[active].float().mean() >= 0.9999
    torch.testing.assert_close(t[same], tp[same], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(uv[same], uvp[same], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh8_kernels_match_plain(dev, any_hit):
    """K5 on a single BVH8 (city, 3 blocks) and K6 on the stacked tables
    of a two-level build (city, 6 blocks, 8+ subtrees) with a per-ray
    subtree index, against their plain versions on the same tensors."""
    n = 50000
    r = np.random.RandomState(2)
    host = procedural.build_city(blocks=3).finish()
    from rtxpt_tpu_torch.ops import bvh as bvh_mod
    b8 = bvh_mod.collapse_bvh8(
        bvh_mod.build_bvh(host["positions"], host["indices"]),
        host["positions"], host["indices"], device=dev)
    o, d = (torch.as_tensor(a, device=dev) for a in _city_rays(n, 3, 3))
    t_max = torch.as_tensor(np.where(r.rand(n) < 0.5, 1e30,
                                     r.uniform(1, 20, n)).astype(np.float32),
                            device=dev)
    act = torch.as_tensor(r.rand(n) < 0.9, device=dev)
    args = (b8.table, b8.leaf_omm, o, d, t_max, act)
    got = T8.trace_bvh8(*args, leaf_size=16, any_hit=any_hit)
    ref = T8.trace_bvh8_plain(*args, leaf_size=16, any_hit=any_hit)
    _same_hits(got, ref, act, any_hit)

    host = procedural.build_city(blocks=6).finish()
    tl = bvh2l.build_two_level(host["positions"], host["indices"],
                               device=dev)
    assert tl.num_subtrees >= 8
    o, d = (torch.as_tensor(a, device=dev) for a in _city_rays(n, 4, 6))
    sub = torch.as_tensor(r.randint(0, tl.num_subtrees, n).astype(np.int32),
                          device=dev)
    args = (tl.sub_tables, tl.sub_leaf_omm, sub, o, d, t_max, act)
    got = T8.trace_bvh8_sub(*args, leaf_size=16, any_hit=any_hit)
    ref = T8.trace_bvh8_plain(tl.sub_tables, tl.sub_leaf_omm, o, d, t_max,
                              act, sub, leaf_size=16, any_hit=any_hit)
    _same_hits(got, ref, act, any_hit)


def test_city_render_launches_k5_k6_and_matches_cpu(dev):
    """A two-level city (6 blocks, 8+ subtrees) renders through the K6
    probe and the K5 sweep, and agrees with the CPU render."""
    host = procedural.build_city(blocks=6).finish()
    cfg = reference_config(max_bounces=3, nee_distant_samples=1,
                           nee_local_samples=1)

    def render(device):
        r = Renderer(host, procedural.city_camera(48, 32, 6), cfg,
                     env_radiance=EM.bake_procedural_sky(height=32),
                     device=device)
        return r.render(48, 32, 2)

    cuda_lib.reset_launch_counts()
    gpu = render(dev).cpu()
    counts = cuda_lib.launch_counts()
    for k in ("bvh8_trace", "bvh8_trace_sub", "gather_rows",
              "gather_rows_interp", "shade_nee"):
        assert counts[k] > 0, counts
    assert counts["mt_dense"] == 0
    torch.testing.assert_close(gpu, render("cpu"), rtol=1e-3, atol=1e-3)


def test_wrappers_reject_bad_arguments(dev):
    table = torch.zeros((8, 4), device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        gather.gather_rows(table, torch.zeros(3, dtype=torch.int32,
                                              device=dev))
    with pytest.raises(ValueError):
        gather.gather_rows(torch.zeros((8, 4), device=dev),
                           torch.zeros(3, dtype=torch.int32))
