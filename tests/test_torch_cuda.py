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
from rtxpt_tpu_torch.pt import integrator as TI
from rtxpt_tpu_torch.pt import shade_kernel as SK
from rtxpt_tpu_torch.scene import envmap as EM
from rtxpt_tpu_torch.scene import procedural
from shade_planes import planes as shade_planes

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


def _at_offset(table, words):
    """`table`'s values in a contiguous tensor that starts `words` 4-byte
    words into its allocation (not 16-byte aligned for words 1-3)."""
    out = table.new_empty(table.numel() + words)[words:].view(table.shape)
    out.copy_(table)
    return out


@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("kind", ["f32", "i32"])
@pytest.mark.parametrize("width", [4, 5, 10, 12, 24, 46, 7])
def test_gather_rows_kernel_bit_equal(dev, width, kind, offset):
    """K2 at every compile-time width and a run-time width, on a table at
    a 16-byte aligned address and at one that is not."""
    r = np.random.RandomState(width)
    a = r.normal(size=(1000, width)).astype(np.float32) if kind == "f32" \
        else r.randint(-(1 << 30), 1 << 30, (1000, width)).astype(np.int32)
    table = _at_offset(torch.as_tensor(a, device=dev), offset)
    for n in (1, 4097, 100_003):
        idx = torch.as_tensor(r.randint(-3, 1003, n), device=dev)
        got = gather.gather_rows(table, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, gather.gather_rows_plain(table, idx)), \
            gather.instance(table)


@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("width", [12, 7])
def test_gather_interp_kernel_bit_equal(dev, width, offset):
    r = np.random.RandomState(width + offset)
    table = _at_offset(torch.as_tensor(
        (r.normal(size=(700, width)) * 10).astype(np.float32), device=dev),
        offset)
    for n in (1, 999, 70_001):
        i3 = torch.as_tensor(r.randint(-2, 702, (n, 3)).astype(np.int32),
                             device=dev)
        w3 = torch.as_tensor(r.dirichlet([1.0, 1.0, 1.0], n).astype(
            np.float32), device=dev)
        got = gather.gather_rows_interp(table, i3, w3)
        torch.cuda.synchronize()
        assert torch.equal(got, gather.gather_rows_interp_plain(table, i3,
                                                                w3))


def _surface_tables(dev, source, offset=0):
    """(tri_pack, vert_pack, tri_geom_pack, mat_pack) on the card: the
    programmer-art scene's, or random ones whose material ids run past
    mat_pack; each at `offset` words into its allocation."""
    if source == "programmer-art":
        from rtxpt_tpu_torch.scene import build as TB
        s = TB.to_device(procedural.build_programmer_art().finish(), dev)
        tables = (s.tri_pack, s.vert_pack, s.tri_geom_pack, s.mat_pack)
    else:
        r = np.random.RandomState(11)
        tables = tuple(torch.as_tensor(a, device=dev) for a in (
            np.concatenate([r.randint(0, 5000, (3000, 3)),
                            r.randint(0, 40, (3000, 1))], 1).astype(np.int32),
            r.normal(size=(5000, 12)).astype(np.float32),
            r.normal(size=(3000, 5)).astype(np.float32),
            r.uniform(0, 2, (32, 46)).astype(np.float32)))
    return tuple(_at_offset(t, offset) for t in tables)


@pytest.mark.parametrize("n", [1, 127, 4097, 480_000])
@pytest.mark.parametrize("source", ["random", "programmer-art"])
def test_gather_surface_bit_equal_to_plain(dev, source, n):
    """The surface fetch against its plain version (load_surface's K2, K3,
    K2, K2 chain) on all four outputs, with miss lanes (-1) and ids past
    the triangle table."""
    tables = _surface_tables(dev, source)
    r = np.random.RandomState(n)
    n_tris = tables[0].shape[0]
    prim = r.randint(0, n_tris, n).astype(np.int32)
    prim[r.rand(n) < 0.2] = -1
    prim[r.rand(n) < 0.02] = n_tris + 3
    bary = r.dirichlet([1.0, 1.0, 1.0], n)[:, 1:].astype(np.float32)
    prim, bary = (torch.as_tensor(a, device=dev) for a in (prim, bary))
    cuda_lib.reset_launch_counts()
    got = gather.gather_surface(*tables, prim, bary)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["gather_surface"] == 1
    for a, b in zip(got, gather.gather_surface_plain(*tables, prim, bary)):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("offset", [1, 2])
def test_gather_surface_unaligned_tables_bit_equal(dev, offset):
    """Tables 4 or 8 bytes past a 16-byte boundary take the narrower
    words (gather.surface_instance) and give the same bits."""
    tables = _surface_tables(dev, "random", offset)
    r = np.random.RandomState(offset)
    prim = torch.as_tensor(r.randint(-1, 3000, 4097).astype(np.int32),
                           device=dev)
    bary = torch.as_tensor(r.rand(4097, 2).astype(np.float32), device=dev)
    want = {1: "tri_pack 4-byte loads, vert_pack 4-byte words, mat_pack "
               "4-byte words",
            2: "tri_pack 4-byte loads, vert_pack 8-byte words, mat_pack "
               "8-byte words"}[offset]
    assert gather.surface_instance(tables[0], tables[1], tables[3]) == want
    got = gather.gather_surface(*tables, prim, bary)
    torch.cuda.synchronize()
    for a, b in zip(got, gather.gather_surface_plain(*tables, prim, bary)):
        assert torch.equal(a, b)


def _dense_rays(dev, n, seed=1, active=0.9, omm=False):
    """A 1000-triangle dense table (omm: with random 16-bit opacity masks)
    and n rays through it: origins inside and around it (some at cluster
    centers), finite and infinite t_max, a share `active` of the lanes
    active -> (the table, the kernels' arguments (aabb_c, tri12, origins,
    directions, t_max, active))."""
    r = np.random.RandomState(seed)
    n_tris = 1000
    c = r.uniform(-4, 4, (n_tris, 3))
    pos = np.concatenate([c + r.uniform(-0.4, 0.4, (n_tris, 3))
                          for _ in range(3)]).astype(np.float32)
    idx = np.arange(3 * n_tris, dtype=np.int32).reshape(3, n_tris).T
    masks = r.randint(0, 1 << 16, n_tris) if omm else None
    dmt = mt_dense.build_dense(pos, idx, tri_omm=masks, device=dev)
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
    act = torch.as_tensor(r.rand(n) < active, device=dev)
    return dmt, (dmt.aabb_c, dmt.tri12, o.contiguous(), d.contiguous(), tmax,
                 act)


def _plain(dmt, args, any_hit):
    """The plain trace over all clusters (it reads tri9) on `args`."""
    return mt_dense.trace_dense_plain(args[0], dmt.tri9, *args[2:],
                                      any_hit=any_hit)


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
    dmt, args = _dense_rays(dev, n)
    t_k, s_k = mt_dense.trace_dense(*args, any_hit=any_hit)
    t_p, s_p = _plain(dmt, args, any_hit)
    act = args[-1]
    assert ((s_k >= 0) == (s_p >= 0))[act].float().mean() >= 0.9999
    if not any_hit:
        same = s_k == s_p
        assert same[act].float().mean() >= 0.9999
        torch.testing.assert_close(t_k[same], t_p[same], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("n", [20037])
@pytest.mark.parametrize("share", [1.0, 0.5, 0.05])
@pytest.mark.parametrize("any_hit", [False, True])
def test_fused_trace_matches_plain(dev, any_hit, share, n):
    """The fused trace (each tile's worklist built in the kernel; N not a
    multiple of the 128-lane tile; mixed t_max)
    against the plain version over all clusters: one launch, the same
    slot (closest) or occlusion flag (any-hit) on >= 99.99% of active
    lanes, t within rtol 1e-5 / atol 1e-6 (bit-equality is expected),
    t_max and -1 on inactive lanes."""
    dmt, args = _dense_rays(dev, n, active=share)
    cuda_lib.reset_launch_counts()
    t_k, s_k = mt_dense.trace_dense_fused(*args, any_hit=any_hit)
    counts = cuda_lib.launch_counts()
    assert counts["mt_dense_fused"] == 1, counts
    assert counts["mt_dense"] == counts["tile_keys"] == 0, counts
    t_p, s_p = _plain(dmt, args, any_hit)
    act, tmax = args[-1], args[-2]
    assert torch.equal(s_k[~act], s_p[~act]) and (s_k[~act] == -1).all()
    assert torch.equal(t_k[~act], tmax[~act])
    hit = (s_k >= 0) == (s_p >= 0)
    print(f"{share:.0%} active: occlusion/hit flag equal on "
          f"{float(hit[act].float().mean()):.6%}")
    assert hit[act].float().mean() >= 0.9999
    if not any_hit:
        same = s_k == s_p
        assert same[act].float().mean() >= 0.9999
        print(f"same slot on {float(same[act].float().mean()):.6%}, max "
              f"|diff| t {float((t_k - t_p)[same].abs().max()):.3g}")
        torch.testing.assert_close(t_k[same], t_p[same], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("any_hit", [False, True])
def test_fused_trace_omm_matches_plain(dev, any_hit):
    """The fused trace's OMM channel (random 16-bit masks) against the
    plain version with the masks: one launch; closest, the same slot and
    the same t bits on every lane; any-hit, the same occlusion flag. The
    unfused K1 refuses the masked table."""
    dmt, args = _dense_rays(dev, 20037, omm=True)
    assert dmt.has_omm
    cuda_lib.reset_launch_counts()
    t_k, s_k = mt_dense.trace_dense_fused(*args, any_hit=any_hit, omm=True)
    assert cuda_lib.launch_counts()["mt_dense_fused"] == 1
    t_p, s_p = mt_dense.trace_dense_plain(args[0], dmt.tri9, *args[2:],
                                          any_hit=any_hit, omm=dmt.omm)
    if any_hit:
        assert torch.equal(s_k >= 0, s_p >= 0)
    else:
        assert torch.equal(s_k, s_p)
        assert torch.equal(t_k.view(torch.int32), t_p.view(torch.int32))
    # the masks rejected hits
    _, s_n = mt_dense.trace_dense_fused(*args, any_hit=any_hit)
    assert (s_n >= 0).sum() > (s_k >= 0).sum()
    with pytest.raises(ValueError, match="no OMM channel"):
        mt_dense.trace_dense(*args, any_hit=any_hit)


def _tie_args(dev, n=300):
    """Slots 0 and 64 hold the same triangle (t = 1); cluster 1's box is
    nearer, so a worklist visits it first."""
    tri9 = torch.zeros((2 * mt_dense.CLUSTER, 10))
    tri9[:, 9] = -1.0
    tri = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    tri9[0, 0:9] = tri9[mt_dense.CLUSTER, 0:9] = tri
    aabb_c = torch.tensor([[-1.0, -1.0, -5.0, 1.0, 1.0, 0.0],
                           [-1.0, -1.0, 0.0, 1.0, 1.0, 0.5]])
    o = torch.tensor([[0.2, 0.2, 1.0]]).repeat(n, 1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1)
    return [a.to(dev) for a in (aabb_c, mt_dense.tri12_from_tri9(tri9), o,
                                d, torch.full((n,), 1e30),
                                torch.ones(n, dtype=torch.bool))]


def test_fused_trace_tie_goes_to_lower_slot_visited_later(dev):
    """The tie of the next test on the fused kernel: its tile's worklist
    visits cluster 1 first, and slot 0 must still win."""
    args = _tie_args(dev)
    counts, order = mt_dense.tile_worklists(args[0], *args[2:])
    assert counts.tolist() == [2, 2, 2]
    assert order[:, :2].tolist() == [[1, 0]] * 3
    t, slot = mt_dense.trace_dense_fused(*args, any_hit=False)
    assert (slot == 0).all() and (t == 1.0).all()


def test_trace_kernel_tie_goes_to_lower_slot_visited_later(dev):
    """Slots 0 and 64 hold the same triangle (t = 1); cluster 1's box is
    nearer, so the worklist visits it first, and slot 0 must still win."""
    args = _tie_args(dev)
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


SHADE_KW = dict(max_bounces=6, max_diffuse_bounces=4,
                spec_rough_threshold=0.25, local_pdf_k=1.0)


def _shade_case(dev, nd, nl, n, seed=0):
    planes = shade_planes(nd, nl, seed=seed + 10 * nd + nl, min_rough=0.3,
                          lanes=n).to(dev)
    return planes, torch.tensor([2.0, 1.0, 1e-5, 0.002], device=dev)


@pytest.mark.parametrize("n", [1, 127, 129, 4099, 4096])
@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("rr", [False, True])
@pytest.mark.parametrize("nl", [0, 1, 2])
@pytest.mark.parametrize("nd", [0, 1, 2])
def test_shade_kernel_every_instance_matches_plain(dev, nd, nl, rr, fill,
                                                   n):
    """Every instantiation the wrapper can pick, at widths that end in a
    ragged tile (all but 4,096) or fill their tiles, against the plain
    version with chip_smoke.py
    `check_shade`'s tolerances: lobe and flags equal on >= 99.99% of
    lanes, the rest within rtol 2e-4 / atol 2e-5 on those lanes (FILL:
    max |diff| < 1e-5)."""
    planes, consts4 = _shade_case(dev, nd, nl, n)
    kw = dict(SHADE_KW, nee_distant=nd, nee_local=nl, rr=rr)
    kernel = SK.shade_nee_fill if fill else SK.shade_nee
    cuda_lib.reset_launch_counts()
    got = kernel(planes, consts4, **kw)
    assert cuda_lib.launch_counts()[
        "shade_nee_fill" if fill else "shade_nee"] == 1
    ref = SK.shade_nee_plain(planes, consts4, fill=fill, **kw)
    L = SK.out_layout(nd, nl, fill)
    flags = [L.map[f][0] for f in ["lobe", "scatter_valid", "will_scatter",
                                   "rr_kill", "non_delta_scatter"]
             + [f"nee_need{i}" for i in range(nd + nl)]]
    same = (got[flags] == ref[flags]).all(0)
    assert same.float().mean() >= 0.9999
    torch.testing.assert_close(got[:, same], ref[:, same], rtol=2e-4,
                               atol=2e-5)
    if fill:
        assert (got[:, same] - ref[:, same]).abs().max() < 1e-5


@pytest.mark.parametrize("n", [4099, 4096])
@pytest.mark.parametrize("fill", [False, True])
def test_shade_kernel_launches_bit_equal(dev, fill, n):
    """Two launches on the same input give the same bits."""
    kw = dict(SHADE_KW, nee_distant=2, nee_local=2, rr=True)
    kernel = SK.shade_nee_fill if fill else SK.shade_nee
    planes, consts4 = _shade_case(dev, 2, 2, n, seed=5)
    assert torch.equal(kernel(planes, consts4, **kw),
                       kernel(planes, consts4, **kw))


def _realtime(device, w=32, h=24, **cfg):
    """A RealtimeRenderer on programmer-art: the default configuration, or
    ReSTIR DI + GI with a denoiser and `cfg`."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.models.renderer import realtime_config
    return RealtimeRenderer(
        procedural.build_programmer_art().finish(),
        procedural.default_camera(w, h),
        realtime_config(use_restir_di=True, use_restir_gi=True,
                        denoiser_enabled=True, **cfg) if cfg else None,
        env_radiance=EM.bake_procedural_sky(height=32), device=device)


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
    """A default realtime frame on the card goes through the fused dense
    trace (neither K1 walking given worklists nor K7), K2, the surface
    fetch (not K3 alone) and K4's FILL variant (not the non-FILL K4), and
    its second frame agrees with the CPU port's."""
    cuda_lib.reset_launch_counts()
    r = _realtime(dev)
    r.render_frame(32, 24)
    gpu = r.render_frame(32, 24).cpu()
    counts = cuda_lib.launch_counts()
    for k in ("mt_dense_fused", "gather_rows", "gather_surface",
              "shade_nee_fill"):
        assert counts[k] > 0, counts
    assert counts["gather_rows_interp"] == 0, counts
    assert counts["shade_nee"] == 0, counts
    assert counts["mt_dense"] == counts["tile_keys"] == 0, counts
    c = _realtime("cpu")
    c.render_frame(32, 24)
    torch.testing.assert_close(gpu, c.render_frame(32, 24), rtol=1e-3,
                               atol=1e-3)


def test_psr_frame_launches_shade_nee_and_matches_cpu(dev):
    """A PSR-lite frame (use_stable_planes=False) on the card runs the
    fused dense trace, K2, the surface fetch and the non-FILL K4 (one per
    bounce of its path loop), never K4 FILL, and its second frame agrees
    with the CPU port's."""
    cuda_lib.reset_launch_counts()
    r = _realtime(dev, use_stable_planes=False)
    r.render_frame(32, 24)
    gpu = r.render_frame(32, 24).cpu()
    counts = cuda_lib.launch_counts()
    for k in ("mt_dense_fused", "gather_rows", "gather_surface",
              "shade_nee"):
        assert counts[k] > 0, counts
    assert counts["shade_nee_fill"] == 0, counts
    assert counts["gather_rows_interp"] == 0, counts
    c = _realtime("cpu", use_stable_planes=False)
    c.render_frame(32, 24)
    torch.testing.assert_close(gpu, c.render_frame(32, 24), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("stable", [True, False],
                         ids=["stable-planes", "psr-lite"])
def test_reblur_frame_matches_cpu(dev, stable):
    """ReBLUR frames on the card agree with the CPU port's (frame 2)."""
    imgs = []
    for device in (dev, "cpu"):
        r = _realtime(device, use_stable_planes=stable,
                      denoiser_method="reblur")
        r.render_frame(32, 24)
        imgs.append(r.render_frame(32, 24).cpu())
    torch.testing.assert_close(imgs[0], imgs[1], rtol=1e-3, atol=1e-3)


def test_taau_frame_matches_cpu(dev):
    """The default pipeline upscaled by TAAU from 32x24 to 64x48 on the
    card agrees with the CPU port's (frame 2)."""
    imgs = []
    for device in (dev, "cpu"):
        r = _realtime(device)
        r.render_frame(32, 24, display_size=(64, 48))
        imgs.append(r.render_frame(32, 24, display_size=(64, 48)).cpu())
    assert imgs[0].shape == (48, 64, 3)
    torch.testing.assert_close(imgs[0], imgs[1], rtol=1e-3, atol=1e-3)


def test_render_launches_every_kernel_and_matches_cpu(dev):
    """Programmer-art takes the dense tier: the fused dense trace (one
    launch per trace: neither K1 walking given worklists nor K7), K2, the
    surface fetch (not K3 alone), K4, and neither K5 nor K6."""
    cuda_lib.reset_launch_counts()
    gpu = _renderer(dev, max_bounces=3).render(32, 24, 2).cpu()
    counts = cuda_lib.launch_counts()
    dense_path = ("mt_dense_fused", "gather_rows", "gather_surface",
                  "shade_nee")
    assert all(counts[k] > 0 for k in dense_path), counts
    assert counts["gather_rows_interp"] == 0, counts
    assert counts["mt_dense"] == counts["tile_keys"] == 0, counts
    assert counts["bvh8_trace"] == counts["bvh8_trace_sub"] == 0, counts
    assert counts["bvh8_trace_2l"] == 0, counts
    cpu = _renderer("cpu", max_bounces=3).render(32, 24, 2)
    torch.testing.assert_close(gpu, cpu, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("cfg", [
    dict(shade_megakernel=False), dict(nee_enabled=False),
    dict(nee_local_type=2), dict(nee_local_type=2, regir_layout="onion"),
    dict(nee_distant_type=0), dict(nee_distant_type=2),
    dict(rng_quality="hq"), dict(rng_quality="uniform")],
    ids=["chain", "no-nee", "regir", "regir-onion", "distant-uniform",
         "presampled", "hq", "uniform"])
def test_reference_configuration_renders_and_matches_cpu(dev, cfg):
    """The reference configurations off the default one: the chain of
    tensor ops (no K4 launch) where the reference's rule refuses the fused
    pass, K4 where it takes it, the same trace and fetch kernels, and the
    CPU's image."""
    cuda_lib.reset_launch_counts()
    gpu = _renderer(dev, max_bounces=3, **cfg).render(32, 24, 2).cpu()
    counts = cuda_lib.launch_counts()
    fused = TI.uses_shade_kernel(reference_config(**cfg), 2)
    assert (counts["shade_nee"] > 0) == fused, counts
    assert counts["shade_nee_fill"] == 0, counts
    for k in ("mt_dense_fused", "gather_surface", "gather_rows"):
        assert counts[k] > 0, counts
    cpu = _renderer("cpu", max_bounces=3, **cfg).render(32, 24, 2)
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


@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh8_2l_matches_plain_composition(dev, any_hit):
    """The two-level trace in one launch against the plain composition
    (bvh2l.trace_two_level_plain) on a city of 6 blocks (8+ subtrees, the
    probe engages): partly active, finite and infinite t_max. The same
    prim or occlusion flag on every active lane; t/u/v within rtol 1e-5 /
    atol 1e-6 (bit-equal is expected: the max |diff| is printed)."""
    n = 50000
    r = np.random.RandomState(5)
    host = procedural.build_city(blocks=6).finish()
    tl = bvh2l.build_two_level(host["positions"], host["indices"],
                               device=dev)
    assert tl.num_subtrees >= bvh2l.PROBE_MIN_SUBTREES
    o, d = (torch.as_tensor(a, device=dev) for a in _city_rays(n, 6, 6))
    t_max = torch.as_tensor(np.where(r.rand(n) < 0.5, 1e30,
                                     r.uniform(1, 20, n)).astype(np.float32),
                            device=dev)
    act = torch.as_tensor(r.rand(n) < 0.8, device=dev)
    cuda_lib.reset_launch_counts()
    got = T8.trace_bvh8_2l(tl, o, d, t_max, act, any_hit=any_hit)
    assert cuda_lib.launch_counts()["bvh8_trace_2l"] == 1
    ref = bvh2l.trace_two_level_plain(tl, o, d, t_max, act, any_hit=any_hit)
    if any_hit:
        assert 0.05 < float(ref[act].float().mean()) < 0.95
        assert torch.equal(got[act], ref[act]) and not got[~act].any()
        return
    assert float((ref.prim[act] >= 0).float().mean()) > 0.3
    assert torch.equal(got.prim[act], ref.prim[act])
    hit = act & (ref.prim >= 0)
    print(f"max |diff| t {float((got.t - ref.t)[hit].abs().max()):.3g}, "
          f"uv {float((got.bary - ref.bary)[hit].abs().max()):.3g}")
    torch.testing.assert_close(got.t[act], ref.t[act], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.bary[act], ref.bary[act], rtol=1e-5,
                               atol=1e-6)


def test_bvh8_2l_tie_goes_to_nearest_subtree_then_lowest_index(dev):
    """The scene of tests/two_level_tie.py on the card: the kernel returns
    the plain composition's copy on every lane, which is the copy of the
    ray's nearest subtree, then of the lowest index."""
    import two_level_tie as TIE
    pos, idx = TIE.scene()
    tl = bvh2l.build_two_level(pos, idx, cap_tris=TIE.CAP_TRIS, device=dev)
    o, d = TIE.rays()
    sub, near_first, lowest_first = TIE.expected(tl, o, d)
    assert near_first.sum() > 50 and lowest_first.sum() > 50
    args = (tl, torch.as_tensor(o, device=dev),
            torch.as_tensor(d, device=dev),
            torch.full((o.shape[0],), 1e30, device=dev),
            torch.ones(o.shape[0], dtype=torch.bool, device=dev))
    got = T8.trace_bvh8_2l(*args, any_hit=False)
    ref = bvh2l.trace_two_level_plain(*args, any_hit=False)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    owner = TIE.subtree_of(tl, got.prim.cpu().numpy())
    assert (owner >= 0).mean() > 0.99
    assert np.array_equal(owner[owner >= 0], sub[owner >= 0])


def test_city_render_launches_two_level_trace_and_matches_cpu(dev):
    """A two-level city (6 blocks, 8+ subtrees) renders through the
    two-level trace in one launch (and neither K5 nor K6 alone), and
    agrees with the CPU render."""
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
    for k in ("bvh8_trace_2l", "gather_rows", "gather_surface",
              "shade_nee"):
        assert counts[k] > 0, counts
    assert counts["gather_rows_interp"] == 0, counts
    assert counts["bvh8_trace"] == counts["bvh8_trace_sub"] == 0, counts
    assert counts["mt_dense"] == counts["mt_dense_fused"] == 0
    torch.testing.assert_close(gpu, render("cpu"), rtol=1e-3, atol=1e-3)


def test_wrappers_reject_bad_arguments(dev):
    table = torch.zeros((8, 4), device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        gather.gather_rows(table, torch.zeros(3, dtype=torch.int32,
                                              device=dev))
    with pytest.raises(ValueError):
        gather.gather_rows(torch.zeros((8, 4), device=dev),
                           torch.zeros(3, dtype=torch.int32))
    dmt, args = _dense_rays(dev, 300)
    with pytest.raises(ValueError):          # tri9 where tri12 belongs
        mt_dense.trace_dense_fused(args[0], dmt.tri9, *args[2:],
                                   any_hit=False)
    with pytest.raises(TypeError):
        mt_dense.trace_dense_fused(*args[:4], args[4].double(), args[5],
                                   any_hit=False)
