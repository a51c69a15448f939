"""ReSTIR DI and GI (rtxpt_tpu_torch/restir/) against the reference
package on the CPU, stage by stage on identical inputs.

The surface is the dominant stable plane of programmer-art at 16x12, built
by the reference (its dense trace in interpret mode, as its own CPU tests
run it) and handed to the port through `interop`, with the same random
motion vectors on both sides so temporal reuse reprojects. Each stage
takes the reference's output of the stage before it, converted, so no
error carries over. Tolerance rtol 1e-4 / atol 1e-5 on floats.

A reservoir keeps one of its candidates by comparing a uniform against
a running weight sum; a one-ulp difference in a target can flip that
choice. Such lanes are counted and their share bounded (at most 2%);
every field that does not depend on the choice (w_sum, M) is still held
to the tolerance on them, the rest on the other lanes."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rtxpt_tpu.models.renderer import Renderer as JRenderer
from rtxpt_tpu.models.renderer import realtime_config as j_realtime_config
from rtxpt_tpu.pt import gbuffer as JGB
from rtxpt_tpu.pt import shading as JSH
from rtxpt_tpu.pt import stableplanes as JSP
from rtxpt_tpu.restir import di as JDI
from rtxpt_tpu.restir import gi as JGI
from rtxpt_tpu.restir import packs as JPK
from rtxpt_tpu.restir import reservoir as JRS
from rtxpt_tpu.scene import envmap as JEM
from rtxpt_tpu.scene import procedural as JP
from rtxpt_tpu_torch import interop
from rtxpt_tpu_torch.models import realtime as TRT
from rtxpt_tpu_torch.restir import di as TDI
from rtxpt_tpu_torch.restir import gi as TGI
from rtxpt_tpu_torch.restir import packs as TPK
from rtxpt_tpu_torch.restir import reservoir as TRS

W, H = 16, 12
N = W * H
FRAME = 5
RTOL, ATOL = 1e-4, 1e-5
MAX_FLIPPED = 0.02


def _jax_gbuffer(assets, sp):
    """The reference's dominant-plane G-buffer, built as its
    models/realtime.py `_pt_frame_stable` builds it."""
    dom = sp.dominant

    def dsel(a):
        idx = dom.reshape((N,) + (1,) * (a.ndim - 1))
        return jnp.take_along_axis(a, idx, axis=1)[:, 0]

    d_prim, d_bary, d_dir = dsel(sp.prim), dsel(sp.bary), dsel(sp.ray_dir)
    surf = JSH.load_surface(assets.scene, jnp.maximum(d_prim, 0), d_bary,
                            d_dir)
    return JGB.GBuffer(
        valid=d_prim >= 0, prim=d_prim, bary=d_bary, t=dsel(sp.scene_length),
        pos=surf.sd.pos, normal=surf.sd.n, face_normal=surf.sd.face_n,
        view_z=dsel(sp.view_z), roughness=dsel(sp.roughness),
        diffuse_albedo=dsel(sp.diff_est), specular_albedo=dsel(sp.spec_est),
        emission=jnp.zeros((N, 3)), motion=dsel(sp.motion), view_dir=d_dir,
        psr_thp=dsel(sp.thp), interior=dsel(sp.interior), surface=surf)


@pytest.fixture(scope="module")
def world():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTXPT_DENSE_INTERPRET", "1")
        jr = JRenderer(JP.build_programmer_art().finish(),
                       JP.default_camera(W, H), j_realtime_config(),
                       env_radiance=JEM.bake_procedural_sky(height=32))
        cam = jr.camera._replace(jitter=jnp.zeros(2),
                                 viewport=jnp.asarray([W, H], jnp.float32))
        jpx, jpy = jr._pixel_grid(W, H)
        jsp = JSP.build_stable_planes(jr.assets, cam, cam, jpx, jpy)
        ta = interop.assets_from_reference(jr.scene, jr.dense, jr.env,
                                           jr.lights, device="cpu")
        tgb = TRT.dominant_gbuffer(
            ta, interop.stable_planes_from_reference(jsp, device="cpu"))
        motion = np.random.RandomState(9).uniform(-2.0, 2.0, (N, 2)) \
            .astype(np.float32)
        yield SimpleNamespace(
            ja=jr.assets, jgb=_jax_gbuffer(jr.assets, jsp)._replace(
                motion=jnp.asarray(motion)),
            jpx=jpx, jpy=jpy, ta=ta,
            tgb=tgb._replace(motion=torch.as_tensor(motion)),
            px=torch.as_tensor(np.asarray(jpx).astype(np.int64)),
            py=torch.as_tensor(np.asarray(jpy).astype(np.int64)))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, ref, mask=None, name=""):
    got, ref = _np(got), _np(ref)
    if mask is not None:
        got, ref = got[mask], ref[mask]
    np.testing.assert_allclose(got.astype(np.float64),
                               ref.astype(np.float64), rtol=RTOL, atol=ATOL,
                               err_msg=name)


def _to_port(r, gi=False):
    return (interop.gi_reservoir_from_reference if gi else
            interop.reservoir_from_reference)(r, device="cpu")


def _same_reservoir(got, ref):
    """DI reservoirs: the chosen light and uv agree on all but a bounded
    share of lanes; the sums agree everywhere."""
    flipped = (_np(got.light) != _np(ref.light)) | ~np.isclose(
        _np(got.uv), _np(ref.uv), rtol=RTOL, atol=ATOL).all(-1)
    assert flipped.mean() <= MAX_FLIPPED, flipped.sum()
    _close(got.w_sum, ref.w_sum, name="w_sum")
    _close(got.m, ref.m, name="m")
    _close(got.target, ref.target, ~flipped, "target")
    _close(got.contribution_weight(), ref.contribution_weight(), ~flipped,
           "W")
    return flipped


def _same_gi(got, ref, summed=True):
    flipped = ~np.isclose(_np(got.pos), _np(ref.pos), rtol=RTOL,
                          atol=1e-4).all(-1) | (_np(got.valid)
                                                != _np(ref.valid))
    assert flipped.mean() <= MAX_FLIPPED, flipped.sum()
    if summed:
        _close(got.w_sum, ref.w_sum, name="w_sum")
    _close(got.m, ref.m, name="m")
    for f in ("normal", "radiance", "target"):
        _close(getattr(got, f), getattr(ref, f), ~flipped, f)
    return flipped


def test_reservoir_update_and_merge():
    rs = np.random.RandomState(1)
    n = 512

    def rand_res(T, mod, empty):
        light = rs.randint(-2, 40, n).astype(np.int32)
        uv = rs.rand(n, 2).astype(np.float32)
        w = (rs.rand(n) * (rs.rand(n) < 0.8)).astype(np.float32)
        m = rs.randint(0, 5, n).astype(np.float32)
        tgt = rs.rand(n).astype(np.float32)
        return T.Reservoir(mod(light), mod(uv), mod(w), mod(m), mod(tgt))

    vals = [rs.randint(0, 40, n).astype(np.int32), rs.rand(n, 2),
            rs.rand(n), rs.rand(n), rs.rand(n)]
    vals = [v.astype(np.int32 if i == 0 else np.float32)
            for i, v in enumerate(vals)]
    state = rs.get_state()
    jr_ = rand_res(JRS, jnp.asarray, None)
    rs.set_state(state)
    tr_ = rand_res(TRS, torch.as_tensor, None)
    got = TRS.update(tr_, *[torch.as_tensor(v) for v in vals])
    ref = JRS.update(jr_, *[jnp.asarray(v) for v in vals])
    for a, b in zip(got, ref):
        _close(a, b)
    other_j, other_t = ref, got
    u = rs.rand(n).astype(np.float32)
    tgt = rs.rand(n).astype(np.float32)
    got = TRS.merge(tr_, other_t, torch.as_tensor(tgt), torch.as_tensor(u))
    ref = JRS.merge(jr_, other_j, jnp.asarray(tgt), jnp.asarray(u))
    for a, b in zip(got, ref):
        _close(a, b)


def _random_lights(world, seed):
    rs = np.random.RandomState(seed)
    n_lights = world.ta.lights.pack.shape[0]
    light = rs.randint(-2, n_lights, N).astype(np.int32)
    uv = rs.rand(N, 2).astype(np.float32)
    return light, uv


def test_packs_match_reference(world):
    sp_t = TPK.pack_surface(world.tgb)
    sp_j = JPK.pack_surface(world.jgb)
    _close(sp_t, sp_j, name="surface pack")
    light, uv = _random_lights(world, 2)
    got = TPK.light_radiance_at(world.ta, world.tgb.pos,
                                torch.as_tensor(light), torch.as_tensor(uv))
    ref = JPK.light_radiance_at(world.ja, world.jgb.pos, jnp.asarray(light),
                                jnp.asarray(uv))
    for a, b, name in zip(got, ref, ("li", "direction", "distance")):
        _close(a, b, name=name)
    _close(TPK.surface_target_cheap(world.ta, sp_t, torch.as_tensor(light),
                                    torch.as_tensor(uv)),
           JPK.surface_target_cheap(world.ja, sp_j, jnp.asarray(light),
                                    jnp.asarray(uv)), name="target")
    rs = np.random.RandomState(3)
    pos = (np.asarray(world.jgb.pos)
           + rs.normal(size=(N, 3))).astype(np.float32)
    nrm = rs.normal(size=(N, 3)).astype(np.float32)
    rad = rs.rand(N, 3).astype(np.float32)
    ok = rs.rand(N) < 0.8
    _close(TPK.gi_target_cheap(sp_t, torch.as_tensor(pos),
                               torch.as_tensor(rad), torch.as_tensor(ok)),
           JPK.gi_target_cheap(sp_j, jnp.asarray(pos), jnp.asarray(nrm),
                               jnp.asarray(rad), jnp.asarray(ok)),
           name="gi target")
    res = _to_port(JRS.Reservoir(
        jnp.asarray(light), jnp.asarray(uv), jnp.asarray(rad[:, 0]),
        jnp.asarray(rad[:, 1]), jnp.asarray(rad[:, 2])))
    rows = TPK.pack_reservoir(res)
    _close(rows, JPK.pack_reservoir(JRS.Reservoir(
        jnp.asarray(light), jnp.asarray(uv), jnp.asarray(rad[:, 0]),
        jnp.asarray(rad[:, 1]), jnp.asarray(rad[:, 2]))))
    for a, b in zip(TPK.unpack_reservoir(rows), res):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def di_chain(world):
    """The reference's DI stages for frames FRAME-1 and FRAME, each as the
    reference computed it (the port's inputs)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTXPT_DENSE_INTERPRET", "1")
        j = world
        ris = JDI.presample_lights(j.ja, FRAME)
        prev = JDI.generate_candidates(j.ja, j.jgb, j.jpx, j.jpy, FRAME - 1,
                                       ris=JDI.presample_lights(j.ja,
                                                                FRAME - 1))
        cand = JDI.generate_candidates(j.ja, j.jgb, j.jpx, j.jpy, FRAME,
                                       ris=ris)
        temporal = JDI.temporal_resample(j.ja, j.jgb, cand, prev, j.jgb,
                                         j.jpx, j.jpy, W, H, FRAME)
        spatial = JDI.spatial_resample(j.ja, j.jgb, temporal, j.jpx, j.jpy,
                                       W, H, FRAME)
        return dict(ris=ris, prev=prev, cand=cand, temporal=temporal,
                    spatial=spatial,
                    final=JDI.final_shade(j.ja, j.jgb, spatial))


def test_presample_lights(world, di_chain):
    got = TDI.presample_lights(world.ta, FRAME).pack.numpy()
    ref = np.asarray(di_chain["ris"].pack)
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    _close(got[:, 1:], ref[:, 1:])


def test_generate_candidates(world, di_chain):
    ris = di_chain["ris"]
    got = TDI.generate_candidates(
        world.ta, world.tgb, world.px, world.py, FRAME,
        TDI.RISTiles(pack=torch.as_tensor(np.asarray(ris.pack)),
                     tiles=ris.tiles, size=ris.size))
    _same_reservoir(got, di_chain["cand"])


def test_temporal_resample(world, di_chain):
    got = TDI.temporal_resample(
        world.ta, world.tgb, _to_port(di_chain["cand"]),
        _to_port(di_chain["prev"]), world.tgb.normal, world.tgb.view_z,
        world.px, world.py, W, H, FRAME)
    _same_reservoir(got, di_chain["temporal"])


def test_boiling_filter():
    rs = np.random.RandomState(5)
    w = rs.rand(H * 3, W * 2).astype(np.float32).reshape(-1)
    w[rs.rand(w.size) < 0.03] *= 100.0
    n = w.size
    ref = JDI.boiling_filter(JRS.Reservoir(
        jnp.zeros(n, jnp.int32), jnp.zeros((n, 2)), jnp.asarray(w),
        jnp.ones(n), jnp.ones(n)), W * 2, H * 3)
    got = TDI.boiling_filter(torch.as_tensor(w), W * 2, H * 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref.light) == JRS.LIGHT_INVALID)
    assert got.any() and not got.all()


def test_spatial_resample(world, di_chain):
    got = TDI.spatial_resample(world.ta, world.tgb,
                               _to_port(di_chain["temporal"]), world.px,
                               world.py, W, H, FRAME)
    _same_reservoir(got, di_chain["spatial"])


def test_final_shade(world, di_chain):
    got = TDI.final_shade(world.ta, world.tgb, _to_port(di_chain["spatial"]))
    for a, b in zip(got, di_chain["final"]):
        _close(a, b)
    assert float(got[0].sum() + got[1].sum()) > 0.0


@pytest.fixture(scope="module")
def gi_chain(world, di_chain):
    """Random secondary samples around the surface, then the reference's
    GI stages and the fused DI + GI final shading."""
    rs = np.random.RandomState(11)
    j = world
    pos = (np.asarray(j.jgb.pos) + rs.normal(size=(N, 3)) * 0.5
           + np.asarray(j.jgb.normal)).astype(np.float32)
    nrm = rs.normal(size=(N, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)) \
        .astype(np.float32)
    lo = rs.gamma(1.0, 0.5, (N, 3)).astype(np.float32)
    found = rs.rand(N) < 0.85
    pdf = rs.uniform(0.05, 2.0, N).astype(np.float32)
    inputs = [pos, nrm, found, lo, pdf]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTXPT_DENSE_INTERPRET", "1")
        mk = lambda s: JGI.make_initial(j.jgb, *[jnp.asarray(np.roll(
            a, s, 0)) for a in inputs])
        prev, init = mk(7), mk(0)
        temporal = JGI.temporal_resample(j.jgb, init, prev, j.jgb.normal,
                                         j.jgb.view_z, j.jpx, j.jpy, W, H,
                                         FRAME)
        spatial = JGI.spatial_resample(j.jgb, temporal, j.jpx, j.jpy, W, H,
                                       FRAME)
        return dict(inputs=inputs, init=init, prev=prev, temporal=temporal,
                    spatial=spatial,
                    final=JGI.final_shade(j.ja, j.jgb, spatial),
                    fused=JDI.fused_final_shade(j.ja, j.jgb,
                                                di_chain["spatial"],
                                                spatial))


def test_gi_make_initial(world, gi_chain):
    pos, nrm, found, lo, pdf = (torch.as_tensor(a)
                                for a in gi_chain["inputs"])
    got = TGI.make_initial(world.tgb, pos, nrm, found, lo, pdf)
    for f in got._fields:
        _close(getattr(got, f), getattr(gi_chain["init"], f), name=f)


def test_gi_temporal_resample(world, gi_chain):
    got = TGI.temporal_resample(
        world.tgb, _to_port(gi_chain["init"], True),
        _to_port(gi_chain["prev"], True), world.tgb.normal,
        world.tgb.view_z, world.px, world.py, W, H, FRAME)
    _same_gi(got, gi_chain["temporal"])


def test_gi_spatial_resample(world, gi_chain):
    got = TGI.spatial_resample(world.tgb, _to_port(gi_chain["temporal"],
                                                   True),
                               world.px, world.py, W, H, FRAME)
    _same_gi(got, gi_chain["spatial"])


def test_gi_final_shade(world, gi_chain):
    got = TGI.final_shade(world.ta, world.tgb,
                          _to_port(gi_chain["spatial"], True))
    for a, b in zip(got, gi_chain["final"]):
        _close(a, b)
    assert float(got[0].sum()) > 0.0


def test_fused_final_shade(world, di_chain, gi_chain):
    got = TDI.fused_final_shade(world.ta, world.tgb,
                                _to_port(di_chain["spatial"]),
                                _to_port(gi_chain["spatial"], True))
    for a, b in zip(got, gi_chain["fused"]):
        _close(a, b)


# ---- row windows (the row-sharded stage 1, parallel/meshutils.py): the
# current buffers hold rows Y0..Y0+ROWS-1 of the frame, the previous
# frame's rows PREV_Y0..PREV_Y0+PREV_ROWS-1 (a halo of 2 rows)
Y0, ROWS, PREV_Y0, PREV_ROWS = 4, 4, 2, 8
WINDOWED = ["di_temporal", "di_spatial", "gi_temporal", "gi_spatial"]


def _rows_of(tree, y0, rows):
    """Rows y0..y0+rows-1 of every per-pixel array of a NamedTuple tree,
    reference (jax) or port (torch)."""
    if isinstance(tree, tuple):
        return type(tree)(*(_rows_of(x, y0, rows) for x in tree))
    return tree[y0 * W:(y0 + rows) * W]


def _window_calls(world, di_chain, gi_chain, stage):
    """(the reference's call, the port's call) of `stage` on the window's
    rows, each taking the window keywords."""
    j, cur = world, lambda t: _rows_of(t, Y0, ROWS)
    prev = lambda t: _rows_of(t, PREV_Y0, PREV_ROWS)
    jgb, tgb = cur(j.jgb), cur(j.tgb)
    jpx, jpy, px, py = cur(j.jpx), cur(j.jpy), cur(j.px), cur(j.py)
    if stage == "di_temporal":
        return (lambda **k: JDI.temporal_resample(
                    j.ja, jgb, cur(di_chain["cand"]), prev(di_chain["prev"]),
                    prev(j.jgb), jpx, jpy, W, H, FRAME, **k),
                lambda **k: TDI.temporal_resample(
                    j.ta, tgb, _to_port(cur(di_chain["cand"])),
                    _to_port(prev(di_chain["prev"])), prev(j.tgb.normal),
                    prev(j.tgb.view_z), px, py, W, H, FRAME, **k))
    if stage == "di_spatial":
        return (lambda **k: JDI.spatial_resample(
                    j.ja, jgb, cur(di_chain["temporal"]), jpx, jpy, W, H,
                    FRAME, **k),
                lambda **k: TDI.spatial_resample(
                    j.ta, tgb, _to_port(cur(di_chain["temporal"])), px, py,
                    W, H, FRAME, **k))
    if stage == "gi_temporal":
        return (lambda **k: JGI.temporal_resample(
                    jgb, cur(gi_chain["init"]), prev(gi_chain["prev"]),
                    prev(j.jgb.normal), prev(j.jgb.view_z), jpx, jpy, W, H,
                    FRAME, **k),
                lambda **k: TGI.temporal_resample(
                    tgb, _to_port(cur(gi_chain["init"]), True),
                    _to_port(prev(gi_chain["prev"]), True),
                    prev(j.tgb.normal), prev(j.tgb.view_z), px, py, W, H,
                    FRAME, **k))
    return (lambda **k: JGI.spatial_resample(
                jgb, cur(gi_chain["temporal"]), jpx, jpy, W, H, FRAME, **k),
            lambda **k: TGI.spatial_resample(
                tgb, _to_port(cur(gi_chain["temporal"]), True), px, py, W,
                H, FRAME, **k))


@pytest.mark.parametrize("stage", WINDOWED)
def test_row_window_matches_reference(world, di_chain, gi_chain, stage):
    """A stage on a window's rows, with y0/rows (and prev_y0/prev_rows),
    against the reference's on the same rows: the taps and the
    reprojection clamp to the window, the boiling filter's blocks start at
    its first row."""
    ref_fn, port_fn = _window_calls(world, di_chain, gi_chain, stage)
    kw = dict(y0=Y0, rows=ROWS)
    if stage.endswith("temporal"):
        kw.update(prev_y0=PREV_Y0, prev_rows=PREV_ROWS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RTXPT_DENSE_INTERPRET", "1")
        ref = ref_fn(**kw)
    got = port_fn(**kw)
    assert got.m.shape[0] == ROWS * W
    (_same_gi if stage.startswith("gi") else _same_reservoir)(got, ref)
    # the window changes the result: the whole-frame clamp reads rows
    # outside the window's buffers
    assert not all(torch.equal(a, b) for a, b in zip(
        got, port_fn(y0=0, rows=ROWS, prev_y0=0, prev_rows=PREV_ROWS)
        if stage.endswith("temporal") else port_fn(y0=0, rows=ROWS)))


@pytest.mark.parametrize("stage", WINDOWED)
def test_whole_frame_window_is_default(world, di_chain, gi_chain, stage):
    """The window keywords set to the whole frame leave a call bit-equal to
    the call without them."""
    j = world
    if stage == "di_temporal":
        call = lambda **k: TDI.temporal_resample(
            j.ta, j.tgb, _to_port(di_chain["cand"]),
            _to_port(di_chain["prev"]), j.tgb.normal, j.tgb.view_z, j.px,
            j.py, W, H, FRAME, **k)
    elif stage == "di_spatial":
        call = lambda **k: TDI.spatial_resample(
            j.ta, j.tgb, _to_port(di_chain["temporal"]), j.px, j.py, W, H,
            FRAME, **k)
    elif stage == "gi_temporal":
        call = lambda **k: TGI.temporal_resample(
            j.tgb, _to_port(gi_chain["init"], True),
            _to_port(gi_chain["prev"], True), j.tgb.normal, j.tgb.view_z,
            j.px, j.py, W, H, FRAME, **k)
    else:
        call = lambda **k: TGI.spatial_resample(
            j.tgb, _to_port(gi_chain["temporal"], True), j.px, j.py, W, H,
            FRAME, **k)
    kw = dict(y0=0, rows=H)
    if stage.endswith("temporal"):
        kw.update(prev_y0=0, prev_rows=H)
    for a, b in zip(call(**kw), call()):
        assert torch.equal(a, b)
