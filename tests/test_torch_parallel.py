"""Multi-device rendering (rtxpt_tpu_torch/parallel/) on CPU ranks against
the reference's shard_map programs and the port's single-device results.

One spawn of four rank processes (tests/parallel_ranks.py; gloo on CPU
tensors, a FileStore under tmp_path) runs every multi-rank case; this
process computes the oracles meanwhile: the reference's halo exchange and
sharded denoiser on 4 of the 8 virtual CPU devices (tests/conftest.py),
and the port's single-device render and frames.

- The halo exchange equals the reference's exactly (halo 1 and 3).
- denoise_taa_sharded equals the reference's on the inputs of
  tests/test_parallel.py:66-97, two frames, every row, rtol 2e-4 / atol
  2e-5.
- render_image_sharded equals the single-device render_sample bit for bit.
- The row-sharded stage 1 (RealtimeRenderer(mesh=), both pipelines,
  32x192, two frames, no denoiser or TAA) meets the reference's seam
  contract (tests/test_parallel.py:122-163): rtol 1e-4 / atol 1e-5 off a
  band of 21 rows about each seam, and the last frame's band mean within
  15% (spatial taps clamp to the slab, so pixels near a seam draw other
  taps; the estimator stays the same). What stage 1 hands the next frame
  (the temporal passes' reservoirs, the G-buffer) equals the
  single-device frame's on every row, seams included, wherever the
  reprojection stays inside the rank's rows and halo.
- With the denoiser and TAA on (48x40, and 48x42, whose rows do not
  divide, so stage 1 runs whole on every rank) every rank returns the same
  finite whole frame.
- ReBLUR with a mesh raises; no rank imports jax or rtxpt_tpu.
- No module of rtxpt_tpu_torch/parallel/ imports the model layer."""
import ast
import pathlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import parallel_ranks as PR
from rtxpt_tpu.parallel import halo as JH
from rtxpt_tpu.parallel import meshutils as JM
from rtxpt_tpu_torch.models.realtime import RealtimeRenderer, dominant_motion
from rtxpt_tpu_torch.models.renderer import Renderer
from rtxpt_tpu_torch.parallel import halo, meshutils
from rtxpt_tpu_torch.scene import procedural

RANKS = 4
TIMEOUT_S = 600
SEAM_BAND = 21


def _reference_halo(mesh, a, h):
    f = jax.jit(jax.shard_map(
        lambda x: JH.exchange_row_halo(x, h, JM.TILE_AXIS), mesh=mesh,
        in_specs=P(JM.TILE_AXIS), out_specs=P(JM.TILE_AXIS)))
    return np.asarray(f(jnp.asarray(a)))


def _reference_post(mesh):
    rad, nrm, z, mot = (jnp.asarray(a) for a in PR.post_inputs())
    c1, den, taa = JM.denoise_taa_sharded(mesh, None, None, rad, nrm, z, mot)
    c2, _, _ = JM.denoise_taa_sharded(mesh, den, taa, rad * 0.5, nrm, z, mot)
    return dict(color=[np.asarray(c1), np.asarray(c2)],
                den_radiance=np.asarray(den.radiance))


def _single_device(host):
    """The port's single-device oracles: the 1-spp render and the frames
    of both pipelines."""
    torch.set_num_threads(2)
    w, h = PR.RENDER_W, PR.RENDER_H
    r = Renderer(host, procedural.default_camera(w, h), PR.render_config(),
                 env_radiance=PR.sky(), device="cpu")
    out = dict(render=r.render_sample(w, h, 0, jitter_aa=False).numpy())
    for stable in (False, True):
        r = RealtimeRenderer(host, procedural.default_camera(PR.FRAME_W,
                                                             PR.FRAME_H),
                             PR.frame_config(stable), env_radiance=PR.sky(),
                             device="cpu")
        for k in ("frames", "feedback", "motion"):
            out[f"{k}_{stable}"] = []
        for _ in range(2):
            out[f"frames_{stable}"].append(
                r.render_frame(PR.FRAME_W, PR.FRAME_H, taa=False).numpy())
            out[f"feedback_{stable}"].append(PR.feedback(r))
            # the G-buffer's motion, which the temporal passes reproject by
            out[f"motion_{stable}"].append((
                dominant_motion(r.last_stable_planes, PR.FRAME_H, PR.FRAME_W)
                if stable else r.last_outputs.motion).numpy())
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the ranks, compute the oracles while they run, collect."""
    d = tmp_path_factory.mktemp("ranks")
    ctx = mp.start_processes(PR.main, args=(RANKS, str(d / "store"), str(d)),
                              nprocs=RANKS, start_method="spawn", join=False)
    try:
        mesh = JM.make_mesh(jax.devices()[:RANKS])
        f, i, b = PR.halo_inputs(RANKS)
        ref_halo = {h: [_reference_halo(mesh, a, h) for a in (f, f, i, b)]
                    for h in (1, 3)}
        ref_post = _reference_post(mesh)
        single = _single_device(procedural.build_programmer_art().finish())
        deadline = time.monotonic() + TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 1.0)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks ran past {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    res = [torch.load(d / f"rank{r}.pt") for r in range(RANKS)]
    return SimpleNamespace(res=res, halo=ref_halo, post=ref_post, **single)


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


@pytest.mark.parametrize("h", [1, 3])
def test_halo_exchange_matches_reference(ranks, h):
    for k, ref in enumerate(ranks.halo[h]):
        got = np.concatenate([_np(r["halo"][h][k]) for r in ranks.res])
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_halo_exchange_one_rank_clamps():
    """With one rank nothing is sent: the pad repeats the edge rows."""
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    got = halo.exchange_row_halo(x, 2, SimpleNamespace(size=1))
    want = torch.cat([x[:1], x[:1], x, x[-1:], x[-1:]])
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        halo.exchange_row_halo(x, 5, SimpleNamespace(size=1))


def test_denoise_taa_sharded_matches_reference(ranks):
    for r in ranks.res:
        for got, ref in zip(r["post"]["color"], ranks.post["color"]):
            np.testing.assert_allclose(_np(got), ref, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(_np(r["post"]["den_radiance"]),
                                   ranks.post["den_radiance"], rtol=2e-4,
                                   atol=2e-5)


def test_render_image_sharded_bit_equal(ranks):
    for r in ranks.res:
        np.testing.assert_array_equal(_np(r["render"]), ranks.render)


@pytest.mark.parametrize("stable", [False, True],
                         ids=["psr_lite", "stable_planes"])
def test_stage1_sharded_seam_contract(ranks, stable):
    key = f"frames_{stable}"
    got = ranks.res[0][key]
    assert got["sharded"]
    assert got["halo_bytes"] > 0 and got["gather_calls"] > 0
    h = PR.FRAME_H
    rows = h // RANKS
    band = np.zeros(h, bool)
    for s in range(rows, h, rows):
        band[max(s - SEAM_BAND, 0):min(s + SEAM_BAND, h)] = True
    for f, (img, one) in enumerate(zip(got["imgs"], getattr(ranks, key))):
        img = _np(img)
        for r in ranks.res[1:]:
            np.testing.assert_array_equal(_np(r[key]["imgs"][f]), img)
        assert np.isfinite(img).all()
        np.testing.assert_allclose(img[~band], one[~band], rtol=1e-4,
                                   atol=1e-5)
        differ = int((img[~band] != one[~band]).any(-1).sum())
        print(f"{key} frame {f}: {differ} of {(~band).sum() * PR.FRAME_W} "
              f"off-band pixels not bit-equal; band means "
              f"{img[band].mean():.6f} sharded, {one[band].mean():.6f} one "
              "device")
    a, b = img[band].mean(), one[band].mean()
    assert abs(a - b) < 0.15 * max(abs(b), 1e-3), (a, b)


@pytest.mark.parametrize("stable", [False, True],
                         ids=["psr_lite", "stable_planes"])
def test_stage1_sharded_feedback_every_row(ranks, stable):
    """What stage 1 hands the next frame comes from its temporal passes
    only, which read the previous frame at the reprojected pixel, within
    the rank's rows and the exchanged halo (STAGE1_HALO). On every row,
    seams included, each pixel whose reprojection lands in that window
    equals the single-device frame's, so the row window's prev_y0, the
    halo's rows and the order of the packed reservoirs are held at every
    seam, which the images' band leaves open. A pixel whose motion
    reaches past the halo reads the window's edge row instead, in the
    reference as here (restir/window.py); those are counted."""
    h, w = PR.FRAME_H, PR.FRAME_W
    rows = h // RANKS
    halo = min(meshutils.STAGE1_HALO, rows - 1)
    y = np.arange(h)[:, None]
    rank = y // rows
    seen = 0
    for f, one in enumerate(getattr(ranks, f"feedback_{stable}")):
        held = np.ones((h, w), bool)
        if f:
            mot = getattr(ranks, f"motion_{stable}")[f]
            src = np.clip(np.round(y + mot[..., 1]), 0, h - 1)
            held = (src >= rank * rows - halo) & (src < (rank + 1) * rows
                                                   + halo)
            # pixels that read a neighbour's rows through the halo
            seen += int((held & (src // rows != rank)).sum())
        assert held.mean() > 0.99, (f, int((~held).sum()))
        held = held.reshape(-1)
        assert set(one) == set(ranks.res[0][f"frames_{stable}"][
            "feedback"][f])
        for name, want in one.items():
            got = np.concatenate([_np(r[f"frames_{stable}"]["feedback"][f][
                name]) for r in ranks.res])[held]
            want = _np(want)[held]
            assert got.shape == want.shape and got.dtype == want.dtype
            if want.dtype.kind == "f":
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                           err_msg=f"frame {f} {name}")
            else:
                np.testing.assert_array_equal(got, want,
                                              err_msg=f"frame {f} {name}")
            print(f"feedback frame {f} {name}: "
                  f"{int((got != want).reshape(len(got), -1).any(-1).sum())}"
                  f" of {len(got)} held pixels not bit-equal "
                  f"({h * w - len(got)} reproject past the halo)")
    assert seen > 0


@pytest.mark.parametrize("stable", [False, True],
                         ids=["psr_lite", "stable_planes"])
@pytest.mark.parametrize("h", [PR.SMOKE_H, PR.SMOKE_ODD_H])
def test_realtime_mesh_denoised_frames(ranks, stable, h):
    key = f"smoke_{stable}_{h}"
    assert ranks.res[0][key]["sharded"] == (h % RANKS == 0)
    for f, img in enumerate(ranks.res[0][key]["imgs"]):
        img = _np(img)
        assert img.shape == (h, PR.SMOKE_W, 3)
        assert np.isfinite(img).all() and img.mean() > 0.01
        for r in ranks.res[1:]:
            np.testing.assert_array_equal(_np(r[key]["imgs"][f]), img)


def test_reblur_with_mesh_raises(ranks):
    for r in ranks.res:
        assert "ReLAX only" in r["reblur"], r["reblur"]


def test_ranks_import_no_jax(ranks):
    for r in ranks.res:
        assert r["imports_jax"] == []


def test_parallel_imports_no_models():
    """parallel/ sits below the model layer: no module of it imports
    rtxpt_tpu_torch.models, at module level or inside a function, by a
    relative or an absolute name. The renderer drives the sharded frame."""
    pkg = pathlib.Path(meshutils.__file__).parent
    found = []
    for path in sorted(pkg.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                targets = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                base = "rtxpt_tpu_torch.parallel".split(".")
                base = base[:len(base) - node.level + 1] if node.level \
                    else []
                module = ".".join(base + ([node.module] if node.module
                                          else []))
                targets = [module] + [f"{module}.{a.name}"
                                      for a in node.names]
            else:
                continue
            found += [f"{path.name}:{node.lineno} {t}" for t in targets
                      if t == "rtxpt_tpu_torch.models"
                      or t.startswith("rtxpt_tpu_torch.models.")]
    assert len(list(pkg.glob("*.py"))) >= 3
    assert found == []


def test_one_rank_mesh_is_single_device():
    """A mesh of one rank renders as no mesh: nothing is sharded."""
    mesh = meshutils.Mesh(group=None, rank=0, size=1,
                          device=torch.device("cpu"), backend="gloo")
    host = procedural.build_programmer_art().finish()
    w, h = 16, 12
    cfg = PR.smoke_config(True)
    frames = []
    for m in (None, mesh):
        r = RealtimeRenderer(host, procedural.default_camera(w, h), cfg,
                             env_radiance=PR.sky(), mesh=m, device="cpu")
        frames.append([r.render_frame(w, h) for _ in range(2)])
    for a, b in zip(*frames):
        assert torch.equal(a, b)
    assert mesh.stats.halo_calls == mesh.stats.gather_calls == 0
