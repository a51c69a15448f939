"""The rank processes of tests/test_torch_parallel.py: each rank runs every
multi-rank case on its rows and saves what it got for the test process to
compare. A rank imports torch and the port only, never jax or rtxpt_tpu
(the test asserts it), as a rank on a GPU machine must.

Ranks are started with torch.multiprocessing's spawn context; they meet
through a FileStore and talk over gloo on CPU tensors."""
import sys

import numpy as np
import torch
import torch.distributed as dist

from rtxpt_tpu_torch import config as C
from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
from rtxpt_tpu_torch.models.renderer import (Renderer, realtime_config,
                                             reference_config)
from rtxpt_tpu_torch.parallel import halo, meshutils
from rtxpt_tpu_torch.scene import envmap as EM
from rtxpt_tpu_torch.scene import procedural

HALO_SHAPE = (8, 16)        # each rank's slab in the halo case
POST_H, POST_W = 160, 48    # tests/test_parallel.py:66-97
RENDER_W, RENDER_H = 32, 16
FRAME_W, FRAME_H = 32, 192
SMOKE_W, SMOKE_H = 48, 40
SMOKE_ODD_H = 42            # not divisible by 4: stage 1 on every rank


def halo_inputs(n: int):
    """The frames whose row slabs the halo case exchanges: float32 (H, W),
    int32 (H, W, 2) and bool (H, W)."""
    h, w = HALO_SHAPE[0] * n, HALO_SHAPE[1]
    f = np.arange(h * w, dtype=np.float32).reshape(h, w)
    i = np.random.RandomState(3).randint(-2**31, 2**31 - 1, (h, w, 2),
                                         dtype=np.int64).astype(np.int32)
    b = np.random.RandomState(4).rand(h, w) < 0.5
    return f, i, b


def post_inputs():
    """The denoiser case's inputs (tests/test_parallel.py:73-77)."""
    rad = np.random.default_rng(0).random((POST_H, POST_W, 3),
                                          dtype=np.float32)
    nrm = np.tile(np.asarray([0.0, 1.0, 0.0], np.float32),
                  (POST_H, POST_W, 1))
    z = np.ones((POST_H, POST_W), np.float32)
    mot = np.zeros((POST_H, POST_W, 2), np.float32)
    return rad, nrm, z, mot


def render_config():
    return reference_config(max_bounces=3, max_diffuse_bounces=2,
                            nee_distant_samples=1, nee_local_samples=1)


def frame_config(stable: bool):
    """tests/test_parallel.py:122-163: ReSTIR DI + GI, no denoiser."""
    return realtime_config(use_restir_di=True, use_restir_gi=True,
                           denoiser_enabled=False, use_stable_planes=stable,
                           max_bounces=3, max_diffuse_bounces=2)


def smoke_config(stable: bool):
    """tests/test_parallel.py:100-119: the denoiser and TAA on."""
    return realtime_config(use_restir_di=False, use_restir_gi=False,
                           denoiser_enabled=True, use_stable_planes=stable,
                           max_bounces=2, max_diffuse_bounces=1)


def sky():
    return EM.bake_procedural_sky(height=32)


def feedback(r):
    """What a realtime frame hands the next on this rank's rows: the DI
    and GI feedback reservoirs (their temporal passes' outputs), the
    G-buffer normal and view z; {name: tensor}."""
    out = {f"di.{k}": v for k, v in r.prev_reservoir._asdict().items()}
    out.update({f"gi.{k}": v for k, v in r.prev_gi._asdict().items()})
    out.update(gb_normal=r.prev_gb_normal, gb_view_z=r.prev_gb_z)
    return out


def _halo_case(mesh):
    f, i, b = halo_inputs(mesh.size)
    rows = HALO_SHAPE[0]
    own = slice(mesh.rank * rows, (mesh.rank + 1) * rows)
    out = {}
    for h in (1, 3):
        out[h] = [halo.exchange_row_halo(torch.as_tensor(f[own]), h, mesh)] \
            + halo.exchange_row_halos([torch.as_tensor(a[own])
                                       for a in (f, i, b)], h, mesh)
    return out


def _post_case(mesh):
    rad, nrm, z, mot = (torch.as_tensor(a) for a in post_inputs())
    rows = lambda a: meshutils.shard_rows(mesh, a)
    c1, den, taa = meshutils.denoise_taa_sharded(
        mesh, None, None, rows(rad), rows(nrm), rows(z), rows(mot))
    c2, _, _ = meshutils.denoise_taa_sharded(
        mesh, den, taa, rows(rad * 0.5), rows(nrm), rows(z), rows(mot))
    whole = lambda a: meshutils.gather_rows(mesh, a, POST_H)
    return dict(color=[whole(c1), whole(c2)],
                den_radiance=whole(den.radiance))


def _render_case(mesh, host):
    cfg = render_config()
    w, h = RENDER_W, RENDER_H
    r = Renderer(host, procedural.default_camera(w, h), cfg,
                 env_radiance=sky(), device=mesh.device)
    return meshutils.render_image_sharded(
        r.assets, r._camera(w, h, (0.0, 0.0)), cfg, C.default_constants(0),
        w, h, mesh)


def _frames(mesh, host, cfg, w, h, frames=2, **kw):
    """(renderer, its frames, its feedback after each frame)."""
    r = RealtimeRenderer(host, procedural.default_camera(w, h), cfg,
                         env_radiance=sky(), mesh=mesh)
    imgs, fbs = [], []
    for _ in range(frames):
        imgs.append(r.render_frame(w, h, **kw))
        fbs.append(feedback(r))
    return r, imgs, fbs


def main(rank: int, size: int, store_path: str, out_dir: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, size),
                            rank=rank, world_size=size)
    try:
        mesh = meshutils.make_mesh()
        host = procedural.build_programmer_art().finish()
        res = dict(halo=_halo_case(mesh), post=_post_case(mesh),
                   render=_render_case(mesh, host))
        try:
            RealtimeRenderer(host, procedural.default_camera(8, 8),
                             realtime_config(denoiser_method="reblur"),
                             mesh=mesh)
            res["reblur"] = "no error"
        except ValueError as e:
            res["reblur"] = str(e)
        for stable in (False, True):
            mesh.stats = meshutils.CommStats()
            r, imgs, fbs = _frames(mesh, host, frame_config(stable),
                                   FRAME_W, FRAME_H, taa=False)
            res[f"frames_{stable}"] = dict(
                imgs=imgs, feedback=fbs, sharded=r._shard_stage1(FRAME_H),
                halo_bytes=mesh.stats.halo_bytes,
                gather_calls=mesh.stats.gather_calls)
            for h in (SMOKE_H, SMOKE_ODD_H):
                r, imgs, _ = _frames(mesh, host, smoke_config(stable),
                                     SMOKE_W, h)
                res[f"smoke_{stable}_{h}"] = dict(
                    imgs=imgs, sharded=r._shard_stage1(h))
        res["imports_jax"] = sorted(
            m for m in sys.modules if m in ("jax", "rtxpt_tpu")
            or m.startswith(("jax.", "rtxpt_tpu.")))
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
