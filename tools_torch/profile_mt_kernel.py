"""Dense-trace lab: the port's counterpart of tools/profile_mt_kernel.py
(K9). On the bench config's first traces of programmer-art at 800x600
(the camera rays, the first bounce's scatter rays, the first NEE rays),
prints the worklist statistics (visits per tile: the exact and interval
prepasses over tiles of 128 and 1024 lane indices; the fused kernel's
tiles are the 128-lane ones), the time of K7, of K1 walking K7's lists
and of the fused trace, and the time of the lab modes of both.

K1 walking given worklists (`rtxpt_mt_dense_variant`, closest hit):

    full     K1 (mode 0)
    noskip   no block-uniform skip: every worklist cluster is staged
    nogate   every worklist cluster is tested by every active lane
    gate     the worklist walk and slab gates only; each lane's count of
             visited clusters, held against `gate_visits_plain`
    inorder  all clusters in slot order (K1 before the worklists)

The fused trace (`rtxpt_mt_dense_fused_variant`, closest and any-hit):

    fused      the main path's kernel
    lists      keys and worklists only: each lane's tile's list length,
               held against `tile_worklists`

    python -m tools_torch.profile_mt_kernel

Needs a CUDA GPU.
"""
from __future__ import annotations

import torch

from rtxpt_tpu_torch.ops import cuda_lib
from rtxpt_tpu_torch.ops import mt_dense as M
from rtxpt_tpu_torch.ops.intersect import safe_inv
from tools_torch.kernel_lab import time_ms

MODES = ("full", "noskip", "nogate", "gate", "inorder")
_KERNEL_MODE = {"full": 0, "noskip": 1, "nogate": 2, "gate": 3,
                "inorder": 0}       # csrc/mt_dense.cu enum Mode
FUSED_MODES = ("fused", "lists")
_FUSED_MODE = {m: i for i, m in enumerate(FUSED_MODES)}   # enum FusedMode
SOURCE = "rtxpt_tpu_torch/csrc/mt_dense.cu"
REPLACES = "tools/profile_mt_kernel.py:171"


def inorder_worklists(nc: int, tiles: int, device):
    """Every cluster on every tile's list, in slot order."""
    return (torch.full((tiles,), nc, dtype=torch.int32, device=device),
            torch.arange(nc, dtype=torch.int32, device=device)
            .expand(tiles, nc).contiguous())


@cuda_lib.counted("mt_dense_variant")
def trace_variant(aabb_c, tri12, origins_c, dirs, t_max, active, mode: str,
                  worklists=None):
    """Closest-hit K1 (rows `tri12`) in lab mode `mode` over tiles of
    M.TILE lanes, with `worklists` (default: K7's) -> (t, slot); in mode
    "gate", slot holds each lane's count of visited clusters and t its
    t_max. It has no OMM channel: a masked table raises."""
    if M.has_masks(tri12):
        raise ValueError("the K1 lab has no OMM channel")
    if not cuda_lib.on_cuda(aabb_c, tri12, origins_c, dirs, t_max, active):
        raise ValueError("the dense-trace lab runs on a CUDA device")
    n, nc = origins_c.shape[0], aabb_c.shape[0]
    tiles = (n + M.TILE - 1) // M.TILE
    if mode == "inorder":
        worklists = inorder_worklists(nc, tiles, aabb_c.device)
    elif worklists is None:
        worklists = M.tile_worklists(aabb_c, origins_c, dirs, t_max, active)
    counts, order = worklists
    cuda_lib.check(counts, "counts", torch.int32, (tiles,))
    cuda_lib.check(order, "order", torch.int32, (tiles, nc))
    t = torch.empty((n,), dtype=torch.float32, device=dirs.device)
    slot = torch.empty((n,), dtype=torch.int32, device=dirs.device)
    if n:
        cuda_lib.bump("mt_dense_variant")
        cuda_lib.launch("rtxpt_mt_dense_variant", aabb_c.data_ptr(),
                        tri12.data_ptr(), nc, counts.data_ptr(),
                        order.data_ptr(), origins_c.data_ptr(),
                        dirs.data_ptr(), t_max.data_ptr(), active.data_ptr(),
                        t.data_ptr(), slot.data_ptr(), n, _KERNEL_MODE[mode])
    return t, slot


@cuda_lib.counted("mt_dense_fused_variant")
def trace_fused_variant(aabb_c, tri12, origins_c, dirs, t_max, active,
                        mode: str, any_hit: bool):
    """The fused trace in lab mode `mode` -> (t, slot); in mode "lists",
    slot holds the length of each lane's tile's worklist and t its
    t_max. Mode "fused" has no OMM channel: a masked table raises."""
    if mode != "lists" and M.has_masks(tri12):
        raise ValueError("the fused K1 lab has no OMM channel")
    if not cuda_lib.on_cuda(aabb_c, tri12, origins_c, dirs, t_max, active):
        raise ValueError("the dense-trace lab runs on a CUDA device")
    return M.launch_fused("rtxpt_mt_dense_fused_variant",
                          "mt_dense_fused_variant", aabb_c, tri12, origins_c,
                          dirs, t_max, active, any_hit, _FUSED_MODE[mode])


def list_lengths_plain(aabb_c, origins_c, dirs, t_max, active):
    """Plain version of mode "lists": the length of each lane's tile's
    worklist (`M.tile_worklists`; int32)."""
    counts, _ = M.tile_worklists(aabb_c, origins_c, dirs, t_max, active)
    lanes = torch.arange(active.shape[0], device=active.device)
    return counts[lanes // M.TILE]


def list_visits(args):
    """(visits, tiles) of the fused kernel's worklists on a trace's
    arguments, both on the device: the lists' total length and the
    number of tiles (mode "lists"; no host sync)."""
    _, lengths = trace_fused_variant(*args, mode="lists", any_hit=False)
    first = lengths[::M.TILE]
    return first.sum(), first.numel()


def run_fused_modes(args, kw) -> dict:
    """Each mode of `FUSED_MODES` on the trace `args` against the plain
    version over all clusters (the same winner (closest) or occlusion
    flag (any-hit) on >= 99.99% of active lanes; "lists": lengths equal
    to `list_lengths_plain`) -> {mode: (ms, agreement)}."""
    aabb_c, tri12, o_c, d, tmax, act = args
    any_hit = kw["any_hit"]
    _, s_p = M.trace_dense_plain(aabb_c, M.tri9_from_tri12(tri12), o_c, d,
                                 tmax, act, any_hit)
    n_act = max(int(act.sum()), 1)
    out = {}
    for mode in FUSED_MODES:
        _, slot = trace_fused_variant(*args, mode=mode, any_hit=any_hit)
        if mode == "lists":
            ref = list_lengths_plain(aabb_c, o_c, d, tmax, act)
            ok = bool(torch.equal(slot, ref))
            agree = float((slot == ref)[act].sum()) / n_act
        else:
            same = (slot >= 0) == (s_p >= 0) if any_hit else slot == s_p
            agree = float(same[act].sum()) / n_act
            ok = agree >= 0.9999
        if not ok:
            raise RuntimeError(f"fused mode {mode}: agreement {agree} with "
                               "the plain version")
        out[mode] = (time_ms(lambda: trace_fused_variant(
            *args, mode=mode, any_hit=any_hit), 20), agree)
    return out


def gate_visits_plain(aabb_c, origins_c, dirs, t_max, active, worklists,
                      tile: int = M.TILE):
    """Plain version of mode "gate": per lane, the clusters of its tile's
    worklist whose slab gate against t_max passes (int32)."""
    member = M.worklist_mask(worklists)
    inv = safe_inv(dirs)
    lo, hi = aabb_c[None, :, 0:3], aabb_c[None, :, 3:6]
    out = []
    for s in range(0, origins_c.shape[0], 1 << 14):
        sl = slice(s, s + (1 << 14))
        t0 = (lo - origins_c[sl, None]) * inv[sl, None]
        t1 = (hi - origins_c[sl, None]) * inv[sl, None]
        tn = torch.clamp(torch.amax(torch.minimum(t0, t1), -1), min=0.0)
        tf = torch.minimum(torch.amin(torch.maximum(t0, t1), -1),
                           t_max[sl, None])
        lanes = torch.arange(s, s + tn.shape[0], device=aabb_c.device)
        live = (tn <= tf) & active[sl, None] & member[lanes // tile]
        out.append(live.sum(1).to(torch.int32))
    return torch.cat(out)


def visits(counts) -> str:
    """Visits per tile of worklists with these counts: mean, max, total."""
    c = counts.double()
    return (f"mean {float(c.mean()):.2f} max {int(c.max())} total "
            f"{int(c.sum())} over {c.numel()} tiles")


def capture_traces(w: int = 800, h: int = 600):
    """The (args, kw) of the first dense traces (`trace_dense_fused`) of
    one bench-config sample of programmer-art at w x h: {"camera",
    "scatter", "nee"}."""
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    cfg = reference_config(max_bounces=6, max_diffuse_bounces=4,
                           nee_distant_samples=1, nee_local_samples=1)
    r = Renderer(procedural.build_programmer_art().finish(),
                 procedural.default_camera(w, h), cfg,
                 env_radiance=EM.bake_procedural_sky(height=64),
                 device="cuda")
    calls, orig = [], M.trace_dense_fused

    def capture(*args, **kw):
        calls.append(([a.clone() if torch.is_tensor(a) else a
                       for a in args], dict(kw)))
        return orig(*args, **kw)

    M.trace_dense_fused = capture
    try:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()
    finally:
        M.trace_dense_fused = orig
    closest = [c for c in calls if not c[1]["any_hit"]]
    anyhit = [c for c in calls if c[1]["any_hit"]]
    return {"camera": closest[0], "scatter": closest[1], "nee": anyhit[0]}


def run_modes(args) -> dict:
    """Each mode of `MODES` on the closest-hit trace `args` against the
    plain K1 (same winner on >= 99.99% of active lanes; "gate": visit
    counts equal to `gate_visits_plain`) -> {mode: (ms, agreement)}."""
    aabb_c, tri12, o_c, d, tmax, act = args
    wl = M.tile_worklists(aabb_c, o_c, d, tmax, act)
    _, s_p = M.trace_dense_plain(aabb_c, M.tri9_from_tri12(tri12), o_c, d,
                                 tmax, act, any_hit=False)
    n_act = max(int(act.sum()), 1)
    out = {}
    for mode in MODES:
        t, slot = trace_variant(*args, mode=mode, worklists=wl)
        if mode == "gate":
            ref = gate_visits_plain(aabb_c, o_c, d, tmax, act, wl)
            agree = float((slot == ref)[act].sum()) / n_act
            ok = bool(torch.equal(slot, ref))
        else:
            agree = float((slot == s_p)[act].sum()) / n_act
            ok = agree >= 0.9999
        if not ok:
            raise RuntimeError(f"K1 mode {mode}: agreement {agree} with the "
                               "plain version")
        out[mode] = (time_ms(lambda: trace_variant(*args, mode=mode,
                                                   worklists=wl), 20), agree)
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_mt_kernel needs a CUDA GPU")
    import subprocess
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    traces = capture_traces()
    print(f"{card}; programmer-art 800x600, "
          f"{traces['camera'][0][0].shape[0]} clusters")
    for what in ("camera", "scatter", "nee"):
        args, kw = traces[what]
        aabb_c, _, o_c, d, tmax, act = args
        print(f"--- {what} rays ({'any' if kw['any_hit'] else 'closest'}"
              f" hit): {o_c.shape[0]} lanes, {int(act.sum())} active",
              flush=True)
        for tile in (M.TILE, 1024):
            ex = M.tile_worklists(aabb_c, o_c, d, tmax, act, tile)
            iv = M.tile_worklists_interval(aabb_c, o_c, d, tmax, act, tile)
            print(f"visits/tile at tile {tile}: exact {visits(ex[0])}; "
                  f"interval {visits(iv[0])}")
        k7 = time_ms(lambda: M.tile_keys(aabb_c, o_c, d, tmax, act), 20)
        trace = time_ms(lambda: M.trace_dense(*args, kw["any_hit"]), 20)
        fused = time_ms(lambda: M.trace_dense_fused(*args, **kw), 20)
        print(f"K7 (keys and sorted worklists) {k7:.4f} ms; K7 + K1 "
              f"(trace_dense) {trace:.4f} ms; fused (trace_dense_fused) "
              f"{fused:.4f} ms")
        for mode, (ms, agree) in run_fused_modes(args, kw).items():
            print(f"fused mode {mode:9s} {ms:8.4f} ms (agreement with plain "
                  f"{agree:.6%})", flush=True)
        if kw["any_hit"]:
            continue
        for mode, (ms, agree) in run_modes(args).items():
            print(f"K1 mode {mode:8s} {ms:8.4f} ms (agreement with plain "
                  f"{agree:.6%})", flush=True)


if __name__ == "__main__":
    main()
