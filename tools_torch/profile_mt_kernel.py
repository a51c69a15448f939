"""Dense-trace lab: the port's counterpart of tools/profile_mt_kernel.py
(K9). On the programmer-art 800x600 camera rays and the first bounce's
scatter rays (the bench config's first closest-hit traces), prints the
worklist statistics (visits per tile, exact and interval prepasses, at
tiles of 128 and 1024 lanes), the time of K7 and of K1 (closest, and
any-hit on the first NEE rays), and the time of K1's ablated modes:

    full     K1 (`rtxpt_mt_dense_variant` mode 0)
    noskip   no block-uniform skip: every worklist cluster is staged
    nogate   every worklist cluster is tested by every active lane
    gate     the worklist walk and slab gates only; each lane's count of
             visited clusters, held against `gate_visits_plain`
    inorder  all clusters in slot order (K1 before the worklists)

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
SOURCE = "rtxpt_tpu_torch/csrc/mt_dense.cu"
REPLACES = "tools/profile_mt_kernel.py:171"


def inorder_worklists(nc: int, tiles: int, device):
    """Every cluster on every tile's list, in slot order."""
    return (torch.full((tiles,), nc, dtype=torch.int32, device=device),
            torch.arange(nc, dtype=torch.int32, device=device)
            .expand(tiles, nc).contiguous())


@cuda_lib.counted("mt_dense_variant")
def trace_variant(aabb_c, tri9, origins_c, dirs, t_max, active, mode: str,
                  worklists=None):
    """Closest-hit K1 in lab mode `mode` over tiles of M.TILE lanes, with
    `worklists` (default: K7's) -> (t, slot); in mode "gate", slot holds
    each lane's count of visited clusters and t its t_max."""
    if not cuda_lib.on_cuda(aabb_c, tri9, origins_c, dirs, t_max, active):
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
                        tri9.data_ptr(), nc, counts.data_ptr(),
                        order.data_ptr(), origins_c.data_ptr(),
                        dirs.data_ptr(), t_max.data_ptr(), active.data_ptr(),
                        t.data_ptr(), slot.data_ptr(), n, _KERNEL_MODE[mode])
    return t, slot


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
    """The (args, kw) of the first K1 calls of one bench-config sample of
    programmer-art at w x h: {"camera", "scatter", "nee"}."""
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    cfg = reference_config(max_bounces=6, max_diffuse_bounces=4,
                           nee_distant_samples=1, nee_local_samples=1)
    r = Renderer(procedural.build_programmer_art().finish(),
                 procedural.default_camera(w, h), cfg,
                 env_radiance=EM.bake_procedural_sky(height=64),
                 device="cuda")
    calls, orig = [], M.trace_dense

    def capture(*args, **kw):
        calls.append(([a.clone() if torch.is_tensor(a) else a
                       for a in args], dict(kw)))
        return orig(*args, **kw)

    M.trace_dense = capture
    try:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()
    finally:
        M.trace_dense = orig
    closest = [c for c in calls if not c[1]["any_hit"]]
    anyhit = [c for c in calls if c[1]["any_hit"]]
    return {"camera": closest[0], "scatter": closest[1], "nee": anyhit[0]}


def run_modes(args) -> dict:
    """Each mode of `MODES` on the closest-hit trace `args` against the
    plain K1 (same winner on >= 99.99% of active lanes; "gate": visit
    counts equal to `gate_visits_plain`) -> {mode: (ms, agreement)}."""
    aabb_c, tri9, o_c, d, tmax, act = args
    wl = M.tile_worklists(aabb_c, o_c, d, tmax, act)
    _, s_p = M.trace_dense_plain(*args, any_hit=False)
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
    traces = capture_traces()
    print(f"{torch.cuda.get_device_name(0)}; programmer-art 800x600, "
          f"{traces['camera'][0][0].shape[0]} clusters")
    for what in ("camera", "scatter"):
        args, _ = traces[what]
        aabb_c, _, o_c, d, tmax, act = args
        print(f"--- {what} rays: {o_c.shape[0]} lanes, {int(act.sum())} "
              f"active", flush=True)
        for tile in (M.TILE, 1024):
            ex = M.tile_worklists(aabb_c, o_c, d, tmax, act, tile)
            iv = M.tile_worklists_interval(aabb_c, o_c, d, tmax, act, tile)
            print(f"visits/tile at tile {tile}: exact {visits(ex[0])}; "
                  f"interval {visits(iv[0])}")
        k7 = time_ms(lambda: M.tile_keys(aabb_c, o_c, d, tmax, act), 20)
        trace = time_ms(lambda: M.trace_dense(*args, any_hit=False), 20)
        print(f"K7 (keys and sorted worklists) {k7:.4f} ms; K7 + K1 "
              f"closest (trace_dense) {trace:.4f} ms")
        for mode, (ms, agree) in run_modes(args).items():
            print(f"mode {mode:8s} {ms:8.4f} ms (agreement with plain "
                  f"{agree:.6%})", flush=True)
    args, kw = traces["nee"]
    print(f"--- NEE rays: K1 any-hit "
          f"{time_ms(lambda: M.trace_dense(*args, **kw), 20):.4f} ms over "
          f"{args[2].shape[0]} lanes ({int(args[5].sum())} active)")


if __name__ == "__main__":
    main()
