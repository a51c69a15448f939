"""ReGIR: a world-space grid of light reservoirs for local-light NEE
(counterpart of rtxpt_tpu/restir/regir.py; LightSamplingLocal.hlsli
RTXDI_MINI_CalculateReGIRCellIndex :555, consumed by NEE at
PathTracerNEE.hlsli:216-230).

For each accumulation sample, every cell streams `candidates`
power-sampled lights through `per_cell` reservoirs, each weighted by the
unshadowed radiance at a jittered point of the cell. At a shading point
NEE picks one reservoir of the containing cell; the reservoir's
contribution weight W replaces 1/pdf. MIS against BSDF sampling keeps the
half-MIS constant (localPdfEstimateK), since a ReGIR pdf cannot be
evaluated for an arbitrary direction.

A reservoir is one (N, 4) float32 row [light, u, v, W], so a shading
point's pick is one row fetch (K2, `ops/gather.py`); light ids stay exact
in float32 below 2^24. The RNG streams are the reference's, in int64
masked to 32 bits.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import mathutils as mu
from ..core import rng
from ..ops import gather
from ..scene import lights as LI

EFFECT_REGIR_BUILD = 32
ONION_LAYERS_PER_OCTAVE = 2.0


@dataclasses.dataclass
class ReGIRGrid:
    """Per-cell light reservoirs over (cells * per_cell,) lanes.

    Two cell layouts:
      * "grid": a regular dims^3 grid over the scene bounds (grid_lo the
        bounds' low corner, grid_inv_ext 1 / their extent);
      * "onion": log-spherical shells around a centre (grid_lo) — layer
        floor(log2(r / r0) * ONION_LAYERS_PER_OCTAVE), then an octahedral
        dims x dims direction bucket (grid_inv_ext = [1 / r0, 0, 0]),
        onion_layers > 0."""
    rows: torch.Tensor          # (C*R, 4) f32 [light (-1 none), u, v, W]
    grid_lo: torch.Tensor       # (3,)
    grid_inv_ext: torch.Tensor  # (3,)
    dims: int
    per_cell: int
    onion_layers: int = 0

    @property
    def light(self):
        return self.rows[:, 0].to(torch.int32)

    @property
    def uv(self):
        return self.rows[:, 1:3]

    @property
    def w(self):
        return self.rows[:, 3]


def _cell_centers(lo, hi, dims: int, jitter):
    g = torch.arange(dims, dtype=torch.float32, device=lo.device)
    zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
    ijk = torch.stack([xx, yy, zz], -1).reshape(-1, 3)      # (C,3)
    return lo + (ijk + jitter) / dims * (hi - lo)


def _onion_cell_positions(center, r0, dims: int, layers: int,
                          per_cell: int, ujit):
    """Jittered world positions of onion cells: cell (l, i, j) covers
    radii [r0 2^(l/LPO), r0 2^((l+1)/LPO)) in octahedral bucket (i, j)."""
    c = layers * dims * dims
    cell = torch.arange(c, device=center.device).repeat_interleave(per_cell)
    l = cell // (dims * dims)
    ij = cell % (dims * dims)
    i = ij // dims
    j = ij % dims
    lf = (l.to(torch.float32) + ujit[..., 0]) / ONION_LAYERS_PER_OCTAVE
    r = r0 * torch.exp2(lf)
    f = torch.stack([(i.to(torch.float32) + ujit[..., 1]) / dims,
                     (j.to(torch.float32) + ujit[..., 2]) / dims],
                    -1) * 2.0 - 1.0
    d = mu.decode_oct(f)
    return center[None, :] + d * r[..., None]


def _norm(v):
    return torch.sqrt(torch.sum(v * v, -1))


def build_regir(lt: LI.LightTable, scene_lo, scene_hi, frame: int,
                dims: int = 8, per_cell: int = 8, candidates: int = 16,
                layout: str = "grid", center=None) -> ReGIRGrid:
    """Rebuild the grid for accumulation sample `frame` (RtxdiPass
    BeginFrame ReGIR build, RtxdiPass.cpp:268-342). layout="onion" puts
    log-spherical cells around `center` (by default the bounds' centre)."""
    if layout not in ("grid", "onion"):
        raise ValueError(f"regir_layout {layout!r} is not 'grid' or 'onion'")
    dev = lt.pack.device
    if layout == "onion":
        layers = int(math.ceil(ONION_LAYERS_PER_OCTAVE * 6)) + 1  # 6 octaves
        c = layers * dims * dims
    else:
        layers = 0
        c = dims ** 3
    n = c * per_cell
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    g = rng.make(lane, lane >> 16, 0, frame & rng.M32)
    g = rng.start_effect(g, EFFECT_REGIR_BUILD)

    g, ujit = rng.next_3d(g, allow_ld=False)
    lo3 = torch.as_tensor(scene_lo, dtype=torch.float32, device=dev)
    hi3 = torch.as_tensor(scene_hi, dtype=torch.float32, device=dev)
    if layout == "onion":
        ctr = (torch.as_tensor(center, dtype=torch.float32, device=dev)
               if center is not None else (lo3 + hi3) * 0.5)
        # r0: the innermost shell's radius, 1/64 of the scene diagonal
        r0 = _norm(hi3 - lo3) / 64.0
        pos = _onion_cell_positions(ctr, r0, dims, layers, per_cell, ujit)
    else:
        pos = _cell_centers(lo3, hi3, dims, 0.5).repeat_interleave(
            per_cell, dim=0)                                  # (n,3)
        # jitter the evaluation point within the cell (decorrelation)
        pos = pos + (ujit - 0.5) * ((hi3 - lo3) / dims)

    best_light = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    best_uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    best_target = torch.zeros((n,), dtype=torch.float32, device=dev)
    w_sum = torch.zeros((n,), dtype=torch.float32, device=dev)
    for _ in range(candidates):
        g, u3 = rng.next_3d(g, allow_ld=False)
        g, usel = rng.next_1d(g, allow_ld=False)
        li_idx = LI.pick_light(lt, u3[..., 0])
        row = LI.fetch_rows(lt, li_idx)
        pick_pdf = row[..., LI.LP_POWER] / max(lt.total_power, 1e-20)
        uv = u3[..., 1:3]
        # target: the unshadowed incident radiance at the cell point with
        # each kind's falloff (lights.eval_sample_at's measure contract)
        _, _, li_eff, inv_area, l_ok = LI.eval_row_at(row, uv, pos)
        target = torch.where(l_ok, mu.luminance(li_eff), 0.0)
        src_pdf = pick_pdf * inv_area
        wi = torch.where(src_pdf > 0,
                         target / torch.clamp(src_pdf, min=1e-20), 0.0)
        w_sum = w_sum + wi
        take = (usel * w_sum < wi) & (wi > 0.0)
        best_light = torch.where(take, li_idx.to(torch.float32), best_light)
        best_uv = torch.where(take[..., None], uv, best_uv)
        best_target = torch.where(take, target, best_target)

    w = torch.where((best_light >= 0) & (best_target > 0.0),
                    w_sum / (candidates
                             * torch.clamp(best_target, min=1e-20)), 0.0)
    rows = torch.cat([best_light[:, None], best_uv, w[:, None]], -1)
    if layout == "onion":
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return ReGIRGrid(rows=rows, grid_lo=ctr,
                         grid_inv_ext=torch.stack(
                             [1.0 / torch.clamp(r0, min=1e-9), zero, zero]),
                         dims=dims, per_cell=per_cell, onion_layers=layers)
    return ReGIRGrid(rows=rows, grid_lo=lo3,
                     grid_inv_ext=1.0 / torch.clamp(hi3 - lo3, min=1e-6),
                     dims=dims, per_cell=per_cell)


def sample_regir(grid: ReGIRGrid, lt: LI.LightTable, shading_pos,
                 u2) -> LI.LightSample:
    """Cell lookup + uniform reservoir pick; the reservoir's W replaces
    1/pdf (RTXDI_MINI_SampleLocalLightsFromWorldSpace)."""
    d = grid.dims
    if grid.onion_layers:
        rel = shading_pos - grid.grid_lo                  # centre-based
        r = _norm(rel)
        dirn = rel / torch.clamp(r[..., None], min=1e-9)
        l = torch.clamp((torch.log2(torch.clamp(r * grid.grid_inv_ext[0],
                                                min=1.0))
                         * ONION_LAYERS_PER_OCTAVE).to(torch.int64),
                        0, grid.onion_layers - 1)
        f = (mu.encode_oct(dirn) + 1.0) * 0.5
        i = torch.clamp((f[..., 0] * d).to(torch.int64), 0, d - 1)
        j = torch.clamp((f[..., 1] * d).to(torch.int64), 0, d - 1)
        cell = (l * d + i) * d + j
    else:
        ijk = torch.clamp(((shading_pos - grid.grid_lo) * grid.grid_inv_ext
                           * d).to(torch.int64), 0, d - 1)
        cell = (ijk[..., 2] * d + ijk[..., 1]) * d + ijk[..., 0]
    slot = torch.clamp((u2[..., 0] * grid.per_cell).to(torch.int64), 0,
                       grid.per_cell - 1)
    res = gather.gather_rows(grid.rows, cell * grid.per_cell + slot)
    li_idx = res[..., 0].to(torch.int32)
    uv = res[..., 1:3]
    w = res[..., 3]

    row = LI.fetch_rows(lt, torch.clamp(li_idx, min=0))
    direction, dist, li_eff, _, l_ok = LI.eval_row_at(row, uv, shading_pos)
    # li_eff * W (W plays 1/pdf in the build's area measure)
    li = li_eff * w[..., None]
    valid = (li_idx >= 0) & (w > 0.0) & l_ok
    kind = row[..., LI.LP_KIND].to(torch.int32)
    is_delta = ((kind == LI.LIGHT_POINT) | (kind == LI.LIGHT_SPOT)
                | (kind == LI.LIGHT_DIRECTIONAL))
    # the pdf the firefly heuristic reads: ~1/W in solid-angle-like terms
    pdf = torch.where(w > 0, torch.where(is_delta, 1.0, dist * dist)
                      / torch.clamp(w, min=1e-20), 0.0)
    return LI.LightSample(direction=direction, distance=dist, li=li,
                          pdf=pdf, valid=valid, delta=is_delta)
