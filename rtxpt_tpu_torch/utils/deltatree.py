"""Debug delta-tree explorer: the reference's interactive stable-planes
debugging tool, driven from the host (counterpart of
rtxpt_tpu/utils/deltatree.py; RTXPT/Sample.hlsl:332-357
DeltaTreeVizExplorePixel and RTXPT/PathTracer/ShaderDebug.hlsli:102-157,
DeltaTreeVizPathVertex / DeltaTreeVizHeader, with the search stack of
DeltaSearchStackPush/Pop :302-330).

For one picked pixel, walk the pure-delta tree depth first: every vertex
records its delta lobes (reflection and transmission throughputs), the
non-delta mass, the throughput so far, the volume absorption and the
stable branch id; then stamp which branches the BUILD pass assigned to
plane slots and which is dominant. The reference's shader caps its stack
at cDeltaTreeVizMaxStackSize; here the stack is a Python list and each
node is one 1-lane trace (the trace structure's kernel) and one surface
fetch, so the tool runs the code it debugs (traverse, shading, nested
dielectrics, stableplanes._delta_lobes).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch

# ignore delta subpaths below 0.1% potential contribution
# (cDeltaTreeVizThpIgnoreThreshold, ShaderDebug.hlsli:135)
THP_IGNORE_THRESHOLD = 1e-3
MAX_VERTICES = 256            # cDeltaTreeVizMaxVertices
LOBE_TRANSMISSION = 0         # LOBE_ID_TRANSMISSION (base-4 digit 0)
LOBE_REFLECTION = 1


@dataclass
class DeltaNode:
    """One DeltaTreeVizPathVertex (ShaderDebug.hlsli:102-132)."""
    vertex_index: int            # 0 = camera, 1 = first hit, ...
    branch_id: int               # PathState::stableBranchID encoding
    material_id: int             # -1 for sky / miss
    throughput: np.ndarray       # (3,) camera -> this vertex
    volume_absorption: float     # 1 - luminance(transmittance) last seg
    world_pos: np.ndarray        # (3,)
    non_delta_part: float        # mass routed to non-delta lobes
    # (lobe_id, luminance(lobe throughput)) for significant delta lobes
    lobes: List[Tuple[int, float]] = field(default_factory=list)
    is_miss: bool = False
    plane_slot: int = -1         # BUILD slot whose branch ends here
    on_stable_path: bool = False  # lies on some plane's branch prefix
    is_dominant: bool = False


@dataclass
class DeltaTreeViz:
    """DeltaTreeVizHeader + node list."""
    pixel: Tuple[int, int]
    nodes: List[DeltaNode]
    plane_branch_ids: List[int]  # per BUILD slot (INVALID -> -1)
    dominant_plane: int


def _lum(rgb) -> float:
    r, g, b = [float(v) for v in np.asarray(rgb).reshape(3)]
    return 0.2126 * r + 0.7152 * g + 0.0722 * b


def explore_pixel(assets, cam, x: int, y: int, *, max_vertex_depth: int = 6,
                  plane_count: int = 3) -> DeltaTreeViz:
    """DFS the delta tree at pixel (x, y) against the loaded scene.

    As DeltaTreeVizExplorePixel: start from the camera ray, and at every
    hit split the BSDF into its delta lobes (stableplanes._delta_lobes,
    evalDeltaLobes); each significant lobe pushes a subpath that goes on
    with branch = (branch << 2) | lobe_id. The BUILD pass runs for the
    same pixel to stamp the plane assignments (GetBranchIDCenter and the
    dominant index, Sample.hlsl:352-355). A later plane slot with the same
    branch id as an earlier one takes the stamp, as in the reference."""
    from ..ops import traverse
    from ..pt import nested, shading
    from ..pt import stableplanes as SP
    from .debugprint import pixel_paths

    dev = assets.scene.positions.device
    p0 = pixel_paths(cam, x, y, max_vertex_depth, dev)

    # BUILD-pass ground truth for this pixel (1-lane wavefront)
    sp = SP.build_stable_planes(assets, cam, cam, p0.px, p0.py,
                                plane_count=plane_count,
                                max_vertex_depth=max_vertex_depth,
                                compaction=False)
    plane_ids = [(-1 if b == SP.INVALID_BRANCH else b)
                 for b in sp.branch_id[0].cpu().tolist()]
    dominant = int(sp.dominant[0])

    mat_iors = assets.scene.mat_ior
    vol_abs = assets.scene.volume_absorption

    def _stamp(node: DeltaNode):
        for s, b in enumerate(plane_ids):
            if b == node.branch_id:
                node.plane_slot = s
                node.is_dominant = (s == dominant)
            # prefix test: on the stable path of plane s
            # (is_on_stable_path, StablePlanes.hlsli logic)
            pb = b
            while pb > 0:
                if pb == node.branch_id:
                    node.on_stable_path = True
                pb >>= 2
        nodes.append(node)

    nodes: List[DeltaNode] = []
    # stack entries: (origin (1,3), direction (1,3), thp (1,3), branch,
    #                 vertex_index, interior (1,2))
    stack = [(p0.origin, p0.direction,
              torch.ones((1, 3), dtype=torch.float32, device=dev), 1, 1,
              nested.empty(1, dev))]
    while stack and len(nodes) < MAX_VERTICES:
        origin, direction, thp, branch, vtx, interior = stack.pop()
        hit = traverse.trace_closest(assets.accel, origin, direction)
        if not bool(hit.valid[0]):
            _stamp(DeltaNode(
                vertex_index=vtx, branch_id=branch, material_id=-1,
                throughput=thp[0].cpu().numpy(),
                volume_absorption=0.0,
                world_pos=(origin + direction * 1e4)[0].cpu().numpy(),
                non_delta_part=0.0, is_miss=True))
            continue

        surf = shading.load_surface(assets.scene, torch.clamp(hit.prim, min=0),
                                    hit.bary, direction)
        sd = surf.sd
        # volume absorption along the incoming segment (Beer-Lambert,
        # PathTracer.hlsli:406-415): DeltaTreeVizHandleHit's
        # volumeAbsorption argument
        in_medium = ~nested.is_empty(interior)
        top = torch.clamp(nested.top_material(interior),
                          max=mat_iors.shape[0] - 1)
        transmittance = torch.exp(-vol_abs[top] * hit.t[..., None])
        thp_here = torch.where(in_medium[..., None], thp * transmittance,
                               thp)
        outside_ior = nested.compute_outside_ior(
            interior, sd.material_id, sd.front_facing, mat_iors)
        surf = shading.update_outside_ior(surf, outside_ior)
        bsdf = shading.make_wavefront_bsdf(surf)
        refl_dir, refl_thp, trans_dir, trans_thp, non_delta = \
            SP._delta_lobes(surf, bsdf)
        interior2 = nested.handle_intersection(
            interior, sd.material_id, sd.nested_priority, sd.front_facing)

        # the vertex's numbers in one copy to the host: medium flag,
        # transmittance, throughput, position, material, non-delta mass and
        # the two lobes' throughputs
        row = torch.cat([in_medium.to(torch.float32), transmittance[0],
                         thp_here[0], sd.pos[0],
                         sd.material_id.to(torch.float32), non_delta,
                         (refl_thp * thp_here)[0], (trans_thp * thp_here)[0]]
                        ).cpu().numpy()
        vol_loss = 1.0 - _lum(row[1:4] if row[0] else np.ones(3, np.float32))
        node = DeltaNode(
            vertex_index=vtx, branch_id=branch, material_id=int(row[10]),
            throughput=row[4:7], volume_absorption=max(0.0, vol_loss),
            world_pos=row[7:10], non_delta_part=float(row[11]))
        for lobe_id, ldir, lthp, lum_row in (
                (LOBE_REFLECTION, refl_dir, refl_thp, row[12:15]),
                (LOBE_TRANSMISSION, trans_dir, trans_thp, row[15:18])):
            lum = _lum(lum_row)
            if lum <= 0.0:
                continue
            node.lobes.append((lobe_id, lum))
            if lum < THP_IGNORE_THRESHOLD or vtx >= max_vertex_depth:
                continue
            o = sd.compute_new_ray_origin(torch.tensor(
                [lobe_id == LOBE_REFLECTION], device=dev))
            stack.append((o, ldir, thp_here * lthp, (branch << 2) | lobe_id,
                          vtx + 1,
                          interior2 if lobe_id == LOBE_TRANSMISSION
                          else interior))
        _stamp(node)

    nodes.sort(key=lambda n: (n.vertex_index, n.branch_id))
    return DeltaTreeViz(pixel=(x, y), nodes=nodes,
                        plane_branch_ids=plane_ids,
                        dominant_plane=dominant)


def format_tree(viz: DeltaTreeViz) -> str:
    """Indented text of the explored tree (the UI panel the reference
    draws from deltaPathTreeUAV)."""
    planes = ['%x' % b if b >= 0 else '-' for b in viz.plane_branch_ids]
    out = [f"delta tree @ pixel {viz.pixel}  planes={planes}"
           f"  dominant=sp{viz.dominant_plane}"]
    for n in viz.nodes:
        indent = "  " * n.vertex_index
        tag = "MISS(sky)" if n.is_miss else f"mat {n.material_id}"
        lobes = " ".join(
            f"{'R' if l == 1 else 'T'}:{v:.3f}" for l, v in n.lobes)
        marks = []
        if n.plane_slot >= 0:
            marks.append(f"<= sp{n.plane_slot}"
                         + (" DOMINANT" if n.is_dominant else ""))
        elif n.on_stable_path:
            marks.append("(on stable path)")
        out.append(
            f"{indent}v{n.vertex_index} branch={n.branch_id:x} {tag} "
            f"thp={_lum(n.throughput):.4f} nonDelta={n.non_delta_part:.3f}"
            + (f" vol={n.volume_absorption:.3f}"
               if n.volume_absorption > 1e-4 else "")
            + (f" [{lobes}]" if lobes else "")
            + ("  " + " ".join(marks) if marks else ""))
    return "\n".join(out)
