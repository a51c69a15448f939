"""Multi-device rendering: pixel rows sharded over the ranks of a
torch.distributed process group (counterpart of
rtxpt_tpu/parallel/meshutils.py).

One process (rank) drives one device. The scene, its acceleration
structure and its lights are replicated: every rank builds them. The
pixels are sharded: each rank owns a contiguous slab of rows (in
reference mode, of the flattened pixel list), paths never migrate, and
the ranks communicate only
  * by halo exchange (parallel/halo.py) for the row-sharded stencils:
    the previous frame's ReSTIR reservoirs and G-buffer (stage 1,
    `exchange_prev_halos`), the denoiser's inputs and history (stage 2,
    `denoise_taa_sharded`);
  * by all_gather where a rank needs the whole frame: the returned image,
    and TAA or TAAU, which run on the whole frame on every rank.

The caller initialises the process group (torchrun, or a spawn with
`init_process_group`) and wraps it with `make_mesh`. The backend is NCCL
where each rank has its own card and gloo on CPU tensors. Gloo moves host
memory, so ranks that share one card run gloo with their buffers copied
to the host and back (`Mesh.host_transport`); NCCL refuses two ranks on
one card.

Example, under `torchrun --nproc-per-node N script.py`:

    dist.init_process_group("nccl")
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    mesh = meshutils.make_mesh()
    r = RealtimeRenderer(host, cam, mesh=mesh)
    img = r.render_frame(1920, 1080)     # the whole frame on every rank
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .halo import exchange_row_halos

# the mesh's one axis (the reference's shard_map axis name): the ranks
TILE_AXIS = "tiles"

# the previous frame's reservoir / G-buffer rows exchanged, so temporal
# reprojection survives this many rows of vertical motion across a seam;
# the current frame's spatial taps clamp to the slab (restir/window.py)
STAGE1_HALO = 16
# the denoiser's reach: a-trous 2 * (1 + 2 + 4 + 8) + variance 3 + TAA 1
_POST_HALO = 34


@dataclasses.dataclass
class CommStats:
    """What a rank's exchanges moved and took, per kind: the halo
    exchanges' bytes received from the neighbours, and the gathers' bytes
    received from the other ranks. Their seconds run from the exchange's
    start to its end on the rank's stream (CUDA events recorded around it,
    read when asked, so the frames are not synchronized), on the host
    clock where the rank renders on the CPU."""
    halo_calls: int = 0
    halo_bytes: int = 0
    gather_calls: int = 0
    gather_bytes: int = 0
    _seconds: dict = dataclasses.field(
        default_factory=lambda: {"halo": 0.0, "gather": 0.0})
    _events: list = dataclasses.field(default_factory=list)

    def add(self, kind: str, nbytes: int, took):
        """`took`: seconds, or the (start, end) CUDA events."""
        setattr(self, f"{kind}_calls", getattr(self, f"{kind}_calls") + 1)
        setattr(self, f"{kind}_bytes", getattr(self, f"{kind}_bytes")
                + nbytes)
        if isinstance(took, float):
            self._seconds[kind] += took
        else:
            # read the exchanges already done, so a long run keeps few
            self._read(wait=False)
            self._events.append((kind, *took))

    def _read(self, wait: bool):
        pending = []
        for k, start, end in self._events:
            if wait:
                end.synchronize()
            if wait or end.query():
                self._seconds[k] += start.elapsed_time(end) / 1e3
            else:
                pending.append((k, start, end))
        self._events = pending

    def seconds(self, kind: str) -> float:
        """The seconds of every exchange of `kind` so far (waits for the
        events not yet read)."""
        self._read(wait=True)
        return self._seconds[kind]


@dataclasses.dataclass
class Mesh:
    """One rank's view of the process group that shards a frame: its rank,
    the group's size, the device it renders on, the backend, and the
    counters of its exchanges."""
    group: Optional[object]       # a ProcessGroup; None: the default group
    rank: int
    size: int
    device: torch.device
    backend: str
    stats: CommStats = dataclasses.field(default_factory=CommStats)

    @property
    def host_transport(self) -> bool:
        """True where a collective's buffers are copied to host memory and
        back: gloo with a CUDA device."""
        return self.backend == "gloo" and self.device.type != "cpu"

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.host_transport else t.contiguous()

    def _start(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(self.device))
        return start

    def _stop(self, start, kind: str, nbytes: int):
        if isinstance(start, float):
            self.stats.add(kind, nbytes, time.perf_counter() - start)
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(self.device))
        self.stats.add(kind, nbytes, (start, end))

    def _peer(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    def exchange(self, top: torch.Tensor, bottom: torch.Tensor):
        """Send `top` to the rank above and `bottom` to the rank below;
        returns (the bottom buffer of the rank above, the top buffer of
        the rank below), None at the frame's edge. Every rank's buffers
        have the same size."""
        t0 = self._start()
        top_w, bottom_w = self._wire(top), self._wire(bottom)
        ops, above, below = [], None, None
        if self.rank > 0:
            above = torch.empty_like(bottom_w)
            peer = self._peer(self.rank - 1)
            ops += [dist.P2POp(dist.isend, top_w, peer, self.group),
                    dist.P2POp(dist.irecv, above, peer, self.group)]
        if self.rank < self.size - 1:
            below = torch.empty_like(top_w)
            peer = self._peer(self.rank + 1)
            ops += [dist.P2POp(dist.isend, bottom_w, peer, self.group),
                    dist.P2POp(dist.irecv, below, peer, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        got = [None if b is None else b.to(self.device)
               for b in (above, below)]
        self._stop(t0, "halo", sum(b.numel() * b.element_size()
                                   for b in (above, below) if b is not None))
        return got[0], got[1]

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's `t` (the same shape and dtype on every rank), in
        rank order, on this rank's device."""
        t0 = self._start()
        wire = self._wire(t)
        out = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(out, wire, group=self.group)
        out = [o.to(self.device) for o in out]
        self._stop(t0, "gather",
                   wire.numel() * wire.element_size() * (self.size - 1))
        return out


def make_mesh(group=None, device=None) -> Mesh:
    """Wrap an initialised process group (None: the default group) as
    this rank's Mesh. `device`: the device this rank renders on; by
    default the current CUDA device under NCCL and the CPU under gloo
    (pass a CUDA device to run gloo ranks on a card). make_mesh never
    initialises a group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the process group first "
                           "(torch.distributed.init_process_group)")
    backend = str(dist.get_backend(group)).lower()
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if backend == "nccl" else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL ranks render on a CUDA device")
    return Mesh(group=group, rank=dist.get_rank(group),
                size=dist.get_world_size(group), device=device,
                backend=backend)


def _pad_rows(img, n_dev: int):
    """(img with its last row repeated up to a multiple of n_dev rows, the
    rows it had)."""
    h = img.shape[0]
    pad = (-h) % n_dev
    if pad:
        img = torch.cat([img, img[-1:].expand((pad,) + img.shape[1:])], 0)
    return img, h


def shard_rows(mesh: Mesh, img):
    """This rank's rows of a whole-frame (H, ...) tensor, padded to a
    multiple of the mesh size as the reference pads its sharded post."""
    img, _ = _pad_rows(img, mesh.size)
    rows = img.shape[0] // mesh.size
    return img[mesh.rank * rows:(mesh.rank + 1) * rows]


def gather_rows(mesh: Mesh, slab, height: int):
    """The whole frame's first `height` rows from every rank's slab (the
    same shape on every rank), on every rank."""
    if mesh.size == 1:
        return slab[:height]
    return torch.cat(mesh.all_gather(slab), 0)[:height]


def render_image_sharded(assets, cam, cfg, consts, width: int, height: int,
                         mesh: Mesh):
    """Render one sample a pixel with the pixels sharded over the mesh:
    each rank runs `integrator.render_wavefront` on its contiguous slab of
    the flattened pixel list (padded with pixel (0, 0) to a multiple of
    the mesh size), so a slab of sky rays ends its bounce loop early.
    Returns the (H, W, 3) radiance on every rank. `assets` and `cam` lie
    on the mesh's device."""
    from ..pt import integrator
    n = width * height
    per = (n + (-n) % mesh.size) // mesh.size
    yy, xx = np.mgrid[0:height, 0:width]
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    pix = lambda a: torch.as_tensor(np.concatenate(
        [a.reshape(-1), np.zeros(per * mesh.size - n, np.int64)])[sl]
        .astype(np.int64), device=mesh.device)
    radiance = integrator.render_wavefront(assets, cam, pix(xx), pix(yy),
                                           consts, cfg=cfg)
    return gather_rows(mesh, radiance, n).reshape(height, width, 3)


def exchange_prev_halos(mesh: Mesh, prev, rows: int, width: int,
                        halo: int = STAGE1_HALO):
    """The previous frame's buffers of a row-sharded stage 1, padded with
    `halo` rows of the ranks above and below (edge-clamped at the frame's
    border), so temporal reprojection reads across the seams. `prev`: a
    NamedTuple whose fields are this rank's flat (rows * width, ...)
    tensors, NamedTuples of them (a reservoir) or None; one exchange
    carries them all. Returns (`prev` padded, of the same structure, and
    the rows each buffer holds)."""
    halo = min(halo, max(rows - 1, 1))
    tensors = lambda b: () if b is None else b if isinstance(b, tuple) \
        else (b,)
    slabs = [a.reshape((rows, width) + a.shape[1:])
             for b in prev for a in tensors(b)]
    padded = iter(a.reshape((-1,) + a.shape[2:])
                  for a in exchange_row_halos(slabs, halo, mesh))

    def refill(b):
        if b is None:
            return None
        if isinstance(b, tuple):
            return type(b)(*[next(padded) for _ in b])
        return next(padded)

    return type(prev)(*map(refill, prev)), rows + 2 * halo


def denoise_taa_sharded(mesh: Mesh, den_state, taa_state, radiance, normal,
                        view_z, motion, roughness=None, iterations: int = 4,
                        use_taa: bool = True, height: Optional[int] = None):
    """ReLAX (and TAA under `use_taa`) on this rank's rows: every input
    and state is this rank's (rows, W, ...) slab of the frame padded to a
    multiple of the mesh size (shard_rows); `height` is the frame's
    unpadded height (default: rows x mesh size). The slabs get the halo
    of the neighbouring ranks (one exchange), the denoiser and TAA run on
    the padded slab, and the result is cropped back. At the frame's top
    and bottom the halo repeats the edge row, so the border rows differ
    from the single-device result, which zero-pads its stencils
    (tests/test_parallel.py:77-81). Returns (color, denoiser state, TAA
    state), this rank's rows."""
    from ..denoise import relax
    from ..post import taa as taa_mod
    rows, w = radiance.shape[0], radiance.shape[1]
    h0 = rows * mesh.size if height is None else height
    halo = min(_POST_HALO, max(h0 // mesh.size - 1, 1))
    if den_state is None:
        den_state = relax.DenoiserState.create(rows, w, radiance.device)
    if taa_state is None and use_taa:
        taa_state = taa_mod.TAAState(history=torch.zeros_like(radiance),
                                     valid=False)
    ins = [*den_state, radiance, normal, view_z, motion]
    if roughness is not None:
        ins.append(roughness)
    if use_taa:
        ins.append(taa_state.history)
    padded = exchange_row_halos(ins, halo, mesh)
    den_p = relax.DenoiserState(*padded[:5])
    rad_p, nrm_p, z_p, mot_p = padded[5:9]
    rough_p = padded[9] if roughness is not None else None
    crop = lambda a: a[halo:-halo] if a.shape[0] > 2 * halo else a
    color, den_n = relax.denoise(den_p, rad_p, nrm_p, z_p, mot_p,
                                 roughness=rough_p, iterations=iterations)
    if use_taa:
        color, taa_n = taa_mod.resolve(
            taa_mod.TAAState(history=padded[-1], valid=taa_state.valid),
            color, mot_p)
        taa_state = taa_mod.TAAState(history=crop(taa_n.history),
                                     valid=taa_n.valid)
    return crop(color), relax.DenoiserState(*map(crop, den_n)), taa_state


class ShardedReLAX:
    """Stage 2's denoiser on a mesh (the realtime post's `den`): ReLAX on
    this rank's rows with the neighbours' halo, without TAA, which runs on
    the gathered frame. `height`: the frame's unpadded height."""

    def __init__(self, mesh: Mesh, height: int):
        self.mesh, self.height = mesh, height

    def denoise(self, state, radiance, normal, view_z, motion,
                roughness=None, iterations: int = 4):
        color, state, _ = denoise_taa_sharded(
            self.mesh, state, None, radiance, normal, view_z, motion,
            roughness=roughness, iterations=iterations, use_taa=False,
            height=self.height)
        return color, state
