"""Realtime frames with their pixel rows sharded over ranks, one process a
device (rtxpt_tpu_torch/parallel/meshutils.py). A development tool,
outside the package; from the repo root, with N cards:

    torchrun --nproc-per-node N -m tools_torch.sharded_frames --scene city

(NCCL, a rank a card), or, starting the ranks itself (N ranks with NCCL
on a machine with N >= 2 cards, else 2 ranks on the one card with gloo
and host copies):

    python -m tools_torch.sharded_frames --scene city [--ranks R]

Every rank renders the default realtime pipeline (3 stable planes, ReSTIR
DI + GI, ReLAX, TAA) at --width x --height: --warmups frames, then
--frames timed ones (host clock, each ending in a device synchronize),
with the launch counters and the mesh's exchange counters set to 0 just
before. Rank 0 prints, for every rank, the ms per frame, the halo and
gather bytes and ms per frame (CUDA events recorded around each exchange
on the rank's stream: the frames are not synchronized for them) and the
launches per kernel.

`spawn` runs any per-rank function this way; chip_smoke.py's
multi-device phase uses it.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist


def choose_ranks(ranks: int = None):
    """(ranks, backend): one rank a card with NCCL where there are two
    cards or more, else two ranks on the one card with gloo."""
    cards = torch.cuda.device_count()
    if cards >= 2:
        return (ranks or cards), "nccl"
    return (ranks or 2), "gloo"


def _rank(rank: int, size: int, backend: str, store_path: str, out: str,
          fn, args):
    """The body of a spawned rank: join the group, make the mesh on the
    rank's card (its own under NCCL, the first under gloo), run
    fn(mesh, *args) and save its result for the parent."""
    from rtxpt_tpu_torch.parallel import meshutils
    torch.backends.cuda.matmul.allow_tf32 = False   # exact sobol matmul
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.FileStore(store_path, size),
                            rank=rank, world_size=size)
    try:
        mesh = meshutils.make_mesh(device=device)
        torch.save(fn(mesh, *args), Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, size: int, backend: str, args=(), timeout_s: float = 600.0):
    """Run fn(mesh, *args) on `size` spawned ranks (fn a module-level
    function; its result a dict of tensors, numbers and strings) and
    return their results in rank order. The caller builds the CUDA
    library first (cuda_lib.lib()), so the ranks only load it. A rank that
    raises raises here; ranks still running at `timeout_s` are killed and
    count as failed."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.start_processes(
            _rank, args=(size, backend, str(Path(d) / "store"), d, fn, args),
            nprocs=size, start_method="spawn", join=False)
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(),
                                           1.0)):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return [torch.load(Path(d) / f"rank{r}.pt") for r in range(size)]


def timed_frames(mesh, host: dict, camera, width: int, height: int,
                 warmups: int = 2, frames: int = 3, after=None) -> dict:
    """Render `warmups` + `frames` frames of the default RealtimeRenderer
    on `mesh` and return the timed frames' numbers on this rank: ms per
    frame, exchange bytes and ms per frame, launches per kernel, and the
    last frame; and, where `after` is given, after(renderer) under
    "after", called once the counts are read (every rank must call it:
    a frame it renders is collective)."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.ops import cuda_lib
    from rtxpt_tpu_torch.parallel import meshutils
    t0 = time.perf_counter()
    r = RealtimeRenderer(host, camera, mesh=mesh)
    build_s = time.perf_counter() - t0
    sync = lambda: torch.cuda.synchronize(mesh.device)
    for _ in range(warmups):
        r.render_frame(width, height)
    sync()
    cuda_lib.reset_launch_counts()
    mesh.stats = meshutils.CommStats()
    walls = []
    for _ in range(frames):
        t0 = time.perf_counter()
        img = r.render_frame(width, height)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    s = mesh.stats
    out = dict(rank=mesh.rank, build_s=build_s, ms=walls,
               sharded=r._shard_stage1(height),
               halo_bytes=s.halo_bytes / frames,
               halo_ms=s.seconds("halo") * 1e3 / frames,
               halo_calls=s.halo_calls / frames,
               gather_bytes=s.gather_bytes / frames,
               gather_ms=s.seconds("gather") * 1e3 / frames,
               launches=cuda_lib.launch_counts(), image=img.cpu())
    out["after"] = None if after is None else after(r)
    return out


def report(results, card: str, backend: str, width: int, height: int):
    """One line a rank: its ms per frame and its exchanges."""
    for res in results:
        ms = res["ms"]
        print(f"rank {res['rank']} of {len(results)} ({backend}), "
              f"{width}x{height}, stage 1 "
              f"{'on its rows' if res['sharded'] else 'whole'}: "
              f"{sum(ms) / len(ms):.1f} ms/frame (frames "
              f"{', '.join(f'{x:.1f}' for x in ms)}); halo "
              f"{res['halo_bytes'] / 1e6:.3f} MB, {res['halo_ms']:.2f} ms "
              f"in {res['halo_calls']:.0f} exchanges a frame; gather "
              f"{res['gather_bytes'] / 1e6:.3f} MB, {res['gather_ms']:.2f} "
              f"ms a frame; renderer built in {res['build_s']:.2f} s; "
              f"launches {res['launches']} on {card}", flush=True)


def camera(scene: str, width: int, height: int):
    from rtxpt_tpu_torch.scene import procedural
    return procedural.city_camera(width, height) if scene == "city" \
        else procedural.default_camera(width, height)


def _frames_job(mesh, host, scene, width, height, warmups, frames):
    out = timed_frames(mesh, host, camera(scene, width, height), width,
                       height, warmups, frames)
    out.pop("image")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=("city", "programmer-art"),
                    default="city")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--warmups", type=int, default=2)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to spawn (not under torchrun)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sharded_frames needs a CUDA GPU")
    from rtxpt_tpu_torch.ops import cuda_lib
    from rtxpt_tpu_torch.parallel import meshutils
    from rtxpt_tpu_torch.scene import procedural
    host = (procedural.build_city() if a.scene == "city"
            else procedural.build_programmer_art()).finish()
    job = (host, a.scene, a.width, a.height, a.warmups, a.frames)
    card = torch.cuda.get_device_name(0)
    if "RANK" in os.environ:                   # under torchrun
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl")
        try:
            if dist.get_rank() == 0:
                cuda_lib.lib()                 # one build, then the others
            dist.barrier()
            res = _frames_job(meshutils.make_mesh(), *job)
            results = [None] * dist.get_world_size()
            dist.all_gather_object(results, res)
        finally:
            dist.destroy_process_group()
        if int(os.environ["RANK"]) == 0:
            report(results, card, "nccl", a.width, a.height)
        return 0
    size, backend = choose_ranks(a.ranks)
    cuda_lib.lib()                             # built before the spawn
    report(spawn(_frames_job, size, backend, job), card, backend, a.width,
           a.height)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
