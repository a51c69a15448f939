"""Row gathers (counterpart of rtxpt_tpu/ops/gather_pallas.py).

The TPU gathers rows with one-hot bf16 matmuls against residual "planes"
because XLA row gathers are slow there. On the GPU a row gather is a plain
coalesced load, so the port gathers straight from the f32/i32 tables:

  K2 `gather_rows(table, idx)`           out[n, :] = table[idx[n], :]
  K3 `gather_rows_interp(table, i3, w3)` out[n, :] = sum_v w3[n,v] *
                                                     table[i3[n,v], :]
  K2 + K3 `gather_surface(...)`          the four fetches of a hit's
                                         surface (pt/shading.py
                                         `load_surface`) in one launch

All three kernels live in ``csrc/gather.cu``. Indices are clamped to the
table, the semantics of the reference's XLA gather. Each wrapper moves a
table's rows in the widest words (16, 8 or 4 bytes) that its row stride
and address allow (`word_bytes`); `instance` says which kernel instance a
table takes.
"""
from __future__ import annotations

import torch

from . import cuda_lib

# (row width in words: word bytes) of the kernels' compile-time instances
# in csrc/gather.cu; any other (width, word) takes the run-time-width
# instance of its word size
ROW_TEMPLATES = {4: 16, 5: 4, 10: 8, 12: 16, 24: 16, 46: 8}
INTERP_TEMPLATES = {12: 16}
# the surface fetch's tables: (name, dtype, row width in words)
SURFACE_TABLES = (("tri_pack", torch.int32, 4),
                  ("vert_pack", torch.float32, 12),
                  ("tri_geom_pack", torch.float32, 5),
                  ("mat_pack", torch.float32, 46))


def word_bytes(table: torch.Tensor, widest: int = 16) -> int:
    """The widest word (of 16, 8 and 4 bytes, at most `widest`) that divides
    both the table's row stride and its address."""
    stride = table.shape[1] * table.element_size()
    for word in (16, 8):
        if word <= widest and stride % word == 0 \
                and table.data_ptr() % word == 0:
            return word
    return 4


def instance(table: torch.Tensor, templates=ROW_TEMPLATES) -> str:
    """Which kernel instance a gather from `table` takes (K2's templates by
    default; K3's with INTERP_TEMPLATES)."""
    width, word = table.shape[1], word_bytes(table)
    kind = "template" if templates.get(width) == word else "run-time width"
    return f"width {width}, {word}-byte words, {kind}"


def surface_words(tri_pack, vert_pack, mat_pack):
    """(tri_pack, vert_pack, mat_pack) word bytes of a surface fetch: a
    triangle row in one 16-byte load or four 4-byte ones, vertex rows in
    16-, 8- or 4-byte words, material rows in 8- or 4-byte words."""
    return (16 if word_bytes(tri_pack) == 16 else 4, word_bytes(vert_pack),
            word_bytes(mat_pack, 8))


def surface_instance(tri_pack, vert_pack, mat_pack) -> str:
    """Which instance a surface fetch from these tables takes."""
    tri, vert, mat = surface_words(tri_pack, vert_pack, mat_pack)
    return (f"tri_pack {tri}-byte loads, vert_pack {vert}-byte words, "
            f"mat_pack {mat}-byte words")


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor):
    """Plain version of K2."""
    safe = torch.clamp(idx.to(torch.int64), 0, table.shape[0] - 1)
    return table[safe]


def gather_rows_interp_plain(table: torch.Tensor, idx3: torch.Tensor,
                             w3: torch.Tensor):
    """Plain version of K3: ((w0*r0 + w1*r1) + w2*r2), the kernel's
    summation order."""
    safe = torch.clamp(idx3.to(torch.int64), 0, table.shape[0] - 1)
    acc = table[safe[:, 0]] * w3[:, 0:1]
    acc = acc + table[safe[:, 1]] * w3[:, 1:2]
    return acc + table[safe[:, 2]] * w3[:, 2:3]


def gather_surface_plain(tri_pack, vert_pack, tri_geom_pack, mat_pack, prim,
                         bary):
    """Plain version of the surface fetch: K2 on the triangle row, K3 on its
    vertices with the barycentric weights ((1 - b0) - b1, b0, b1), K2 on
    its geometry row and on its material row."""
    prim = torch.clamp(prim, min=0)
    tp = gather_rows_plain(tri_pack, prim)
    tri, mid = tp[..., :3], tp[..., 3]
    w = torch.stack([1.0 - bary[..., 0] - bary[..., 1],
                     bary[..., 0], bary[..., 1]], dim=-1)
    vi = gather_rows_interp_plain(vert_pack, tri, w)
    geom = gather_rows_plain(tri_geom_pack, prim)
    mrow = gather_rows_plain(mat_pack, mid)
    return vi, geom, mrow, mid


@cuda_lib.counted("gather_rows")
def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K2: (R, W) f32 or i32 table, integer indices of any shape ->
    (*idx.shape, W) rows of the table's dtype."""
    if not cuda_lib.on_cuda(table, idx):
        return gather_rows_plain(table, idx)
    if table.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"gather_rows: table dtype {table.dtype}")
    cuda_lib.check(table, "table", table.dtype, (None, None))
    shape = idx.shape
    flat = idx.reshape(-1).to(torch.int32).contiguous()
    rows, width = table.shape
    out = torch.empty((flat.shape[0], width), dtype=table.dtype,
                      device=table.device)
    if flat.shape[0]:
        cuda_lib.bump("gather_rows")
        cuda_lib.launch("rtxpt_gather_rows", table.data_ptr(), rows, width,
                        flat.data_ptr(), out.data_ptr(), flat.shape[0],
                        word_bytes(table))
    return out.reshape(*shape, width)


@cuda_lib.counted("gather_rows_interp")
def gather_rows_interp(table: torch.Tensor, idx3: torch.Tensor,
                       w3: torch.Tensor) -> torch.Tensor:
    """K3: (R, W) f32 table, (N, 3) indices, (N, 3) f32 weights ->
    (N, W) barycentric blend."""
    if not cuda_lib.on_cuda(table, idx3, w3):
        return gather_rows_interp_plain(table, idx3, w3)
    cuda_lib.check(table, "table", torch.float32, (None, None))
    n = idx3.shape[0]
    i3 = idx3.to(torch.int32).contiguous()
    cuda_lib.check(i3, "idx3", torch.int32, (n, 3))
    cuda_lib.check(w3, "w3", torch.float32, (n, 3))
    rows, width = table.shape
    out = torch.empty((n, width), dtype=torch.float32, device=table.device)
    if n:
        cuda_lib.bump("gather_rows_interp")
        cuda_lib.launch("rtxpt_gather_rows_interp", table.data_ptr(), rows,
                        width, i3.data_ptr(), w3.data_ptr(), out.data_ptr(),
                        n, word_bytes(table))
    return out


@cuda_lib.counted("gather_surface")
def gather_surface(tri_pack: torch.Tensor, vert_pack: torch.Tensor,
                   tri_geom_pack: torch.Tensor, mat_pack: torch.Tensor,
                   prim: torch.Tensor, bary: torch.Tensor):
    """K2 + K3, the surface fetch of (N,) hits `prim` (triangle ids, -1 for
    a miss) with (N, 2) f32 barycentrics `bary` from the scene's (T, 4) i32
    tri_pack, (V, 12) f32 vert_pack, (T, 5) f32 tri_geom_pack and (M, 46)
    f32 mat_pack -> (vi (N, 12) blended vertex attributes, geom (N, 5),
    mrow (N, 46), mid (N,) i32 material ids), as gather_surface_plain."""
    tables = (tri_pack, vert_pack, tri_geom_pack, mat_pack)
    on_cuda = cuda_lib.on_cuda(*tables, prim, bary)
    for t, (name, dtype, width) in zip(tables, SURFACE_TABLES):
        cuda_lib.check(t, name, dtype, (None, width))
        if t.shape[0] == 0:
            raise ValueError(f"{name}: no rows")
    if tri_geom_pack.shape[0] != tri_pack.shape[0]:
        raise ValueError(f"tri_geom_pack: {tri_geom_pack.shape[0]} rows, "
                         f"tri_pack {tri_pack.shape[0]}")
    if prim.dtype not in (torch.int32, torch.int64) or prim.dim() != 1:
        raise TypeError(f"prim: {prim.dtype} of shape {tuple(prim.shape)}, "
                        "expected (N,) int32 or int64")
    if bary.dtype != torch.float32:
        raise TypeError(f"bary: dtype {bary.dtype}, expected torch.float32")
    n = prim.shape[0]
    if tuple(bary.shape) != (n, 2):
        raise ValueError(f"bary: shape {tuple(bary.shape)}, expected "
                         f"({n}, 2)")
    if not on_cuda:
        return gather_surface_plain(*tables, prim, bary)
    prim = prim.to(torch.int32).contiguous()
    bary = bary.contiguous()
    if bary.data_ptr() % 8:                 # the kernel reads 8-byte pairs
        bary = bary.clone()
    dev = prim.device
    vi = torch.empty((n, 12), dtype=torch.float32, device=dev)
    geom = torch.empty((n, 5), dtype=torch.float32, device=dev)
    mrow = torch.empty((n, 46), dtype=torch.float32, device=dev)
    mid = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        tri_w, vert_w, mat_w = surface_words(tri_pack, vert_pack, mat_pack)
        cuda_lib.bump("gather_surface")
        cuda_lib.launch(
            "rtxpt_gather_surface", tri_pack.data_ptr(), tri_pack.shape[0],
            tri_w, vert_pack.data_ptr(), vert_pack.shape[0], vert_w,
            tri_geom_pack.data_ptr(), mat_pack.data_ptr(), mat_pack.shape[0],
            mat_w, prim.data_ptr(), bary.data_ptr(), vi.data_ptr(),
            geom.data_ptr(), mrow.data_ptr(), mid.data_ptr(), n)
    return vi, geom, mrow, mid
