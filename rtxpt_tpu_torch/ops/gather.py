"""Row gathers (counterpart of rtxpt_tpu/ops/gather_pallas.py).

The TPU gathers rows with one-hot bf16 matmuls against residual "planes"
because XLA row gathers are slow there. On the GPU a row gather is a plain
coalesced load, so the port gathers straight from the f32/i32 tables:

  K2 `gather_rows(table, idx)`           out[n, :] = table[idx[n], :]
  K3 `gather_rows_interp(table, i3, w3)` out[n, :] = sum_v w3[n,v] *
                                                     table[i3[n,v], :]

Both kernels live in ``csrc/gather.cu``. Indices are clamped to the
table, the semantics of the reference's XLA gather.
"""
from __future__ import annotations

import torch

from . import cuda_lib


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
                        flat.data_ptr(), out.data_ptr(), flat.shape[0])
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
                        n)
    return out
