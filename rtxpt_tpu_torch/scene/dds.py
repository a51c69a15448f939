"""DDS texture decoding (counterpart of rtxpt_tpu/scene/dds.py; donut
DDSFile.cpp + TextureCache.cpp).

numpy block decompression of the DDS formats the reference's asset
pipeline ships: BC1 (DXT1), BC2 (DXT3), BC3 (DXT5), BC4 (one channel), BC5
(two channels, normal maps), and uncompressed RGBA8/BGRA8. Returns (H, W,
4) uint8, bit for bit the reference's, the contract of the port's PNG
reader (utils/image.py `decode_png_rgba`), so DDS and PNG images of a glTF
load through the same texture stack.
"""
from __future__ import annotations

import struct

import numpy as np

DDS_MAGIC = b"DDS "
FOURCC_DXT1 = b"DXT1"
FOURCC_DXT3 = b"DXT3"
FOURCC_DXT5 = b"DXT5"
FOURCC_BC4U = b"BC4U"
FOURCC_ATI1 = b"ATI1"
FOURCC_BC5U = b"BC5U"
FOURCC_ATI2 = b"ATI2"
FOURCC_DX10 = b"DX10"

# DXGI formats (DX10 header)
DXGI_BC1_UNORM = {71, 72}
DXGI_BC2_UNORM = {74, 75}
DXGI_BC3_UNORM = {77, 78}
DXGI_BC4_UNORM = {80}
DXGI_BC5_UNORM = {83}
DXGI_RGBA8 = {28, 29}
DXGI_BGRA8 = {87, 91}


def is_dds(data: bytes) -> bool:
    return data[:4] == DDS_MAGIC


def _bc1_colors(c0, c1):
    """(N,) uint16 pairs -> (N,4,3) RGB palette (565 expansion)."""
    def expand(c):
        r = ((c >> 11) & 31).astype(np.uint32)
        g = ((c >> 5) & 63).astype(np.uint32)
        b = (c & 31).astype(np.uint32)
        return np.stack([(r * 255 + 15) // 31, (g * 255 + 31) // 63,
                         (b * 255 + 15) // 31], -1)
    p0 = expand(c0.astype(np.uint32))
    p1 = expand(c1.astype(np.uint32))
    four = c0 > c1
    p2 = np.where(four[:, None], (2 * p0 + p1) // 3, (p0 + p1) // 2)
    p3 = np.where(four[:, None], (p0 + 2 * p1) // 3, 0)
    return np.stack([p0, p1, p2, p3], 1).astype(np.uint8)   # (N,4,3)


def _decode_bc1_blocks(blocks, alpha_from_mode=True):
    """(N,8) uint8 -> (N,16,4) RGBA; 1-bit alpha in 3-color mode."""
    n = blocks.shape[0]
    c0 = blocks[:, 0].astype(np.uint16) | (blocks[:, 1].astype(np.uint16)
                                           << 8)
    c1 = blocks[:, 2].astype(np.uint16) | (blocks[:, 3].astype(np.uint16)
                                           << 8)
    pal = _bc1_colors(c0, c1)                               # (N,4,3)
    bits = (blocks[:, 4:8].astype(np.uint32)
            * (1 << (8 * np.arange(4, dtype=np.uint32)))).sum(-1)
    idx = (bits[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
    rgb = pal[np.arange(n)[:, None], idx]                   # (N,16,3)
    alpha = np.full((n, 16, 1), 255, np.uint8)
    if alpha_from_mode:
        three = (c0 <= c1)[:, None]
        alpha = np.where(three & (idx == 3), 0, 255
                         ).astype(np.uint8)[..., None]
    return np.concatenate([rgb, alpha], -1)


def _decode_bc4_channel(blocks):
    """(N,8) uint8 interpolated-alpha blocks -> (N,16) uint8 channel."""
    n = blocks.shape[0]
    a0 = blocks[:, 0].astype(np.float32)
    a1 = blocks[:, 1].astype(np.float32)
    bits = np.zeros((n,), np.uint64)
    for k in range(6):
        bits |= blocks[:, 2 + k].astype(np.uint64) << np.uint64(8 * k)
    idx = (bits[:, None] >> (3 * np.arange(16, dtype=np.uint64))
           ).astype(np.uint32) & 7
    eight = a0 > a1
    pal = np.zeros((n, 8), np.float32)
    pal[:, 0] = a0
    pal[:, 1] = a1
    for k in range(2, 8):
        w8 = (8 - k) / 7.0
        pal_e = a0 * w8 + a1 * (1 - w8)
        if k < 6:
            w6 = (6 - k) / 5.0
            pal_s = a0 * w6 + a1 * (1 - w6)
        elif k == 6:
            pal_s = np.zeros_like(a0)
        else:
            pal_s = np.full_like(a0, 255.0)
        pal[:, k] = np.where(eight, pal_e, pal_s)
    out = pal[np.arange(n)[:, None], idx]
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def _blocks(data, w, h, block_bytes):
    bw, bh = (w + 3) // 4, (h + 3) // 4
    arr = np.frombuffer(data[:bw * bh * block_bytes], np.uint8)
    return arr.reshape(bw * bh, block_bytes), bw, bh


def _assemble(px16, bw, bh, w, h):
    """(N,16,C) block texels -> (H,W,C)."""
    c = px16.shape[-1]
    img = px16.reshape(bh, bw, 4, 4, c).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(bh * 4, bw * 4, c)[:h, :w])


def decode_dds(data: bytes) -> np.ndarray:
    """DDS bytes -> (H,W,4) uint8 RGBA (top mip only)."""
    if not is_dds(data):
        raise ValueError("not a DDS file")
    (h, w) = struct.unpack_from("<II", data, 12)
    pf_flags, fourcc = struct.unpack_from("<I4s", data, 80)
    rgb_bits, rmask, gmask, bmask, amask = struct.unpack_from(
        "<IIIII", data, 88)
    off = 128
    fmt = None
    if pf_flags & 0x4:                                     # FOURCC
        if fourcc == FOURCC_DX10:
            dxgi, = struct.unpack_from("<I", data, 128)
            off = 148
            if dxgi in DXGI_BC1_UNORM:
                fmt = "bc1"
            elif dxgi in DXGI_BC2_UNORM:
                fmt = "bc2"
            elif dxgi in DXGI_BC3_UNORM:
                fmt = "bc3"
            elif dxgi in DXGI_BC4_UNORM:
                fmt = "bc4"
            elif dxgi in DXGI_BC5_UNORM:
                fmt = "bc5"
            elif dxgi in DXGI_RGBA8:
                fmt = "rgba8"
            elif dxgi in DXGI_BGRA8:
                fmt = "bgra8"
        elif fourcc == FOURCC_DXT1:
            fmt = "bc1"
        elif fourcc == FOURCC_DXT3:
            fmt = "bc2"
        elif fourcc == FOURCC_DXT5:
            fmt = "bc3"
        elif fourcc in (FOURCC_BC4U, FOURCC_ATI1):
            fmt = "bc4"
        elif fourcc in (FOURCC_BC5U, FOURCC_ATI2):
            fmt = "bc5"
    elif pf_flags & 0x40 and rgb_bits == 32:               # uncompressed
        fmt = "bgra8" if bmask == 0xFF else "rgba8"
    if fmt is None:
        raise ValueError(f"unsupported DDS format (fourcc={fourcc!r})")
    body = data[off:]

    if fmt in ("rgba8", "bgra8"):
        img = np.frombuffer(body[:w * h * 4], np.uint8).reshape(h, w, 4)
        if fmt == "bgra8":
            img = img[..., [2, 1, 0, 3]]
        return np.ascontiguousarray(img)
    if fmt == "bc1":
        blk, bw, bh = _blocks(body, w, h, 8)
        return _assemble(_decode_bc1_blocks(blk), bw, bh, w, h)
    if fmt == "bc2":
        blk, bw, bh = _blocks(body, w, h, 16)
        a = blk[:, :8]
        a4 = np.zeros((blk.shape[0], 16), np.uint8)
        for k in range(8):
            a4[:, 2 * k] = (a[:, k] & 0xF) * 17
            a4[:, 2 * k + 1] = (a[:, k] >> 4) * 17
        rgba = _decode_bc1_blocks(blk[:, 8:], alpha_from_mode=False)
        rgba[..., 3] = a4
        return _assemble(rgba, bw, bh, w, h)
    if fmt == "bc3":
        blk, bw, bh = _blocks(body, w, h, 16)
        alpha = _decode_bc4_channel(blk[:, :8])
        rgba = _decode_bc1_blocks(blk[:, 8:], alpha_from_mode=False)
        rgba[..., 3] = alpha
        return _assemble(rgba, bw, bh, w, h)
    if fmt == "bc4":
        blk, bw, bh = _blocks(body, w, h, 8)
        r = _decode_bc4_channel(blk)
        px = np.stack([r, r, r, np.full_like(r, 255)], -1)
        return _assemble(px, bw, bh, w, h)
    if fmt == "bc5":
        blk, bw, bh = _blocks(body, w, h, 16)
        r = _decode_bc4_channel(blk[:, :8])
        g = _decode_bc4_channel(blk[:, 8:])
        px = np.stack([r, g, np.full_like(r, 128),
                       np.full_like(r, 255)], -1)
        return _assemble(px, bw, bh, w, h)
    raise AssertionError(fmt)
