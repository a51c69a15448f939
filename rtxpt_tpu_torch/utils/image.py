"""Image IO of the headless harness (counterpart of
rtxpt_tpu/utils/image.py): an 8-bit RGB PNG writer and reader on the
standard library's zlib and struct, so the port needs no imaging
package."""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def to_uint8(srgb01) -> np.ndarray:
    """(H,W,3) float in [0,1] -> uint8, the reference's rounding."""
    return np.clip(np.asarray(srgb01) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def encode_png_bytes(srgb01) -> bytes:
    arr = to_uint8(srgb01)
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


def save_png(path: str, srgb01):
    with open(path, "wb") as f:
        f.write(encode_png_bytes(srgb01))


def _unfilter(rows: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = rows[pos]
        line = np.frombuffer(rows, np.uint8, stride, pos + 1).astype(np.int32)
        pos += stride + 1
        cur = np.zeros(stride, np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 255
        else:
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    p = a
                elif ftype == 3:
                    p = (a + b) >> 1
                elif ftype == 4:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                else:
                    raise ValueError(f"bad PNG filter {ftype}")
                cur[x] = (line[x] + p) & 255
        out[y] = cur
        prev = cur
    return out


def load_png(path: str) -> np.ndarray:
    """8-bit non-interlaced gray/RGB/RGBA PNG -> (H,W,3) float in [0,1]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    chans = {0: 1, 2: 3, 6: 4}.get(ctype)
    if depth != 8 or chans is None or interlace:
        raise ValueError(f"{path}: unsupported PNG (depth {depth}, "
                         f"color type {ctype}, interlace {interlace})")
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * chans, chans)
    img = img.reshape(h, w, chans)
    rgb = np.repeat(img, 3, axis=-1) if chans == 1 else img[..., :3]
    return rgb.astype(np.float32) / 255.0


def save_npy(path: str, hdr):
    np.save(path, np.asarray(hdr, np.float32))


def compare(a, b) -> dict:
    """MSE / PSNR / SMAPE between two (H,W,3) images (the golden harness
    of tools/compare_images.py)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"image shapes differ: {a.shape} vs {b.shape}")
    mse = float(np.mean((a - b) ** 2))
    peak = max(a.max(), b.max(), 1e-9)
    psnr = float(10.0 * np.log10(peak * peak / max(mse, 1e-20)))
    smape = float(np.mean(np.abs(a - b) / (np.abs(a) + np.abs(b) + 1e-3)))
    return dict(mse=mse, psnr=psnr, smape=smape)
