"""Image IO of the headless harness (counterpart of
rtxpt_tpu/utils/image.py): an 8-bit RGB PNG writer and reader on the
standard library's zlib and struct, so the port needs no imaging
package. The reader also decodes the RGBA of glTF images."""
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


def encode_png_uint8(arr) -> bytes:
    """(H,W,3) RGB or (H,W,4) RGBA uint8 -> 8-bit PNG bytes (filter 0)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, {3: 2, 4: 6}[c], 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw))
            + _chunk(b"IEND", b""))


def encode_png_bytes(srgb01) -> bytes:
    return encode_png_uint8(to_uint8(srgb01))


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
        if ftype == 0:
            cur = line
        elif ftype == 1:        # Sub: a running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ftype == 2:
            cur = (line + prev) & 255
        elif ftype in (3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    p = (a + b) >> 1
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (line[x] + p) & 255
        else:
            raise ValueError(f"bad PNG filter {ftype}")
        out[y] = cur
        prev = cur
    return out


_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_png_rgba(data: bytes, name: str = "PNG") -> np.ndarray:
    """Non-interlaced PNG bytes -> (H,W,4) uint8 RGBA, as an imaging
    package's RGBA conversion gives it: 8-bit gray, gray + alpha, RGB and
    RGBA, and palette images of 1-8 bits, a tRNS chunk's transparency
    applied. Any other PNG (16-bit, sub-byte gray, interlaced) raises
    ValueError naming `name`."""
    if data[:8] != _SIG:
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, hdr, plte, trns = 8, [], None, None, None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    chans = _CHANNELS.get(ctype)
    sub = ctype == 3 and depth in (1, 2, 4)     # packed palette indices
    if (depth != 8 and not sub) or chans is None or interlace or \
            (ctype == 3 and plte is None):
        raise ValueError(f"{name}: unsupported PNG (depth {depth}, color "
                         f"type {ctype}, interlace {interlace}); 8-bit "
                         "non-interlaced images (palettes of 1-8 bits) "
                         "are read")
    stride = (w * depth + 7) // 8 if sub else w * chans
    img = _unfilter(zlib.decompress(b"".join(idat)), h, stride, chans)
    if sub:
        per = 8 // depth
        shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
        img = ((img[..., None] >> shifts) & ((1 << depth) - 1)).reshape(
            h, -1)[:, :w]
    img = img.reshape(h, w, chans)
    alpha = np.full((h, w, 1), 255, np.uint8)
    if ctype == 3:
        pal_a = np.full((plte.shape[0],), 255, np.uint8)
        if trns is not None:
            t = np.frombuffer(trns, np.uint8)[:plte.shape[0]]
            pal_a[:t.shape[0]] = t
        i = np.minimum(img[..., 0], plte.shape[0] - 1)
        return np.concatenate([plte[i], pal_a[i][..., None]], -1)
    if ctype in (4, 6):
        return np.concatenate(
            [np.repeat(img[..., :1], 3, -1) if ctype == 4 else img[..., :3],
             img[..., -1:]], -1)
    if trns is not None:      # a color key: that color is transparent
        key = np.asarray(struct.unpack(f">{chans}H", trns[:2 * chans]))
        alpha[(img == key).all(-1)] = 0
    rgb = np.repeat(img, 3, -1) if ctype == 0 else img
    return np.concatenate([rgb, alpha], -1)


def load_png(path: str) -> np.ndarray:
    """8-bit non-interlaced PNG -> (H,W,3) float in [0,1] (the color of
    `decode_png_rgba`)."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_png_rgba(data, path)[..., :3].astype(np.float32) / 255.0


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
