"""The port's loaders against the reference's on the same files: DDS
decode bit for bit (the formats of tests/test_textures_dds.py, and random
blocks of each compressed format); the PNG reader against PIL's
convert("RGBA") on each color type it takes, and its refusals; glTF and
GLB host dicts equal on the documents of tests/test_gltf.py and
tests/test_texcache.py; async decode equal to sync; .scene.json; the
CLI's --scene PATH on the CPU. The port decodes PNG and DDS images only,
and raises on an image it cannot decode, where the reference falls back
to a white texture (ROADMAP §3)."""
import base64
import io
import json
import struct
from concurrent.futures import Future

import numpy as np
import pytest
from PIL import Image

from test_gltf import _make_doc
from test_texcache import _textured_gltf
from test_textures_dds import _dds_header
from rtxpt_tpu.scene import dds as JDDS
from rtxpt_tpu.scene import gltf as JG
from rtxpt_tpu.scene import scene_json as JSJ
from rtxpt_tpu_torch.app import cli
from rtxpt_tpu_torch.scene import dds as TDDS
from rtxpt_tpu_torch.scene import gltf as TG
from rtxpt_tpu_torch.scene import scene_json as TSJ
from rtxpt_tpu_torch.scene.texcache import TextureCache, resolve_images
from rtxpt_tpu_torch.utils import image as IM

HOST_KEYS = ("positions", "normals", "tangents", "uvs", "indices", "tri_mat",
             "tri_instance")


def _dx10(w, h, dxgi):
    hdr = bytearray(_dds_header(w, h, fourcc=b"DX10"))
    return bytes(hdr) + struct.pack("<IIIII", dxgi, 3, 0, 1, 0)


def _dds_files():
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (8, 12, 4), np.uint8)
    blocks = lambda n, size: rs.randint(0, 256, n * size, np.uint8).tobytes()
    return {
        "rgba8": _dds_header(12, 8, rgb=True) + img.tobytes(),
        "dx10-bgra8": _dx10(12, 8, 87) + img.tobytes(),
        "bc1": _dds_header(10, 7, fourcc=b"DXT1") + blocks(6, 8),
        "bc2": _dds_header(8, 8, fourcc=b"DXT3") + blocks(4, 16),
        "bc3": _dds_header(8, 4, fourcc=b"DXT5") + blocks(2, 16),
        "bc4": _dds_header(4, 8, fourcc=b"ATI1") + blocks(2, 8),
        "bc5": _dds_header(8, 8, fourcc=b"BC5U") + blocks(4, 16),
        "dx10-bc1": _dx10(8, 8, 71) + blocks(4, 8),
        "dx10-bc3": _dx10(8, 8, 77) + blocks(4, 16),
    }


@pytest.mark.parametrize("fmt", sorted(_dds_files()))
def test_dds_bit_equal(fmt):
    data = _dds_files()[fmt]
    ref = JDDS.decode_dds(data)
    got = TDDS.decode_dds(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref)


def test_dds_refusals():
    with pytest.raises(ValueError, match="not a DDS"):
        TDDS.decode_dds(b"PNG ....")
    with pytest.raises(ValueError, match="unsupported DDS"):
        TDDS.decode_dds(_dds_header(4, 4, fourcc=b"XXXX") + bytes(16))


def _png(im, **kw):
    b = io.BytesIO()
    im.save(b, format="PNG", **kw)
    return b.getvalue()


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "LA", "P16", "P16t",
                                  "P200t", "Lt", "RGBt"])
def test_png_reader_matches_pil_rgba(mode):
    a = np.random.RandomState(1).randint(0, 256, (13, 17, 4)).astype(np.uint8)
    kw = {}
    if mode.startswith("P"):
        im = Image.fromarray(a[..., :3], "RGB").quantize(
            int(mode[1:].rstrip("t")))
        if mode.endswith("t"):
            kw["transparency"] = 3
    elif mode == "Lt":
        im, kw = Image.fromarray(a[..., 0], "L"), dict(transparency=int(
            a[0, 0, 0]))
    elif mode == "RGBt":
        im = Image.fromarray(a[..., :3], "RGB")
        kw = dict(transparency=tuple(int(x) for x in a[0, 0, :3]))
    else:
        im = Image.fromarray(a[..., :len(mode)].squeeze(-1) if mode == "L"
                             else a[..., :len(mode)], mode)
    data = _png(im, **kw)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))
    got = IM.decode_png_rgba(data)
    assert got.dtype == np.uint8 and np.array_equal(got, ref)


def test_png_reader_refusals_and_writer():
    a = np.random.RandomState(2).randint(0, 256, (9, 11, 4)).astype(np.uint8)
    with pytest.raises(ValueError, match="depth 16"):
        IM.decode_png_rgba(_png(Image.fromarray(
            a[..., 0].astype(np.uint16) * 257)), "deep.png")
    interlaced = (IM._SIG + IM._chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 11, 9, 8, 6, 0, 0, 1)) + IM._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="interlace 1"):
        IM.decode_png_rgba(interlaced)
    with pytest.raises(ValueError, match="not a PNG"):
        IM.decode_png_rgba(b"\xff\xd8\xff\xe0 a jpeg")
    data = IM.encode_png_uint8(a)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(data))), a)
    assert np.array_equal(IM.decode_png_rgba(data), a)


def _assert_hosts_equal(ref, got):
    for k in HOST_KEYS:
        assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k
    for k, v in ref["materials"].items():
        assert np.array_equal(got["materials"][k], np.asarray(v)), k


def _glb(doc):
    js = json.dumps(doc).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    return struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js)) + \
        struct.pack("<II", len(js), 0x4E4F534A) + js


@pytest.mark.parametrize("kind", ["gltf", "glb", "textured"])
def test_gltf_host_dicts_equal(tmp_path, kind):
    path = tmp_path / ("t.glb" if kind == "glb" else "t.gltf")
    if kind == "textured":
        _textured_gltf(path)
    elif kind == "glb":
        path.write_bytes(_glb(_make_doc()))
    else:
        path.write_text(json.dumps(_make_doc()))
    ref, rinfo = JG.load_gltf(str(path))
    got, info = TG.load_gltf(str(path))
    _assert_hosts_equal(ref, got)
    assert info["texture_srgb"] == rinfo["texture_srgb"]
    assert len(info["textures"]) == len(rinfo["textures"])
    for a, b in zip(info["textures"], rinfo["textures"]):
        assert np.array_equal(a, np.asarray(b))
    rc, tc = (JG.camera_from_info(rinfo, 64, 48),
              TG.camera_from_info(info, 64, 48))
    for name in tc._fields:
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(rc, name)))


def test_async_decode_matches_sync(tmp_path):
    p = tmp_path / "tex.gltf"
    _textured_gltf(p)
    _, sync = TG.load_gltf(str(p))
    _, info = TG.load_gltf(str(p), texture_cache=TextureCache())
    assert all(isinstance(t, Future) for t in info["textures"])
    assert info["textures"][0] is info["textures"][1]     # one source
    for a, b in zip(resolve_images(info["textures"]), sync["textures"]):
        assert np.array_equal(a, b)


def _with_image(tmp_path, uri_or_bytes, mime=None):
    """tests/test_texcache.py's document with its image replaced."""
    p = tmp_path / "tex.gltf"
    _textured_gltf(p)
    doc = json.loads(p.read_text())
    if isinstance(uri_or_bytes, bytes):
        uri_or_bytes = (f"data:{mime};base64,"
                        + base64.b64encode(uri_or_bytes).decode())
    doc["images"] = [{"uri": uri_or_bytes}]
    p.write_text(json.dumps(doc))
    return p


def test_undecodable_images_raise(tmp_path):
    b = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(b, format="JPEG")
    p = _with_image(tmp_path, b.getvalue(), "image/jpeg")
    with pytest.raises(ValueError, match="image/jpeg"):
        TG.load_gltf(str(p))
    # the reference falls back to a white 4x4 texture
    _, rinfo = JG.load_gltf(str(p))
    assert np.asarray(rinfo["textures"][0]).shape == (4, 4, 4)
    (tmp_path / "leaf.dds").write_bytes(b"DDS " + bytes(200))
    p = _with_image(tmp_path, "leaf.dds")
    with pytest.raises(ValueError, match="leaf.dds: DDS image"):
        TG.load_gltf(str(p))
    # a future raises where it is resolved
    _, info = TG.load_gltf(str(p), texture_cache=TextureCache())
    with pytest.raises(ValueError, match="leaf.dds"):
        resolve_images(info["textures"])


def _scene_json(tmp_path):
    _textured_gltf(tmp_path / "tex.gltf")
    (tmp_path / "t.gltf").write_text(json.dumps(_make_doc()))
    doc = {"models": ["tex.gltf", "t.gltf"],
           "environment": {"type": "constant", "radiance": [0.2, 0.3, 0.4],
                           "intensity": 2.0},
           "camera": {"position": [0.3, 0.3, 3.0], "target": [0.3, 0.3, 0],
                      "fov_y_degrees": 50},
           "lights": [{"type": "point", "position": [0, 2, 1],
                       "radiance": [3, 3, 3]}],
           "settings": {"MaxBounces": 2, "nee_local_samples": 1}}
    path = tmp_path / "s.scene.json"
    path.write_text(json.dumps(doc))
    return path


def test_scene_json_matches_reference(tmp_path):
    path = _scene_json(tmp_path)
    ref, rcam, rextra = JSJ.load_scene_json(str(path), 16, 12)
    got, cam, extra = TSJ.load_scene_json(str(path), 16, 12)
    _assert_hosts_equal(ref, got)
    for name in cam._fields:
        np.testing.assert_array_equal(getattr(cam, name).numpy(),
                                      np.asarray(getattr(rcam, name)))
    np.testing.assert_array_equal(extra["env_radiance"],
                                  np.asarray(rextra["env_radiance"]))
    assert extra["env_intensity"] == rextra["env_intensity"] == 2.0
    assert extra["settings"] == rextra["settings"]
    assert len(extra["analytic_lights"]) == len(rextra["analytic_lights"])
    # the port keeps the models' textures (the reference drops them)
    assert "texture_images" not in ref
    assert len(got["texture_images"]) == 2 and got["texture_srgb"] == [
        True, False]


@pytest.mark.parametrize("scene", ["gltf", "scene.json"])
def test_cli_scene_path_on_cpu(tmp_path, scene):
    if scene == "gltf":
        path = tmp_path / "tex.gltf"
        _textured_gltf(path)
    else:
        path = _scene_json(tmp_path)
    npy = str(tmp_path / "o.npy")
    assert cli.main(["--scene", str(path), "--width", "16", "--height", "12",
                     "--spp", "1", "--device", "cpu", "--max-bounces", "2",
                     "--output", str(tmp_path / "o.png"), "--dump-npy", npy,
                     "--quiet"]) == 0
    hdr = np.load(npy)
    assert hdr.shape == (12, 16, 3)
    assert np.isfinite(hdr).all() and hdr.mean() > 0.0
    with pytest.raises(SystemExit, match="unknown scene"):
        cli.main(["--scene", str(tmp_path / "x.obj"), "--device", "cpu"])
