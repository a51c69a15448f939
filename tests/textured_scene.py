"""A small textured, alpha-MASK scene built in code, shared by the
textured parity tests (test_torch_textured_render.py,
test_torch_visibility.py): a floor, alpha-MASK cards with 64x64 leaf
textures, one BLEND card and a normal-mapped box, under the programmer-art
default camera. Its host dict (numpy) goes to the reference's Renderer
and to the port's alike."""
import numpy as np

W, H = 16, 12


def leaf_alpha(size: int, seed: int) -> np.ndarray:
    """(size, size, 4) uint8 RGBA: green leaf shapes (ellipses) over a
    transparent background, about half the texels opaque."""
    rs = np.random.RandomState(seed)
    y, x = (np.mgrid[0:size, 0:size] + 0.5) / size
    alpha = np.zeros((size, size), np.float32)
    for _ in range(6):
        cx, cy = rs.uniform(0.2, 0.8, 2)
        rx, ry = rs.uniform(0.12, 0.3, 2)
        th = rs.uniform(0, np.pi)
        dx, dy = x - cx, y - cy
        u = dx * np.cos(th) + dy * np.sin(th)
        v = -dx * np.sin(th) + dy * np.cos(th)
        alpha = np.maximum(alpha, 1.0 - (u / rx) ** 2 - (v / ry) ** 2)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 0] = rs.randint(20, 90, (size, size))
    img[..., 1] = rs.randint(110, 230, (size, size))
    img[..., 2] = rs.randint(10, 60, (size, size))
    img[..., 3] = np.clip(alpha * 4.0, 0.0, 1.0) * 255
    return img


def normal_map(size: int, seed: int) -> np.ndarray:
    """(size, size, 3) uint8 tangent-space normals: bumps."""
    rs = np.random.RandomState(seed)
    g = rs.normal(0.0, 0.35, (size, size, 2))
    n = np.concatenate([g, np.ones((size, size, 1))], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return ((n * 0.5 + 0.5) * 255).astype(np.uint8)


def _quad(sb, Mesh, p, mat):
    i = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    sb.add_instance(sb.add_mesh(Mesh(positions=np.asarray(p, np.float32),
                                     indices=i, uvs=uv)),
                    material_override=mat)


def build(SceneBuilder, Mesh, tex: int = 64) -> dict:
    """The scene through a SceneBuilder / Mesh pair (the reference's or
    the port's): host dict with texture_images and texture_srgb."""
    sb = SceneBuilder()
    floor = sb.add_material(base_color=(0.7, 0.7, 0.7), roughness=0.8)
    leaf = sb.add_material(base_color=(1, 1, 1), roughness=0.6,
                           alpha_mode=1, alpha_cutoff=0.5, base_tex=0,
                           metal_rough_tex=2)
    blend = sb.add_material(base_color=(0.9, 0.4, 0.3), roughness=0.5,
                            alpha_mode=2, base_tex=1)
    box = sb.add_material(base_color=(0.5, 0.6, 0.9), roughness=0.3,
                          metalness=0.2, normal_tex=3, emissive_tex=-1)
    lamp = sb.add_material(base_color=(1, 1, 1), emissive=(6.0, 5.0, 4.0))
    _quad(sb, Mesh, [[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], floor)
    rs = np.random.RandomState(3)
    for k in range(5):
        c = np.asarray([rs.uniform(-1.5, 1.5), rs.uniform(0.4, 1.4),
                        rs.uniform(-1.5, 0.5)])
        a = rs.uniform(0, np.pi)
        e = np.asarray([np.cos(a), 0.0, np.sin(a)]) * 0.6
        up = np.asarray([0.0, 0.6, 0.0])
        _quad(sb, Mesh, [c - e - up, c + e - up, c + e + up, c - e + up],
              leaf)
    _quad(sb, Mesh, [[-0.5, 0.2, 1.0], [0.5, 0.2, 1.0], [0.5, 1.2, 1.0],
                     [-0.5, 1.2, 1.0]], blend)
    _quad(sb, Mesh, [[-1, 3, -1], [-1, 3, 1], [1, 3, 1], [1, 3, -1]], lamp)
    # a box: 6 faces of the unit cube at (1.2, 0.5, 0.8)
    o = np.asarray([1.2, 0.0, 0.8])
    for axis in range(3):
        for side in (0.0, 1.0):
            u, v = (axis + 1) % 3, (axis + 2) % 3
            pts = []
            for a, b in ((0, 0), (1, 0), (1, 1), (0, 1)):
                q = np.zeros(3)
                q[axis], q[u], q[v] = side, a, b
                pts.append(o + (q - 0.5) * 0.8 + [0, 0.4, 0])
            if side == 0.0:
                pts = pts[::-1]
            _quad(sb, Mesh, pts, box)
    host = sb.finish()
    blend_img = leaf_alpha(tex, 5)
    blend_img[..., 3] = np.where(blend_img[..., 3] > 0, 160, 60)
    mr = np.random.RandomState(9).randint(0, 256, (tex // 2, tex // 2, 4)
                                          ).astype(np.uint8)
    host["texture_images"] = [leaf_alpha(tex, 1), blend_img, mr,
                              normal_map(tex, 2)]
    host["texture_srgb"] = [True, True, False, False]
    return host


def camera(mod, width: int = W, height: int = H):
    """A camera looking at the cards from the front, of camera module
    `mod` (the reference's scene.camera or the port's)."""
    return mod.look_at(width, height, eye=(0.5, 1.6, 5.0),
                       target=(0.0, 0.8, 0.0))
