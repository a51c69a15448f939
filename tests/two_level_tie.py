"""A two-level scene in which only the visit order decides the closest hit
(shared by tests/test_torch_bvh2l_order.py, on the CPU against the JAX
package, and tests/test_torch_cuda.py, the kernel on the card).

One triangle T is duplicated COPIES times, vertex for vertex. Six
zero-area triangles on the z axis through the centre of T's bounding box
share its centroid (their Möller–Trumbore determinant is exactly 0, so no
ray hits them), so the builder's median split deals the copies and them
out over several subtrees whose boxes reach different heights above and
below T. Small triangles in a ring around T make the other subtrees.
Rays from above aim at T's interior, so a ray that reaches T meets every
copy at the same t, and the copy it returns names the subtree it walked
first among those holding one."""
import numpy as np
import torch

from rtxpt_tpu_torch.ops import bvh2l as TL

COPIES = 12
CAP_TRIS = 7       # K >= 8 here, so the probe engages
SEED = 3           # a ring whose subtrees make both cases below occur


def scene():
    """(positions (V,3) f32, indices (T,3) i32); triangles 0..COPIES-1
    are the copies of T."""
    r = np.random.default_rng(SEED)
    tri = np.array([[-2, -2, 0], [2, -2, 0], [-2, 2, 0]], np.float32)
    lines = [np.array([[0, 0, -h], [0, 0, h], [0, 0, 0]], np.float32)
             for h in (0.5, 1.0, 2.0, 3.0, 4.0, 5.0)]
    n = 60
    ang = r.uniform(0, 2 * np.pi, n)
    rad = r.uniform(4.5, 8, n)
    c = np.stack([rad * np.cos(ang), rad * np.sin(ang),
                  r.uniform(-3, 3, n)], -1)
    ring = c[:, None, :] + r.uniform(-0.3, 0.3, (n, 3, 3))
    pos = np.concatenate([np.tile(tri, (COPIES, 1)), *lines,
                          ring.reshape(-1, 3)]).astype(np.float32)
    return pos, np.arange(pos.shape[0], dtype=np.int32).reshape(-1, 3)


def rays(n: int = 2048, seed: int = 1):
    """Origins above the scene, directions at T's interior."""
    r = np.random.default_rng(seed)
    o = np.stack([r.uniform(-8, 8, n), r.uniform(-8, 8, n),
                  r.uniform(4, 8, n)], -1)
    target = np.stack([r.uniform(-1.9, 0.0, n), r.uniform(-1.9, 0.0, n),
                       np.zeros(n)], -1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def expected(tl, o, d):
    """Per lane, the subtree whose copy the visit order picks: the ray's
    nearest overlapped subtree (first minimal entry t of the boxes it
    hits) if it holds a copy, else the lowest-index subtree holding one
    whose box the ray hits -> (subtree, lanes where the nearest subtree
    wins over a lower index, lanes where the lowest index wins over a
    nearer copy subtree), numpy."""
    lt = tl.sub_leaf_tris.cpu().numpy()
    has_copy = ((lt >= 0) & (lt < COPIES)).any(1)
    dev = tl.sub_aabb.device
    hit_k, tn_k = TL._top_slabs(tl, torch.as_tensor(o, device=dev),
                                torch.as_tensor(d, device=dev),
                                torch.full((o.shape[0],), 1e30, device=dev))
    hit_k, tn_k = hit_k.cpu().numpy(), tn_k.cpu().numpy()
    near = np.argmin(np.where(hit_k, tn_k, np.inf), 1)
    copy_hit = hit_k & has_copy[None]
    lowest = np.argmax(copy_hit, 1)
    nearest_copy = np.argmin(np.where(copy_hit, tn_k, np.inf), 1)
    near_wins = hit_k.any(1) & has_copy[near]
    sub = np.where(near_wins, near, lowest)
    return sub, near_wins & (near != lowest), \
        ~near_wins & (lowest != nearest_copy)


def subtree_of(tl, prim):
    """The subtree holding each lane's copy (-1 for any other prim)."""
    lt = tl.sub_leaf_tris.cpu().numpy()
    owner = np.full(COPIES, -1)
    for s, row in enumerate(lt):
        ids = row[(row >= 0) & (row < COPIES)]
        owner[ids] = s
    prim = np.asarray(prim)
    copy = (prim >= 0) & (prim < COPIES)
    return np.where(copy, owner[np.clip(prim, 0, COPIES - 1)], -1)
