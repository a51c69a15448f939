"""rtxpt_tpu_torch: the PyTorch + CUDA (Hopper) port of rtxpt_tpu.

The module layout mirrors ``rtxpt_tpu`` so every file here has one
counterpart there; the JAX package is the reference the port is tested
against. This package imports ``torch`` and never ``jax``.

Carried so far: the reference-mode accumulation render
(``Renderer.render`` -> ``integrator.render_paths`` -> the bounce loop)
and the realtime mode's pipelines, of the ``programmer-art`` scene, the
procedural city and glTF / .scene.json scenes with textures and
alpha-MASK materials, through the reference's three trace tiers (dense,
BVH8, two-level BVH8), with the TPU kernels of those paths rewritten as
hand-written CUDA kernels for ``sm_90a`` (``csrc/``):

  K1 ops/mt_dense.py       closest/any-hit ray-triangle trace (dense scenes;
                           with K7's worklists, one fused launch per trace;
                           its OMM channel tests opacity micro-masks)
  K2 ops/gather.py         row gather
  K3 ops/gather.py         barycentric 3-row blend (with K2, one fused
                           surface-fetch launch per load_surface call)
  K4 pt/shade_kernel.py    fused shade + NEE bounce
  K5 ops/traverse_bvh8.py  BVH8 closest/any-hit traversal
  K6 ops/traverse_bvh8.py  the same over stacked subtree tables, one
                           subtree per ray (the two-level probe)

Dispatch rule for every kernel wrapper: a CPU tensor takes the plain
PyTorch version beside the kernel; a CUDA tensor launches the kernel (or
the call raises). There is no environment switch and no fallback.
"""

__version__ = "0.1.0"
