"""rtxpt_tpu_torch: the PyTorch + CUDA (Hopper) port of rtxpt_tpu.

The module layout mirrors ``rtxpt_tpu`` so every file here has one
counterpart there; the JAX package is the reference the port is tested
against. This package imports ``torch`` and never ``jax``.

Slice carried so far: the reference-mode accumulation render of the
``programmer-art`` scene (``Renderer.render`` -> ``integrator.render_paths``
-> the bounce loop), with the four TPU kernels of that path rewritten as
hand-written CUDA kernels for ``sm_90a`` (``csrc/``):

  K1 ops/mt_dense.py      closest/any-hit ray-triangle trace (dense scenes)
  K2 ops/gather.py        row gather
  K3 ops/gather.py        barycentric 3-row blend
  K4 pt/shade_kernel.py   fused shade + NEE bounce

Dispatch rule for every kernel wrapper: a CPU tensor takes the plain
PyTorch version beside the kernel; a CUDA tensor launches the kernel (or
the call raises). There is no environment switch and no fallback.
"""

__version__ = "0.1.0"
