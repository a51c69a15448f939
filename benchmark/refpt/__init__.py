"""The plain reference that decides `correct`: the port's plain
reference-mode path tracer as it stood when the benchmark was written,
frozen here and trimmed to the one configuration the cells run
(config.py). It imports nothing of the port, and a later change to the
port is judged against this arithmetic.

What is the benchmark's own rather than the port's:

- `ops/traverse.py` is a brute-force trace: it tests every triangle of the
  clusters whose boxes a ray enters, and so works each hit out again from
  the triangles, whatever structure the port built;
- `scene/camera.py` takes a jitter per lane, and the bounce loop
  (`pt/integrator.py`) a sample base per lane, so that one wavefront can
  replay the lanes of several render calls;
- every gather and the shade pass are plain tensor code, called directly.

The copied shading, NEE, BSDF, light and environment tables and RNG are
witnessed apart from the port by `benchmark/tests/test_refpt_witness.py`:
against the JAX package's renders of the same scene, and the committed
golden images that package rendered.
"""
