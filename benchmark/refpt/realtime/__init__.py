"""The plain reference of the realtime mode: the port's realtime frame
(the stable-planes pipeline: BUILD, ReSTIR DI, FILL, ReSTIR GI, the fused
DI + GI final shading, ReLAX per plane and channel, the compose and TAA)
as it stood when the realtime cell was written, frozen here in plain
float32 PyTorch and trimmed to the one configuration the cell runs
(config.py). It imports nothing of the port; the unchanged reference-mode
modules of `refpt` (brute-force trace, BSDF, RNG, gathers, light and sky
tables, surface fetch) are reused by import.

Departures from the port, none of which changes a lane's arithmetic:

- no wavefront compaction (BUILD and FILL) and no Morton order of the
  FILL wavefront: both move lanes only;
- the trace is `refpt`'s brute-force trace over the reference's own
  clusters, whatever structure the port built;
- the K4 FILL pass is its plain version (`shade_fill.py`), called
  directly;
- the pipeline runs at any set of pixels (`frame.py`): the per-pixel
  stages take the pixels' own lanes, and the cross-pixel reads (the
  boiling filter's 16x16 block means and the spatial taps) read a
  full-frame source handed in, so a check can replay the drawn pixels of
  one frame against the program's own neighbours;
- the temporal passes return the reservoir before and after the boiling
  filter apart (`restir.py`), so that the block means can be formed from
  both sources.

The witness is `tests/test_refpt_realtime_witness.py` (against the JAX
package's RealtimeRenderer on the CPU).
"""
