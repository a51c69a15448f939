#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rtxpt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line; each prints
its seconds):
  1. print the card (nvidia-smi name, power limit); build the CUDA kernels
     from csrc/ with nvcc for sm_90a, the renderer's library and the K8
     lab's (one nvcc per source, all started together), and print ptxas's
     registers, shared memory and spills of every kernel instance of
     csrc/gather.cu (none may spill) and of the main paths' K4 and K4 FILL
     instantiations with their float operations per lane, counted from
     the built library's SASS (`cuobjdump -sass`; K4's operation bound);
  2. hold the fused dense trace (`mt_dense_fused`: each tile's worklist
     and the walk in one launch), K1 walking K7's
     worklists, the surface fetch (`gather_surface`: K2 + K3 in one
     launch), K2-K4 and K7 against their plain PyTorch versions on the
     card, on the inputs of the first bounces of an 800x600 programmer-art
     render (480,000 camera rays, then scattered and NEE rays), and time
     both (K2 beside torch.index_select, on each table the path gathers
     from, those inside the surface fetch included; the surface fetch
     bit-equal to its plain version and to the four-launch composition it
     replaced, K2, K3, K2, K2, timed beside it; K3 on the surface fetch's
     blend); K7's worklist keys must be bit-equal on every captured dense
     trace; the active lanes, tiles and visits per tile and the fused
     kernel's lab modes are printed; the sample generator's kernels
     (csrc/rng.cu: make, start_effect, next_*) on every generator call of
     the first bounce of the art cell's render (800x600, 8 spp, NEE 2+2:
     init_paths, the shade step, the regeneration), bit-equal to the
     plain version, kernel ms against plain ms, each call's bytes and
     their time at 3.35 TB/s;
  3. render 64x48 2spp and 160x120 8spp with reference_config() and hold
     them against the goldens in assets/ (PSNR > 40 dB, SMAPE < 0.02, the
     cross-platform gate); hold the 64x48 GPU render against the port's
     CPU render of the same frame (PSNR > 40 dB);
  4. render the bench workload (800x600, 6 bounces / 4 diffuse, NEE 1+1,
     8 spp as one regenerating wavefront) with every launch counter set to
     0 just before, and require the fused dense trace once per dense trace
     call, K1 and K7 not at all, the surface fetch once per load_surface
     call, K3 not at all, K4 once per bounce, the sample generator's three
     kernels at least once per bounce and K2 to have launched; then
     render
     it once more unsorted and once with wavefront_sort="raystream", print
     both walls and the fused kernel's visits per tile (its lab mode
     "lists" on every trace), require the same launches and the sorted
     image to equal the unsorted one (rtol 1e-5, atol 1e-6,
     tests/test_raystream_sort.py);
  5. the city: build the default procedural city (404,186 triangles,
     two-level BVH8); on the three two-level traces of the first bounce
     of a 1920x1080 1-spp render (camera, NEE any-hit, scattered) hold
     the fused two-level launch (`bvh8_trace_2l`) against the plain
     composition, K6 against its plain version on those rays with their
     nearest subtree and K5 on the largest subtree's table with the rays
     that overlap its box, and time them (and the two-level kernel's lab
     modes, tools_torch/profile_bvh8.py); the surface fetch, K2-K4 on the
     gathers and the shade pass of that bounce, as in 2., and the sample
     generator's kernels on the generator calls of the first bounce of a
     1920x1080 2-spp render; render it at
     1920x1080, bench config, 2 spp as one regenerating chunk, after a
     warm-up render, with the counters set to 0 just before, and require
     K2 to have launched, K4 once per bounce, the surface fetch once per
     load_surface call and K3 not at all, the sample generator's kernels
     at least once per bounce, `bvh8_trace_2l` once per
     two-level trace call, and K5 and K6 not at all; hold a 64x36 GPU
     render against the port's CPU render (PSNR > 40 dB);
  6. reference configurations (the configurations of reference mode
     other than the default, pt/integrator.py `uses_shade_kernel`): hold
     the fused dense trace, K1, K7, the surface fetch, K2 and K3 against
     their plain versions on the first bounce of the bench through the
     chain of tensor ops (shade_megakernel=False, path "bench_chain");
     render the bench through the chain with the counters set to 0 just
     before, and require no K4, the fused dense trace once per dense trace
     call, the surface fetch once per load_surface call, K2 to have
     launched and the image to be within PSNR 40 dB of the K4 bench's
     (tonemapped); render the bench under NEE off, the uniform and the
     presampled distant samplers, ReGIR local sampling (grid and onion
     cells) and the "hq" and "uniform" sample-generator tiers, each with
     K4 once per bounce where the rule takes it and not at all elsewhere,
     and require each image mean within 10% of the default bench's (the
     reference's unbiasedness gate, tests/test_regir.py:30-31); on the
     city at 1920x1080 with ReGIR local sampling (path "city_regir"), hold
     the two-level trace (camera and NEE rays), K5, K6, the surface fetch,
     K2 and K3 against their plain versions on its first bounce, render
     2 spp and require `bvh8_trace_2l` once per two-level trace call, no
     K4, and the mean within 10% of the city phase's; hold every
     configuration's 64x48 2-spp GPU render against the CPU's (PSNR >
     40 dB), and two 64x48 realtime frames through the FILL chain
     (shade_megakernel=False; no K4 FILL) against the CPU's;
  7. realtime: the default realtime pipeline (3 stable planes, ReSTIR DI
     + GI, ReLAX, TAA; 30 bounces / 3 diffuse, NEE 2+2). On the city at
     1920x1080 and on programmer-art at 640x360 (the bench's realtime
     case): capture the first launches of each kernel in one frame (the
     BUILD pass's camera trace, the first FILL bounce's gathers and K4
     FILL, the first FILL NEE trace that casts a ray, the fused ReSTIR
     final shade's visibility trace) and hold each kernel of the path
     against its plain version on them (city: the two-level launch, K6
     and K5 as in 5., the surface fetch, K2, K3, K4 FILL; 360p: the fused
     dense trace, K1, K7, the surface fetch, K2, K3, K4 FILL, as in 2.);
     after the no-history and the history warm-up frames, time 3 frames
     with the counters set to 0 just before, and require the path's
     kernels to have launched (the city: `bvh8_trace_2l` once per
     two-level trace call, K5 and K6 not at all; 360p: `mt_dense_fused`
     once per dense trace call, K1 and K7 not at all; both: the surface
     fetch once per load_surface call, K3 not at all, K4 FILL once per
     FILL bounce and K4 not at all; ReLAX's three passes and the TAA
     resolve launched) and the frame to be finite and not black; then
     one more frame with ReLAX's and TAA's wrappers captured: every call's
     kernels (csrc/relax.cu: the temporal and the variance pass, one
     launch each, one launch an a-trous iteration, the TAA resolve)
     counted and bit-equal to the plain version on the call's inputs,
     timed beside it (CUDA events) with their bytes at 3.35 TB/s. Then
     the port on the card against the port on the CPU (programmer-art 64x48,
     2 frames, PSNR > 40 dB), and the estimator oracle of
     tests/test_ref_vs_realtime.py on the card on stable planes (phase 8
     runs it on PSR-lite): the mean of 32 `ref-vs-realtime` frames at
     48x32 against the port's 32-spp reference render (median block
     error < 0.25, means within 10%);
  8. realtime pipelines: PSR-lite (use_stable_planes=False, ReSTIR DI +
     GI, ReLAX, TAA; 30 bounces / 3 diffuse, NEE 2+2) on the city at
     1920x1080 and on programmer-art at 640x360: each kernel of the path
     against its plain version on the G-buffer's camera trace, its first
     PSR-chain trace with an active lane (printing how many lanes it has;
     the city's chain may cast none), the path loop's first bounce (K2,
     the surface fetch, K3, and K4 at NEE 2+2 on all w*h lanes), its
     first NEE trace that casts a ray and the ReSTIR visibility trace;
     3 timed frames each with one `bvh8_trace_2l` or `mt_dense_fused` per
     trace call, one surface fetch per load_surface, one K4 per bounce
     and no K4 FILL, then ReLAX's and TAA's kernels on one more frame, as
     in 7. The city at 960x540 upscaled by TAAU to 1920x1080 on
     RealtimeRenderer defaults (its kernels checked at 518,400 lanes, 3
     timed frames of 1920x1080, ReLAX's kernels as in 7.; TAAU takes
     TAA's place). The city at 1920x1080 denoised by ReBLUR (3 timed
     frames with the launch checks, the TAA resolve among them). GPU vs
     CPU (PSNR > 40 dB, 64x48, frame 2): PSR-lite, its ref-vs-realtime
     preset, ReBLUR on both pipelines, TAAU from 32x24 to 64x48, and
     photo_denoise_auto on a 2-spp reference render. The estimator
     oracle on PSR-lite (the reference's own configuration). Denoiser
     quality (tests/test_denoise_quality.py): 4 frames at 64x48 against
     a 64-spp reference render, ReLAX and ReBLUR each more than 1.5 dB
     above the raw frame and above 18 dB;
  9. foliage dense: programmer-art and 1,500 alpha-MASK leaf cards in
     the default camera's view (8,160 triangles, the dense tier; 2048x2048
     leaf base color + alpha and normal map, 1024x1024 metal-rough, all
     made from a seed; the texture stack's 1024x1024 cap), bench config
     at 800x600: the fused dense trace with its OMM channel against its
     plain version on the first bounce's camera trace, the exact alpha
     test's first and re-queue traces (closest, masked) and the NEE
     any-hit trace of the masks alone (exact_alpha_test=False): 0 lanes
     may differ in slot and t bits (any-hit: in the occlusion flag); the
     surface fetch, K2 (the texel pool's gathers among them) and K4 on
     that bounce; the 8-spp render with the counters set to 0 just
     before (the launch checks of the bench), after a warm-up render that
     counts the visibility lanes the exact test re-queues and those left
     unresolved; the image with the masks alone (its mean must differ);
     64x48 2-spp GPU vs CPU (PSNR > 40 dB);
  10. city foliage: build_city() and 20,000 leaf cards along the camera's
     street (444,186 triangles, two-level): the two-level kernel (with
     K6 and K5 on the largest subtree, as in 5.) against its plain
     version on the first bounce's camera and exact visibility traces,
     the surface fetch, K2 and K4; the 1920x1080 2-spp render with the
     city's launch checks; 3 frames of the default realtime pipeline at
     1920x1080 after the two warm-ups (the first counting the re-queue),
     with the realtime city's launch checks, and ReLAX's and TAA's
     kernels on one more frame, as in 7.; 64x36 1-spp GPU vs CPU;
  11. the glTF loader: a .scene.json written to a temporary directory,
     whose model is a .gltf of the 1,500 cards over a floor with one PNG
     base color + alpha and one BC1 .dds metal-rough, rendered through
     the CLI (`--scene PATH --device cuda`) at 800x600 8 spp with the
     counters set to 0 just before (the bench's launch checks), and at
     64x48 2 spp on the card against the CPU (PSNR > 40 dB);
  12. skinned: the skinned figure of tools_torch/animated_scenes.py (a
     tube of 512 segments x 24 sides over a chain of 64 joints, its last
     8 segments an emissive primitive of the same skin, a floor and a
     camera: 24,578 triangles, the single-BVH8 tier), written to a
     temporary directory and posed at 0.5 s of its animation: the BVH8
     refit on the card bit-equal to the CPU's refit of the same positions,
     every leaf triangle inside its parent slot's box, the `animate` call
     timed; K5 against its plain version on the posed first bounce's
     camera and NEE traces (0 lanes differ in slot and t bits), the
     surface fetch, K2 and K4 on that bounce; the 800x600 8-spp bench
     render through the CLI (`--animate-time 0.5`) with the counters set
     to 0 just before: K5 once per trace call, K6 and the two-level trace
     not at all, the surface fetch once per load_surface call, K4 once per
     bounce; 64x48 GPU vs CPU (PSNR > 40 dB). The same figure at 128
     segments (6,146 triangles, the dense tier): the fused dense trace on
     refresh_dense's planes against its plain version (0 lanes differ),
     its kernels on the first bounce, the CLI render's launch checks, GPU
     vs CPU. `--animate` realtime at 1920x1080 (the default pipeline): the
     path's kernels on the first frame, then 3 frames with the animate
     call before each, with the realtime launch checks (K5 once per trace
     call), and ReLAX's and TAA's kernels on one more frame, as in 7.;
  13. instanced city: build_city() written as a glTF (3,219 mesh nodes
     over the four meshes, one glTF mesh per mesh and material, one
     animation that moves 64 of the spheres; 404,186 triangles): the gate
     must pick the instanced TLAS; one round's K5 launch against its plain
     version (0 lanes differ), the first bounce's other kernels, the
     camera trace call timed with its rounds; the 1920x1080 1-spp bench
     render through the CLI (`--animate-time 0.5`) with K5 once per round,
     the surface fetch and K4 as on the bench; 64x36 GPU vs CPU; the same
     file without its animation must take the two-level BVH8;
  14. multi-device (rtxpt_tpu_torch/parallel/; the ranks started by
     tools_torch/sharded_frames.py `spawn` after the CUDA library is
     built): torch.cuda.device_count() ranks over NCCL, one card each,
     where there are two cards or more, else two ranks on cuda:0 over
     gloo with the halo and gather buffers copied through host memory
     (printed). The single-device oracles first, on the card: two frames
     of each pipeline at 32x192 (ReSTIR DI + GI, no denoiser or TAA), the
     1-spp render at 32x16, five frames of the realtime city at
     1920x1080 (default pipeline; the last 3 timed) and three without
     TAA. Then on every rank:
     the same two pipelines through RealtimeRenderer(mesh=) (stage 1 on
     the rank's rows), held to the reference's seam contract against
     the single-device frames (rtol 1e-4 / atol 1e-5 off 21 rows about
     each seam, the band's mean within 15%, the pixels not bit-equal
     printed); render_image_sharded against render_sample (rtol 1e-5 /
     atol 1e-6, the pixels not bit-equal printed); the city at 1920x1080
     (default pipeline: stable planes, ReLAX, TAA), 2 warm-ups and 3
     timed frames with the counters set to 0 just before: every rank
     returns the same finite frame, its mean within 5% of one device's
     (PSNR printed), and launches the realtime city's kernels
     (`bvh8_trace_2l`, K2, the surface fetch, K4 FILL; no K5, K6 or K4);
     each rank prints its ms per frame, the halo and gather bytes and ms
     per frame (CUDA events around each exchange) and its launches per
     kernel. The launches, summed over the ranks, are the kernels line's
     path `realtime_sharded`; then every rank renders two more frames, of
     which rank 0 holds the path's kernels against their plain versions
     on its rows' launches (the first frame's; ReLAX's on its rows and
     their halo, TAA's on the gathered frame, the second's, as in 7.; the
     path's numbers in the kernels line).
     Last, 3 city frames without TAA on every rank, against one device's:
     every pixel within rtol 1e-4 / atol 1e-5 on the rows beyond the
     reach of a seam, the frame's edge and (from the second frame) the
     rows whose boiling-filter block differs on their rank. A rank that
     fails or runs past 480 s fails the phase;
  15. tools (the debug views, debug print, debug lines, delta tree,
     viewer and profiler of rtxpt_tpu_torch/utils/ and app/viewer.py): on
     the 1920x1080 city (two-level), the first debug view's camera trace
     and surface fetch (K2 on its tables and on the first ReSTIR view's
     light and environment rows, K3 on its blend) against their plain
     versions, as in 5.; then every surface view (the OMM views
     among them), the ReSTIR DI stage views, ReGIRIndirectOutput and
     inspect_pixel with the counters set to 0 just before (path
     "debug_views": `bvh8_trace_2l` once per trace call, the surface fetch
     once per load_surface call, K2 launched, no K4; the slowest view's
     ms and all views' together printed), and every pipeline view on
     phase 7's stable planes and phase 8's PSR-lite outputs at 1080p (no
     extra frames). On programmer-art at 64x48, the card against the CPU:
     every view (PSNR > 40 dB against [0, 1]; the hashed views equal where
     the G-buffer prims agree; the ReSTIR stage views off the lanes whose
     reservoir picked another sample, at most 2%; the pipeline views on
     the card's frames copied to the CPU), explore_pixel on the glass
     pixel of tests/test_deltatree.py (the same nodes; ms a node printed),
     print_path within 1e-4, mat_pack bit-equal after set_material, a
     render after update_environment (PSNR > 40 dB). The web viewer
     (ViewerApp(device="cuda") at 640x360 on 127.0.0.1, a free port): a
     reference frame (the dense trace once per trace call, the surface
     fetch once per load_surface call, K4 once per bounce), a material
     edit, realtime frames and a debug-view frame, each request's ms
     printed. The CLI's --debug-* flags with --device cuda (the tables
     equal the library's). One realtime frame inside profiling.trace: the
     Chrome trace names the dense trace, surface-fetch and shade kernels;
  16. the labs: every micro-kernel of the traversal-ingredient lab (K8,
     tools_torch/kernel_lab.py) against its plain version at 16
     iterations, and its microseconds per iteration at 2,000; each mode of
     the dense-trace lab (K9, tools_torch/profile_mt_kernel.py) on the
     bench camera rays, the "gate" mode's visit counts equal to its plain
     version and the others' winners against the plain K1;
  17. print the seconds of the two-level checks' plain compositions
     (each run once: its result is compared, its CUDA-event time is the
     path's plain_ms), then a JSON line describing the kernels (each
     kernel's numbers on every path that checks it under `by_path`; at
     the top level, those of the first main path that runs it, else of
     the first path that checks it, named in `measured_on`), then the
     result line.

Each kernel's `bound_ms` is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its float operations over
67 TFLOP/s (H100 SXM, NVIDIA's data sheet), for the work of the launches
its `ms` sums; K4's operations are counted from its SASS (`sass_ops`).
Each K4 check prints the instantiation's registers, shared bytes and
spills (none allowed), its bound's kind and its dispatch floor
(`dispatch_ms`: worked out from the static SASS count, so printed only
and kept out of the kernels line). The kernels are built with
--fmad=false, so their exact float32 arithmetic cannot run faster than
about twice an operation bound. Most kernels are timed with CUDA events
around back-to-back launches (`time_ms`); the row gathers, whose launches
can take less device time than their host calls, by replaying a CUDA
graph of their launches (`device_ms`), with the CUDA-event time beside it
(`paced_ms`).

Needs CUDA: exits non-zero without printing a result when
torch.cuda.is_available() is false.
"""
import concurrent.futures
import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = {
    # name: (launch counter, source, TPU kernel it replaces)
    # the dense trace (K1's walk and K7's worklists) in one launch
    "mt_dense_fused": ("mt_dense_fused", "rtxpt_tpu_torch/csrc/mt_dense.cu",
                       "rtxpt_tpu/ops/mt_dense.py:947"),
    "mt_dense": ("mt_dense", "rtxpt_tpu_torch/csrc/mt_dense.cu",
                 "rtxpt_tpu/ops/mt_dense.py:947"),
    "gather_rows": ("gather_rows", "rtxpt_tpu_torch/csrc/gather.cu",
                    "rtxpt_tpu/ops/gather_pallas.py:128"),
    "gather_rows_interp": ("gather_rows_interp",
                           "rtxpt_tpu_torch/csrc/gather.cu",
                           "rtxpt_tpu/ops/gather_pallas.py:183"),
    # load_surface's four fetches (K2, K3, K2, K2) in one launch
    "gather_surface": ("gather_surface", "rtxpt_tpu_torch/csrc/gather.cu",
                       "rtxpt_tpu/ops/gather_pallas.py:128 + :183"),
    "shade_nee": ("shade_nee", "rtxpt_tpu_torch/csrc/shade_kernel.cu",
                  "rtxpt_tpu/pt/shade_kernel.py:1049"),
    "shade_nee_fill": ("shade_nee_fill",
                       "rtxpt_tpu_torch/csrc/shade_kernel.cu",
                       "rtxpt_tpu/pt/shade_kernel.py:1049"),
    "bvh8_trace": ("bvh8_trace", "rtxpt_tpu_torch/csrc/bvh8_trace.cu",
                   "rtxpt_tpu/ops/traverse_pallas.py:279"),
    "bvh8_trace_sub": ("bvh8_trace_sub",
                       "rtxpt_tpu_torch/csrc/bvh8_trace.cu",
                       "rtxpt_tpu/ops/traverse_pallas.py:380"),
    # the two-level trace (K6's probe and K5's sweep) in one launch
    "bvh8_trace_2l": ("bvh8_trace_2l", "rtxpt_tpu_torch/csrc/bvh8_trace.cu",
                      "rtxpt_tpu/ops/traverse_pallas.py:279"),
    "tile_keys": ("tile_keys", "rtxpt_tpu_torch/csrc/mt_dense.cu",
                  "rtxpt_tpu/ops/mt_dense.py:490"),
    # the sample generator: no TPU kernel (XLA fuses the reference's hashes)
    "rng_make": ("rng_make", "rtxpt_tpu_torch/csrc/rng.cu", None),
    "rng_start_effect": ("rng_start_effect", "rtxpt_tpu_torch/csrc/rng.cu",
                         None),
    "rng_next": ("rng_next", "rtxpt_tpu_torch/csrc/rng.cu", None),
    # ReLAX's passes and the TAA resolve: no TPU kernel (the reference's
    # denoiser and TAA are XLA code)
    "relax_temporal": ("relax_temporal", "rtxpt_tpu_torch/csrc/relax.cu",
                       None),
    "relax_variance": ("relax_variance", "rtxpt_tpu_torch/csrc/relax.cu",
                       None),
    "relax_atrous": ("relax_atrous", "rtxpt_tpu_torch/csrc/relax.cu", None),
    "taa_resolve": ("taa_resolve", "rtxpt_tpu_torch/csrc/relax.cu", None),
}
# the sample generator's wrappers (core/rng.py) by launch counter
RNG_CALLS = {"make": "rng_make", "start_effect": "rng_start_effect",
             "next_1d": "rng_next", "next_2d": "rng_next",
             "next_3d": "rng_next"}
# ReLAX's and TAA's wrappers (denoise/relax.py, post/taa.py) by launch
# counter
DENOISER_CALLS = {"temporal_accumulate": "relax_temporal",
                  "estimate_variance": "relax_variance",
                  "atrous_filter": "relax_atrous", "resolve": "taa_resolve"}
# the bytes a pixel one launch of each reads and writes: the temporal
# pass's history (40 B) and frame (36 B) in, 24 B out; the variance pass's
# radiance, moments and history in, 4 B out; an a-trous iteration's
# radiance, variance, normal and depth in (specular: and roughness),
# radiance and variance out; TAA's history, colour and motion in (and the
# relax mask), the colour out
DENOISER_BYTES = {"temporal_accumulate": 100, "estimate_variance": 28,
                  "atrous_filter": 48, "resolve": 44}
# the kernels each main path must launch; the realtime pipelines' post:
# ReLAX's passes, then TAA
RELAX = ("relax_temporal", "relax_variance", "relax_atrous")
RELAX_TAA = RELAX + ("taa_resolve",)
BENCH_PATH = ("mt_dense_fused", "gather_rows", "gather_surface",
              "shade_nee")
CITY_PATH = ("bvh8_trace_2l", "gather_rows", "gather_surface", "shade_nee")
RT_CITY_PATH = ("bvh8_trace_2l", "gather_rows", "gather_surface",
                "shade_nee_fill") + RELAX_TAA
RT_ART_PATH = ("mt_dense_fused", "gather_rows", "gather_surface",
               "shade_nee_fill") + RELAX_TAA
# TAAU's upscale takes TAA's place, ReBLUR takes ReLAX's
RT_CITY_TAAU_PATH = RT_CITY_PATH[:4] + RELAX
RT_CITY_REBLUR_PATH = RT_CITY_PATH[:4] + ("taa_resolve",)
# the PSR-lite pipeline's paths: the non-FILL K4 once per bounce
RT_CITY_PSR_PATH = ("bvh8_trace_2l", "gather_rows", "gather_surface",
                    "shade_nee") + RELAX_TAA
RT_ART_PSR_PATH = ("mt_dense_fused", "gather_rows", "gather_surface",
                   "shade_nee") + RELAX_TAA
# the textured, alpha-MASK paths: the foliage scenes' reference renders
FOLIAGE_PATH = ("mt_dense_fused", "gather_rows", "gather_surface",
                "shade_nee")
# the reference configurations' paths through the chain of tensor ops
BENCH_CHAIN_PATH = ("mt_dense_fused", "gather_rows", "gather_surface")
CITY_REGIR_PATH = ("bvh8_trace_2l", "gather_rows", "gather_surface")
# the animated scenes' paths (posed by Renderer.animate): the skinned
# figure in the single-BVH8 tier (K5 once per trace, on the refitted
# table) and in the dense tier (on refresh_dense's planes), and the
# rigid-animated city on the instanced TLAS (K5 once per round)
SKINNED_BVH8_PATH = ("bvh8_trace", "gather_rows", "gather_surface",
                     "shade_nee")
RT_SKINNED_PATH = ("bvh8_trace", "gather_rows", "gather_surface",
                   "shade_nee_fill") + RELAX_TAA
SKINNED_DENSE_PATH = ("mt_dense_fused", "gather_rows", "gather_surface",
                      "shade_nee")
INSTANCED_PATH = ("bvh8_trace", "gather_rows", "gather_surface",
                  "shade_nee")
# the debug views on the city (phase 15): the G-buffer's two-level traces
# and surface fetches, and the ReSTIR views' light and environment rows
DEBUG_VIEWS_PATH = ("bvh8_trace_2l", "gather_rows", "gather_surface")
# a kernel that runs once per trace call: (the module whose trace_closest
# and trace_anyhit make those calls, the kernels its path no longer runs)
ONE_LAUNCH = {"bvh8_trace_2l": ("rtxpt_tpu_torch.ops.bvh2l",
                                ("bvh8_trace", "bvh8_trace_sub")),
              "mt_dense_fused": ("rtxpt_tpu_torch.ops.mt_dense",
                                 ("mt_dense", "tile_keys")),
              "bvh8_trace": ("rtxpt_tpu_torch.ops.traverse",
                             ("bvh8_trace_sub", "bvh8_trace_2l"))}
PATHS = {"bench": BENCH_PATH, "city": CITY_PATH,
         "bench_chain": BENCH_CHAIN_PATH, "city_regir": CITY_REGIR_PATH,
         "realtime_city": RT_CITY_PATH, "realtime_360p": RT_ART_PATH,
         "realtime_city_psr": RT_CITY_PSR_PATH,
         "realtime_360p_psr": RT_ART_PSR_PATH,
         "realtime_city_taau": RT_CITY_TAAU_PATH,
         "foliage_dense": FOLIAGE_PATH, "city_foliage": CITY_PATH,
         "realtime_city_foliage": RT_CITY_PATH, "gltf_scene": FOLIAGE_PATH,
         "skinned_bvh8": SKINNED_BVH8_PATH,
         "realtime_skinned": RT_SKINNED_PATH,
         "skinned_dense": SKINNED_DENSE_PATH,
         "instanced_city": INSTANCED_PATH,
         "realtime_sharded": RT_CITY_PATH, "debug_views": DEBUG_VIEWS_PATH}
# the bench workload's configuration and size (width, height, spp), the
# city's size, and the reference configurations other than the default
# that phase 6 renders the bench under
BENCH_SIZE, CITY_SIZE = (800, 600, 8), (1920, 1080, 2)
# the instanced city's render (width, height, spp) and the skinned
# figure's realtime frames (width, height)
INSTANCED_SIZE, SKINNED_RT_SIZE = (1920, 1080, 1), (1920, 1080)
BENCH_CFG = dict(max_bounces=6, max_diffuse_bounces=4, nee_distant_samples=1,
                 nee_local_samples=1)
OTHER_CONFIGS = {"NEE off": dict(nee_enabled=False),
                 "distant uniform": dict(nee_distant_type=0),
                 "distant presampled": dict(nee_distant_type=2),
                 "ReGIR grid": dict(nee_local_type=2),
                 "ReGIR onion": dict(nee_local_type=2, regir_layout="onion"),
                 "rng hq": dict(rng_quality="hq"),
                 "rng uniform": dict(rng_quality="uniform")}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_OPS_PER_S = 67e12         # H100 SXM float32, outside the tensor cores
# warp instructions the H100 SXM can dispatch: 132 SMs x 4 schedulers x
# one a clock at 1.98 GHz (the clock of the 67 TFLOP/s peak)
DISPATCH_PER_S = 132 * 4 * 1.98e9
# float operations of one unit of work (counted from the kernels' source)
SLAB_OPS = 25                  # one ray-box slab test
NODE_ROW_OPS = 8 * SLAB_OPS + 19   # 8 child slabs + the sorting network
TRI_OPS = 45                   # one Möller–Trumbore test
TRI_U_OPS = 22                 # its operations up to the u test (h, a, s, u)
# K1's OMM test on a pair that passes Möller–Trumbore: two divisions and
# two float-to-int conversions (counted 8 each, at the MUFU rate, as
# SASS_OP_WEIGHTS does), two multiplies and four clamps
OMM_OPS = 2 * 8 + 2 * 8 + 2 + 4
GROUP = 8                      # clusters under one group box (mt_dense.cu)
# K4's operations per lane are counted from the built library's SASS
# (`sass_ops`): each float32 instruction that runs at the FP32 pipe's
# rate counts 1 (an FFMA 2, as the 67 TFLOP/s peak counts it); MUFU and
# the float conversions, which run at 16 per clock per SM against 128
# FP32 lanes, count 8
SASS_OP_WEIGHTS = dict.fromkeys(
    ("FADD", "FADD32I", "FMUL", "FMUL32I", "FMNMX", "FSETP", "FSET", "FSEL",
     "FCHK", "FSWZADD", "I2FP", "F2IP"), 1)
SASS_OP_WEIGHTS.update(FFMA=2, FFMA32I=2, MUFU=8, F2I=8, I2F=8, F2F=8,
                       FRND=8)
# (nee_distant, nee_local, rr, fill) -> registers, shared bytes, spills and
# SASS operations per lane of that K4 instantiation (filled by main)
SHADE = {}
PSNR_MIN, SMAPE_MAX = 40.0, 0.02            # cross-platform golden gate
FAST_PSNR, FAST_SMAPE = 45.0, 0.01          # same-platform fast gate
# the foliage phases: the leaf textures' edge, and the cards added to
# programmer-art (the dense tier) and to the city
FOLIAGE_TEX, FOLIAGE_CARDS, CITY_CARDS = 2048, 1500, 20000


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float):
    """(least ms, "bytes" or "operations") for the work on the H100."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_ms(fn, iters: int, warmup: bool = True) -> float:
    """Mean device time of fn() over `iters` calls (CUDA events, after
    one warm-up call unless warmup=False)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed_call(fn):
    """(fn()'s result, its device time in ms by CUDA events): times a call
    whose result is needed anyway, such as a plain version's."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def device_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Mean device time of the work fn() launches: `iters` calls captured
    in a CUDA graph (after a warm-up call) and the graph replayed `reps`
    times between CUDA events. Unlike time_ms, it leaves out the host time
    between launches, which sets time_ms where a launch takes less device
    time than its host call."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)


class Capture:
    """Records the arguments of the first calls of kernel wrappers during
    one render (the inputs the main path gives each kernel), up to
    limits[name] calls per wrapper; with `during` (keys of STAGES), only
    the calls made inside all of those stages' functions. Captures nest."""
    MODULES = {"trace_dense_fused": "rtxpt_tpu_torch.ops.mt_dense",
               "gather_rows": "rtxpt_tpu_torch.ops.gather",
               "gather_surface": "rtxpt_tpu_torch.ops.gather",
               "shade_nee": "rtxpt_tpu_torch.pt.shade_kernel",
               "shade_nee_fill": "rtxpt_tpu_torch.pt.shade_kernel",
               "trace_bvh8_2l": "rtxpt_tpu_torch.ops.traverse_bvh8",
               "trace_bvh8": "rtxpt_tpu_torch.ops.traverse_bvh8",
               **dict.fromkeys(RNG_CALLS, "rtxpt_tpu_torch.core.rng"),
               **dict.fromkeys(DENOISER_CALLS,
                               "rtxpt_tpu_torch.denoise.relax"),
               "resolve": "rtxpt_tpu_torch.post.taa"}
    # (module, function, which calls count: None for all): the realtime
    # frame's stages, as models/realtime.py calls them, and the visibility
    # traces that cast at least one ray
    STAGES = {"build": ("rtxpt_tpu_torch.pt.stableplanes",
                        "build_stable_planes", None),
              "gbuffer": ("rtxpt_tpu_torch.pt.gbuffer", "trace_gbuffer",
                          None),
              "fill": ("rtxpt_tpu_torch.pt.integrator", "render_paths",
                       None),
              "restir": ("rtxpt_tpu_torch.restir.di", "fused_final_shade",
                         None),
              "busy_anyhit": ("rtxpt_tpu_torch.ops.traverse", "trace_anyhit",
                              lambda kw: kw.get("active") is None
                              or bool(kw["active"].any())),
              "busy_visibility": ("rtxpt_tpu_torch.pt.visibility",
                                  "trace_visibility",
                                  lambda kw: kw.get("active") is None
                                  or bool(kw["active"].any()))}

    def __init__(self, limits: dict, during=()):
        import importlib
        self.limits = limits
        self.kernels = [(importlib.import_module(self.MODULES[name]), name)
                        for name in limits]
        self.stages = [(importlib.import_module(self.STAGES[s][0]),
                        *self.STAGES[s][1:]) for s in during]
        self.inside = {name: False for _, name, _ in self.stages}
        self.calls = {name: [] for name in limits}
        self.orig = []

    def __enter__(self):
        for mod, name, when in self.stages:
            fn = getattr(mod, name)
            self.orig.append((mod, name, fn))

            def staged(*args, _fn=fn, _name=name, _when=when, **kw):
                was = self.inside[_name]
                self.inside[_name] = _when is None or _when(kw)
                try:
                    return _fn(*args, **kw)
                finally:
                    self.inside[_name] = was
            setattr(mod, name, staged)
        for mod, name in self.kernels:
            fn = getattr(mod, name)
            self.orig.append((mod, name, fn))

            def wrapped(*args, _fn=fn, _name=name, **kw):
                if all(self.inside.values()) and \
                        len(self.calls[_name]) < self.limits[_name]:
                    self.calls[_name].append(
                        ([a.clone() if torch.is_tensor(a) else a
                          for a in args], dict(kw)))
                return _fn(*args, **kw)
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.orig):
            setattr(mod, name, fn)


FIRST_BOUNCE = {"trace_dense_fused": 3, "gather_rows": 16,
                "gather_surface": 1, "shade_nee": 1}


def dense_visits(args, kw, t, slot, worklists, rows: bool = False):
    """(slab tests, passing clusters) of one dense trace walking
    `worklists` (tiles of TILE lane indices): every active lane
    slab-tests the clusters of its tile's worklist, and tests the 64 rows
    of each cluster its box lets through (up to the lane's final t; for
    any-hit, up to the cluster of the first hit, in worklist order). With
    `rows`, also (row tests, rows that pass the u test, rows that pass the
    whole test): those rows one by one (any-hit: in the hit's cluster, up
    to the hit's row)."""
    from rtxpt_tpu_torch.ops import mt_dense
    from rtxpt_tpu_torch.ops.intersect import safe_inv
    aabb_c, tri12, o_c, d, tmax, act = args
    counts, order = worklists
    n, nc = o_c.shape[0], aabb_c.shape[0]
    tile_of = torch.arange(n, device=o_c.device) // mt_dense.TILE
    lim = tmax if kw["any_hit"] else t
    # rank[tile, c]: cluster c's place on the tile's list
    rank = torch.empty_like(order).scatter_(
        1, order.long(), torch.arange(nc, dtype=order.dtype,
                                      device=order.device).expand_as(order)
        .contiguous())
    passing, tested, upass, hits = 0, 0, 0, 0
    for c in range(0, n, 1 << 16):
        sl = slice(c, c + (1 << 16))
        tiles = tile_of[sl]
        r = rank[tiles]
        inv = safe_inv(d[sl])[:, None]
        t0 = (aabb_c[None, :, 0:3] - o_c[sl, None]) * inv
        t1 = (aabb_c[None, :, 3:6] - o_c[sl, None]) * inv
        tn = torch.clamp(torch.amax(torch.minimum(t0, t1), -1), min=0.0)
        tf = torch.minimum(torch.amin(torch.maximum(t0, t1), -1),
                           lim[sl, None])
        m = (tn <= tf) & act[sl, None] & (r < counts[tiles, None])
        if kw["any_hit"]:
            hit_c = torch.clamp(slot[sl], min=0).long() // mt_dense.CLUSTER
            last = torch.where(slot[sl] >= 0, r.gather(1, hit_c[:, None])[:, 0],
                               nc)
            m &= r <= last[:, None]
        passing += int(m.sum())
        if rows:
            lane, clus = torch.nonzero(m, as_tuple=True)
            for p in range(0, lane.numel(), 1 << 14):
                li, ci = lane[p:p + (1 << 14)], clus[p:p + (1 << 14)]
                row_last = torch.full_like(ci, mt_dense.CLUSTER - 1)
                if kw["any_hit"]:
                    s_hit = slot[sl][li].long()
                    row_last = torch.where(
                        (s_hit >= 0) & (ci == s_hit // mt_dense.CLUSTER),
                        s_hit % mt_dense.CLUSTER, row_last)
                k, u, x = u_tests(tri12, o_c[sl][li], d[sl][li], ci,
                                  row_last)
                tested, upass, hits = tested + k, upass + u, hits + x
    slabs = int(counts.long()[tile_of][act].sum())
    return (slabs, passing, (tested, upass, hits)) if rows \
        else (slabs, passing)


def u_tests(tri12, o, d, clusters, row_last):
    """(rows, rows past the u test, rows that pass the whole test) of the
    lanes' rays (o, d) against the rows 0..row_last of their `clusters`:
    the u test of the kernels' Möller–Trumbore test (csrc/mt_dense.cu
    `mt_row`): |a| > 1e-12 and 0 <= u <= |a|, sign-folded by a; then
    v >= 0, u + v <= |a| and t > 0 (where the OMM channel tests the
    mask)."""
    from rtxpt_tpu_torch.ops import mt_dense
    rows = tri12.view(-1, mt_dense.CLUSTER, 12)[clusters]   # (P, 64, 12)
    p0, e1, e2 = rows[..., 0:3], rows[..., 4:7], rows[..., 8:11]
    d = d[:, None].expand_as(e2)
    h = torch.linalg.cross(d, e2, dim=-1)
    a = e1[..., 0] * h[..., 0] + e1[..., 1] * h[..., 1] \
        + e1[..., 2] * h[..., 2]
    s = o[:, None] - p0
    uu = s[..., 0] * h[..., 0] + s[..., 1] * h[..., 1] + s[..., 2] * h[..., 2]
    su = torch.where(a < 0, -uu, uu)
    absa = a.abs()
    k = torch.arange(mt_dense.CLUSTER, device=o.device)
    tested = k[None] <= row_last[:, None]
    ok = tested & (absa > 1e-12) & (su >= 0) & (su <= absa)
    q = torch.linalg.cross(s, e1, dim=-1)
    vv = d[..., 0] * q[..., 0] + d[..., 1] * q[..., 1] + d[..., 2] * q[..., 2]
    tt = e2[..., 0] * q[..., 0] + e2[..., 1] * q[..., 1] \
        + e2[..., 2] * q[..., 2]
    sv, st = torch.where(a < 0, -vv, vv), torch.where(a < 0, -tt, tt)
    hit = ok & (sv >= 0) & (su + sv <= absa) & (st > 0)
    return int(tested.sum()), int(ok.sum()), int(hit.sum())


def k1_work(args, kw, t, slot, worklists):
    """(bytes, ops) of one K1 launch walking `worklists` (tiles of lane
    indices): dense_visits' slab tests and row tests."""
    from rtxpt_tpu_torch.ops import mt_dense
    aabb_c, tri12, o_c = args[:3]
    counts, order = worklists
    nbytes = (aabb_c.numel() + tri12.numel() + counts.numel()
              + order.numel()) * 4 + o_c.shape[0] * (12 + 12 + 4 + 1 + 8)
    slabs, passing = dense_visits(args, kw, t, slot, worklists)
    return nbytes, slabs * SLAB_OPS + passing * mt_dense.CLUSTER * TRI_OPS


def fused_work(args, kw, t, slot, worklists):
    """(bytes, ops) of one fused launch (its tiles' `worklists`: K7's):
    its inputs read and outputs written once, and the operations this
    run's data needs: each active lane's slab tests of the group boxes
    and of the clusters of the groups whose box it passes (the keys), the
    sort of each tile's finite keys (m log2 m compare-exchanges of 4
    operations), and the row tests of the clusters each lane must test
    (dense_visits: TRI_U_OPS where a row fails its u test, TRI_OPS where
    it passes; the walk's slab gate repeats a key test and is not counted
    again), and with the OMM channel (kw["omm"]) OMM_OPS on each row that
    passes the whole test."""
    from rtxpt_tpu_torch.ops import mt_dense as M
    from rtxpt_tpu_torch.ops.intersect import safe_inv
    aabb_c, tri12, o_c, d, tmax, act = args
    counts, _ = worklists
    nc = aabb_c.shape[0]
    groups = torch.stack([torch.cat([aabb_c[g:g + GROUP, 0:3].amin(0),
                                     aabb_c[g:g + GROUP, 3:6].amax(0)])
                          for g in range(0, nc, GROUP)])
    size = torch.tensor([min(GROUP, nc - g) for g in range(0, nc, GROUP)],
                        device=o_c.device)
    lanes = torch.nonzero(act)[:, 0]
    key_tests = lanes.numel() * groups.shape[0]
    for c in range(0, lanes.numel(), 1 << 16):
        li = lanes[c:c + (1 << 16)]
        inv = safe_inv(d[li])[:, None]
        t0 = (groups[None, :, 0:3] - o_c[li, None]) * inv
        t1 = (groups[None, :, 3:6] - o_c[li, None]) * inv
        tn = torch.clamp(torch.amax(torch.minimum(t0, t1), -1), min=0.0)
        tf = torch.minimum(torch.amin(torch.maximum(t0, t1), -1),
                           tmax[li, None])
        key_tests += int(((tn <= tf) * size[None]).sum())
    _, _, (tested, upass, hits) = dense_visits(args, kw, t, slot, worklists,
                                               rows=True)
    m = counts.double()
    sort = float((m * torch.ceil(torch.log2(torch.clamp(m, min=2.0)))).sum())
    ops = key_tests * SLAB_OPS + (tested - upass) * TRI_U_OPS \
        + upass * TRI_OPS + int(sort) * 4 \
        + (hits * OMM_OPS if kw.get("omm") else 0)
    nbytes = (aabb_c.numel() + tri12.numel()) * 4 \
        + o_c.shape[0] * (12 + 12 + 4 + 1 + 8)
    return nbytes, ops


def check_k7(args, what) -> tuple:
    """K7 on one captured dense trace's inputs: keys bit-equal to the plain
    version's, and counts/order equal to a stable argsort of them; the
    plain version is the keys and that sort -> (worklists, ms, plain ms,
    bytes, ops)."""
    from rtxpt_tpu_torch.ops import mt_dense as M
    from tools_torch.profile_mt_kernel import visits
    aabb_c, _, o_c, d, tmax, act = args

    def plain():
        keys = M.tile_keys_plain(aabb_c, o_c, d, tmax, act)
        return (keys, *M.worklists_from_keys(keys))

    k, counts, order = M.tile_keys(aabb_c, o_c, d, tmax, act)
    p, counts_p, order_p = plain()
    require(torch.equal(k.view(torch.int32), p.view(torch.int32)),
            f"K7 {what}: keys not bit-equal to the plain version")
    require(torch.equal(counts, counts_p) and torch.equal(order, order_p),
            f"K7 {what}: counts/order differ from the plain version's")
    ms = time_ms(lambda: M.tile_keys(aabb_c, o_c, d, tmax, act), 20)
    pms = time_ms(plain, 3)
    n, nc = o_c.shape[0], aabb_c.shape[0]
    nbytes = n * (12 + 12 + 4 + 1) + nc * 24 + (2 * k.numel()
                                                + counts.numel()) * 4
    # slab tests, and the bitonic sort's compare-exchanges (4 operations)
    steps = (nc - 1).bit_length()
    ops = int(act.sum()) * nc * SLAB_OPS \
        + k.shape[0] * (1 << steps) // 2 * steps * (steps + 1) // 2 * 4
    print(f"K7 {what}: keys bit-equal, worklists equal ({k.shape[0]} tiles "
          f"of {M.TILE} x {nc}), visits/tile {visits(counts)}; kernel "
          f"{ms:.4f} ms, plain {pms:.4f} ms, bound "
          f"{bound(nbytes, ops)[0]:.4f} ms", flush=True)
    return (counts, order), ms, pms, nbytes, ops


def check_kernels(results: dict):
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.scene import envmap as EM, procedural

    w, h = 800, 600
    host = procedural.build_programmer_art().finish()
    cfg = reference_config(max_bounces=6, max_diffuse_bounces=4,
                           nee_distant_samples=1, nee_local_samples=1)
    r = Renderer(host, procedural.default_camera(w, h), cfg,
                 env_radiance=EM.bake_procedural_sky(height=64),
                 device="cuda")
    with Capture(FIRST_BOUNCE) as cap:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()

    # ---- the dense trace: the first closest trace (camera rays), the
    # second (one bounce of scattered rays) and the first any-hit trace
    # (NEE rays)
    calls = cap.calls["trace_dense_fused"]
    closest = [c for c in calls if not c[1]["any_hit"]]
    anyhit = [c for c in calls if c[1]["any_hit"]]
    require(len(closest) >= 2 and anyhit, "too few dense traces captured")
    results["bench"].update(check_dense(
        r.accel, [("camera", closest[0], True),
                  ("scattered", closest[1], False),
                  ("nee any-hit", anyhit[0], True)], "bench"))

    # ---- K2-K4 on the gathers and the shade pass of the first bounce;
    # K4 also at the goldens' NEE 2+2 (reference_config())
    results["bench"].update(check_surface_kernels(cap, "bench", w * h))
    r = Renderer(host, procedural.default_camera(w, h), reference_config(),
                 env_radiance=EM.bake_procedural_sky(height=64),
                 device="cuda")
    with Capture(FIRST_BOUNCE) as cap:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()
    check_shade(*cap.calls["shade_nee"][0], "reference_config()")
    # the sample generator on the art cell's calls: 800x600, 8 spp, NEE 2+2
    results["bench"].update(check_rng(r, w, h, 8, "bench"))


def dense_agreement(accel, args, kw, got, ref, what) -> float:
    """A dense trace's (t, slot) `got` against the plain version's `ref`:
    the same winner (closest) or occlusion flag (any-hit) on >= 99.99% of
    the active lanes, t/u/v within rtol 1e-5 / atol 1e-6 where the
    winners agree; prints the agreement -> max |diff| of t/u/v."""
    from rtxpt_tpu_torch.ops import mt_dense
    _, _, o_c, d, _, act = args
    (t_k, s_k), (t_p, s_p) = got, ref
    lanes = int(act.sum())
    if kw["any_hit"]:
        differ = int(((s_k >= 0) != (s_p >= 0))[act].sum())
        agree = 1.0 - differ / lanes
        print(f"{what}: {act.numel()} lanes ({lanes} active), occlusion "
              f"flag equal on {agree:.6%} ({differ} lanes differ)")
        require(agree >= 0.9999, f"{what}: agreement {agree}")
        return 0.0
    same = (s_k == s_p) & act
    differ = lanes - int(same.sum())
    agree = 1.0 - differ / lanes
    hk = mt_dense.resolve_hits(accel, o_c, d, t_k, s_k)
    hp = mt_dense.resolve_hits(accel, o_c, d, t_p, s_p)
    m = same & (s_k >= 0)
    err = max(float((hk.t - hp.t)[m].abs().max()),
              float((hk.bary - hp.bary)[m].abs().max()))
    ok_tuv = torch.allclose(hk.t[m], hp.t[m], rtol=1e-5, atol=1e-6) \
        and torch.allclose(hk.bary[m], hp.bary[m], rtol=1e-5, atol=1e-6)
    print(f"{what}: {act.numel()} lanes ({lanes} active), same winner on "
          f"{agree:.6%} ({differ} lanes differ), t/u/v max |diff| {err:.3g}")
    require(agree >= 0.9999, f"{what}: winner agreement {agree}")
    require(ok_tuv, f"{what}: t/u/v outside rtol 1e-5 / atol 1e-6")
    return err


def check_dense(accel, traces, label) -> dict:
    """On captured dense traces [(what, (args, kw) of trace_dense_fused,
    timed)]: the fused launch, and K1 walking K7's worklists, against the
    plain version over all clusters (dense_agreement); K7 as check_k7
    says; the fused kernel's lab modes (tools_torch/profile_mt_kernel.py);
    kernel and plain times and the bounds summed over the timed traces ->
    {"mt_dense_fused": ..., "mt_dense": ..., "tile_keys": ...}. The
    plain version, timed on the call the kernels are held against, is
    that of both traces."""
    from rtxpt_tpu_torch.ops import mt_dense as M
    from tools_torch import profile_mt_kernel as PM
    # max |diff|, ms, plain ms, bytes, ops
    tot = {name: [0.0, 0.0, 0.0, 0, 0]
           for name in ("mt_dense_fused", "mt_dense", "tile_keys")}
    old_bound, modes = [0, 0], {}
    for what, (args, kw), timed in traces:
        aabb_c, tri12, o_c, d, tmax, act = args
        require(int(act.sum()) > 0, f"{label} {what}: no active lane")
        tri9 = M.tri9_from_tri12(tri12)

        def plain():
            return M.trace_dense_plain(aabb_c, tri9, o_c, d, tmax, act,
                                       kw["any_hit"])
        ref, pms = timed_call(plain)
        wl, *k7 = check_k7(args, f"{label} {what}")
        got = M.trace_dense(*args, kw["any_hit"], worklists=wl)
        torch.cuda.synchronize()
        k1_err = dense_agreement(accel, args, kw, got, ref,
                                 f"K1 {label} {what}")
        got_f = M.trace_dense_fused(*args, **kw)
        torch.cuda.synchronize()
        f_err = dense_agreement(accel, args, kw, got_f, ref,
                                f"mt_dense_fused {label} {what}")
        for name, err in (("mt_dense", k1_err), ("mt_dense_fused", f_err),
                          ("tile_keys", 0.0)):
            tot[name][0] = max(tot[name][0], err)
        if not timed:
            continue
        ms = time_ms(lambda: M.trace_dense(*args, kw["any_hit"],
                                           worklists=wl), 20)
        fms = time_ms(lambda: M.trace_dense_fused(*args, **kw), 20)
        nb, ops = k1_work(args, kw, *got, wl)
        fnb, fops = fused_work(args, kw, *got_f, wl)
        m_ms = PM.run_fused_modes(args, kw)
        lanes = int(act.sum())
        print(f"K1 {label} {what}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bound(nb, ops)[0]:.4f} ms", flush=True)
        print(f"mt_dense_fused {label} {what}: 1 launch over {act.numel()} "
              f"lanes, {lanes} active, {wl[0].numel()} tiles of "
              f"{M.TILE} lanes, visits/tile {PM.visits(wl[0])}; "
              f"kernel {fms:.4f} ms (K7 + K1 {k7[0] + ms:.4f}), plain "
              f"{pms:.4f} ms, bound {bound(fnb, fops)[0]:.4f} ms (K1's + "
              f"K7's: {bound(nb + k7[2], ops + k7[3])[0]:.4f}); lab modes "
              + ", ".join(f"{mode} {v:.4f}" for mode, (v, _) in m_ms.items())
              + " ms", flush=True)
        for name, vals in (("mt_dense", (ms, pms, nb, ops)),
                           ("mt_dense_fused", (fms, pms, fnb, fops)),
                           ("tile_keys", k7)):
            for j, v in enumerate(vals):
                tot[name][j + 1] += v
        old_bound = [old_bound[0] + nb + k7[2], old_bound[1] + ops + k7[3]]
        for mode, (v, _) in m_ms.items():
            modes[mode] = modes.get(mode, 0.0) + v
    out = {}
    for name, (err, ms, pms, nb, ops) in tot.items():
        b_ms, b_by = bound(nb, ops)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                         library_ms=None, bound_ms=b_ms, bound_by=b_by)
    out["mt_dense_fused"].update(modes_ms=modes,
                                 k1_k7_bound_ms=bound(*old_bound)[0])
    return out


def check_gathers(calls, label, lanes=None) -> dict:
    """K2 on each distinct captured gather (table, index count), with
    `lanes` rows when given: bit-equal to the plain version; kernel, plain
    and torch.index_select device times (device_ms; the kernel's CUDA-event
    time too, `paced_ms`), each table's instance (row width, word size)
    under `tables`, and their sums."""
    from rtxpt_tpu_torch.ops import gather
    ms_sum = plain_sum = lib_sum = 0.0
    nbytes = 0
    seen, tables = set(), []
    for args, _ in calls:
        table, idx = args
        key = (tuple(table.shape), table.dtype, idx.numel())
        if (lanes is not None and idx.numel() != lanes) or key in seen:
            continue
        seen.add(key)
        got = gather.gather_rows(table, idx)
        ref = gather.gather_rows_plain(table, idx)
        require(torch.equal(got, ref), f"K2 {label}: gather of a "
                f"{tuple(table.shape)} table not bit-equal")
        ms = device_ms(lambda: gather.gather_rows(table, idx))
        paced = time_ms(lambda: gather.gather_rows(table, idx), 50)
        pms = device_ms(lambda: gather.gather_rows_plain(table, idx))
        # the library call: torch.index_select on the clamped indices
        safe = torch.clamp(idx.reshape(-1), 0, table.shape[0] - 1)
        lms = device_ms(lambda: torch.index_select(table, 0, safe))
        uniq = torch.unique(safe).numel()
        nb = (uniq + idx.numel()) * table.shape[1] * table.element_size() \
            + idx.numel() * idx.element_size()
        inst = gather.instance(table)
        print(f"K2 {label} {tuple(table.shape)} {table.dtype} x "
              f"{idx.numel()} rows ({inst}): bit-equal, kernel {ms:.4f} ms "
              f"(CUDA events {paced:.4f}), plain {pms:.4f} ms, index_select "
              f"{lms:.4f} ms, bound {bound(nb, 0)[0]:.4f} ms")
        tables.append(dict(table=list(table.shape), dtype=str(table.dtype),
                           rows=idx.numel(), instance=inst, ms=ms,
                           paced_ms=paced, plain_ms=pms, library_ms=lms,
                           bound_ms=bound(nb, 0)[0]))
        nbytes += nb
        ms_sum += ms
        plain_sum += pms
        lib_sum += lms
    require(len(seen) >= 5, f"K2 {label}: too few gathers captured")
    b_ms, b_by = bound(nbytes, 0)
    return dict(max_abs_err=0.0, ms=ms_sum, plain_ms=plain_sum,
                library_ms=lib_sum, bound_ms=b_ms, bound_by=b_by,
                tables=tables)


def check_interp(args, label) -> dict:
    """K3 on one barycentric blend, within rtol/atol 1e-6 (max |diff|
    recorded); device times (device_ms) and the kernel's CUDA-event time."""
    from rtxpt_tpu_torch.ops import gather
    got = gather.gather_rows_interp(*args)
    ref = gather.gather_rows_interp_plain(*args)
    err = float((got - ref).abs().max())
    require(torch.allclose(got, ref, rtol=1e-6, atol=1e-6),
            f"K3 {label} outside rtol 1e-6 / atol 1e-6 (max |diff| {err})")
    ms = device_ms(lambda: gather.gather_rows_interp(*args))
    paced = time_ms(lambda: gather.gather_rows_interp(*args), 50)
    pms = device_ms(lambda: gather.gather_rows_interp_plain(*args))
    table, i3, w3 = args
    nb = (torch.unique(i3).numel() + i3.shape[0]) * table.shape[1] * 4 \
        + i3.numel() * i3.element_size() + w3.numel() * 4
    b_ms, b_by = bound(nb, i3.shape[0] * table.shape[1] * 5)
    inst = gather.instance(table, gather.INTERP_TEMPLATES)
    print(f"K3 {label} {i3.shape[0]} lanes ({inst}): max |diff| {err:.3g}, "
          f"kernel {ms:.4f} ms (CUDA events {paced:.4f}), plain {pms:.4f} "
          f"ms, bound {b_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, paced_ms=paced, plain_ms=pms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by, instance=inst)


def parent_surface(tri_pack, vert_pack, tri_geom_pack, mat_pack, prim,
                   bary, rows=None, interp=None):
    """The surface fetch as pt/shading.py `load_surface` made it before the
    one-launch kernel: K2 on tri_pack, K3 on vert_pack, K2 on tri_geom_pack
    and on mat_pack, with the PyTorch ops between them (K2 and K3: `rows`
    and `interp`, by default this tree's gather_rows and
    gather_rows_interp)."""
    from rtxpt_tpu_torch.ops import gather
    rows = rows or gather.gather_rows
    interp = interp or gather.gather_rows_interp
    prim = torch.clamp(prim, min=0)
    tp = rows(tri_pack, prim)
    tri = tp[..., :3]
    mid = tp[..., 3]
    w = torch.stack([1.0 - bary[..., 0] - bary[..., 1],
                     bary[..., 0], bary[..., 1]], dim=-1)
    vi = interp(vert_pack, tri.contiguous(), w)
    geom = rows(tri_geom_pack, prim)
    mrow = rows(mat_pack, mid)
    return vi, geom, mrow, mid


def surface_inputs(args):
    """The K2 and K3 calls inside one captured surface fetch (the parent's
    composition): [(tri_pack, prim), (tri_geom_pack, prim), (mat_pack,
    mid)] and K3's (vert_pack, tri, w)."""
    from rtxpt_tpu_torch.ops import gather
    tri_pack, vert_pack, tri_geom, mat_pack, prim, bary = args
    p = torch.clamp(prim, min=0)
    tp = gather.gather_rows_plain(tri_pack, p)
    w = torch.stack([1.0 - bary[:, 0] - bary[:, 1], bary[:, 0], bary[:, 1]],
                    dim=-1)
    k2 = [((tri_pack, p), {}), ((tri_geom, p), {}),
          ((mat_pack, tp[:, 3].contiguous()), {})]
    return k2, (vert_pack, tp[:, :3].contiguous(), w)


def check_surface(args, label) -> dict:
    """The surface fetch on one captured call: bit-equal to its plain
    version on all four outputs (the parent's composition too); kernel,
    plain and the parent's composition (parent_surface) timed by device
    time (device_ms), the kernel and the composition also by CUDA events
    (which count the host time between the composition's launches); the
    bound: prim and bary read once, each distinct row of the four tables
    read once, the 256 bytes per lane written."""
    from rtxpt_tpu_torch.ops import gather
    tri_pack, vert_pack, tri_geom, mat_pack, prim, bary = args
    got = gather.gather_surface(*args)
    for what, ref in (("plain version", gather.gather_surface_plain(*args)),
                      ("parent's composition", parent_surface(*args))):
        require(all(torch.equal(a, b) for a, b in zip(got, ref)),
                f"gather_surface {label}: not bit-equal to the {what}")
    ms = device_ms(lambda: gather.gather_surface(*args))
    paced = time_ms(lambda: gather.gather_surface(*args), 50)
    pms = device_ms(lambda: gather.gather_surface_plain(*args))
    cms = device_ms(lambda: parent_surface(*args))
    c_paced = time_ms(lambda: parent_surface(*args), 50)
    n = prim.shape[0]
    p = torch.clamp(prim.long(), 0, tri_pack.shape[0] - 1)
    tp = tri_pack[p].long()
    verts = torch.clamp(tp[:, :3], 0, vert_pack.shape[0] - 1)
    mats = torch.clamp(tp[:, 3], 0, mat_pack.shape[0] - 1)
    nbytes = n * (prim.element_size() + 8 + 256) \
        + torch.unique(p).numel() * (16 + 20) \
        + torch.unique(verts).numel() * 48 + torch.unique(mats).numel() * 184
    b_ms, b_by = bound(nbytes, n * (2 + 12 * 5))
    inst = gather.surface_instance(tri_pack, vert_pack, mat_pack)
    print(f"gather_surface {label} {n} lanes ({int((prim < 0).sum())} "
          f"misses; {inst}): bit-equal to the plain version and the "
          f"parent's composition; kernel {ms:.4f} ms (CUDA events "
          f"{paced:.4f}), plain {pms:.4f} ms, parent's composition (K2, K3, "
          f"K2, K2 and the ops between) {cms:.4f} ms (CUDA events "
          f"{c_paced:.4f}), bound {b_ms:.4f} ms ({b_by}; {nbytes / n:.1f} B "
          "per lane)", flush=True)
    return dict(max_abs_err=0.0, ms=ms, paced_ms=paced, plain_ms=pms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                composition_ms=cms, composition_paced_ms=c_paced,
                instance=inst)


def rng_bytes(name, args, kw, out) -> int:
    """Bytes a sample-generator call reads and writes once: its per-lane
    operands (a broadcast one counted once) and the fields and samples it
    writes."""
    def read(xs):
        return sum(x.numel() * x.element_size() if x.stride().count(0) == 0
                   else x.element_size() for x in xs if torch.is_tensor(x))
    if name == "make":
        ld = args[4] if len(args) > 4 else kw.get("low_discrepancy")
        return read(list(args[:4]) + [ld]) + sum(f.numel() * 8 for f in out)
    g = args[0]
    if name == "start_effect":
        ld = args[2] if len(args) > 2 else kw.get("low_discrepancy")
        return read((g.base, g.sample_index, ld)) + 3 * g.base.numel() * 8
    allow_ld = args[1] if len(args) > 1 else kw.get("allow_ld", True)
    fields = (g.effect, g.hq) + ((g.dimension, g.active) if allow_ld else ())
    g2, u = out
    return read(fields) + g2.effect.numel() * 8 * (2 if allow_ld else 1) + \
        u.numel() * u.element_size()


def rng_first_bounce(cfg) -> dict:
    """The generator calls of init_paths, the first bounce's shade step
    (K4's path, RR, the MIP-descent distant sampler) and its regeneration,
    by wrapper."""
    from rtxpt_tpu_torch.config import NEE_DISTANT_MIP_DESCENT
    require(cfg.nee_distant_type == NEE_DISTANT_MIP_DESCENT
            and cfg.enable_russian_roulette and cfg.nee_enabled,
            "rng_first_bounce: not the reference configuration's draws")
    return {"make": 3, "start_effect": 3, "next_1d": 1,
            "next_2d": 2 + cfg.nee_distant_samples,
            "next_3d": 1 + cfg.nee_local_samples}


def check_rng(r, w, h, spp, label) -> dict:
    """The sample generator's kernels on the generator calls of the first
    bounce of r.render(w, h, spp) (init_paths, the shade step, the
    regeneration): each call's outputs bit-equal to the plain version's on
    the captured state; kernel device time (device_ms, CUDA events beside
    it) against the plain version's (CUDA events: its host copies keep it
    out of a CUDA graph), and the bound: the call's bytes at 3.35 TB/s ->
    {launch counter: summed result}."""
    from rtxpt_tpu_torch.core import rng as T
    limits = rng_first_bounce(r.cfg)
    with Capture(limits) as cap:
        r.render(w, h, spp)
        torch.cuda.synchronize()
    r.reset_accumulation()
    out = {}
    for name, calls in cap.calls.items():
        require(len(calls) == limits[name],
                f"{label}: {len(calls)} {name} calls captured, expected "
                f"{limits[name]}")
        for i, (args, kw) in enumerate(calls):
            kern = lambda: getattr(T, name)(*args, **kw)
            plain = lambda: getattr(T, name + "_plain")(*args, **kw)
            got, ref = kern(), plain()
            if name.startswith("next"):
                require(torch.equal(got[1], ref[1]), f"rng {name} {label} "
                        f"call {i}: samples differ from the plain version")
                got, ref = got[0], ref[0]
            require(all(torch.equal(a, b.expand(a.shape))
                        for a, b in zip(got, ref)),
                    f"rng {name} {label} call {i}: state differs from the "
                    "plain version")
            nbytes = rng_bytes(name, args, kw, kern())
            ms, paced = device_ms(kern), time_ms(kern, 20)
            pms = time_ms(plain, 20)
            b_ms, b_by = bound(nbytes, 0)
            lanes = got.base.numel()
            print(f"rng {name} {label} call {i} ({lanes} lanes): bit-equal "
                  f"to the plain version; kernel {ms:.4f} ms (CUDA events "
                  f"{paced:.4f}), plain {pms:.4f} ms (CUDA events), "
                  f"{nbytes / 1e6:.2f} MB, bound {b_ms:.4f} ms ({b_by})",
                  flush=True)
            acc = out.setdefault(RNG_CALLS[name], dict(
                max_abs_err=0.0, ms=0.0, paced_ms=0.0, plain_ms=0.0,
                library_ms=None, bound_ms=0.0, bound_by="bytes", calls=0,
                bytes=0))
            for key, v in (("ms", ms), ("paced_ms", paced), ("plain_ms", pms),
                           ("bound_ms", b_ms), ("calls", 1),
                           ("bytes", nbytes)):
                acc[key] += v
    for name, acc in out.items():
        print(f"rng {label} {name}: {acc['calls']} calls, kernel "
              f"{acc['ms']:.4f} ms (CUDA events {acc['paced_ms']:.4f}), "
              f"plain {acc['plain_ms']:.4f} ms, bound {acc['bound_ms']:.4f} "
              f"ms ({acc['bytes'] / 1e6:.1f} MB)", flush=True)
    return out


def check_surface_kernels(cap, label, lanes=None, fill=False,
                          shade_pass=True) -> dict:
    """The surface fetch, K2, K3 and K4 (fill: K4 FILL; shade_pass=False:
    no K4, for a bounce through the chain of tensor ops) on the calls a
    Capture of one first bounce recorded -> {kernel name: result}; K2 also
    on the three table fetches inside the surface fetch and K3 on its
    blend, the parent's calls; raises where a kernel disagrees."""
    shade = "shade_nee_fill" if fill else "shade_nee"
    require(cap.calls["gather_surface"]
            and (not shade_pass or cap.calls[shade]),
            f"{label}: no surface fetch or {shade} launch captured")
    args = cap.calls["gather_surface"][0][0]
    k2, k3 = surface_inputs(args)
    out = {"gather_surface": check_surface(args, label),
           "gather_rows": check_gathers(cap.calls["gather_rows"] + k2, label,
                                        lanes),
           "gather_rows_interp": check_interp(k3, label)}
    if shade_pass:
        args, kw = cap.calls[shade][0]
        out[shade] = check_shade(args, kw, label, fill=fill)
    return out


def sass_ops(so) -> dict:
    """{mangled kernel name: (weighted float32 operations, instructions)}
    of every kernel in the shared library `so`, from `cuobjdump -sass`
    (SASS_OP_WEIGHTS; instructions: every one but NOP). A static count:
    K4's arithmetic is straight-line code with selects, so each float
    instruction runs once per lane; the rarely taken slow paths of IEEE
    division, square root and sin/cos range reduction are counted once
    each, so the operations are a little above the common path's. Its
    copy loops (no float instruction) run once per input row and are
    counted once, so its instructions are a little below a lane's."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                             text=True, timeout=600)
    except OSError as e:
        raise RuntimeError(f"cuobjdump is needed to count K4's operations: "
                           f"{e}") from e
    require(out.returncode == 0, f"cuobjdump -sass {so} failed: "
            f"{out.stderr[-2000:]}")
    ops, name = {}, None
    for line in out.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            ops[name] = [0, 0]
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]\s+)?"
                     r"([A-Z][A-Z0-9]*)", line)
        if m and name and m.group(1) != "NOP":
            ops[name][0] += SASS_OP_WEIGHTS.get(m.group(1), 0)
            ops[name][1] += 1
    require(ops, f"cuobjdump found no kernel in {so}")
    return {name: tuple(v) for name, v in ops.items()}


def ptxas_kernels(report: str) -> list:
    """[[mangled name, registers, static shared bytes, spilled bytes]] of
    every kernel in an nvcc -Xptxas=-v report."""
    rows, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append([name, int(m.group(1)),
                         int(smem.group(1)) if smem else 0, spill])
            name = None
    return rows


SHADE_NAME = re.compile(r"shade_nee_kernelILi(\d)ELi(\d)ELb([01])ELb([01])E")


def shade_instances(report: str, so, staged: bool = True) -> dict:
    """{(nee_distant, nee_local, rr, fill): registers, shared (static +
    dynamic) bytes, spilled bytes, SASS operations and instructions per
    lane} of every K4 instantiation, from ptxas's report on
    csrc/shade_kernel.cu and the SASS of the library `so`. A kernel that
    stages its input rows (`staged`) takes `smem_bytes` of dynamic shared
    memory a block, one that reads them from global memory none."""
    from rtxpt_tpu_torch.pt.shade_kernel import smem_bytes
    out = {}
    for name, regs, smem, spill in ptxas_kernels(report):
        m = SHADE_NAME.search(name)
        if m:
            nd, nl = int(m.group(1)), int(m.group(2))
            out[(nd, nl, m.group(3) == "1", m.group(4) == "1")] = dict(
                registers=regs,
                shared=smem + (smem_bytes(nd, nl) if staged else 0),
                spill=spill)
    for name, (ops, instructions) in sass_ops(so).items():
        m = SHADE_NAME.search(name)
        if m:
            key = (int(m.group(1)), int(m.group(2)), m.group(3) == "1",
                   m.group(4) == "1")
            out[key].update(ops=ops, instructions=instructions)
    require(len(out) == 36 and all("ops" in v for v in out.values()),
            "ptxas and cuobjdump do not report all 36 K4 instantiations")
    return out


def check_shade(args, kw, label="bench", fill=False) -> dict:
    """K4 (fill: its FILL variant) against its plain version: lobe and
    flags equal on >= 99.99% of lanes, the rest within rtol 2e-4 / atol
    2e-5 on those lanes (FILL: max |diff| < 1e-5); both timed. Prints the
    instantiation's registers, shared bytes and spills (none allowed)
    and its bound: the larger of its bytes and its SASS operation count."""
    from rtxpt_tpu_torch.pt import shade_kernel as SK
    kernel = SK.shade_nee_fill if fill else SK.shade_nee
    key = (kw["nee_distant"], kw["nee_local"], bool(kw["rr"]), fill)
    inst = SHADE[key]
    got = kernel(*args, **kw)
    ref = SK.shade_nee_plain(*args, fill=fill, **kw)
    L = SK.out_layout(kw["nee_distant"], kw["nee_local"], fill)
    flags = ["lobe", "scatter_valid", "will_scatter", "rr_kill",
             "non_delta_scatter"] + [f"nee_need{i}" for i in range(
                 kw["nee_distant"] + kw["nee_local"])]
    rows = [L.map[f][0] for f in flags]
    same = (got[rows] == ref[rows]).all(0)
    agree = float(same.float().mean())
    err = float((got[:, same] - ref[:, same]).abs().max())
    close = torch.allclose(got[:, same], ref[:, same], rtol=2e-4, atol=2e-5)
    what = f"K4{' FILL' if fill else ''} {label} NEE " \
        f"{kw['nee_distant']}+{kw['nee_local']}"
    print(f"{what}, {got.shape[1]} lanes: lobe/flags equal on "
          f"{agree:.6%}, max |diff| {err:.3g}")
    require(agree >= 0.9999, f"{what}: lobe/flag agreement {agree}")
    require(close, f"{what}: outside rtol 2e-4 / atol 2e-5")
    if fill:
        require(err < 1e-5, f"{what}: max |diff| {err} >= 1e-5")
    ms = time_ms(lambda: kernel(*args, **kw), 20)
    pms = time_ms(lambda: SK.shade_nee_plain(*args, fill=fill, **kw), 5)
    planes, n = args[0], args[0].shape[1]
    b_ms, b_by = bound((planes.shape[0] + L.rows) * n * 4, n * inst["ops"])
    dispatch = dispatch_ms(n, inst["instructions"])
    print(f"{what}: {inst['registers']} registers, {inst['shared']} B "
          f"shared, {inst['spill']} B spilled; kernel {ms:.4f} ms, plain "
          f"{pms:.4f} ms, bound {b_ms:.4f} ms ("
          f"{'operations (SASS count)' if b_by == 'operations' else b_by}; "
          f"{planes.shape[0]} + {L.rows} rows, {inst['ops']} operations a "
          f"lane); dispatch {dispatch:.4f} ms ({inst['instructions']} SASS "
          "instructions a lane)", flush=True)
    require(inst["spill"] == 0, f"{what}: the kernel spills")
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
                bound_ms=b_ms, bound_by=b_by, registers=inst["registers"],
                shared_bytes=inst["shared"], spill_bytes=inst["spill"],
                ops_per_lane=inst["ops"])


def dispatch_ms(lanes: int, instructions: int) -> float:
    """Least ms in which the card can dispatch `instructions` warp
    instructions for each warp of `lanes` lanes (DISPATCH_PER_S)."""
    return -(-lanes // 32) * instructions / DISPATCH_PER_S * 1e3


def render(w, h, spp, device, cfg=None, env_height=64):
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    host = procedural.build_programmer_art().finish()
    r = Renderer(host, procedural.default_camera(w, h),
                 cfg or reference_config(),
                 env_radiance=EM.bake_procedural_sky(height=env_height),
                 device=device)
    hdr = r.render(w, h, spp)
    return hdr, r.tonemapped(hdr)


def check_goldens():
    from rtxpt_tpu_torch.utils import image as IM
    imgs = {}
    for w, h, spp in ((64, 48, 2), (160, 120, 8)):
        hdr, img = render(w, h, spp, "cuda")
        img = img.cpu().numpy()
        require(np.isfinite(img).all() and img.shape == (h, w, 3),
                f"{w}x{h}: non-finite or misshapen image")
        m = IM.compare(img, IM.load_png(
            f"assets/golden_programmer_art_{w}x{h}_{spp}spp.png"))
        fast = m["psnr"] > FAST_PSNR and m["smape"] < FAST_SMAPE
        print(f"golden {w}x{h} {spp}spp: PSNR {m['psnr']:.2f} dB, SMAPE "
              f"{m['smape']:.5f} (gate {PSNR_MIN} dB / {SMAPE_MAX}; fast "
              f"gate {FAST_PSNR} dB / {FAST_SMAPE}: "
              f"{'met' if fast else 'not met'})")
        require(m["psnr"] > PSNR_MIN and m["smape"] < SMAPE_MAX,
                f"golden {w}x{h} {spp}spp outside the gate: {m}")
        imgs[(w, h)] = img
    _, cpu = render(64, 48, 2, "cpu")
    m = IM.compare(imgs[(64, 48)], cpu.numpy())
    print(f"GPU vs CPU (plain) 64x48 2spp: PSNR {m['psnr']:.2f} dB, SMAPE "
          f"{m['smape']:.5f}")
    require(m["psnr"] > PSNR_MIN, f"GPU vs CPU render: {m}")


def bench(card: str):
    """The bench workload; returns its launch counts and HDR image."""
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    w, h, spp = BENCH_SIZE
    host = procedural.build_programmer_art().finish()
    r = Renderer(host, procedural.default_camera(w, h),
                 reference_config(**BENCH_CFG),
                 env_radiance=EM.bake_procedural_sky(height=64),
                 device="cuda")
    r.render(w, h, spp)                      # warm-up (allocator, caches)
    r.reset_accumulation()
    out, wall, counts, tc, sc, shc = counted_render(
        r, w, h, spp, ONE_LAUNCH["mt_dense_fused"][0])
    mpaths = w * h * spp / wall / 1e6
    print(f"bench {w}x{h} {spp}spp NEE 1+1, 6 bounces: {wall * 1e3:.1f} ms "
          f"wall, {mpaths:.3f} Mpaths/s on {card}; {tc.n} dense traces, "
          f"{sc.n} load_surface calls, {shc.n} bounces; launches {counts}")
    for name in BENCH_PATH:
        require(counts[KERNELS[name][0]] > 0,
                f"{name} was not launched on the bench path")
    require_one_launch_per_trace(counts, tc.n, "bench", "mt_dense_fused")
    require_one_surface_fetch(counts, sc.n, "bench")
    require_one_shade_per_bounce(counts, shc.n, "bench")
    require_rng(counts, shc.n, "bench")
    require(shc.n_chain == 0, "bench: a bounce took the chain")
    return {name: counts.get(KERNELS[name][0], 0) for name in KERNELS}, out


class VisitCount:
    """Counts the tiles and worklist visits of the fused kernel on every
    dense trace while active: wraps mt_dense.trace_dense_fused and runs
    its lab mode "lists" on the same inputs first (the launches count on
    the lab's counter, `mt_dense_fused_variant`; the sums stay on the
    device)."""

    def __enter__(self):
        from rtxpt_tpu_torch.ops import mt_dense as M
        from tools_torch import profile_mt_kernel as PM
        self.mod, self.orig = M, M.trace_dense_fused
        self.visits, self.tiles = 0, 0

        def counted(*args, **kw):
            v, t = PM.list_visits(args)
            self.visits, self.tiles = self.visits + v, self.tiles + t
            return self.orig(*args, **kw)
        M.trace_dense_fused = counted
        return self

    def __exit__(self, *exc):
        self.mod.trace_dense_fused = self.orig

    def per_tile(self) -> float:
        return float(self.visits) / max(float(self.tiles), 1.0)


def sorted_bench(card: str):
    """The bench workload unsorted and under wavefront_sort="raystream"
    (each with its launch counts set to 0 just before): both walls and the
    fused kernel's visits per tile (VisitCount: its lab launches are in
    the walls); each render must launch the fused dense trace once per
    dense trace call and K1 and K7 not at all, and the sorted image must
    equal the unsorted one to the tolerance of
    tests/test_raystream_sort.py."""
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.ops import cuda_lib
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    w, h, spp = 800, 600, 8
    host = procedural.build_programmer_art().finish()
    imgs = {}
    for sort in ("none", "raystream"):
        cfg = reference_config(max_bounces=6, max_diffuse_bounces=4,
                               nee_distant_samples=1, nee_local_samples=1,
                               wavefront_sort=sort)
        r = Renderer(host, procedural.default_camera(w, h), cfg,
                     env_radiance=EM.bake_procedural_sky(height=64),
                     device="cuda")
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        with VisitCount() as vc, \
                TraceCalls(ONE_LAUNCH["mt_dense_fused"][0]) as tc:
            t0 = time.perf_counter()
            hdr = r.render(w, h, spp)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = cuda_lib.launch_counts()
        imgs[sort] = hdr.cpu().numpy()
        print(f"bench wavefront_sort={sort}: {wall * 1e3:.1f} ms wall "
              f"({w * h * spp / wall / 1e6:.3f} Mpaths/s) on {card}; "
              f"visits/tile {vc.per_tile():.3f} over {int(vc.tiles)} tiles; "
              f"mt_dense_fused {counts['mt_dense_fused']} "
              f"launches for {tc.n} dense traces", flush=True)
        require_one_launch_per_trace(counts, tc.n,
                                     f"wavefront_sort={sort}",
                                     "mt_dense_fused")
    a, b = imgs["none"], imgs["raystream"]
    diff = np.abs(a - b)
    out = (diff > 1e-6 + 1e-5 * np.abs(a)).any(-1)
    print(f"raystream vs unsorted: max |diff| {diff.max():.3g}, pixels "
          f"outside rtol 1e-5 / atol 1e-6: {int(out.sum())} of {w * h} "
          f"(first (y, x): {np.argwhere(out)[:5].tolist()})", flush=True)
    require(np.isfinite(b).all() and np.allclose(b, a, rtol=1e-5, atol=1e-6),
            "raystream render differs from the unsorted one")


def labs(results: dict) -> dict:
    """The labs phase (12.): K9's modes on the bench camera rays and every
    K8 micro-kernel against its plain version -> results["labs"]; returns
    the labs' kernels (no main path runs them) as KERNELS describes
    kernels."""
    from rtxpt_tpu_torch.ops import mt_dense as M
    from tools_torch import kernel_lab as KL
    from tools_torch import profile_mt_kernel as PM
    args, _ = PM.capture_traces()["camera"]
    aabb_c, _, o_c, d, tmax, act = args
    modes = PM.run_modes(args)
    print("K9 modes on the bench camera rays (ms, agreement with the plain "
          "version): " + ", ".join(f"{m} {ms:.4f} ({agree:.6%})"
                                   for m, (ms, agree) in modes.items()),
          flush=True)
    wl = M.tile_worklists(aabb_c, o_c, d, tmax, act)
    pms = time_ms(lambda: PM.gate_visits_plain(aabb_c, o_c, d, tmax, act,
                                               wl), 3)
    tiles = torch.arange(o_c.shape[0], device=o_c.device) // M.TILE
    nb = o_c.shape[0] * (12 + 12 + 4 + 1 + 4) + aabb_c.numel() * 4 \
        + (wl[0].numel() + wl[1].numel()) * 4
    b_ms, b_by = bound(nb, int(wl[0].long()[tiles][act].sum()) * SLAB_OPS)
    kernels = {"mt_dense_gate": ("mt_dense_variant", PM.SOURCE,
                                 PM.REPLACES)}
    results["labs"]["mt_dense_gate"] = dict(
        max_abs_err=0.0, ms=modes["gate"][0], plain_ms=pms, library_ms=None,
        bound_ms=b_ms, bound_by=b_by,
        modes_ms={m: ms for m, (ms, _) in modes.items()})
    table = KL.make_table("cuda")
    for name in KL.KERNELS:
        err = KL.check(name, table)
        ms = KL.time_ms(lambda: KL.run(name, table, KL.CHECK_ITERS))
        pms = KL.time_ms(lambda: KL.plain(name, table, KL.CHECK_ITERS), 1)
        full = KL.time_ms(lambda: KL.run(name, table, KL.ITERS))
        nb = KL.LANES * 4 + (table.numel() * 4 if name == "row_fetch" else 0)
        b_ms, b_by = bound(nb, KL.OPS[name] * KL.LANES * KL.CHECK_ITERS)
        print(f"K8 {name}: max |diff| {err:.3g} at {KL.CHECK_ITERS} "
              f"iterations (kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{b_ms:.4f} ms); {full * 1e3 / KL.ITERS:.4f} us/iter over "
              f"{KL.LANES} lanes at {KL.ITERS} iterations", flush=True)
        kernels[f"lab_{name}"] = ("kernel_lab", KL.SOURCE, KL.REPLACES[name])
        results["labs"][f"lab_{name}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
            bound_ms=b_ms, bound_by=b_by,
            us_per_iter=full * 1e3 / KL.ITERS)
    return kernels


def bvh8_work(args, stats, stacked: bool):
    """(bytes, ops) of one K5/K6 launch: the active lanes' rays (and
    subtree index), every lane's t_max and active flag, the outputs, and
    each table row the plain version fetched, once (a node row's 56
    floats; a leaf's triangles at 9 floats and one opacity mask each);
    operations from the plain version's counts of node rows and leaf
    triangles."""
    o, act = args[3 if stacked else 2], args[-1]
    n, a = o.shape[0], int(act.sum())
    nbytes = n * (1 + 4 + 16) + a * (24 + (4 if stacked else 0)) \
        + stats["distinct_node_rows"] * 56 * 4 \
        + stats["distinct_leaf_tris"] * (9 + 1) * 4
    ops = stats["node_rows"] * NODE_ROW_OPS + stats["leaf_tris"] * TRI_OPS
    return nbytes, ops


def check_bvh8(calls, label, stacked):
    """K6 (stacked) or K5 on calls [(args, kw)]: kernel against plain
    version (agreement, max |diff|), both timed; returns
    (agreeing lanes, active lanes, max |diff|, ms, plain ms, bytes, ops,
    launches with no active lane, row-traffic bytes)."""
    from rtxpt_tpu_torch.ops import traverse_bvh8 as T8
    kernel = T8.trace_bvh8_sub if stacked else T8.trace_bvh8
    agree = lanes = empty = 0
    err = ms = pms = nbytes = ops = traffic = 0.0
    for args, kw in calls:
        act = args[-1]
        n_act = int(act.sum())
        empty += n_act == 0
        if stacked:
            tables, omm, sub, o, d, tmax, _ = args
            plain_args = (tables, omm, o, d, tmax, act, sub)
        else:
            plain_args = tuple(args)
        stats = {}
        t_k, s_k, uv_k = kernel(*args, **kw)
        t_p, s_p, uv_p = T8.trace_bvh8_plain(*plain_args, **kw, stats=stats)
        torch.cuda.synchronize()
        if kw["any_hit"]:
            agree += int(((s_k >= 0) == (s_p >= 0))[act].sum())
        else:
            same = s_k == s_p
            agree += int(same[act].sum())
            m = same & (s_k >= 0)
            if bool(m.any()):
                err = max(err, float((t_k - t_p)[m].abs().max()),
                          float((uv_k - uv_p)[m].abs().max()))
                require(torch.allclose(t_k[m], t_p[m], rtol=1e-5, atol=1e-6)
                        and torch.allclose(uv_k[m], uv_p[m], rtol=1e-5,
                                           atol=1e-6),
                        f"{label}: t/u/v outside rtol 1e-5 / atol 1e-6")
        lanes += n_act
        ms += time_ms(lambda: kernel(*args, **kw), 20)
        pms += time_ms(lambda: T8.trace_bvh8_plain(*plain_args, **kw), 1,
                       warmup=False)
        nb, op = bvh8_work(args, stats, stacked)
        nbytes += nb
        ops += op
        traffic += stats["node_rows"] * 56 * 4 + stats["leaf_tris"] * 40
    return agree, lanes, err, ms, pms, nbytes, ops, empty, traffic


def two_level_work(args, kw, stats):
    """(bytes, ops) of one two-level trace: every lane's t_max, active
    flag and output (16 bytes closest, 1 any-hit), the active lanes' rays,
    the K boxes, and the rows the plain composition fetched (each plain
    call's distinct rows, summed over the probe and the subtrees, as
    bvh8_work counts them); operations: each active lane's K box tests
    and the plain walks' node rows and leaf triangles."""
    tl, o, _, _, act = args
    n, a, k = o.shape[0], int(act.sum()), tl.num_subtrees
    nbytes = n * (1 + 4 + (1 if kw["any_hit"] else 16)) + a * 24 + k * 24 \
        + stats["distinct_node_rows"] * 56 * 4 \
        + stats["distinct_leaf_tris"] * (9 + 1) * 4
    ops = a * k * SLAB_OPS + stats["node_rows"] * NODE_ROW_OPS \
        + stats["leaf_tris"] * TRI_OPS
    return nbytes, ops


def call_ms(fn, iters: int = 20) -> float:
    """Host-clock ms of one fn() call, ending in a device synchronize
    (mean of `iters` after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def check_two_level(traces, label) -> dict:
    """On captured two-level traces [(what, (args, kw) of trace_bvh8_2l,
    timed)]: the fused launch against the plain composition (the same
    prim (closest) or occlusion flag (any-hit) on >= 99.99% of the active
    lanes, t/u/v within rtol 1e-5 / atol 1e-6 where the prims agree), its
    lab modes, and the whole trace call on the host clock; K6 on the
    trace's rays with their nearest subtree and K5 on the largest
    subtree's table with the rays that overlap its box, against their
    plain versions -> {kernel name: result}, times and bounds summed over
    the timed traces."""
    from rtxpt_tpu_torch.ops import bvh2l
    from rtxpt_tpu_torch.ops import traverse_bvh8 as T8
    from tools_torch import profile_bvh8 as PB
    tot = {name: [0] * 9 for name in ("bvh8_trace_2l", "bvh8_trace_sub",
                                      "bvh8_trace")}
    modes, calls = {}, 0.0
    for what, (args, kw), timed in traces:
        tl, o, d, tmax, act = args
        tag = f"bvh8_trace_2l {label} {what}"
        stats = {}
        got = T8.trace_bvh8_2l(*args, **kw)
        # the plain composition runs once: its result is compared and its
        # CUDA-event time is plain_ms
        ref, pms = timed_call(lambda: bvh2l.trace_two_level_plain(
            *args, **kw, stats=stats))
        lanes, err = int(act.sum()), 0.0
        if kw["any_hit"]:
            agree = int((got == ref)[act].sum())
        else:
            same = got.prim == ref.prim
            agree = int(same[act].sum())
            m = same & (got.prim >= 0)
            if bool(m.any()):
                err = max(float((got.t - ref.t)[m].abs().max()),
                          float((got.bary - ref.bary)[m].abs().max()))
                require(torch.allclose(got.t[m], ref.t[m], rtol=1e-5,
                                       atol=1e-6)
                        and torch.allclose(got.bary[m], ref.bary[m],
                                           rtol=1e-5, atol=1e-6),
                        f"{tag}: t/u/v outside rtol 1e-5 / atol 1e-6")
        frac = agree / max(lanes, 1)
        ms = time_ms(lambda: T8.trace_bvh8_2l(*args, **kw), 20)
        trace = bvh2l.trace_anyhit if kw["any_hit"] else bvh2l.trace_closest
        c_ms = call_ms(lambda: trace(tl, o, d, tmax, act))
        m_ms = PB.run_modes(args, kw)
        nb, ops = two_level_work(args, kw, stats)
        traffic = stats["node_rows"] * 56 * 4 + stats["leaf_tris"] * 40
        print(f"{tag}: 1 launch over {o.shape[0]} lanes, {lanes} active "
              f"lanes, K={tl.num_subtrees}; same "
              f"{'occlusion' if kw['any_hit'] else 'prim'} as the plain "
              f"composition on {frac:.6%}, t/u/v max |diff| {err:.3g}; "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{bound(nb, ops)[0]:.4f} ms, whole trace call {c_ms:.4f} ms "
              f"(host clock); the plain composition made {stats['calls']} "
              f"walk calls, {stats['idle_calls']} with no active lane, row "
              f"traffic {traffic / 1e9:.3f} GB; lab modes "
              + ", ".join(f"{mode} {v:.4f}" for mode, v in m_ms.items())
              + " ms", flush=True)
        require(lanes == 0 or frac >= 0.9999, f"{tag}: agreement {frac}")
        rows = [("bvh8_trace_2l", agree, lanes, err, ms, pms, nb, ops, 0,
                 traffic)]
        if timed:
            for mode, v in m_ms.items():
                modes[mode] = modes.get(mode, 0.0) + v
            calls += c_ms

        # K6 on these rays with their nearest subtree (plain code), K5 on
        # the largest subtree with the rays that overlap its box
        hit_k, tn_k = bvh2l._top_slabs(tl, o, d, tmax)
        near = torch.argmin(torch.where(hit_k, tn_k, torch.inf), dim=1)
        big = int((tl.sub_leaf_tris >= 0).sum(1).argmax())
        kwk = dict(leaf_size=tl.leaf_size, any_hit=kw["any_hit"])
        for name, k_args, stacked in (
                ("bvh8_trace_sub", (tl.sub_tables, tl.sub_leaf_omm,
                                    near.to(torch.int32), o, d, tmax,
                                    act & hit_k.any(1)), True),
                ("bvh8_trace", (tl.sub_tables[big], tl.sub_leaf_omm[big],
                                o, d, tmax, act & hit_k[:, big]), False)):
            k_tag = f"{name} {label} {what}"
            res = check_bvh8([(k_args, kwk)], k_tag, stacked)
            k_agree, k_lanes, k_err, k_ms, k_pms, k_nb, k_ops, _, k_tr = res
            k_frac = k_agree / max(k_lanes, 1)
            print(f"{k_tag}{'' if stacked else f' (subtree {big})'}: "
                  f"{k_lanes} active lanes; same "
                  f"{'occlusion' if kw['any_hit'] else 'prim'} on "
                  f"{k_frac:.6%}, t/u/v max |diff| {k_err:.3g}; kernel "
                  f"{k_ms:.4f} ms, plain {k_pms:.4f} ms, bound "
                  f"{bound(k_nb, k_ops)[0]:.4f} ms", flush=True)
            require(k_lanes == 0 or k_frac >= 0.9999,
                    f"{k_tag}: agreement {k_frac}")
            rows.append((name, *res))
        if timed:
            for name, *vals in rows:
                acc = tot[name]
                for j, v in enumerate(vals):
                    acc[j] = max(acc[j], v) if j == 2 else acc[j] + v
    out = {}
    for name, acc in tot.items():
        require(acc[1] > 0, f"{label}: no active lane for {name}")
        b_ms, b_by = bound(acc[5], acc[6])
        out[name] = dict(max_abs_err=acc[2], ms=acc[3], plain_ms=acc[4],
                         library_ms=None, bound_ms=b_ms, bound_by=b_by)
    out["bvh8_trace_2l"].update(modes_ms=modes, call_ms=calls)
    return out


class TraceCalls:
    """Counts the trace calls that cast at least one ray while active:
    wraps trace_closest and trace_anyhit of the trace module `module`
    (ONE_LAUNCH)."""

    def __init__(self, module: str):
        import importlib
        self.mod, self.n = importlib.import_module(module), 0

    def __enter__(self):
        self.orig = {name: getattr(self.mod, name)
                     for name in ("trace_closest", "trace_anyhit")}
        for name, fn in self.orig.items():
            def counted(accel, origins, *args, _fn=fn, **kw):
                self.n += origins.shape[0] > 0
                return _fn(accel, origins, *args, **kw)
            setattr(self.mod, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


class SurfaceCalls:
    """Counts the pt/shading.py `load_surface` calls with at least one lane
    while active."""

    def __enter__(self):
        from rtxpt_tpu_torch.pt import shading
        self.mod, self.orig, self.n = shading, shading.load_surface, 0

        def counted(scene, prim, *args, **kw):
            self.n += prim.shape[0] > 0
            return self.orig(scene, prim, *args, **kw)
        shading.load_surface = counted
        return self

    def __exit__(self, *exc):
        self.mod.load_surface = self.orig


class ShadeCalls:
    """Counts the bounces with at least one lane while active: `n` those
    of the fused pass (pt/integrator.py `_shade_step` calls, each of which
    runs K4 or K4 FILL once), `n_chain` those of the chain of tensor ops
    (`_chain_shade_step`)."""
    STEPS = {"_shade_step": "n", "_chain_shade_step": "n_chain"}

    def __enter__(self):
        from rtxpt_tpu_torch.pt import integrator
        self.mod, self.n, self.n_chain = integrator, 0, 0
        self.orig = {name: getattr(integrator, name) for name in self.STEPS}
        for name, fn in self.orig.items():
            def counted(assets, cfg, consts4, path, surf, shade, *args,
                        _fn=fn, _attr=self.STEPS[name], **kw):
                setattr(self, _attr,
                        getattr(self, _attr) + (shade.shape[0] > 0))
                return _fn(assets, cfg, consts4, path, surf, shade, *args,
                           **kw)
            setattr(integrator, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


def require_one_shade_per_bounce(counts, n_bounces, what, fill=False):
    """One K4 (fill: K4 FILL) launch per bounce, and the other variant
    not at all."""
    name, other = ("shade_nee_fill", "shade_nee") if fill \
        else ("shade_nee", "shade_nee_fill")
    require(counts[name] == n_bounces > 0 and counts[other] == 0,
            f"{what}: {counts[name]} {name} and {counts[other]} {other} "
            f"launches for {n_bounces} bounces")


def require_rng(counts, n_bounces, what):
    """The sample generator's kernels: at least one make, start_effect and
    next_* launch per bounce (the shade step's)."""
    got = [counts[k] for k in ("rng_make", "rng_start_effect", "rng_next")]
    require(min(got) >= n_bounces > 0,
            f"{what}: rng make, start_effect, next launches {got} for "
            f"{n_bounces} bounces")


def require_chain(counts, shc, what):
    """Every bounce through the chain of tensor ops: no K4 or K4 FILL
    launch, and no bounce of the fused pass."""
    require(shc.n_chain > 0 and shc.n == 0 and counts["shade_nee"] == 0
            and counts["shade_nee_fill"] == 0,
            f"{what}: {shc.n_chain} chain and {shc.n} fused bounces, "
            f"{counts['shade_nee']} shade_nee and {counts['shade_nee_fill']} "
            "shade_nee_fill launches")


def require_one_surface_fetch(counts, n_calls, what):
    """One `gather_surface` launch per load_surface call, and no K3."""
    require(counts["gather_surface"] == n_calls > 0,
            f"{what}: {counts['gather_surface']} gather_surface launches for "
            f"{n_calls} load_surface calls")
    require(counts["gather_rows_interp"] == 0,
            f"{what}: gather_rows_interp launched beside gather_surface: "
            f"{counts}")


def require_one_launch_per_trace(counts, n_traces, what,
                                 kernel="bvh8_trace_2l"):
    """`kernel` launched once per trace call (ONE_LAUNCH), and the
    kernels it replaced on the path not at all."""
    require(counts[kernel] == n_traces > 0,
            f"{what}: {counts[kernel]} {kernel} launches for {n_traces} "
            "trace calls")
    others = ONE_LAUNCH[kernel][1]
    require(all(counts[k] == 0 for k in others),
            f"{what}: {others} launched beside {kernel}: {counts}")


def build_city():
    from rtxpt_tpu_torch.scene import procedural
    return procedural.build_city().finish()


def city(results: dict, card: str, host, geometry_s: float):
    """The city phase (5.) on the host geometry build_city() made in
    `geometry_s` seconds; returns the launch counts and the image mean of
    its render."""
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.ops import bvh2l
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    from rtxpt_tpu_torch.utils import image as IM
    w, h, spp = 1920, 1080, 2
    cfg = reference_config(max_bounces=6, max_diffuse_bounces=4,
                           nee_distant_samples=1, nee_local_samples=1)
    env = EM.bake_procedural_sky(height=64)
    t0 = time.perf_counter()
    r = Renderer(host, procedural.city_camera(w, h), cfg, env_radiance=env,
                 device="cuda")
    torch.cuda.synchronize()
    renderer_s = time.perf_counter() - t0
    tl = r.accel
    require(isinstance(tl, bvh2l.BVH8TwoLevel),
            "city: not on the two-level tier")
    k = tl.num_subtrees
    print(f"city: {host['indices'].shape[0]} triangles, two-level BVH8 "
          f"K={k} S={tl.rows} ({tl.sub_tables.numel() * 4 / 1e6:.1f} MB), "
          f"host build {geometry_s + renderer_s:.2f} s (geometry "
          f"{geometry_s:.2f} s, Renderer {renderer_s:.2f} s)", flush=True)
    require(k >= bvh2l.PROBE_MIN_SUBTREES, "city: the probe does not engage")

    # the two-level traces of the first bounce of a 1-spp render: camera
    # rays, their NEE rays and the scattered rays (ms sums camera + NEE,
    # as K1's); K2-K4 on its gathers and shade pass
    with Capture(dict(FIRST_BOUNCE, trace_bvh8_2l=3)) as cap:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()
    traces = cap.calls["trace_bvh8_2l"]
    require([kw["any_hit"] for _, kw in traces] == [False, True, False],
            "city: the first bounce's traces are not camera, NEE, scattered")
    results["city"].update(check_two_level(
        [(what, traces[i], what != "scattered")
         for i, what in enumerate(("camera", "nee any-hit", "scattered"))],
        "city"))
    results["city"].update(check_surface_kernels(cap, "city"))
    del cap, traces                  # the captured inputs
    results["city"].update(check_rng(r, w, h, spp, "city"))

    # the main path: 1920x1080, 2 spp as one regenerating chunk
    r.render(w, h, spp)                      # warm-up
    r.reset_accumulation()
    out, wall, counts, tc, sc, shc = counted_render(
        r, w, h, spp, ONE_LAUNCH["bvh8_trace_2l"][0])
    print(f"city {w}x{h} {spp}spp NEE 1+1, 6 bounces: {wall * 1e3:.1f} ms "
          f"wall, {w * h * spp / wall / 1e6:.3f} Mpaths/s on {card}; "
          f"{tc.n} two-level traces, {sc.n} load_surface calls, {shc.n} "
          f"bounces; launches {counts}", flush=True)
    for name in CITY_PATH:
        require(counts[KERNELS[name][0]] > 0,
                f"{name} was not launched on the city path")
    require_one_launch_per_trace(counts, tc.n, "city render")
    require_one_surface_fetch(counts, sc.n, "city render")
    require_one_shade_per_bounce(counts, shc.n, "city render")
    require_rng(counts, shc.n, "city render")
    require(shc.n_chain == 0, "city render: a bounce took the chain")

    # the port on the card against the port's plain versions on the CPU
    imgs = []
    for device in ("cuda", "cpu"):
        rs = Renderer(host, procedural.city_camera(64, 36), cfg,
                      env_radiance=env, device=device)
        imgs.append(rs.tonemapped(rs.render(64, 36, 1)).cpu().numpy())
    require(np.isfinite(imgs[0]).all(), "city 64x36: non-finite image")
    m = IM.compare(imgs[0], imgs[1])
    print(f"city GPU vs CPU (plain) 64x36 1spp: PSNR {m['psnr']:.2f} dB, "
          f"SMAPE {m['smape']:.5f}")
    require(m["psnr"] > PSNR_MIN, f"city GPU vs CPU render: {m}")
    return {name: counts.get(KERNELS[name][0], 0) for name in KERNELS}, \
        float(out.mean())


def counted_render(r, w, h, spp, trace_module):
    """r.render(w, h, spp) with every launch counter set to 0 just before:
    (HDR image as numpy, wall seconds, launch counts, TraceCalls of
    `trace_module`, SurfaceCalls, ShadeCalls)."""
    from rtxpt_tpu_torch.ops import cuda_lib
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    with TraceCalls(trace_module) as tc, SurfaceCalls() as sc, \
            ShadeCalls() as shc:
        t0 = time.perf_counter()
        hdr = r.render(w, h, spp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = hdr.cpu().numpy()
    require(out.shape == (h, w, 3) and np.isfinite(out).all()
            and out.mean() > 0.0, "render: bad output")
    return out, wall, cuda_lib.launch_counts(), tc, sc, shc


def require_mean(mean, ref_mean, what):
    """The reference's unbiasedness gate (tests/test_regir.py:30-31):
    image means within 10%."""
    rel = abs(mean - ref_mean) / max(ref_mean, 1e-6)
    require(rel < 0.10, f"{what}: mean {mean} against {ref_mean} ({rel:.2%})")
    return rel


def reference_configs(results: dict, card: str, host_city, bench_hdr,
                      city_mean: float) -> dict:
    """The reference configurations phase (6.); returns the launch counts
    of its main-path renders (bench_chain, city_regir)."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.models.renderer import (Renderer, realtime_config,
                                                 reference_config)
    from rtxpt_tpu_torch.ops import cuda_lib
    from rtxpt_tpu_torch.post.tonemap import tonemap
    from rtxpt_tpu_torch.pt import integrator as TI
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    from rtxpt_tpu_torch.utils import image as IM
    dense = ONE_LAUNCH["mt_dense_fused"][0]
    two_level = ONE_LAUNCH["bvh8_trace_2l"][0]
    host = procedural.build_programmer_art().finish()
    env = EM.bake_procedural_sky(height=64)
    w, h, spp = BENCH_SIZE
    launches = {}

    def art(cfg, device="cuda", w=w, h=h):
        return Renderer(host, procedural.default_camera(w, h),
                        reference_config(**BENCH_CFG, **cfg),
                        env_radiance=env, device=device)

    def png(hdr):
        return tonemap(torch.as_tensor(hdr)).numpy()

    # ---- the bench through the chain: its kernels on the first bounce
    chain = dict(shade_megakernel=False)
    r = art(chain)
    with Capture(dict(FIRST_BOUNCE, gather_rows=48)) as cap:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()
    calls = cap.calls["trace_dense_fused"]
    closest = [c for c in calls if not c[1]["any_hit"]]
    anyhit = [c for c in calls if c[1]["any_hit"]]
    require(len(closest) >= 2 and anyhit and not cap.calls["shade_nee"],
            "bench chain: wrong first-bounce launches captured")
    results["bench_chain"].update(check_dense(
        r.accel, [("camera", closest[0], True),
                  ("scattered", closest[1], False),
                  ("nee any-hit", anyhit[0], True)], "bench chain"))
    results["bench_chain"].update(check_surface_kernels(
        cap, "bench chain", w * h, shade_pass=False))
    del cap, calls, closest, anyhit

    # ---- the bench through the chain: the main path
    r.render(w, h, spp)                      # warm-up
    r.reset_accumulation()
    hdr, wall, counts, tc, sc, shc = counted_render(r, w, h, spp, dense)
    m = IM.compare(png(hdr), png(bench_hdr))
    print(f"bench chain {w}x{h} {spp}spp NEE 1+1, 6 bounces: "
          f"{wall * 1e3:.1f} ms wall, {w * h * spp / wall / 1e6:.3f} "
          f"Mpaths/s on {card}; {tc.n} dense traces, {sc.n} load_surface "
          f"calls, {shc.n_chain} chain bounces; launches {counts}; against "
          f"the K4 bench: PSNR {m['psnr']:.2f} dB, SMAPE {m['smape']:.5f}, "
          f"means {hdr.mean():.6f} / {bench_hdr.mean():.6f}", flush=True)
    require_chain(counts, shc, "bench chain")
    require_one_launch_per_trace(counts, tc.n, "bench chain",
                                 "mt_dense_fused")
    require_one_surface_fetch(counts, sc.n, "bench chain")
    require(counts["gather_rows"] > 0, "bench chain: no K2 launch")
    require(m["psnr"] > PSNR_MIN, f"bench chain against the K4 bench: {m}")
    launches["bench_chain"] = {name: counts.get(KERNELS[name][0], 0)
                               for name in KERNELS}
    del r

    # ---- the bench under each other configuration
    for name, cfg in OTHER_CONFIGS.items():
        r = art(cfg)
        hdr, wall, counts, tc, sc, shc = counted_render(r, w, h, spp, dense)
        rel = require_mean(float(hdr.mean()), float(bench_hdr.mean()),
                           f"bench {name}")
        fused = TI.uses_shade_kernel(r.cfg, 1)
        print(f"bench {name} {w}x{h} {spp}spp: {wall * 1e3:.1f} ms wall "
              f"(first render), {w * h * spp / wall / 1e6:.3f} Mpaths/s on "
              f"{card}; mean {hdr.mean():.6f} ({rel:.3%} from the default "
              f"bench's); {'K4' if fused else 'chain'}: {shc.n} fused, "
              f"{shc.n_chain} chain bounces; launches {counts}", flush=True)
        if fused:
            require_one_shade_per_bounce(counts, shc.n, f"bench {name}")
            require(shc.n_chain == 0, f"bench {name}: a chain bounce")
        else:
            require_chain(counts, shc, f"bench {name}")
        require_one_launch_per_trace(counts, tc.n, f"bench {name}",
                                     "mt_dense_fused")
        require_one_surface_fetch(counts, sc.n, f"bench {name}")
        del r
    torch.cuda.empty_cache()

    # ---- the city with ReGIR local sampling
    cw, ch, cspp = CITY_SIZE
    r = Renderer(host_city, procedural.city_camera(cw, ch),
                 reference_config(**BENCH_CFG, nee_local_type=2),
                 env_radiance=env, device="cuda")
    with Capture(dict(FIRST_BOUNCE, trace_bvh8_2l=2, gather_rows=48)) as cap:
        r.render_sample(cw, ch, 0)
        torch.cuda.synchronize()
    traces = cap.calls["trace_bvh8_2l"]
    require([kw["any_hit"] for _, kw in traces] == [False, True]
            and not cap.calls["shade_nee"],
            "city ReGIR: the first bounce's traces are not camera, NEE")
    results["city_regir"].update(check_two_level(
        [("camera", traces[0], True), ("nee any-hit", traces[1], True)],
        "city regir"))
    results["city_regir"].update(check_surface_kernels(
        cap, "city regir", shade_pass=False))
    del cap, traces
    torch.cuda.empty_cache()
    hdr, wall, counts, tc, sc, shc = counted_render(r, cw, ch, cspp,
                                                    two_level)
    rel = require_mean(float(hdr.mean()), city_mean, "city ReGIR")
    print(f"city ReGIR {cw}x{ch} {cspp}spp NEE 1+1, 6 bounces: "
          f"{wall * 1e3:.1f} ms wall, {cw * ch * cspp / wall / 1e6:.3f} "
          f"Mpaths/s on {card}; mean {hdr.mean():.6f} against the power "
          f"sampler's {city_mean:.6f} ({rel:.3%}); {tc.n} two-level "
          f"traces, {sc.n} load_surface calls, {shc.n_chain} chain "
          f"bounces; launches {counts}", flush=True)
    require_chain(counts, shc, "city ReGIR")
    require_one_launch_per_trace(counts, tc.n, "city ReGIR")
    require_one_surface_fetch(counts, sc.n, "city ReGIR")
    require(counts["gather_rows"] > 0, "city ReGIR: no K2 launch")
    launches["city_regir"] = {name: counts.get(KERNELS[name][0], 0)
                              for name in KERNELS}
    del r
    torch.cuda.empty_cache()

    # ---- each configuration on the card against the CPU
    for name, cfg in {"chain": chain, **OTHER_CONFIGS}.items():
        imgs = [art(cfg, device, 64, 48).render(64, 48, 2) for device in
                ("cuda", "cpu")]
        imgs = [png(img.cpu().numpy()) for img in imgs]
        m = IM.compare(*imgs)
        print(f"{name} GPU vs CPU (plain) 64x48 2spp: PSNR {m['psnr']:.2f} "
              f"dB, SMAPE {m['smape']:.5f}", flush=True)
        require(np.isfinite(imgs[0]).all() and m["psnr"] > PSNR_MIN,
                f"{name} GPU vs CPU render: {m}")

    # ---- the realtime FILL pass through the chain
    rt_cfg = realtime_config(use_restir_di=True, use_restir_gi=True,
                             denoiser_enabled=True, use_stable_planes=True,
                             shade_megakernel=False)
    imgs = []
    for device in ("cuda", "cpu"):
        rs = RealtimeRenderer(host, procedural.default_camera(64, 48),
                              rt_cfg, device=device)
        with ShadeCalls() as shc:
            if device == "cuda":
                torch.cuda.synchronize()
                cuda_lib.reset_launch_counts()
            for _ in range(2):
                img = rs.render_frame(64, 48)
        if device == "cuda":
            torch.cuda.synchronize()
            counts = cuda_lib.launch_counts()
            require_chain(counts, shc, "realtime FILL chain")
        imgs.append(rs.tonemapped(img).cpu().numpy())
    m = IM.compare(*imgs)
    print(f"realtime FILL chain GPU vs CPU (plain) 64x48, frame 2: PSNR "
          f"{m['psnr']:.2f} dB, SMAPE {m['smape']:.5f}; launches {counts}",
          flush=True)
    require(np.isfinite(imgs[0]).all() and m["psnr"] > PSNR_MIN,
            f"realtime FILL chain GPU vs CPU: {m}")
    return launches


def capture_realtime_frame(r, w, h, frame_kw=None):
    """Render one frame of the realtime renderer `r` (render_frame's
    keywords `frame_kw`) with the first launches of each stage captured
    -> (the trace wrapper's name, the first bounce's Capture, [(what,
    (args, kw) of the captured trace or None, any-hit)]). Stable planes: the first FILL bounce (its gathers and K4
    FILL), the BUILD pass's first trace (the camera rays), the first FILL
    NEE trace that casts a ray (the first bounce's casts none where
    ReSTIR DI owns the base) and the fused ReSTIR DI + GI final shade's
    visibility trace. PSR-lite: the first bounce of the path loop (its
    gathers and K4), the G-buffer's camera trace and its first PSR-chain
    trace with an active lane (the chain casts no ray where no pixel sees
    a pure-delta surface), the path loop's first NEE trace that casts a
    ray and the ReSTIR visibility trace. Under the exact alpha test the
    visibility traces are the re-queue's first closest trace of a
    trace_visibility call that casts a ray. A two-level trace is one
    launch, a single-BVH8 trace one K5 launch."""
    from rtxpt_tpu_torch.ops import bvh, bvh2l
    name = "trace_bvh8_2l" if isinstance(r.accel, bvh2l.BVH8TwoLevel) \
        else "trace_bvh8" if isinstance(r.accel, bvh.BVH8) \
        else "trace_dense_fused"
    stable = r.cfg.use_stable_planes
    shade = "shade_nee_fill" if stable else "shade_nee"
    exact = r.cfg.exact_alpha_test
    vis = "busy_visibility" if exact else "busy_anyhit"
    with Capture({name: 1 if stable else 3},
                 during=("build" if stable else "gbuffer",)) as primary, \
            Capture({"gather_rows": 16, "gather_surface": 1, shade: 1},
                    during=("fill",)) as first, \
            Capture({name: 1}, during=("fill", vis)) as nee, \
            Capture({name: 1}, during=("restir", vis)) as restir:
        r.render_frame(w, h, **(frame_kw or {}))
        torch.cuda.synchronize()
    calls = primary.calls[name]
    require(calls, "no primary trace captured")
    traces = [("BUILD camera" if stable else "G-buffer camera", calls[0],
               False)]
    chain = [c for c in calls[1:] if bool(c[0][-1].any())]
    if chain:
        lanes = int(chain[0][0][-1].sum())
        print(f"PSR chain: the first chain trace with an active lane has "
              f"{lanes} of {w * h} lanes", flush=True)
        traces.append(("PSR chain", chain[0], False))
    elif not stable:
        print(f"PSR chain: no chain trace has an active lane ({len(calls)} "
              "G-buffer traces)", flush=True)
    traces += [("FILL NEE" if stable else "paths NEE",
                nee.calls[name][0] if nee.calls[name] else None, not exact),
               ("ReSTIR visibility",
                restir.calls[name][0] if restir.calls[name] else None,
                not exact)]
    return name, first, traces


def check_realtime_kernels(r, w, h, label, frame_kw=None,
                           lanes=None) -> dict:
    """Every kernel of a realtime path against its plain version on the
    launches capture_realtime_frame() records (K4 FILL, or K4 on
    PSR-lite, on all `lanes` lanes of the first bounce: by default w*h;
    a rank's rows on a mesh) -> {kernel name: result}."""
    name, first, traces = capture_realtime_frame(r, w, h, frame_kw)
    for what, call, any_hit in traces:
        require(call is not None, f"{label} {what}: no {name} call "
                "captured")
        require(call[1]["any_hit"] == any_hit,
                f"{label} {what}: the trace is not "
                f"{'any-hit' if any_hit else 'closest-hit'}")
    fill = r.cfg.use_stable_planes
    shade = "shade_nee_fill" if fill else "shade_nee"
    require(first.calls[shade], f"{label}: no {shade} launch")
    got = first.calls[shade][0][0][0].shape[1]
    lanes = w * h if lanes is None else lanes
    require(got == lanes, f"{label}: the first bounce's {shade} has "
            f"{got} lanes, not {lanes}")
    timed = [(what, call, True) for what, call, _ in traces]
    if name == "trace_dense_fused":
        out = check_dense(r.accel, timed, label)
    elif name == "trace_bvh8":
        out = check_k5_exact([(what, call) for what, call, _ in traces],
                             label)
    else:
        out = check_two_level(timed, label)
    out.update(check_surface_kernels(first, label, fill=fill))
    return out


def tensors_of(x) -> list:
    """The tensors of a result: a tensor, or those in its tuples."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, tuple):
        return [t for y in x for t in tensors_of(y)]
    return []


def check_denoiser_kernels(r, w, h, label, frame_kw=None) -> dict:
    """ReLAX's and TAA's kernels (csrc/relax.cu) on every call of their
    wrappers in one more frame of the realtime renderer `r` (render_frame's
    keywords `frame_kw`; after the timed frames, so most pixels hold four
    frames of history or more, past the variance pass's switch, and TAA a
    valid one): each call's launches counted (one a pass, one an a-trous
    iteration) and its outputs bit-equal to the plain version's on the
    captured inputs; the call's device time (CUDA events over 10 calls)
    beside the plain version's (CUDA events, one call) and the bound: its
    launches' bytes at 3.35 TB/s -> {launch counter: summed over the
    frame's calls}."""
    import importlib
    from rtxpt_tpu_torch.ops import cuda_lib
    with Capture(dict.fromkeys(DENOISER_CALLS, 64)) as cap:
        r.render_frame(w, h, **(frame_kw or {}))
        torch.cuda.synchronize()
    out = {}
    for name, counter in DENOISER_CALLS.items():
        mod = importlib.import_module(Capture.MODULES[name])
        for i, (args, kw) in enumerate(cap.calls[name]):
            kern = lambda: getattr(mod, name)(*args, **kw)
            plain = lambda: getattr(mod, name + "_plain")(*args, **kw)
            before = cuda_lib.launch_counts()[counter]
            got = tensors_of(kern())
            launches = cuda_lib.launch_counts()[counter] - before
            ref, pms = timed_call(plain)
            ref = tensors_of(ref)
            what = f"{counter} {label} call {i}"
            if name == "atrous_filter":
                roughness = kw.get("roughness",
                                   args[4] if len(args) > 4 else None)
                want = kw.get("iterations", args[5] if len(args) > 5 else 5)
                px_bytes = DENOISER_BYTES[name] + 4 * (roughness is not None)
            else:
                mask = kw.get("relax_mask") if name == "resolve" else None
                want = 1
                px_bytes = DENOISER_BYTES[name] + 4 * (mask is not None)
            require(launches == want, f"{what}: {launches} launches, "
                    f"expected {want}")
            require(len(got) == len(ref) and all(
                torch.equal(a, b) for a, b in zip(got, ref)),
                f"{what}: differs from the plain version")
            px = got[0].shape[0] * got[0].shape[1]
            nbytes = px * px_bytes * launches
            ms = time_ms(kern, 10)
            acc = out.setdefault(counter, dict(
                max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=None,
                bound_ms=0.0, bound_by="bytes", calls=0, launches=0,
                bytes=0))
            for key, v in (("ms", ms), ("plain_ms", pms),
                           ("bound_ms", bound(nbytes, 0)[0]), ("calls", 1),
                           ("launches", launches), ("bytes", nbytes)):
                acc[key] += v
    for counter, acc in out.items():
        print(f"{counter} {label}: {acc['calls']} calls of a frame, "
              f"{acc['launches']} launches, bit-equal to the plain version; "
              f"kernel {acc['ms']:.4f} ms, plain {acc['plain_ms']:.4f} ms, "
              f"bound {acc['bound_ms']:.4f} ms ({acc['bytes'] / 1e6:.1f} MB)",
              flush=True)
    return out


def realtime_frames(r, w, h, label, card, path, warmups=2,
                    frames=3, frame_kw=None, before=None) -> dict:
    """`warmups` frames (the no-history and the history variant: 2 from a
    new renderer), then `frames` timed frames (render_frame's keywords
    `frame_kw`) with the launch counters set to 0 just before, each
    ending in a device synchronize; requires the kernels of `path` to
    have launched (its ONE_LAUNCH kernel once per trace call:
    `bvh8_trace_2l` on a two-level path, and no K5 or K6; `mt_dense_fused`
    on a dense one, and no K1 or K7; K4 FILL once per bounce on stable
    planes, K4 on PSR-lite, and the other not at all) and the last frame
    to be finite and not black, at the display size where `frame_kw`
    asks for one. `before(i)`, where given, runs before frame i (warm-ups
    included) and returns its own seconds, printed beside the frames.
    Returns the counts."""
    from rtxpt_tpu_torch.ops import cuda_lib
    frame_kw = frame_kw or {}
    fill = r.cfg.use_stable_planes
    shade = "shade_nee_fill" if fill else "shade_nee"
    for i in range(warmups):
        if before is not None:
            before(i)
        r.render_frame(w, h, **frame_kw)
        torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    walls, fills, extra = [], [], []
    kernel = next(k for k in ONE_LAUNCH if k in path)
    with TraceCalls(ONE_LAUNCH[kernel][0]) as tc, SurfaceCalls() as sc, \
            ShadeCalls() as shc:
        for i in range(frames):
            if before is not None:
                extra.append(before(warmups + i) * 1e3)
            t0 = time.perf_counter()
            img = r.render_frame(w, h, **frame_kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            fills.append(cuda_lib.launch_counts()[shade] - sum(fills))
    counts = cuda_lib.launch_counts()
    out = img.cpu().numpy()
    dw, dh = frame_kw.get("display_size", (w, h))
    require(out.shape == (dh, dw, 3) and np.isfinite(out).all()
            and out.mean() > 0.0, f"realtime {label}: bad frame")
    ms = [x * 1e3 for x in walls]
    print(f"realtime {label} {w}x{h}"
          f"{f' -> {dw}x{dh}' if (dw, dh) != (w, h) else ''}: "
          f"{sum(ms) / len(ms):.1f} ms/frame (frames "
          f"{', '.join(f'{x:.1f}' for x in ms)} ms; "
          f"{'FILL ' if fill else ''}bounces {fills})"
          + (f", before each frame {', '.join(f'{x:.1f}' for x in extra)} "
             "ms (not in the frames)" if extra else "")
          + f" on {card}; {tc.n} "
          f"trace calls, {sc.n} load_surface calls, {shc.n} bounces; "
          f"launches over {frames} frames {counts}", flush=True)
    for name in path:
        require(counts[KERNELS[name][0]] > 0,
                f"{name} was not launched on the realtime {label} path")
    require_one_launch_per_trace(counts, tc.n, f"realtime {label}", kernel)
    require_one_surface_fetch(counts, sc.n, f"realtime {label}")
    require_one_shade_per_bounce(counts, shc.n, f"realtime {label}",
                                 fill=fill)
    return {name: counts.get(KERNELS[name][0], 0) for name in KERNELS}


def realtime(results: dict, card: str, host_city, kept: dict) -> dict:
    """The realtime phase (7.); returns the launch counts of its timed
    frames by path, and keeps the 1080p city's last stable-planes frame
    for phase 15's views in kept["stable"]."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.scene import procedural
    launches = {}
    # ---- the city at 1920x1080: K4 FILL on the first FILL bounce, then
    # the timed frames
    w, h = 1920, 1080
    t0 = time.perf_counter()
    r = RealtimeRenderer(host_city, procedural.city_camera(w, h),
                         device="cuda")
    torch.cuda.synchronize()
    print(f"realtime city: renderer built in {time.perf_counter() - t0:.2f}"
          " s", flush=True)
    results["realtime_city"].update(
        check_realtime_kernels(r, w, h, "realtime city"))
    torch.cuda.empty_cache()
    # the captured frame was the no-history warm-up
    launches["realtime_city"] = realtime_frames(r, w, h, "city", card,
                                                RT_CITY_PATH, warmups=1)
    results["realtime_city"].update(
        check_denoiser_kernels(r, w, h, "realtime city"))
    kept["stable"] = keep_stable(r)
    del r
    torch.cuda.empty_cache()

    # ---- programmer-art at 640x360 (the bench's realtime case)
    host = procedural.build_programmer_art().finish()
    w, h = 640, 360
    r = RealtimeRenderer(host, procedural.default_camera(w, h),
                         device="cuda")
    results["realtime_360p"].update(
        check_realtime_kernels(r, w, h, "realtime 360p"))
    launches["realtime_360p"] = realtime_frames(r, w, h, "programmer-art",
                                                card, RT_ART_PATH, warmups=1)
    results["realtime_360p"].update(
        check_denoiser_kernels(r, w, h, "realtime 360p"))

    # ---- the port on the card against the port on the CPU
    realtime_gpu_vs_cpu(host, "realtime")
    # ---- the estimator oracle (tests/test_ref_vs_realtime.py) on the card
    estimator_oracle(host, stable=True)
    return launches


def realtime_gpu_vs_cpu(host, what, cfg=None, frame_kw=None, w=64, h=48,
                        frames=2):
    """The port on the card against the port on the CPU: `frames` frames
    of a RealtimeRenderer (configuration `cfg`, None for its defaults;
    render_frame's keywords `frame_kw`) at w x h from each, the last
    tonemapped; PSNR > 40 dB."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.scene import procedural
    from rtxpt_tpu_torch.utils import image as IM
    imgs = []
    for device in ("cuda", "cpu"):
        rs = RealtimeRenderer(host, procedural.default_camera(w, h), cfg,
                              device=device)
        for _ in range(frames):
            img = rs.render_frame(w, h, **(frame_kw or {}))
        imgs.append(rs.tonemapped(img).cpu().numpy())
    require(np.isfinite(imgs[0]).all(), f"{what}: non-finite frame")
    m = IM.compare(imgs[0], imgs[1])
    dw, dh = (frame_kw or {}).get("display_size", (w, h))
    size = f"{w}x{h}" + (f" -> {dw}x{dh}" if (dw, dh) != (w, h) else "")
    print(f"{what} GPU vs CPU (plain) {size}, frame {frames}: PSNR "
          f"{m['psnr']:.2f} dB, SMAPE {m['smape']:.5f}", flush=True)
    require(m["psnr"] > PSNR_MIN, f"{what} GPU vs CPU: {m}")
    return m["psnr"]


def estimator_oracle(host, stable: bool):
    """tests/test_ref_vs_realtime.py on the card: the mean of 32
    ref-vs-realtime frames at 48x32 (PSR-lite, the test's configuration,
    or stable planes) against the port's 32-spp reference render; median
    block error < 0.25, means within 10%."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.models.renderer import (Renderer, realtime_config,
                                                 reference_config)
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    w, h, n = 48, 32, 32
    cam = procedural.default_camera(w, h)
    env = EM.bake_procedural_sky(height=32, sun_radiance=(40.0, 38.0, 33.0))
    common = dict(max_bounces=4, max_diffuse_bounces=3,
                  nee_distant_samples=1, nee_local_samples=1,
                  enable_russian_roulette=False)
    ref = Renderer(host, cam, reference_config(**common), env_radiance=env,
                   device="cuda").render(w, h, n, jitter_aa=False)
    rt = RealtimeRenderer(host, cam, realtime_config(
        use_restir_di=False, use_restir_gi=False, denoiser_enabled=False,
        realtime_noise=False, use_stable_planes=stable, **common),
        env_radiance=env, device="cuda")
    acc = torch.zeros((h, w, 3), device="cuda")
    for i in range(n):
        rt.frame_index = i
        acc += rt.render_frame(w, h, denoise=False, taa=False)
    ref, rt_img = ref.cpu().numpy(), (acc / n).cpu().numpy()
    blocks = lambda a: a.reshape(h // 8, 8, w // 8, 8, 3).mean((1, 3, 4))
    b_ref, b_rt = blocks(ref), blocks(rt_img)
    med = float(np.median(np.abs(b_ref - b_rt)
                          / (0.5 * (b_ref + b_rt) + 5e-2)))
    rel_mean = abs(ref.mean() - rt_img.mean()) / max(ref.mean(),
                                                     rt_img.mean())
    what = "stable planes" if stable else "PSR-lite"
    print(f"ref-vs-realtime ({what}) {w}x{h}, {n} frames vs {n} spp: "
          f"median block error {med:.4f} (< 0.25), means {ref.mean():.5f} / "
          f"{rt_img.mean():.5f} ({rel_mean:.3%}, < 10%)", flush=True)
    require(med < 0.25 and rel_mean < 0.10,
            f"ref-vs-realtime oracle ({what}) failed")


def realtime_pipelines(results: dict, card: str, host_city,
                       kept: dict) -> dict:
    """The realtime pipelines phase (8.): PSR-lite, TAAU and ReBLUR on
    the card; returns the launch counts of its timed frames by path, and
    keeps the 1080p PSR-lite city's last frame outputs for phase 15's
    views in kept["psr"]."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.models.renderer import (Renderer, realtime_config,
                                                 reference_config)
    from rtxpt_tpu_torch.denoise.offline import photo_denoise_auto
    from rtxpt_tpu_torch.post.tonemap import tonemap
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    from rtxpt_tpu_torch.utils import image as IM
    launches = {}
    restir = dict(use_restir_di=True, use_restir_gi=True,
                  denoiser_enabled=True)
    # the reference's realtime defaults with PSR-lite: 30 bounces / 3
    # diffuse, NEE 2+2
    psr = realtime_config(**restir, use_stable_planes=False)

    # ---- the city at 1920x1080, PSR-lite: the G-buffer's traces, the
    # path loop's first bounce (K4 at NEE 2+2 on every lane), its NEE
    # trace and the ReSTIR visibility trace, then the timed frames
    w, h = 1920, 1080
    r = RealtimeRenderer(host_city, procedural.city_camera(w, h), psr,
                         device="cuda")
    results["realtime_city_psr"].update(
        check_realtime_kernels(r, w, h, "realtime city PSR-lite"))
    torch.cuda.empty_cache()
    launches["realtime_city_psr"] = realtime_frames(
        r, w, h, "city PSR-lite", card, RT_CITY_PSR_PATH, warmups=1)
    results["realtime_city_psr"].update(
        check_denoiser_kernels(r, w, h, "realtime city PSR-lite"))
    kept["psr"] = dict(frame_outputs=r.last_outputs)
    del r
    torch.cuda.empty_cache()

    # ---- programmer-art at 640x360, PSR-lite: its mirror and glass
    # spheres chain, so the G-buffer's second trace casts rays
    host = procedural.build_programmer_art().finish()
    w, h = 640, 360
    r = RealtimeRenderer(host, procedural.default_camera(w, h), psr,
                         device="cuda")
    out = check_realtime_kernels(r, w, h, "realtime 360p PSR-lite")
    results["realtime_360p_psr"].update(out)
    launches["realtime_360p_psr"] = realtime_frames(
        r, w, h, "programmer-art PSR-lite", card, RT_ART_PSR_PATH,
        warmups=1)
    results["realtime_360p_psr"].update(
        check_denoiser_kernels(r, w, h, "realtime 360p PSR-lite"))
    del r

    # ---- the city rendered at 960x540 and upscaled by TAAU to 1920x1080
    # (bench.py:270-272), RealtimeRenderer defaults: its kernels at
    # 518,400 lanes
    w, h, display = 960, 540, dict(display_size=(1920, 1080))
    r = RealtimeRenderer(host_city, procedural.city_camera(w, h),
                         device="cuda")
    results["realtime_city_taau"].update(check_realtime_kernels(
        r, w, h, "realtime city TAAU", frame_kw=display))
    launches["realtime_city_taau"] = realtime_frames(
        r, w, h, "city TAAU", card, RT_CITY_TAAU_PATH, warmups=1,
        frame_kw=display)
    results["realtime_city_taau"].update(check_denoiser_kernels(
        r, w, h, "realtime city TAAU", frame_kw=display))
    del r
    torch.cuda.empty_cache()

    # ---- the city at 1920x1080 denoised by ReBLUR (stable planes). Its
    # stage 1, and so every kernel's inputs, is the realtime city's
    # (phase 7 holds those kernels there): no second capture
    w, h = 1920, 1080
    r = RealtimeRenderer(host_city, procedural.city_camera(w, h),
                         realtime_config(**restir, use_stable_planes=True,
                                         denoiser_method="reblur"),
                         device="cuda")
    launches["realtime_city_reblur"] = realtime_frames(
        r, w, h, "city ReBLUR", card, RT_CITY_REBLUR_PATH)
    del r
    torch.cuda.empty_cache()

    # ---- the new pipelines on the card against the CPU, 64x48
    realtime_gpu_vs_cpu(host, "PSR-lite", psr)
    # the CLI's --preset ref-vs-realtime --no-stable-planes
    realtime_gpu_vs_cpu(host, "PSR-lite ref-vs-realtime", realtime_config(
        use_stable_planes=False, nee_distant_samples=1,
        nee_local_samples=1), frame_kw=dict(taa=False))
    for stable in (True, False):
        realtime_gpu_vs_cpu(
            host, f"ReBLUR {'stable planes' if stable else 'PSR-lite'}",
            realtime_config(**restir, use_stable_planes=stable,
                            denoiser_method="reblur"))
    realtime_gpu_vs_cpu(host, "TAAU", None, dict(display_size=(64, 48)),
                        w=32, h=24)
    imgs = []
    for device in ("cuda", "cpu"):
        rr = Renderer(host, procedural.default_camera(64, 48),
                      reference_config(), device=device)
        hdr = photo_denoise_auto(rr, rr.render(64, 48, 2), 64, 48)
        imgs.append(tonemap(hdr).cpu().numpy())
    m = IM.compare(imgs[0], imgs[1])
    print(f"photo_denoise_auto GPU vs CPU (plain) 64x48, 2 spp: PSNR "
          f"{m['psnr']:.2f} dB, SMAPE {m['smape']:.5f}", flush=True)
    require(np.isfinite(imgs[0]).all() and m["psnr"] > PSNR_MIN,
            f"photo_denoise_auto GPU vs CPU: {m}")

    # ---- the estimator oracle in the reference's own configuration
    # (tests/test_ref_vs_realtime.py: PSR-lite); phase 7 runs it on
    # stable planes
    estimator_oracle(host, stable=False)

    # ---- the denoisers' quality (tests/test_denoise_quality.py): 4
    # frames at 64x48 against a 64-spp reference render
    w, h, peak = 64, 48, 4.0
    cam = procedural.default_camera(w, h)
    env = EM.bake_procedural_sky(height=32)
    truth = Renderer(host, cam, reference_config(
        max_bounces=4, max_diffuse_bounces=3, nee_distant_samples=1,
        nee_local_samples=1), env_radiance=env, device="cuda").render(
            w, h, 64).cpu().numpy()

    def psnr(img):
        a = np.clip(img, 0.0, peak)
        mse = float(np.mean((a - np.clip(truth, 0.0, peak)) ** 2))
        return 10.0 * np.log10(peak * peak / max(mse, 1e-12))

    for method in ("relax", "reblur"):
        db = []
        for denoise in (False, True):
            rt = RealtimeRenderer(host, cam, realtime_config(
                **restir, use_stable_planes=True, max_bounces=4,
                max_diffuse_bounces=3, denoiser_method=method),
                env_radiance=env, device="cuda")
            for _ in range(4):
                img = rt.render_frame(w, h, denoise=denoise, taa=False)
            db.append(psnr(img.cpu().numpy()))
        print(f"denoiser quality {method} {w}x{h}, frame 4: raw "
              f"{db[0]:.2f} dB -> denoised {db[1]:.2f} dB (> raw + 1.5 and "
              f"> 18)", flush=True)
        require(db[1] > db[0] + 1.5 and db[1] > 18.0,
                f"denoiser quality {method}: {db}")
    return launches


def leaf_textures(seed: int = 11) -> list:
    """The foliage's textures, made from `seed`: a 2048x2048 RGBA base
    color whose alpha holds leaf shapes (ellipses, wrapped; half the
    texels opaque), a 2048x2048 normal map and a 1024x1024 metal-rough
    map (uint8). The stack resamples them to its 1024x1024 cap."""
    rs = np.random.RandomState(seed)
    n = FOLIAGE_TEX // 4
    y, x = (np.mgrid[0:n, 0:n] + 0.5) / n
    field = np.zeros((n, n), np.float32)
    for _ in range(48):
        cx, cy = rs.uniform(0, 1, 2)
        rx = rs.uniform(0.03, 0.08)
        ry = rx * rs.uniform(1.8, 3.0)
        th = rs.uniform(0, np.pi)
        dx, dy = (x - cx + 0.5) % 1.0 - 0.5, (y - cy + 0.5) % 1.0 - 0.5
        u = dx * np.cos(th) + dy * np.sin(th)
        v = -dx * np.sin(th) + dy * np.cos(th)
        field = np.maximum(field, 1.0 - (u / rx) ** 2 - (v / ry) ** 2)
    up = lambda a, k: np.repeat(np.repeat(a, k, 0), k, 1)
    base = np.empty((FOLIAGE_TEX, FOLIAGE_TEX, 4), np.uint8)
    base[..., 0] = up(rs.randint(20, 90, (n, n)), 4)
    base[..., 1] = up(rs.randint(100, 220, (n, n)), 4)
    base[..., 2] = up(rs.randint(10, 50, (n, n)), 4)
    base[..., 3] = up(np.where(field > np.median(field), 255, 0), 4)
    g = up(rs.normal(0.0, 0.3, (n // 2, n // 2, 2)), 8)
    nrm = np.concatenate([g, np.ones(g.shape[:2] + (1,))], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = ((nrm * 0.5 + 0.5) * 255).astype(np.uint8)
    mr = np.zeros((FOLIAGE_TEX // 2, FOLIAGE_TEX // 2, 4), np.uint8)
    mr[..., 1] = up(rs.randint(80, 230, (n // 2, n // 2)), 4)
    mr[..., 3] = 255
    return [base, nrm, mr]


def leaf_cards(n: int, lo, hi, size: float, seed: int):
    """n square cards (2 triangles each) of edge `size`, centered
    uniformly in the box [lo, hi], randomly oriented, each with a quarter
    of the leaf texture -> (positions (4n,3), indices (2n,3), uvs
    (4n,2))."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(lo, hi, (n, 3))
    a = rs.normal(size=(n, 3))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b = np.cross(a, rs.normal(size=(n, 3)))
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    e1, e2 = a * size * 0.5, b * size * 0.5
    pos = np.stack([c - e1 - e2, c + e1 - e2, c + e1 + e2, c - e1 + e2], 1)
    o = rs.randint(0, 4, (n, 1, 2)) * 0.25
    uv = o + np.asarray([[0, 0], [0.25, 0], [0.25, 0.25], [0, 0.25]])
    q = 4 * np.arange(n)[:, None]
    idx = np.concatenate([q + [0, 1, 2], q + [0, 2, 3]], 1).reshape(-1, 3)
    return (pos.reshape(-1, 3).astype(np.float32), idx.astype(np.int32),
            uv.reshape(-1, 2).astype(np.float32))


def add_foliage(sb, n, lo, hi, size, seed):
    """n alpha-MASK leaf cards (leaf_cards) with the leaf material: base
    color + alpha (texture 0), normal map (1), metal-rough (2)."""
    from rtxpt_tpu_torch.scene.build import Mesh
    leaf = sb.add_material(base_color=(1.0, 1.0, 1.0), roughness=1.0,
                           alpha_mode=1, alpha_cutoff=0.5, base_tex=0,
                           normal_tex=1, metal_rough_tex=2)
    pos, idx, uv = leaf_cards(n, lo, hi, size, seed)
    sb.add_instance(sb.add_mesh(Mesh(positions=pos, indices=idx, uvs=uv)),
                    material_override=leaf)


def foliage_host(scene: str) -> dict:
    """"programmer-art": programmer-art and 1,500 leaf cards in the
    default camera's view (8,160 triangles: the dense tier); "city":
    build_city() and 20,000 cards along the camera's street (444,186
    triangles: two-level)."""
    from rtxpt_tpu_torch.scene import procedural
    if scene == "programmer-art":
        sb = procedural.build_programmer_art()
        add_foliage(sb, FOLIAGE_CARDS, (-2.5, 0.1, -2.5), (3.5, 2.4, 3.5),
                    0.3, 21)
    else:
        sb = procedural.build_city()
        add_foliage(sb, CITY_CARDS, (-6.0, 0.5, -6.0), (50.0, 9.0, 56.0),
                    1.2, 22)
    host = sb.finish()
    host["texture_images"] = leaf_textures()
    host["texture_srgb"] = [True, False, False]
    return host


class VisStats:
    """Collects the exact alpha test's counts (pt/visibility.py
    `trace_visibility(stats=)`) over every visibility trace while
    active."""

    def __enter__(self):
        from rtxpt_tpu_torch.pt import visibility
        self.mod, self.orig, self.stats = visibility, \
            visibility.trace_visibility, {}

        def counted(*args, **kw):
            return self.orig(*args, stats=self.stats, **kw)
        visibility.trace_visibility = counted
        return self

    def __exit__(self, *exc):
        self.mod.trace_visibility = self.orig

    def line(self) -> str:
        s = self.stats
        require(s.get("lanes", 0) > 0, "no exact visibility trace ran")
        return (f"exact alpha test: {s['lanes']} visibility lanes, "
                f"{s['requeued']} re-queued "
                f"({s['requeued'] / s['lanes']:.4%}), {s['unresolved']} "
                f"unresolved after the re-queue's last trace")


def check_dense_omm(traces, label, masked=True) -> dict:
    """On captured dense traces of a masked table (masked=False: of an
    unmasked one) [(what, (args, kw) of trace_dense_fused, timed)]: the
    fused launch with its OMM channel (masked) against the plain version
    over all clusters with the masks: closest,
    the same slot and the same t bits on every lane; any-hit, the same
    occlusion flag on every lane (its slot is the first hit in visit
    order), with the masks the trace's rows carry; kernel and plain
    times and the bound (fused_work, the mask test counted) summed over
    the timed traces -> {"mt_dense_fused": result}."""
    from rtxpt_tpu_torch.ops import mt_dense as M
    ms = pms = nbytes = ops = 0.0
    for what, (args, kw), timed in traces:
        aabb_c, tri12, o_c, d, tmax, act = args
        require(bool(kw.get("omm") and M.has_masks(tri12)) == masked,
                f"{label} {what}: the trace's masks are not as expected")
        omm = M.omm_from_tri12(tri12) if masked else None
        lanes = int(act.sum())
        require(lanes > 0, f"{label} {what}: no active lane")

        def plain():
            return M.trace_dense_plain(aabb_c, M.tri9_from_tri12(tri12), o_c,
                                       d, tmax, act, kw["any_hit"],
                                       omm=omm)
        t_p, s_p = plain()
        t_k, s_k = M.trace_dense_fused(*args, **kw)
        torch.cuda.synchronize()
        if kw["any_hit"]:
            differ = int(((s_k >= 0) != (s_p >= 0)).sum())
            kind = "occlusion flag"
        else:
            differ = int(((s_k != s_p) | (t_k.view(torch.int32)
                                          != t_p.view(torch.int32))).sum())
            kind = "slot and t bits"
        hits = int((s_k >= 0).sum())
        line = (f"mt_dense_fused{' OMM' if masked else ''} {label} {what}: "
                f"{o_c.shape[0]} lanes, "
                f"{lanes} active, {hits} hits; {kind} differ from the "
                f"plain version's on {differ} lanes")
        require(differ == 0, line)
        if timed:
            k_ms = time_ms(lambda: M.trace_dense_fused(*args, **kw), 20)
            p_ms = time_ms(plain, 1, warmup=False)
            wl = M.tile_worklists(aabb_c, o_c, d, tmax, act)
            nb, op = fused_work(args, kw, t_k, s_k, wl)
            line += (f"; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                     f"{bound(nb, op)[0]:.4f} ms ({bound(nb, op)[1]})")
            ms, pms, nbytes, ops = ms + k_ms, pms + p_ms, nbytes + nb, \
                ops + op
        print(line, flush=True)
    b_ms, b_by = bound(nbytes, ops)
    return {"mt_dense_fused": dict(max_abs_err=0.0, ms=ms, plain_ms=pms,
                                   library_ms=None, bound_ms=b_ms,
                                   bound_by=b_by)}


def gpu_vs_cpu(host, cam_fn, cfg, w, h, spp, what):
    """The port's render of `host` on the card against its plain versions
    on the CPU (tonemapped): PSNR > 40 dB."""
    from rtxpt_tpu_torch.models.renderer import Renderer
    from rtxpt_tpu_torch.scene import envmap as EM
    from rtxpt_tpu_torch.utils import image as IM
    imgs = []
    for device in ("cuda", "cpu"):
        r = Renderer(host, cam_fn(w, h), cfg,
                     env_radiance=EM.bake_procedural_sky(height=64),
                     device=device)
        imgs.append(r.tonemapped(r.render(w, h, spp)).cpu().numpy())
    require(np.isfinite(imgs[0]).all(), f"{what}: non-finite image")
    m = IM.compare(imgs[0], imgs[1])
    print(f"{what} GPU vs CPU (plain) {w}x{h} {spp}spp: PSNR "
          f"{m['psnr']:.2f} dB, SMAPE {m['smape']:.5f}", flush=True)
    require(m["psnr"] > PSNR_MIN, f"{what} GPU vs CPU render: {m}")


def foliage_dense(results: dict, card: str) -> dict:
    """The foliage dense phase (9.); returns the launch counts of its
    timed render."""
    import dataclasses
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.ops import mt_dense
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    w, h, spp = BENCH_SIZE
    cfg = reference_config(**BENCH_CFG)
    env = EM.bake_procedural_sky(height=64)
    t0 = time.perf_counter()
    host = foliage_host("programmer-art")
    geometry_s = time.perf_counter() - t0
    r = Renderer(host, procedural.default_camera(w, h), cfg,
                 env_radiance=env, device="cuda")
    torch.cuda.synchronize()
    tex = r.scene.textures
    require(isinstance(r.accel, mt_dense.DenseMT) and r.accel.has_omm
            and r.cfg.exact_alpha_test, "foliage dense: not a masked dense "
            "table with the exact alpha test")
    print(f"foliage dense: {host['indices'].shape[0]} triangles "
          f"({r.accel.num_clusters} clusters), texel pool "
          f"{tex.pool.numel() * 4 / 1e6:.1f} MB, host build "
          f"{time.perf_counter() - t0:.2f} s (geometry and textures "
          f"{geometry_s:.2f} s)", flush=True)

    # the kernels on the first bounce: the camera trace and the exact
    # alpha test's first and second visibility traces (closest, masked)
    with Capture(dict(FIRST_BOUNCE, trace_dense_fused=3)) as cap:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()
    calls = cap.calls["trace_dense_fused"]
    require(len(calls) == 3 and not any(kw["any_hit"] for _, kw in calls),
            "foliage dense: the first traces are not closest")
    traces = [("camera", calls[0], True),
              ("NEE exact alpha, first trace", calls[1], True),
              ("NEE exact alpha, re-queue", calls[2], False)]
    # the masks alone (exact_alpha_test=False): the any-hit OMM channel
    r_any = Renderer(host, procedural.default_camera(w, h),
                     dataclasses.replace(cfg, exact_alpha_test=False),
                     env_radiance=env, device="cuda")
    with Capture({"trace_dense_fused": 2}) as cap_any:
        r_any.render_sample(w, h, 0)
        torch.cuda.synchronize()
    anyhit = [c for c in cap_any.calls["trace_dense_fused"]
              if c[1]["any_hit"]]
    require(anyhit, "foliage dense: no any-hit trace captured")
    traces.append(("NEE any-hit, masks alone", anyhit[0], True))
    results["foliage_dense"].update(check_dense_omm(traces,
                                                    "foliage dense"))
    results["foliage_dense"].update(check_surface_kernels(
        cap, "foliage dense"))
    del cap, cap_any, calls, traces, anyhit

    # the main path, after a warm-up render that counts the re-queue
    with VisStats() as vs:
        r.render(w, h, spp)
        torch.cuda.synchronize()
    print(f"foliage dense warm-up render: {vs.line()}", flush=True)
    r.reset_accumulation()
    out, wall, counts, tc, sc, shc = counted_render(
        r, w, h, spp, ONE_LAUNCH["mt_dense_fused"][0])
    print(f"foliage dense {w}x{h} {spp}spp NEE 1+1, 6 bounces: "
          f"{wall * 1e3:.1f} ms wall, {w * h * spp / wall / 1e6:.3f} "
          f"Mpaths/s on {card}; {tc.n} dense traces, {sc.n} load_surface "
          f"calls, {shc.n} bounces; launches {counts}", flush=True)
    for name in FOLIAGE_PATH:
        require(counts[KERNELS[name][0]] > 0,
                f"{name} was not launched on the foliage dense path")
    require_one_launch_per_trace(counts, tc.n, "foliage dense",
                                 "mt_dense_fused")
    require_one_surface_fetch(counts, sc.n, "foliage dense")
    require_one_shade_per_bounce(counts, shc.n, "foliage dense")

    # the masks alone over-darken: the exact test's image differs
    exact_mean = float(out.mean())
    loose = r_any.render(w, h, spp).cpu().numpy()
    print(f"foliage dense image mean: exact alpha test {exact_mean:.6f}, "
          f"masks alone {float(loose.mean()):.6f}", flush=True)
    require(np.isfinite(loose).all() and float(loose.mean()) != exact_mean,
            "foliage dense: the masks alone give the exact test's image")
    del r, r_any
    torch.cuda.empty_cache()
    gpu_vs_cpu(host, procedural.default_camera, cfg, 64, 48, 2,
               "foliage dense")
    return {name: counts.get(KERNELS[name][0], 0) for name in KERNELS}


def city_foliage(results: dict, card: str) -> dict:
    """The city foliage phase (10.); returns the launch counts of its
    timed render and realtime frames by path."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.ops import bvh2l
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    w, h, spp = CITY_SIZE
    cfg = reference_config(**BENCH_CFG)
    env = EM.bake_procedural_sky(height=64)
    t0 = time.perf_counter()
    host = foliage_host("city")
    geometry_s = time.perf_counter() - t0
    r = Renderer(host, procedural.city_camera(w, h), cfg, env_radiance=env,
                 device="cuda")
    torch.cuda.synchronize()
    tl = r.accel
    require(isinstance(tl, bvh2l.BVH8TwoLevel) and r.cfg.exact_alpha_test
            and bool((tl.sub_leaf_omm != 0xFFFF).any()),
            "city foliage: not a masked two-level table")
    print(f"city foliage: {host['indices'].shape[0]} triangles, two-level "
          f"BVH8 K={tl.num_subtrees} S={tl.rows}, host build "
          f"{time.perf_counter() - t0:.2f} s (geometry and textures "
          f"{geometry_s:.2f} s)", flush=True)
    with Capture(dict(FIRST_BOUNCE, trace_bvh8_2l=2)) as cap:
        r.render_sample(w, h, 0)
        torch.cuda.synchronize()
    traces = cap.calls["trace_bvh8_2l"]
    require(len(traces) == 2 and not any(kw["any_hit"] for _, kw in traces),
            "city foliage: the first traces are not closest")
    results["city_foliage"].update(check_two_level(
        [("camera", traces[0], True),
         ("NEE exact alpha, first trace", traces[1], True)],
        "city foliage"))
    results["city_foliage"].update(check_surface_kernels(cap,
                                                         "city foliage"))
    del cap, traces
    with VisStats() as vs:
        r.render(w, h, spp)                  # warm-up
        torch.cuda.synchronize()
    print(f"city foliage warm-up render: {vs.line()}", flush=True)
    r.reset_accumulation()
    out, wall, counts, tc, sc, shc = counted_render(
        r, w, h, spp, ONE_LAUNCH["bvh8_trace_2l"][0])
    print(f"city foliage {w}x{h} {spp}spp NEE 1+1, 6 bounces: "
          f"{wall * 1e3:.1f} ms wall, {w * h * spp / wall / 1e6:.3f} "
          f"Mpaths/s on {card}; {tc.n} two-level traces, {sc.n} "
          f"load_surface calls, {shc.n} bounces; launches {counts}",
          flush=True)
    for name in CITY_PATH:
        require(counts[KERNELS[name][0]] > 0,
                f"{name} was not launched on the city foliage path")
    require_one_launch_per_trace(counts, tc.n, "city foliage")
    require_one_surface_fetch(counts, sc.n, "city foliage")
    require_one_shade_per_bounce(counts, shc.n, "city foliage")
    launches = {"city_foliage": {name: counts.get(KERNELS[name][0], 0)
                                 for name in KERNELS}}
    del r
    torch.cuda.empty_cache()
    # 3 realtime frames of the default pipeline after the two warm-ups
    rr = RealtimeRenderer(host, procedural.city_camera(w, h), device="cuda")
    require(rr.cfg.exact_alpha_test, "realtime city foliage: no exact test")
    # the kernels on the no-history warm-up frame's inputs
    with VisStats() as vs:
        results["realtime_city_foliage"].update(check_realtime_kernels(
            rr, w, h, "realtime city foliage"))
    print(f"realtime city foliage, first frame: {vs.line()}", flush=True)
    torch.cuda.empty_cache()
    launches["realtime_city_foliage"] = realtime_frames(
        rr, w, h, "city foliage", card, RT_CITY_PATH, warmups=1)
    results["realtime_city_foliage"].update(
        check_denoiser_kernels(rr, w, h, "realtime city foliage"))
    del rr
    torch.cuda.empty_cache()
    gpu_vs_cpu(host, procedural.city_camera, cfg, 64, 36, 1, "city foliage")
    return launches


def bc1_solid(img: np.ndarray) -> bytes:
    """A DDS file of (H,W,>=3) uint8 `img` (H, W multiples of 4) as BC1:
    each 4x4 block one color (its mean, RGB 565; c0 == c1, every index
    0)."""
    h, w = img.shape[:2]
    m = img[..., :3].reshape(h // 4, 4, w // 4, 4, 3).mean((1, 3))
    c = ((np.round(m[..., 0] * 31 / 255).astype(np.uint16) << 11)
         | (np.round(m[..., 1] * 63 / 255).astype(np.uint16) << 5)
         | np.round(m[..., 2] * 31 / 255).astype(np.uint16))
    blocks = np.zeros((h // 4, w // 4, 4), np.uint16)
    blocks[..., 0] = blocks[..., 1] = c
    hdr = bytearray(128)
    hdr[0:4] = b"DDS "
    for off, v in ((4, 124), (8, 0x1007), (12, h), (16, w), (76, 32),
                   (80, 0x4)):
        hdr[off:off + 4] = int(v).to_bytes(4, "little")
    hdr[84:88] = b"DXT1"
    return bytes(hdr) + blocks.astype("<u2").tobytes()


def write_foliage_gltf(folder: str) -> str:
    """A .scene.json in `folder` whose model is a .gltf of the 1,500 leaf
    cards over a floor, its base color + alpha one PNG and its
    metal-rough one BC1 .dds; returns its path."""
    import base64
    import os
    from rtxpt_tpu_torch.utils import image as IM
    base, _, mr = leaf_textures()
    with open(os.path.join(folder, "leaf.png"), "wb") as f:
        f.write(IM.encode_png_uint8(base))
    with open(os.path.join(folder, "leaf_mr.dds"), "wb") as f:
        f.write(bc1_solid(mr))
    pos, idx, uv = leaf_cards(FOLIAGE_CARDS, (-2.5, 0.1, -2.5),
                              (3.5, 2.4, 3.5), 0.3, 21)
    floor_p = np.asarray([[-6, 0, -6], [6, 0, -6], [6, 0, 6], [-6, 0, 6]],
                         np.float32)
    floor_i = np.asarray([[0, 2, 1], [0, 3, 2]], np.uint32)
    floor_uv = np.asarray([[0, 0], [4, 0], [4, 4], [0, 4]], np.float32)
    arrays = [pos, uv, idx.astype(np.uint32), floor_p, floor_uv, floor_i]
    views, acc, blob = [], [], b""
    for a in arrays:
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": a.nbytes})
        vec = {3: "VEC3", 2: "VEC2"}[a.shape[1]] \
            if a.dtype == np.float32 else "SCALAR"
        acc.append({"bufferView": len(views) - 1, "count":
                    a.shape[0] if vec != "SCALAR" else a.size,
                    "componentType": 5126 if a.dtype == np.float32
                    else 5125, "type": vec})
        if a.dtype == np.float32 and a.shape[1] == 3:
            acc[-1].update(min=a.min(0).tolist(), max=a.max(0).tolist())
        blob += a.tobytes()
    doc = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0, 1]}],
        "nodes": [{"mesh": 0}, {"mesh": 1}],
        "meshes": [{"primitives": [{"attributes": {
            "POSITION": 0, "TEXCOORD_0": 1}, "indices": 2, "material": 0}]},
            {"primitives": [{"attributes": {
                "POSITION": 3, "TEXCOORD_0": 4}, "indices": 5,
                "material": 1}]}],
        "materials": [
            {"pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 1},
                "metallicFactor": 0.0},
             "alphaMode": "MASK", "alphaCutoff": 0.5, "doubleSided": True},
            {"pbrMetallicRoughness": {
                "baseColorFactor": [0.6, 0.55, 0.5, 1.0],
                "metallicFactor": 0.0, "roughnessFactor": 0.9}}],
        "textures": [{"source": 0}, {"source": 1}],
        "images": [{"uri": "leaf.png"}, {"uri": "leaf_mr.dds"}],
        "accessors": acc, "bufferViews": views,
        "buffers": [{"byteLength": len(blob),
                     "uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(blob).decode()}]}
    with open(os.path.join(folder, "foliage.gltf"), "w") as f:
        json.dump(doc, f)
    path = os.path.join(folder, "foliage.scene.json")
    with open(path, "w") as f:
        json.dump({"models": ["foliage.gltf"],
                   "environment": {"type": "procedural-sky"},
                   "camera": {"position": [4.2, 2.6, 4.6],
                              "target": [0.0, 0.7, 0.0],
                              "fov_y_degrees": 55.0},
                   "settings": dict(BENCH_CFG)}, f)
    return path


def gltf_scene(results: dict, card: str) -> dict:
    """The glTF loader phase (11.); returns the launch counts of its
    800x600 8-spp CLI render."""
    import tempfile
    from rtxpt_tpu_torch.app import cli
    from rtxpt_tpu_torch.ops import cuda_lib
    from rtxpt_tpu_torch.post.tonemap import tonemap
    from rtxpt_tpu_torch.utils import image as IM
    w, h, spp = BENCH_SIZE
    with tempfile.TemporaryDirectory() as folder:
        path = write_foliage_gltf(folder)
        out = f"{folder}/gltf.png"
        # the kernels on a 1-spp CLI render's first bounce: the camera
        # trace and the exact alpha test's first trace (closest, masked)
        with Capture(dict(FIRST_BOUNCE, trace_dense_fused=2)) as cap:
            require(cli.main(["--scene", path, "--width", str(w),
                              "--height", str(h), "--spp", "1", "--device",
                              "cuda", "--output", out, "--quiet"]) == 0,
                    "glTF scene: CLI failed")
            torch.cuda.synchronize()
        calls = cap.calls["trace_dense_fused"]
        require(len(calls) == 2 and not any(kw["any_hit"]
                                            for _, kw in calls),
                "glTF scene: the first traces are not closest")
        results["gltf_scene"].update(check_dense_omm(
            [("camera", calls[0], True),
             ("NEE exact alpha, first trace", calls[1], True)],
            "glTF scene"))
        results["gltf_scene"].update(check_surface_kernels(cap,
                                                           "glTF scene"))
        del cap, calls
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        with TraceCalls(ONE_LAUNCH["mt_dense_fused"][0]) as tc, \
                SurfaceCalls() as sc, ShadeCalls() as shc:
            t0 = time.perf_counter()
            rc = cli.main(["--scene", path, "--width", str(w), "--height",
                           str(h), "--spp", str(spp), "--device", "cuda",
                           "--output", out, "--dump-npy",
                           f"{folder}/gltf.npy", "--quiet"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = cuda_lib.launch_counts()
        hdr = np.load(f"{folder}/gltf.npy")
        require(rc == 0 and hdr.shape == (h, w, 3) and np.isfinite(hdr).all()
                and hdr.mean() > 0.0, "glTF scene: bad CLI render")
        print(f"glTF scene through the CLI (--scene .scene.json, .gltf, "
              f"PNG + BC1 DDS) {w}x{h} {spp}spp on {card}: "
              f"{wall * 1e3:.1f} ms wall from the command (loading and "
              f"builds included), image mean {float(hdr.mean()):.6f}; "
              f"{tc.n} dense traces, {sc.n} load_surface calls, {shc.n} "
              f"bounces; launches {counts}", flush=True)
        for name in FOLIAGE_PATH:
            require(counts[KERNELS[name][0]] > 0,
                    f"{name} was not launched on the glTF scene path")
        require_one_launch_per_trace(counts, tc.n, "glTF scene",
                                     "mt_dense_fused")
        require_one_surface_fetch(counts, sc.n, "glTF scene")
        require_one_shade_per_bounce(counts, shc.n, "glTF scene")
        # the CLI's HDR renders (--dump-npy) on both devices, tonemapped
        # alike, as gpu_vs_cpu compares the Renderer's
        hdrs = []
        for device in ("cuda", "cpu"):
            require(cli.main(["--scene", path, "--width", "64", "--height",
                              "48", "--spp", "2", "--device", device,
                              "--output", f"{folder}/{device}.png",
                              "--dump-npy", f"{folder}/{device}.npy",
                              "--quiet"]) == 0, "glTF scene: CLI failed")
            hdrs.append(np.load(f"{folder}/{device}.npy"))
        require(np.isfinite(hdrs[0]).all(), "glTF scene: non-finite HDR")
        imgs = [tonemap(torch.as_tensor(x), auto_expose=True).numpy()
                for x in hdrs]
        m = IM.compare(imgs[0], imgs[1])
        print(f"glTF scene GPU vs CPU (plain) 64x48 2spp, the CLI's HDR "
              f"tonemapped: PSNR {m['psnr']:.2f} dB, SMAPE "
              f"{m['smape']:.5f}; HDR values bit-equal "
              f"{int((hdrs[0] == hdrs[1]).sum())} of {hdrs[0].size}",
              flush=True)
        require(m["psnr"] > PSNR_MIN, f"glTF scene GPU vs CPU: {m}")
    return {name: counts.get(KERNELS[name][0], 0) for name in KERNELS}


def check_k5_exact(calls, label) -> dict:
    """K5 on captured calls [(what, (args, kw) of trace_bvh8)]: the kernel
    against its plain version, 0 lanes differing in slot and t bits
    (any-hit: in the occlusion flag); kernel (CUDA events, 20 launches)
    and plain times and the bound (bvh8_work, from the plain version's
    counts) summed -> {"bvh8_trace": result}."""
    from rtxpt_tpu_torch.ops import traverse_bvh8 as T8
    ms = pms = nbytes = ops = 0.0
    err = 0.0
    for what, (args, kw) in calls:
        act = args[-1]
        lanes = int(act.sum())
        stats = {}
        t_k, s_k, uv_k = T8.trace_bvh8(*args, **kw)
        (t_p, s_p, uv_p), p_ms = timed_call(
            lambda: T8.trace_bvh8_plain(*args, **kw, stats=stats))
        if kw["any_hit"]:
            differ = int(((s_k >= 0) != (s_p >= 0)).sum())
            kind = "occlusion flag"
        else:
            differ = int(((s_k != s_p) | (t_k.view(torch.int32)
                                          != t_p.view(torch.int32))).sum())
            kind = "slot and t bits"
            m = s_k >= 0
            if bool(m.any()):
                err = max(err, float((uv_k - uv_p)[m].abs().max()))
        k_ms = time_ms(lambda: T8.trace_bvh8(*args, **kw), 20)
        nb, op = bvh8_work(args, stats, False)
        b_ms, b_by = bound(nb, op)
        line = (f"bvh8_trace {label} {what}: 1 launch over {act.numel()} "
                f"lanes, {lanes} active, {int((s_k >= 0).sum())} hits; "
                f"{kind} differ from the plain version's on {differ} "
                f"lanes; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}); the plain walk visited "
                f"{stats['node_rows']} node rows and {stats['leaf_tris']} "
                "leaf triangles")
        print(line, flush=True)
        require(differ == 0 and lanes > 0, line)
        ms, pms, nbytes, ops = ms + k_ms, pms + p_ms, nbytes + nb, ops + op
    b_ms, b_by = bound(nbytes, ops)
    return {"bvh8_trace": dict(max_abs_err=err, ms=ms, plain_ms=pms,
                               library_ms=None, bound_ms=b_ms,
                               bound_by=b_by)}


def check_refit(rest, posed, positions, indices, label):
    """A BVH8 refit on the card against the same refit on the CPU: `rest`
    is the table before posing (a CPU copy), `posed` the card's refitted
    one, `positions` the card's posed vertices; tables bit-equal. Every
    leaf's triangles must lie inside its parent slot's box."""
    from rtxpt_tpu_torch.scene import animation as AN
    t0 = time.perf_counter()
    cpu = AN.refit_bvh8(rest, positions.cpu(), indices.cpu())
    cpu_s = time.perf_counter() - t0
    gpu_ms = call_ms(lambda: AN.refit_bvh8(posed, positions, indices), 5)
    differ = int((cpu.table != posed.table.cpu()).sum())
    table, nn, ls = posed.table, posed.num_nodes, posed.leaf_size
    codes = table[:nn, 48:56].long()
    node, slot = torch.nonzero(codes < -1, as_tuple=True)
    leaf = (-codes[node, slot] - 1) >> 5
    tris = posed.leaf_tris.view(-1, ls)[leaf]                  # (L, ls)
    pts = positions[indices[tris.clamp(min=0)].long()]          # (L,ls,3,3)
    box = table[node, :48].view(-1, 8, 6)[
        torch.arange(node.numel(), device=table.device), slot]
    inside = ((pts >= box[:, None, None, :3])
              & (pts <= box[:, None, None, 3:])).all(-1).all(-1)
    outside = int((~inside & (tris >= 0)).sum())
    print(f"refit {label}: {table.shape[0]} rows ({nn} nodes); the card's "
          f"table differs from the CPU's refit of the same positions in "
          f"{differ} floats; {int((tris >= 0).sum())} leaf triangles, "
          f"{outside} outside their parent slot's box; refit "
          f"{gpu_ms:.3f} ms on the card (host clock), {cpu_s * 1e3:.1f} ms "
          "on the CPU", flush=True)
    require(differ == 0 and outside == 0, f"refit {label}: {differ} floats "
            f"differ, {outside} triangles outside their boxes")


def cli_gpu_vs_cpu(scene, folder, w, h, spp, what, extra=()):
    """The CLI's HDR (--dump-npy) of `scene` on the card against the CPU's
    (arguments `extra` on both), tonemapped alike: PSNR > 40 dB."""
    from rtxpt_tpu_torch.app import cli
    from rtxpt_tpu_torch.post.tonemap import tonemap
    from rtxpt_tpu_torch.utils import image as IM
    hdrs = []
    for device in ("cuda", "cpu"):
        out = f"{folder}/{device}_{w}x{h}"
        require(cli.main(["--scene", scene, "--width", str(w), "--height",
                          str(h), "--spp", str(spp), "--device", device,
                          "--output", out + ".png", "--dump-npy",
                          out + ".npy", "--quiet", *extra]) == 0,
                f"{what}: CLI failed on {device}")
        hdrs.append(np.load(out + ".npy"))
    require(np.isfinite(hdrs[0]).all() and hdrs[0].mean() > 0.0,
            f"{what}: bad HDR")
    imgs = [tonemap(torch.as_tensor(x), auto_expose=True).numpy()
            for x in hdrs]
    m = IM.compare(imgs[0], imgs[1])
    print(f"{what} GPU vs CPU (plain) {w}x{h} {spp}spp, the CLI's HDR "
          f"tonemapped: PSNR {m['psnr']:.2f} dB, SMAPE {m['smape']:.5f}; "
          f"HDR values bit-equal {int((hdrs[0] == hdrs[1]).sum())} of "
          f"{hdrs[0].size}", flush=True)
    require(m["psnr"] > PSNR_MIN, f"{what} GPU vs CPU: {m}")


def cli_counted(args, module, what, card, path) -> dict:
    """cli.main(args) with every launch counter set to 0 just before:
    requires the kernels of `path` to have launched, `module`'s trace
    calls one ONE_LAUNCH kernel each, one surface fetch per load_surface
    and one K4 per bounce; returns the counts."""
    from rtxpt_tpu_torch.app import cli
    from rtxpt_tpu_torch.ops import cuda_lib
    kernel = next(k for k in ONE_LAUNCH if k in path)
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    with TraceCalls(module) as tc, SurfaceCalls() as sc, \
            ShadeCalls() as shc:
        t0 = time.perf_counter()
        rc = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = cuda_lib.launch_counts()
    require(rc == 0, f"{what}: CLI failed")
    print(f"{what} through the CLI on {card}: {wall * 1e3:.1f} ms wall "
          f"from the command (loading, builds and animate included); "
          f"{tc.n} trace calls, {sc.n} load_surface calls, {shc.n} "
          f"bounces; launches {counts}", flush=True)
    for name in path:
        require(counts[KERNELS[name][0]] > 0,
                f"{name} was not launched on the {what} path")
    require_one_launch_per_trace(counts, tc.n, what, kernel)
    require_one_surface_fetch(counts, sc.n, what)
    require_one_shade_per_bounce(counts, shc.n, what)
    return {name: counts.get(KERNELS[name][0], 0) for name in KERNELS}


def bench_args(scene, w, h, spp, *extra):
    """The CLI's arguments for the bench configuration on --device cuda,
    the image written beside `scene`."""
    return ["--scene", scene, "--width", str(w), "--height", str(h),
            "--spp", str(spp), "--device", "cuda", "--max-bounces", "6",
            "--max-diffuse-bounces", "4", "--nee-distant-samples", "1",
            "--nee-local-samples", "1", "--output", scene + ".png",
            "--quiet", *extra]


def posed_renderer(scene, w, h, time_s, device="cuda", realtime=False):
    """(Renderer or RealtimeRenderer of the glTF `scene` in the bench
    configuration (realtime: the default pipeline), its glTF info, the
    trace structure before posing, the animate call's ms), posed at
    `time_s` seconds."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.scene import gltf
    host, info = gltf.load_gltf(scene)
    cam = gltf.camera_from_info(info, w, h)
    kw = dict(analytic_lights=gltf.analytic_lights_from_info(info),
              device=device)
    r = RealtimeRenderer(host, cam, **kw) if realtime else \
        Renderer(host, cam, reference_config(**BENCH_CFG), **kw)
    rest = r.accel
    ms = call_ms(lambda: r.animate(info, time_s), 1)
    return r, info, rest, ms


def skinned(results: dict, card: str) -> dict:
    """The skinned phase (12.); returns the launch counts of its main-path
    runs by path."""
    import dataclasses
    import tempfile
    from rtxpt_tpu_torch.ops import bvh, mt_dense
    from tools_torch import animated_scenes as AS
    launches = {}
    w, h, spp = BENCH_SIZE
    with tempfile.TemporaryDirectory() as folder:
        fig = AS.skinned_figure(f"{folder}/figure.gltf")
        fig_dense = AS.skinned_figure(f"{folder}/figure_dense.gltf",
                                      rings=128)
        # ---- the single-BVH8 tier: K5 on the posed first bounce, the
        # refit against the CPU's, then the 800x600 8-spp CLI render
        r, info, rest, a_ms = posed_renderer(fig, w, h, 0.5)
        require(isinstance(r.accel, bvh.BVH8), "skinned figure: not on the "
                "single-BVH8 tier")
        joints = len(info["skins"][0]["joints"])
        print(f"skinned figure: {r.scene.num_triangles} triangles, {joints} "
              f"joints, BVH8 of {r.accel.num_rows} rows; animate "
              f"{a_ms:.1f} ms (host clock: keyframes, skinning, tables, "
              f"refit, lights)", flush=True)
        check_refit(dataclasses.replace(
            rest, table=rest.table.cpu(), leaf_tris=rest.leaf_tris.cpu(),
            leaf_omm=rest.leaf_omm.cpu(), topology=None), r.accel,
            r.scene.positions, r.scene.indices, "skinned figure")
        animate_ms = call_ms(lambda: r.animate(info, 0.5), 5)
        print(f"skinned figure: animate {animate_ms:.2f} ms a call (host "
              "clock, mean of 5)", flush=True)
        with Capture(dict(FIRST_BOUNCE, trace_bvh8=2)) as cap:
            r.render_sample(w, h, 0)
            torch.cuda.synchronize()
        calls = cap.calls["trace_bvh8"]
        require([kw["any_hit"] for _, kw in calls] == [False, True],
                "skinned figure: the first traces are not camera, NEE")
        results["skinned_bvh8"].update(check_k5_exact(
            [("posed camera", calls[0]), ("posed NEE any-hit", calls[1])],
            "skinned figure"))
        results["skinned_bvh8"].update(check_surface_kernels(
            cap, "skinned figure"))
        del cap, calls, r, rest
        launches["skinned_bvh8"] = cli_counted(
            bench_args(fig, w, h, spp, "--animate-time", "0.5"),
            ONE_LAUNCH["bvh8_trace"][0], f"skinned figure {w}x{h} {spp}spp",
            card, SKINNED_BVH8_PATH)
        cli_gpu_vs_cpu(fig, folder, 64, 48, 2, "skinned figure posed",
                       ("--animate-time", "0.5"))

        # ---- the dense tier: the fused dense trace on refresh_dense's
        # planes
        r, info, rest, a_ms = posed_renderer(fig_dense, w, h, 0.5)
        require(isinstance(r.accel, mt_dense.DenseMT), "dense figure: not "
                "on the dense tier")
        require(not torch.equal(r.accel.aabb, rest.aabb),
                "dense figure: the cluster boxes did not move")
        print(f"dense figure: {r.scene.num_triangles} triangles; animate "
              f"{a_ms:.1f} ms", flush=True)
        with Capture(dict(FIRST_BOUNCE, trace_dense_fused=2)) as cap:
            r.render_sample(w, h, 0)
            torch.cuda.synchronize()
        calls = cap.calls["trace_dense_fused"]
        results["skinned_dense"].update(check_dense_omm(
            [("posed camera", calls[0], True),
             ("posed NEE any-hit", calls[1], True)], "dense figure",
            masked=False))
        results["skinned_dense"].update(check_surface_kernels(
            cap, "dense figure"))
        del cap, calls, r, rest
        launches["skinned_dense"] = cli_counted(
            bench_args(fig_dense, w, h, spp, "--animate-time", "0.5"),
            ONE_LAUNCH["mt_dense_fused"][0],
            f"dense figure {w}x{h} {spp}spp", card, SKINNED_DENSE_PATH)
        cli_gpu_vs_cpu(fig_dense, folder, 64, 48, 2, "dense figure posed",
                       ("--animate-time", "0.5"))

        # ---- realtime --animate at 1920x1080, the default pipeline
        rw, rh = SKINNED_RT_SIZE
        r, info, _, _ = posed_renderer(fig, rw, rh, 0.0, realtime=True)
        results["realtime_skinned"].update(
            check_realtime_kernels(r, rw, rh, "realtime skinned"))
        torch.cuda.empty_cache()

        def tick(i):
            t0 = time.perf_counter()
            r.animate(info, i / 60.0)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        launches["realtime_skinned"] = realtime_frames(
            r, rw, rh, "skinned figure --animate", card, RT_SKINNED_PATH,
            warmups=1, before=tick)
        results["realtime_skinned"].update(
            check_denoiser_kernels(r, rw, rh, "realtime skinned"))
        del r
        torch.cuda.empty_cache()
        # the realtime CLI's flags on the card
        from rtxpt_tpu_torch.app import cli
        require(cli.main(["--scene", fig, "--mode", "realtime", "--animate",
                          "--animate-fps", "30", "--spp", "3", "--width",
                          "320", "--height", "180", "--device", "cuda",
                          "--output", f"{folder}/rt.png", "--dump-npy",
                          f"{folder}/rt.npy", "--quiet"]) == 0
                and np.isfinite(np.load(f"{folder}/rt.npy")).all(),
                "skinned figure: the realtime CLI with --animate failed")
    return launches


class RoundCalls:
    """Counts the instanced TLAS's trace calls that cast at least one ray,
    their chunks and rounds (ops/instanced.py's `stats`), while active;
    keeps the arguments of the first closest-hit call in `first` (tl,
    origins, dirs, keywords)."""

    def __enter__(self):
        from rtxpt_tpu_torch.ops import instanced
        self.mod, self.n, self.stats, self.first = instanced, 0, {}, None
        self.orig = {name: getattr(instanced, name)
                     for name in ("trace_closest", "trace_anyhit")}
        for name, fn in self.orig.items():
            def counted(tl, origins, dirs, _fn=fn, _name=name, **kw):
                self.n += origins.shape[0] > 0
                if _name == "trace_closest" and self.first is None:
                    self.first = (tl, origins.clone(), dirs.clone(),
                                  {k: v.clone() if torch.is_tensor(v) else v
                                   for k, v in kw.items()})
                return _fn(tl, origins, dirs, stats=self.stats, **kw)
            setattr(instanced, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.mod, name, fn)


def instanced_city(results: dict, card: str) -> dict:
    """The instanced city phase (13.); returns the launch counts of its
    main-path render."""
    import tempfile
    from rtxpt_tpu_torch.app import cli
    from rtxpt_tpu_torch.models import renderer as R
    from rtxpt_tpu_torch.ops import cuda_lib, instanced
    from rtxpt_tpu_torch.scene import gltf
    from tools_torch import animated_scenes as AS
    w, h, spp = INSTANCED_SIZE
    with tempfile.TemporaryDirectory() as folder:
        t0 = time.perf_counter()
        city_file = AS.rigid_city(f"{folder}/city.gltf")
        still_file = AS.rigid_city(f"{folder}/city_still.gltf",
                                   animated=False)
        r, info, _, a_ms = posed_renderer(city_file, w, h, 0.5)
        tl = r.accel
        require(isinstance(tl, instanced.InstancedTL) and
                R.uses_instanced(r.host_scene),
                "instanced city: the gate did not pick the instanced TLAS")
        print(f"instanced city: {r.scene.num_triangles} triangles, "
              f"{tl.num_instances} instances of {tl.num_meshes} meshes "
              f"(BLASes of up to {tl.rows} rows), "
              f"{len(r.host_scene['animations'])} animated nodes; written, "
              f"loaded and built in {time.perf_counter() - t0:.1f} s; "
              f"animate {a_ms:.1f} ms", flush=True)
        animate_ms = call_ms(lambda: r.animate(info, 0.5), 5)
        print(f"instanced city: animate {animate_ms:.2f} ms a call (host "
              "clock, mean of 5)", flush=True)
        # one round's K5 launch (the camera trace's first) against its
        # plain version; the surface fetch, K2, K3 and K4 of the first
        # bounce; the camera trace timed whole, with its rounds
        with Capture(dict(FIRST_BOUNCE, trace_bvh8=1)) as cap, \
                RoundCalls() as rc:
            r.render_sample(w, h, 0)
            torch.cuda.synchronize()
        results["instanced_city"].update(check_k5_exact(
            [("camera, first round", cap.calls["trace_bvh8"][0])],
            "instanced city"))
        results["instanced_city"].update(check_surface_kernels(
            cap, "instanced city"))
        del cap
        print(f"instanced city 1-spp sample {w}x{h}: {rc.n} trace calls, "
              f"{rc.stats['chunks']} chunks, {rc.stats['rounds']} rounds",
              flush=True)
        # the camera trace call whole, and its rounds
        tl, o, d, kw = rc.first
        c_ms = call_ms(lambda: instanced.trace_closest(tl, o, d, **kw), 2)
        st = {}
        instanced.trace_closest(tl, o, d, stats=st, **kw)
        print(f"instanced city camera trace {w}x{h}: {c_ms:.2f} ms a call "
              f"(host clock), {st['chunks']} chunks, {st['rounds']} rounds "
              f"(one K5 launch each), {c_ms / st['rounds']:.3f} ms a round "
              f"on {card}", flush=True)
        results["instanced_city"]["bvh8_trace"].update(
            camera_call_ms=c_ms, camera_rounds=st["rounds"],
            camera_chunks=st["chunks"], ms_per_round=c_ms / st["rounds"])
        del rc, tl, o, d
        del r
        torch.cuda.empty_cache()
        # the main path through the CLI: K5 once per round
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        with RoundCalls() as rc, SurfaceCalls() as sc, ShadeCalls() as shc:
            t0 = time.perf_counter()
            code = cli.main(bench_args(city_file, w, h, spp,
                                       "--animate-time", "0.5"))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = cuda_lib.launch_counts()
        rounds, chunks = rc.stats.get("rounds", 0), rc.stats.get("chunks", 0)
        print(f"instanced city {w}x{h} {spp}spp through the CLI on {card}: "
              f"{wall * 1e3:.1f} ms wall from the command (loading, builds "
              f"and animate included); {rc.n} trace calls, {chunks} chunks, "
              f"{rounds} rounds ({rounds / max(rc.n, 1):.1f} a trace call), "
              f"{sc.n} load_surface calls, {shc.n} bounces; launches "
              f"{counts}", flush=True)
        require(code == 0, "instanced city: CLI failed")
        for name in INSTANCED_PATH:
            require(counts[KERNELS[name][0]] > 0,
                    f"{name} was not launched on the instanced city path")
        require(counts["bvh8_trace"] == rounds > 0
                and counts["bvh8_trace_2l"] == 0
                and counts["bvh8_trace_sub"] == 0,
                f"instanced city: {counts['bvh8_trace']} K5 launches for "
                f"{rounds} rounds: {counts}")
        require_one_surface_fetch(counts, sc.n, "instanced city")
        require_one_shade_per_bounce(counts, shc.n, "instanced city")
        launches = {name: counts.get(KERNELS[name][0], 0)
                    for name in KERNELS}
        cli_gpu_vs_cpu(city_file, folder, 64, 36, 1, "instanced city posed",
                       ("--animate-time", "0.5"))
        # the same file without its animation: the two-level BVH8
        host, _ = gltf.load_gltf(still_file)
        require(not R.uses_instanced(host), "still city: gate took the TLAS")
        cuda_lib.reset_launch_counts()
        require(cli.main(["--scene", still_file, "--width", "64",
                          "--height", "36", "--spp", "1", "--device", "cuda",
                          "--output", f"{folder}/still.png",
                          "--quiet"]) == 0, "still city: CLI failed")
        still = cuda_lib.launch_counts()
        print(f"still city (no animation) 64x36 1spp: launches {still}",
              flush=True)
        require(still["bvh8_trace_2l"] > 0 and still["bvh8_trace"] == 0,
                f"still city: not on the two-level BVH8: {still}")
    return launches


# phase 14: the parity frames (tests/test_parallel.py:122-163, both
# pipelines), the sharded 1-spp render (:34-55) and the full-width city
PARITY_SIZE, RENDER_1SPP_SIZE, SEAM_BAND = (32, 192), (32, 16), 21
SHARDED_CITY_SIZE, UNTAA_FRAMES = (1920, 1080), 3


def parity_config(stable: bool):
    """tests/test_parallel.py:122-163: ReSTIR DI + GI, no denoiser."""
    from rtxpt_tpu_torch.models.renderer import realtime_config
    return realtime_config(use_restir_di=True, use_restir_gi=True,
                           denoiser_enabled=False, use_stable_planes=stable,
                           max_bounces=3, max_diffuse_bounces=2)


def render_1spp_config():
    from rtxpt_tpu_torch.models.renderer import reference_config
    return reference_config(max_bounces=3, max_diffuse_bounces=2,
                            nee_distant_samples=1, nee_local_samples=1)


def parity_frames(host, mesh=None):
    """Two frames of each pipeline at PARITY_SIZE without TAA, and the
    1-spp render at RENDER_1SPP_SIZE: on the card (mesh None) or on this
    rank's rows of `mesh` (render_image_sharded)."""
    from rtxpt_tpu_torch import config as C
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.models.renderer import Renderer
    from rtxpt_tpu_torch.parallel import meshutils
    from rtxpt_tpu_torch.scene import envmap as EM
    from rtxpt_tpu_torch.scene import procedural
    device = mesh.device if mesh is not None else "cuda"
    sky = EM.bake_procedural_sky(height=32)
    w, h = PARITY_SIZE
    out = {}
    for stable in (False, True):
        r = RealtimeRenderer(host, procedural.default_camera(w, h),
                             parity_config(stable), env_radiance=sky,
                             mesh=mesh, device=device)
        out[f"frames_{stable}"] = [r.render_frame(w, h, taa=False).cpu()
                                   for _ in range(2)]
        out[f"sharded_{stable}"] = r._shard_stage1(h)
    w, h = RENDER_1SPP_SIZE
    cfg = render_1spp_config()
    r = Renderer(host, procedural.default_camera(w, h), cfg,
                 env_radiance=sky, device=device)
    out["render"] = (r.render_sample(w, h, 0, jitter_aa=False)
                     if mesh is None else meshutils.render_image_sharded(
                         r.assets, r._camera(w, h, (0.0, 0.0)), cfg,
                         C.default_constants(0), w, h, mesh)).cpu()
    return out


def city_frames_no_taa(host_city, mesh=None):
    """UNTAA_FRAMES frames of the realtime city at SHARDED_CITY_SIZE
    (default pipeline, TAA off: stage 1 and ReLAX) from a new renderer, on
    the card (mesh None) or on `mesh`."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.scene import procedural
    w, h = SHARDED_CITY_SIZE
    r = RealtimeRenderer(host_city, procedural.city_camera(w, h), mesh=mesh,
                         device=mesh.device if mesh is not None else "cuda")
    return [r.render_frame(w, h, taa=False).cpu()
            for _ in range(UNTAA_FRAMES)]


def sharded_rank(mesh, host_city, shade):
    """One rank of phase 14: the parity cases, the city frames (then
    rank 0 holds the city path's kernels against their plain versions on
    the launches of two more frames, its rows' shapes, while the other
    ranks render those frames and wait), and the city without TAA."""
    import torch.distributed as dist
    from rtxpt_tpu_torch.scene import procedural
    from tools_torch import sharded_frames
    SHADE.update(shade)                # K4's instances, for its bound
    out = parity_frames(procedural.build_programmer_art().finish(), mesh)
    w, h = SHARDED_CITY_SIZE

    def check(r):
        # a frame's exchanges are collective: every rank renders it
        got = None
        if mesh.rank == 0:
            got = check_realtime_kernels(r, w, h, "realtime sharded",
                                         lanes=w * h // mesh.size)
            got.update(check_denoiser_kernels(r, w, h, "realtime sharded"))
        else:
            r.render_frame(w, h)
            r.render_frame(w, h)
        dist.barrier()
        return got

    out["city"] = sharded_frames.timed_frames(
        mesh, host_city, procedural.city_camera(w, h), w, h, after=check)
    torch.cuda.empty_cache()
    out["untaa"] = city_frames_no_taa(host_city, mesh)
    return out


def boiling_rows(h: int, ranks: int):
    """(h,) True on the rows whose 16-row block of ReSTIR's boiling filter
    (restir/di.py boiling_filter, zero-padded at the buffer's end) is not
    the same on the row's rank as on one device: the filter blocks the
    rank's own rows, as the reference's does, so a rank whose first row
    is not a multiple of 16, or whose last block is short, judges those
    rows against another block's mean."""
    rows = h // ranks
    y = np.arange(h)
    y0 = y // rows * rows
    start = y0 + (y - y0) // 16 * 16
    end = np.minimum(start + 16, y0 + rows)
    return (start != y // 16 * 16) | (end != np.minimum(y // 16 * 16 + 16,
                                                        h))


def check_far_rows(got, one, ranks: int):
    """The sharded city without TAA against one device's: rows farther
    than the reach of a seam, of the frame's top and bottom (ReLAX's edge
    clamp) and, from the second frame (the temporal passes'), of a row
    whose boiling-filter block differs (boiling_rows) within rtol 1e-4 /
    atol 1e-5 on every frame. The reach: stage 1's band, ReLAX's halo,
    and two rows a frame of the denoiser's history (its 3x3 clamp box and
    bilinear reprojection). Prints what differs elsewhere."""
    from rtxpt_tpu_torch.parallel.meshutils import _POST_HALO
    from rtxpt_tpu_torch.post import tonemap
    from rtxpt_tpu_torch.utils import image as IM
    h = one[0].shape[0]
    shown = lambda x: tonemap.tonemap(torch.from_numpy(x)).numpy()
    boiling = boiling_rows(h, ranks)
    for f, (a, b) in enumerate(zip(got, one)):
        a, b = a.numpy(), b.numpy()
        require(np.isfinite(a).all(), f"sharded city, no TAA, frame {f}: "
                "not finite")
        reach = SEAM_BAND + _POST_HALO + 2 * (f + 1)
        far = np.ones(h, bool)
        sources = list(range(0, h + 1, h // ranks)) + (
            list(np.nonzero(boiling)[0]) if f else [])
        for s in sources:
            far[max(s - reach, 0):min(s + reach, h)] = False
        d = np.abs(a[far] - b[far])
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-5).all(-1)
        ta, tb = shown(a), shown(b)
        db = lambda m: IM.compare(ta[m], tb[m])["psnr"] if m.any() \
            else float("nan")
        what = f" or a row of the {int(boiling.sum())} whose " \
            "boiling-filter block differs" if f else ""
        print(f"multi-device city {a.shape[1]}x{h} without TAA, frame {f}: "
              f"on the {int(far.sum())} rows farther than {reach} from a "
              f"seam, the frame's edge{what}, "
              f"{int((d > 0).any(-1).sum())} pixels not bit-equal to one "
              f"device (max |diff| {d.max() if d.size else 0:.3g}), "
              f"{int(off[far].sum())} outside rtol 1e-4 / atol 1e-5; "
              f"elsewhere {int(off[~far].sum())} outside on "
              f"{int(off[~far].any(1).sum())} rows; PSNR (tonemapped) "
              f"{db(np.ones(h, bool)):.2f} dB whole, {db(~far):.2f} "
              "elsewhere", flush=True)
        require(far.any(), "sharded city: no row beyond the reach")
        require(not off[far].any(), f"sharded city, no TAA, frame {f}: "
                f"{int(off[far].sum())} pixels far from the seams differ "
                "from one device")


def check_seams(got, one, ranks: int, what: str):
    """The reference's seam contract (tests/test_parallel.py:148-163): off
    a band of SEAM_BAND rows about each seam rtol 1e-4 / atol 1e-5, the
    last frame's band mean within 15%."""
    h = got[0].shape[0]
    rows = h // ranks
    band = np.zeros(h, bool)
    for s in range(rows, h, rows):
        band[max(s - SEAM_BAND, 0):min(s + SEAM_BAND, h)] = True
    for f, (a, b) in enumerate(zip(got, one)):
        a, b = a.numpy(), b.numpy()
        require(np.isfinite(a).all(), f"{what} frame {f}: not finite")
        require(np.allclose(a[~band], b[~band], rtol=1e-4, atol=1e-5),
                f"{what} frame {f}: off the seams, max |diff| "
                f"{np.abs(a[~band] - b[~band]).max()}")
        print(f"{what} frame {f}: {int((a[~band] != b[~band]).any(-1).sum())}"
              f" of {int((~band).sum()) * a.shape[1]} off-band pixels not "
              f"bit-equal to one device; band means {a[band].mean():.6f} "
              f"sharded, {b[band].mean():.6f} one device", flush=True)
    ma, mb = a[band].mean(), b[band].mean()
    require(abs(ma - mb) < 0.15 * max(abs(mb), 1e-3),
            f"{what}: the seam band's mean {ma} against {mb}")


def multi_device(results: dict, card: str, host_city) -> dict:
    """Phase 14: multi-device rendering over torch.distributed ranks
    (tools_torch/sharded_frames.py starts them); returns the launch
    counts of the ranks' timed city frames, summed over the ranks."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.ops import cuda_lib
    from rtxpt_tpu_torch.post import tonemap
    from rtxpt_tpu_torch.scene import procedural
    from rtxpt_tpu_torch.utils import image as IM
    from tools_torch import sharded_frames
    size, backend = sharded_frames.choose_ranks()
    print(f"multi-device: {size} ranks over {backend}, " + (
        "one card each" if backend == "nccl" else
        "all on cuda:0, the halo and gather buffers copied through host "
        "memory") + f"; {card}", flush=True)
    # the single-device oracles first, so nothing else runs on the card
    # while the ranks are timed
    one = parity_frames(procedural.build_programmer_art().finish())
    w, h = SHARDED_CITY_SIZE
    r = RealtimeRenderer(host_city, procedural.city_camera(w, h),
                         device="cuda")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        img = r.render_frame(w, h)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    one_city = tonemap.tonemap(img).cpu().numpy()
    one_mean = float(img.mean())
    del r, img
    one_untaa = city_frames_no_taa(host_city)
    print(f"multi-device: one device {w}x{h} city "
          f"{sum(walls[2:]) / 3:.1f} ms/frame (frames "
          f"{', '.join(f'{x:.1f}' for x in walls[2:])}) on {card}",
          flush=True)
    torch.cuda.empty_cache()
    cuda_lib.lib()                   # built before the ranks start
    t0 = time.perf_counter()
    res = sharded_frames.spawn(sharded_rank, size, backend,
                               args=(host_city, SHADE), timeout_s=480)
    print(f"multi-device: the ranks took {time.perf_counter() - t0:.1f} s",
          flush=True)
    for stable in (False, True):
        key = f"frames_{stable}"
        require(all(x[f"sharded_{stable}"] for x in res),
                f"{key}: stage 1 did not run on the ranks' rows")
        for x in res[1:]:
            require(all(torch.equal(a, b) for a, b in zip(x[key],
                                                          res[0][key])),
                    f"{key}: the ranks returned different frames")
        check_seams(res[0][key], one[key], size,
                    f"multi-device {'stable planes' if stable else 'PSR-lite'}"
                    f" {PARITY_SIZE[0]}x{PARITY_SIZE[1]}")
    for x in res:
        a, b = x["render"].numpy(), one["render"].numpy()
        require(np.allclose(a, b, rtol=1e-5, atol=1e-6),
                f"render_image_sharded: max |diff| {np.abs(a - b).max()}")
    print(f"multi-device render_image_sharded {RENDER_1SPP_SIZE[0]}x"
          f"{RENDER_1SPP_SIZE[1]}: {int((a != b).any(-1).sum())} pixels of "
          f"{a.shape[0] * a.shape[1]} not bit-equal to render_sample",
          flush=True)
    city = [x["city"] for x in res]
    img = city[0]["image"]
    require(img.shape == (h, w, 3) and bool(torch.isfinite(img).all()),
            "multi-device city: bad frame")
    require(all(torch.equal(c["image"], img) for c in city[1:]),
            "multi-device city: the ranks returned different frames")
    require(all(c["sharded"] for c in city),
            "multi-device city: stage 1 did not run on the ranks' rows")
    mean = float(img.mean())
    require(abs(mean - one_mean) < 0.05 * one_mean,
            f"multi-device city: mean {mean} against one device's "
            f"{one_mean}")
    shown = tonemap.tonemap(img).numpy()
    m = IM.compare(shown, one_city)
    # rows beyond the reach of a seam (stage 1's band and ReLAX's halo)
    # and of the frame's top and bottom (ReLAX's edge clamp)
    far = np.ones(h, bool)
    reach = SEAM_BAND + 34
    for s in range(0, h + 1, h // size):
        far[max(s - reach, 0):min(s + reach, h)] = False
    far_db = IM.compare(shown[far], one_city[far])["psnr"]
    print(f"multi-device city {w}x{h}, frame 5: PSNR {m['psnr']:.2f} dB "
          f"against one device (tonemapped), {far_db:.2f} dB on the "
          f"{int(far.sum())} rows farther than {reach} from a seam or the "
          f"frame's edge; means {mean:.6f} and {one_mean:.6f}", flush=True)
    sharded_frames.report(city, card, backend, w, h)
    for x in res[1:]:
        require(all(torch.equal(a, b) for a, b in zip(x["untaa"],
                                                      res[0]["untaa"])),
                "multi-device city without TAA: the ranks returned "
                "different frames")
    check_far_rows(res[0]["untaa"], one_untaa, size)
    # rank 0's kernel checks on its rows' launches
    results["realtime_sharded"].update(city[0]["after"])
    total = {}
    for c in city:
        counts = c["launches"]
        for name in RT_CITY_PATH:
            require(counts[KERNELS[name][0]] > 0, f"{name} was not launched "
                    f"on rank {c['rank']}'s city frames")
        for name in ONE_LAUNCH["bvh8_trace_2l"][1] + ("shade_nee",):
            require(counts[name] == 0, f"rank {c['rank']}'s city frames "
                    f"launched {name}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return {"realtime_sharded": {name: total.get(KERNELS[name][0], 0)
                                 for name in KERNELS}}


# ---- phase 15: the tools and UI -------------------------------------------

# the views that shade a reservoir on the re-traced G-buffer, and those
# that read a realtime frame's outputs alone
RESTIR_VIEWS = ("ReSTIRDIInitialOutput", "ReSTIRDITemporalOutput",
                "ReSTIRDISpatialOutput", "ReGIRIndirectOutput")
FRAME_OUTPUT_VIEWS = ("DenoiserDiffRadiance", "DenoiserSpecRadiance",
                      "ReSTIRDIOutput", "ReSTIRGIOutput",
                      "ReSTIRDIFinalContribution", "SecondarySurfacePosition",
                      "SecondarySurfaceRadiance")
HASHED_VIEWS = ("MaterialID", "FirstHitShaderPermutation")
VIEWER_SIZE = (640, 360)
# the glass pixel of tests/test_deltatree.py at 160x120 (its probe order)
GLASS_PROBE = [(x, y) for y in (73, 71, 75) for x in (88, 86, 90, 84, 92)]


def view_groups():
    """(surface views, stable-plane views) of debugviews.VIEWS: the views
    that re-trace the G-buffer and read nothing else (the OMM views among
    them), and the views of a stable-planes frame."""
    from rtxpt_tpu_torch.utils import debugviews as DV
    stable = [v for v in DV.VIEWS
              if v.startswith("StablePlane") or v == "StableRadiance"]
    other = set(stable) | set(RESTIR_VIEWS) | set(FRAME_OUTPUT_VIEWS) \
        | {"NaNSanitizer"}
    return [v for v in DV.VIEWS if v not in other], stable


def keep_stable(r) -> dict:
    """The debug views' inputs from a stable-planes RealtimeRenderer's
    last frame."""
    return dict(stable_planes=r.last_stable_planes,
                plane_radiance=r.last_plane_radiance,
                plane_denoised=r.last_plane_denoised,
                den_states=r.den_states)


def view_psnr(a, b) -> float:
    """PSNR of two views against their range [0, 1] (inf where equal)."""
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0.0 else float(-10.0 * np.log10(mse))


def timed_view(view, *args, **kw):
    """(the view as a tensor, its host-clock ms ending in a synchronize)."""
    from rtxpt_tpu_torch.utils import debugviews as DV
    t0 = time.perf_counter()
    img = DV.render_debug_view(view, *args, **kw)
    torch.cuda.synchronize()
    return img, (time.perf_counter() - t0) * 1e3


def city_debug_views(results: dict, card: str, host_city, kept: dict):
    """Every surface view (the OMM views among them), the ReSTIR DI stage
    views, ReGIRIndirectOutput and inspect_pixel on the 1920x1080 city
    (the two-level tier), then the pipeline views of phase 7's stable
    planes and phase 8's PSR-lite frame outputs; the first view's camera
    trace and surface fetch are held against their plain versions.
    Returns the launch counts of path "debug_views"."""
    from rtxpt_tpu_torch.models.renderer import Renderer, reference_config
    from rtxpt_tpu_torch.ops import bvh2l, cuda_lib
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    from rtxpt_tpu_torch.utils import debugviews as DV
    w, h = 1920, 1080
    r = Renderer(host_city, procedural.city_camera(w, h), reference_config(),
                 env_radiance=EM.bake_procedural_sky(height=64),
                 device="cuda")
    require(isinstance(r.accel, bvh2l.BVH8TwoLevel),
            "debug views: the city is not on the two-level tier")
    cam = r._camera(w, h, (0.0, 0.0))
    surface, stable = view_groups()

    # the first view's camera trace and surface fetch against their plain
    # versions, and K2 on the tables of the surface fetch and of the first
    # ReSTIR view (the light and environment rows)
    with Capture({"trace_bvh8_2l": 1, "gather_rows": 16,
                  "gather_surface": 1}) as cap:
        DV.render_debug_view(surface[0], r.assets, cam, w, h)
        DV.render_debug_view(RESTIR_VIEWS[0], r.assets, cam, w, h)
        torch.cuda.synchronize()
    require(not cap.calls["trace_bvh8_2l"][0][1]["any_hit"],
            "debug views: the first trace is not the camera's")
    results["debug_views"].update(check_two_level(
        [("camera", cap.calls["trace_bvh8_2l"][0], True)], "debug_views"))
    results["debug_views"].update(check_surface_kernels(
        cap, "debug_views", shade_pass=False))
    del cap

    # the path: every view that re-traces the G-buffer and inspect_pixel,
    # with the counters set to 0 just before
    fo = kept["psr"]["frame_outputs"]
    ms = {}
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    with TraceCalls(ONE_LAUNCH["bvh8_trace_2l"][0]) as tc, \
            SurfaceCalls() as sc:
        for view in surface + list(RESTIR_VIEWS):
            img, ms[view] = timed_view(
                view, r.assets, cam, w, h, frame_outputs=fo
                if view == "ReSTIRDITemporalOutput" else None)
            require(img.shape == (h, w, 3) and bool(torch.isfinite(img).all())
                    and float(img.min()) >= 0.0 and float(img.max()) <= 1.0,
                    f"debug view {view}: bad image")
        t0 = time.perf_counter()
        pick = DV.inspect_pixel(r.assets, cam, w, h, w // 2, h // 2)
        inspect_ms = (time.perf_counter() - t0) * 1e3
    counts = cuda_lib.launch_counts()
    n_gbuffer = len(surface) + len(RESTIR_VIEWS) + 1
    slowest = max(ms, key=ms.get)
    print(f"debug views city {w}x{h}: {len(ms)} views re-tracing the "
          f"G-buffer in {sum(ms.values()):.1f} ms (slowest {slowest} "
          f"{ms[slowest]:.1f} ms; FirstHitShadingNormal "
          f"{ms['FirstHitShadingNormal']:.1f} ms), inspect_pixel "
          f"{inspect_ms:.1f} ms (prim {pick['prim']}, t {pick['t']:.4f}) on "
          f"{card}; {n_gbuffer} trace_gbuffer calls, {tc.n} two-level trace "
          f"calls (3 a G-buffer: the camera and 2 PSR segments, and "
          f"ReSTIR's visibility traces), {sc.n} load_surface calls; "
          f"launches {counts}", flush=True)
    require(pick["valid"], "inspect_pixel: the centre pixel missed")
    for name in DEBUG_VIEWS_PATH:
        require(counts[KERNELS[name][0]] > 0,
                f"{name} was not launched on the debug views path")
    require_one_launch_per_trace(counts, tc.n, "debug views")
    require_one_surface_fetch(counts, sc.n, "debug views")
    require(counts["shade_nee"] == counts["shade_nee_fill"] == 0,
            "debug views: K4 launched")
    del r

    # the pipeline views at 1080p on the inputs phases 7 and 8 kept
    pms = {}
    for views, kw in ((stable, kept["stable"]),
                      (FRAME_OUTPUT_VIEWS, dict(frame_outputs=fo))):
        for view in views:
            img, pms[view] = timed_view(view, None, None, w, h, **kw)
            require(img.shape == (h, w, 3) and bool(torch.isfinite(img).all()),
                    f"debug view {view}: bad image")
    slowest = max(pms, key=pms.get)
    print(f"debug views city {w}x{h}: {len(pms)} pipeline views (stable "
          f"planes of phase 7, PSR-lite outputs of phase 8) in "
          f"{sum(pms.values()):.1f} ms (slowest {slowest} "
          f"{pms[slowest]:.1f} ms)", flush=True)
    return {name: counts.get(KERNELS[name][0], 0) for name in KERNELS}


def shaded_reservoir(view, assets, gb, px, py, w, h, fo):
    """The reservoir a ReSTIR DI stage view shades, recomputed on the
    devices of `assets` (render_debug_view's, with the frame outputs
    `fo`)."""
    from rtxpt_tpu_torch.restir import di
    if view == "ReSTIRDITemporalOutput":
        return fo.reservoir
    if view == "ReSTIRDIInitialOutput":
        return di.generate_candidates(assets, gb, px, py, 0)
    return di.spatial_resample(assets, gb, fo.reservoir, px, py, w, h, 0)


def tools_gpu_vs_cpu():
    """Programmer-art at 64x48 on the card against the CPU: every view
    (PSNR > 40 dB against [0, 1]; the hashed views equal where the
    G-buffer prims agree; the ReSTIR stage views off the lanes whose
    reservoir picked another sample, at most 2%, as
    tests/test_torch_debugviews.py holds them; the pipeline views on the
    card's realtime frames copied to the CPU), explore_pixel on the glass
    pixel (the same nodes), print_path within 1e-4, mat_pack after
    set_material bit-equal, and a render after update_environment."""
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.models.renderer import (Renderer, realtime_config,
                                                 reference_config)
    from rtxpt_tpu_torch.pt import gbuffer as GB
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    from rtxpt_tpu_torch.utils import debugprint as DP
    from rtxpt_tpu_torch.utils import debugviews as DV
    from rtxpt_tpu_torch.utils import deltatree as DT
    from rtxpt_tpu_torch.utils import image as IM
    host = procedural.build_programmer_art().finish()
    w, h = 64, 48
    devs = ("cuda", "cpu")
    env = EM.bake_procedural_sky(height=32)
    rs = {d: Renderer(host, procedural.default_camera(w, h),
                      reference_config(), env_radiance=env, device=d)
          for d in devs}
    cams = {d: rs[d]._camera(w, h, (0.0, 0.0)) for d in devs}
    grid = {d: rs[d]._pixel_grid(w, h) for d in devs}
    gbs = {d: GB.trace_gbuffer(rs[d].assets, cams[d], cams[d], *grid[d])
           for d in devs}
    same_prim = (gbs["cuda"].prim.cpu() == gbs["cpu"].prim).numpy()
    # the pipeline views' inputs: the card's realtime frames, copied
    st = RealtimeRenderer(host, procedural.default_camera(w, h),
                          env_radiance=env, device="cuda")
    ps = RealtimeRenderer(host, procedural.default_camera(w, h),
                          realtime_config(use_restir_di=True,
                                          use_restir_gi=True,
                                          denoiser_enabled=True,
                                          use_stable_planes=False),
                          env_radiance=env, device="cuda")
    for _ in range(2):
        color = st.render_frame(w, h)
        ps.render_frame(w, h)
    color = color.reshape(-1, 3).clone()
    color[::97] = float("nan")
    kw = {"cuda": dict(keep_stable(st), frame_outputs=ps.last_outputs,
                       color=color)}
    kw["cpu"] = to_cpu(kw["cuda"])
    low, flips = [], {}
    for view in DV.VIEWS:
        imgs = [DV.render_debug_view(view, rs[d].assets, cams[d], w, h,
                                     **kw[d]).cpu().numpy() for d in devs]
        keep = np.ones(w * h, bool)
        if view in HASHED_VIEWS:
            keep = same_prim
        elif view in RESTIR_VIEWS[:3]:
            res = [shaded_reservoir(view, rs[d].assets, gbs[d], *grid[d], w,
                                    h, kw[d]["frame_outputs"]) for d in devs]
            keep = (res[0].light.cpu() == res[1].light).numpy() & np.isclose(
                res[0].uv.cpu().numpy(), res[1].uv.numpy(), rtol=1e-4,
                atol=1e-5).all(-1)
            flips[view] = int((~keep).sum())
            require(flips[view] <= 0.02 * w * h,
                    f"{view} GPU vs CPU: {flips[view]} reservoirs flipped")
        a, b = (x.reshape(-1, 3)[keep] for x in imgs)
        if view in HASHED_VIEWS:
            require(np.array_equal(a, b),
                    f"{view} GPU vs CPU: not equal where the prims agree")
        else:
            db = view_psnr(a, b)
            low.append((db, view))
            require(db > PSNR_MIN, f"{view} GPU vs CPU: PSNR {db:.2f} dB")
    low.sort()
    print(f"debug views GPU vs CPU (plain) {w}x{h}: {len(DV.VIEWS)} views, "
          f"prims agree on {same_prim.mean():.4%} of pixels, lowest PSNR "
          + ", ".join(f"{v} {db:.2f} dB" for db, v in low[:3])
          + f"; reservoirs flipped {flips}", flush=True)

    # the delta tree on the glass pixel, and the print slots
    tw, th = 160, 120
    tr = {d: Renderer(host, procedural.default_camera(tw, th),
                      reference_config(), env_radiance=env, device=d)
          for d in devs}
    tcam = {d: tr[d]._camera(tw, th, (0.0, 0.0)) for d in devs}
    pixel = next((p for p in GLASS_PROBE
                  if any(len(n.lobes) >= 2 for n in DT.explore_pixel(
                      tr["cpu"].assets, tcam["cpu"], *p,
                      max_vertex_depth=3).nodes)), None)
    require(pixel is not None, "no forking delta tree on the glass row")
    trees = {}
    for d in devs:
        t0 = time.perf_counter()
        trees[d] = DT.explore_pixel(tr[d].assets, tcam[d], *pixel)
        if d == "cuda":
            torch.cuda.synchronize()
            tree_ms = (time.perf_counter() - t0) * 1e3
    g, c = trees["cuda"], trees["cpu"]
    require([(n.vertex_index, n.branch_id, n.material_id, n.is_miss,
              n.plane_slot, n.on_stable_path, n.is_dominant, len(n.lobes))
             for n in g.nodes]
            == [(n.vertex_index, n.branch_id, n.material_id, n.is_miss,
                 n.plane_slot, n.on_stable_path, n.is_dominant, len(n.lobes))
                for n in c.nodes]
            and g.plane_branch_ids == c.plane_branch_ids
            and g.dominant_plane == c.dominant_plane,
            f"delta tree GPU vs CPU at {pixel}: the nodes differ")
    t_err = max(float(np.abs(n.throughput - m.throughput).max())
                for n, m in zip(g.nodes, c.nodes))
    slots = {}
    for d in devs:
        t0 = time.perf_counter()
        slots[d] = DP.print_path(tr[d].assets, tcam[d], *pixel)
        if d == "cuda":
            torch.cuda.synchronize()
            print_ms = (time.perf_counter() - t0) * 1e3
    require([s["label"] for s in slots["cuda"]]
            == [s["label"] for s in slots["cpu"]]
            and all(np.allclose(a["value"], b["value"], rtol=0, atol=1e-4)
                    for a, b in zip(slots["cuda"], slots["cpu"])),
            f"print_path GPU vs CPU at {pixel}: the slots differ")
    print(f"delta tree at {pixel} ({tw}x{th}): {len(g.nodes)} nodes, the "
          f"same on the card and the CPU (throughput max |diff| "
          f"{t_err:.3g}); {tree_ms:.1f} ms on the card, "
          f"{tree_ms / len(g.nodes):.2f} ms a node; print_path "
          f"{len(slots['cuda'])} slots in {print_ms:.1f} ms", flush=True)

    # live edits: the same edits on both devices, then a render after a
    # new environment
    panel = int(np.argmax(np.asarray(host["materials"]["emissive"]).max(-1)))
    for d in devs:
        rs[d].set_material(0, base_color=(0.9, 0.1, 0.1), roughness=0.3)
        rs[d].set_material(2, metalness=0.8)
        rs[d].set_material(panel, emissive=(4.0, 3.0, 2.0))
    require(torch.equal(rs["cuda"].scene.mat_pack.cpu(),
                        rs["cpu"].scene.mat_pack),
            "set_material GPU vs CPU: mat_pack differs")
    sky = EM.bake_procedural_sky(height=32, sun_dir=(-0.5, 0.2, -0.8),
                                 sky_scale=0.2)
    imgs = []
    for d in devs:
        rs[d].update_environment(sky)
        imgs.append(rs[d].tonemapped(rs[d].render(w, h, 2)).cpu().numpy())
    m = IM.compare(imgs[0], imgs[1])
    print(f"live edits GPU vs CPU (plain) {w}x{h} 2spp: mat_pack bit-equal "
          f"after 3 set_material calls, the render after update_environment "
          f"PSNR {m['psnr']:.2f} dB", flush=True)
    require(np.isfinite(imgs[0]).all() and m["psnr"] > PSNR_MIN,
            f"update_environment GPU vs CPU: {m}")


def to_cpu(tree):
    """A copy of a nest of tensors, tuples, lists and dicts on the CPU."""
    if torch.is_tensor(tree):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_cpu(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def viewer_request(port, method, path, body=None):
    """(status, body bytes, headers, ms) of one HTTP request."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        t0 = time.perf_counter()
        conn.request(method, path,
                     body=json.dumps(body) if body is not None else None)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, data, dict(resp.getheaders()), \
            (time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def viewer_on_card(card: str):
    """The web viewer on the card: ViewerApp(device="cuda") at 640x360 on
    127.0.0.1, a free port; one reference frame (its launches counted:
    the dense trace once per trace call, the surface fetch once per
    load_surface call, K4 once per bounce), one realtime frame, one
    debug-view frame and one material edit, each request's ms printed."""
    from rtxpt_tpu_torch.app.viewer import ViewerApp, serve
    from rtxpt_tpu_torch.ops import cuda_lib
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    w, h = VIEWER_SIZE
    t0 = time.perf_counter()
    app = ViewerApp(procedural.build_programmer_art().finish(),
                    procedural.default_camera(w, h), w, h,
                    env=EM.bake_procedural_sky(height=64),
                    realtime_overrides=dict(mode="reference"),
                    device="cuda")
    srv, th = serve(app, 0)
    port = srv.server_address[1]
    build_s = time.perf_counter() - t0
    out = {}
    try:
        def frame(what, body):
            status, png, hdrs, ms = viewer_request(port, "POST",
                                                   "/api/frame", body)
            require(status == 200 and png[:4] == b"\x89PNG",
                    f"viewer {what}: status {status}")
            out[what] = (ms, app.frame_ms, hdrs.get("X-Stats", ""))

        status, state, _, ms = viewer_request(port, "GET", "/api/state")
        require(status == 200 and len(json.loads(state)["materials"]) > 0,
                "viewer /api/state")
        out["state"] = (ms, 0.0, "")
        frame("reference warm-up", {"keys": ["w"]})
        torch.cuda.synchronize()
        cuda_lib.reset_launch_counts()
        with TraceCalls(ONE_LAUNCH["mt_dense_fused"][0]) as tc, \
                SurfaceCalls() as sc, ShadeCalls() as shc:
            frame("reference", {"keys": []})
        counts = cuda_lib.launch_counts()
        require(app._renderer.sample_index == 2,
                "viewer: the still frame did not accumulate")
        require_one_launch_per_trace(counts, tc.n, "viewer reference frame",
                                     "mt_dense_fused")
        require_one_surface_fetch(counts, sc.n, "viewer reference frame")
        require_one_shade_per_bounce(counts, shc.n, "viewer reference frame")
        ref_counts = counts
        status, _, _, ms = viewer_request(port, "POST", "/api/material",
                                          {"index": 0,
                                           "base_color": [0.9, 0.2, 0.1],
                                           "roughness": 0.4})
        require(status == 200 and float(app._renderer.scene.mat_pack[0, 0])
                == np.float32(0.9), "viewer /api/material")
        out["material edit"] = (ms, 0.0, "")
        frame("reference after the edit", {"keys": []})
        require(app._renderer.sample_index == 1,
                "viewer: the material edit did not restart accumulation")
        status, _, _, ms = viewer_request(port, "POST", "/api/config",
                                          {"mode": "realtime"})
        require(status == 200, "viewer /api/config")
        out["switch to realtime"] = (ms, 0.0, "")
        frame("realtime warm-up", {"keys": []})
        frame("realtime warm-up 2", {"keys": []})
        frame("realtime", {"keys": ["d"], "dx": 2.0})
        viewer_request(port, "POST", "/api/config",
                       {"debug_view": "FirstHitShadingNormal"})
        frame("debug view", {"keys": []})
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    require(not th.is_alive(), "viewer: the server thread did not stop")
    print(f"viewer {w}x{h} on {card} (built in {build_s:.2f} s): "
          + "; ".join(f"{what} {ms:.1f} ms" + (f" (frame {fms:.1f} ms)"
                                                if fms else "")
                      for what, (ms, fms, _) in out.items())
          + f"; the reference frame's launches {ref_counts} over {tc.n} "
          f"trace calls, {sc.n} load_surface calls, {shc.n} bounces",
          flush=True)


def profiler_trace(card: str):
    """One realtime frame (programmer-art 640x360, stable planes with
    ReSTIR DI + GI, ReLAX and TAA, 2 bounces: the trace holds an event for
    every tensor op and kernel, about 80 MB on the CPU already) inside
    profiling.trace: the written Chrome trace must name the frame's
    trace, surface-fetch and shade kernels and its BUILD stage."""
    import tempfile
    from rtxpt_tpu_torch.models.realtime import RealtimeRenderer
    from rtxpt_tpu_torch.models.renderer import realtime_config
    from rtxpt_tpu_torch.scene import procedural
    from rtxpt_tpu_torch.utils import profiling
    w, h = VIEWER_SIZE
    r = RealtimeRenderer(procedural.build_programmer_art().finish(),
                         procedural.default_camera(w, h),
                         realtime_config(use_restir_di=True,
                                         use_restir_gi=True,
                                         denoiser_enabled=True,
                                         use_stable_planes=True,
                                         max_bounces=2,
                                         max_diffuse_bounces=1),
                         device="cuda")
    r.render_frame(w, h)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as folder:
        t0 = time.perf_counter()
        with profiling.trace(folder) as prof:
            r.render_frame(w, h)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(prof.trace_path) as f:
            text = f.read()
        size = len(text)
    names = ("mt_dense_fused_kernel", "gather_surface_kernel",
             "shade_nee_kernel", "rtxpt:realtime/build")
    found = {n: text.count(n) for n in names}
    print(f"profiling.trace of one realtime frame {w}x{h} on {card}: "
          f"{wall:.2f} s with the trace written, {size / 1e6:.1f} MB; "
          f"occurrences {found}", flush=True)
    require(all(found.values()), f"profiler trace: missing names {found}")


def cli_debug_flags():
    """The CLI's debug flags with --device cuda (programmer-art 64x48):
    --debug-view saves a PNG; --debug-print-pixel, --debug-delta-tree and
    --debug-lines-pixel print what the library prints for the CLI's
    camera and change the saved image."""
    import contextlib
    import io
    import os
    import tempfile
    from rtxpt_tpu_torch.app import cli
    from rtxpt_tpu_torch.models.renderer import Renderer
    from rtxpt_tpu_torch.scene import envmap as EM, procedural
    from rtxpt_tpu_torch.utils import debugprint as DP
    from rtxpt_tpu_torch.utils import deltatree as DT
    from rtxpt_tpu_torch.utils import image as IM
    w, h, pix = 64, 48, (32, 24)
    size = ["--width", str(w), "--height", str(h), "--device", "cuda",
            "--quiet"]
    flags = ["--spp", "1", "--max-bounces", "4"]
    with tempfile.TemporaryDirectory() as folder:
        out = {k: os.path.join(folder, f"{k}.png")
               for k in ("view", "plain", "tools")}
        require(cli.main(size + ["--debug-view", "FirstHitShadingNormal",
                                 "--output", out["view"]]) == 0,
                "cli --debug-view")
        require(cli.main(size + flags + ["--output", out["plain"]]) == 0,
                "cli render")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            require(cli.main(size + flags + [
                "--output", out["tools"],
                "--debug-print-pixel", "%d,%d" % pix,
                "--debug-delta-tree", "%d,%d" % pix,
                "--debug-lines-pixel", "%d,%d" % pix]) == 0,
                "cli debug flags")
        view = IM.load_png(out["view"])
        plain, lined = IM.load_png(out["plain"]), IM.load_png(out["tools"])
    r = Renderer(procedural.build_programmer_art().finish(),
                 procedural.default_camera(w, h),
                 env_radiance=EM.bake_procedural_sky(), device="cuda")
    cam = r.camera._replace(viewport=torch.tensor(
        [w, h], dtype=torch.float32, device="cuda"))
    want = DP.format_slots(DP.print_path(r.assets, cam, *pix)) + "\n" + \
        DT.format_tree(DT.explore_pixel(r.assets, cam, *pix)) + "\n"
    drawn = int((plain != lined).any(-1).sum())
    print(f"CLI --device cuda {w}x{h}: --debug-view PNG {view.shape}, "
          f"mean {view.mean():.2f}; the print and delta-tree tables "
          f"({len(want.splitlines())} lines) equal the library's; "
          f"--debug-lines-pixel changed {drawn} pixels", flush=True)
    require(view.shape == (h, w, 3) and view.std() > 0,
            "cli --debug-view: a flat image")
    require(text.getvalue() == want,
            f"cli debug tables differ from the library's:\n"
            f"{text.getvalue()}\n{want}")
    require(drawn > 0, "cli --debug-lines-pixel drew nothing")


def tools(results: dict, card: str, host_city, kept: dict) -> dict:
    """Phase 15: the tools and UI on the card; returns the launch counts
    of path "debug_views"."""
    launches = {"debug_views": city_debug_views(results, card, host_city,
                                                kept)}
    kept.clear()                     # the 1080p frames' outputs
    torch.cuda.empty_cache()
    tools_gpu_vs_cpu()
    cli_debug_flags()
    viewer_on_card(card)
    profiler_trace(card)
    return launches


def gather_instances(report: str):
    """Print the registers, shared memory and spills of every kernel
    instance of csrc/gather.cu from ptxas's report; none may spill."""
    rows = ptxas_kernels(report)
    require(rows, "ptxas reported no kernel of gather.cu")
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, demangled in zip(rows, names):
                r[0] = demangled
    except OSError:
        pass                         # keep the mangled names
    for kname, regs, smem, spill in rows:
        print(f"ptxas gather.cu {kname}: {regs} registers, {smem} B shared, "
              f"{spill} B spilled", flush=True)
    require(all(r[3] == 0 for r in rows), "a gather.cu kernel spills")


def phase(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs a CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # exact sobol matmul
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    from rtxpt_tpu_torch.ops import cuda_lib
    from tools_torch import kernel_lab
    t0 = time.time()
    # the renderer's library and the K8 lab's, every nvcc started together,
    # and gather.cu and shade_kernel.cu once more for ptxas's reports on
    # their instances
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futures = [pool.submit(cuda_lib.lib), pool.submit(kernel_lab.library),
                   pool.submit(cuda_lib.ptxas_report, "gather.cu"),
                   pool.submit(cuda_lib.ptxas_report, "shade_kernel.cu")]
        report, shade_report = [f.result() for f in futures][2:]
    print(f"built CUDA kernels in {time.time() - t0:.1f} s "
          f"({cuda_lib.build()} and the lab's)", flush=True)
    gather_instances(report)
    SHADE.update(shade_instances(shade_report, cuda_lib.build()))
    for (nd, nl, rr, fill), inst in sorted(SHADE.items()):
        if rr and nd == nl and nd > 0:        # the main paths' instances
            print(f"K4{' FILL' if fill else ''} NEE {nd}+{nl}: "
                  f"{inst['registers']} registers, {inst['shared']} B "
                  f"shared, {inst['spill']} B spilled, {inst['ops']} SASS "
                  f"operations a lane", flush=True)

    # each path's kernel checks, {path: {kernel name: result}}
    results = {p: {} for p in PATHS}
    results["labs"] = {}
    launches = {}
    kept = {}                        # phase 7 and 8 frames for phase 15
    phase("kernels: dense trace, K1-K4, K7", check_kernels, results)
    phase("goldens", check_goldens)
    launches["bench"], bench_hdr = phase("bench", bench, card)
    phase("bench raystream", sorted_bench, card)
    t0 = time.perf_counter()
    host_city = build_city()
    geometry_s = time.perf_counter() - t0
    launches["city"], city_mean = phase("city", city, results, card,
                                        host_city, geometry_s)
    launches.update(phase("reference configurations", reference_configs,
                          results, card, host_city, bench_hdr, city_mean))
    launches.update(phase("realtime", realtime, results, card, host_city,
                          kept))
    launches.update(phase("realtime pipelines", realtime_pipelines, results,
                          card, host_city, kept))
    launches["foliage_dense"] = phase("foliage dense", foliage_dense,
                                      results, card)
    launches.update(phase("city foliage", city_foliage, results, card))
    launches["gltf_scene"] = phase("glTF loader", gltf_scene, results, card)
    launches.update(phase("skinned", skinned, results, card))
    launches["instanced_city"] = phase("instanced city", instanced_city,
                                       results, card)
    launches.update(phase("multi-device", multi_device, results, card,
                          host_city))
    launches.update(phase("tools", tools, results, card, host_city, kept))
    lab_kernels = phase("labs K8, K9", labs, results)
    # each two-level check runs its plain composition once, its result
    # compared and its CUDA-event time its plain_ms
    plain = [r["bvh8_trace_2l"]["plain_ms"] for r in results.values()
             if "bvh8_trace_2l" in r]
    print(f"the two-level checks' plain compositions: {len(plain)} paths, "
          f"{sum(plain) / 1e3:.1f} s of timed traces, one run each",
          flush=True)
    for p, names in PATHS.items():
        missing = [n for n in names if n not in results[p]]
        require(not missing, f"{p}: {missing} not checked at this path's "
                "shapes")
    kernels = []
    for name, (_, src, rep) in {**KERNELS, **lab_kernels}.items():
        # the top-level numbers are those of the first main path that
        # runs the kernel and checks it (K1-K4: the bench; K5: the skinned
        # figure; the two-level trace: the city; K4 FILL: the realtime
        # city), else of the first path that checks it (K6 and K7: the
        # city and the bench; K8, K9: the labs); by_path holds every path's
        path = next((p for p in PATHS if name in PATHS[p]
                     and name in results[p]), None) or \
            next(p for p in results if name in results[p])
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=sum(c.get(name, 0) for c in launches.values()),
            launches_by_path={p: c.get(name, 0)
                              for p, c in launches.items()},
            measured_on=path, **{key: results[path][name][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            by_path={p: results[p][name] for p in results
                     if name in results[p]}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
