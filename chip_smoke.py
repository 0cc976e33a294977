"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi); no CUDA -> exit 1
  2. build the kernels of vpt_tpu_torch/csrc with nvcc (sm_90a, one nvcc
     per source, all at once); print the ptxas registers, spills and
     stack frame of every instantiation of K1, K4 (and its surrogate
     mode, <NB,MAJ,ENV,XY>), K5, K9, K10, K11, K12 (<NB,MAJ,ENV,XY>), K13,
     K14 and K15-K31
  3. sample_volume_packed vs its plain version: all 256 u8 codes exact;
     timed at 1M lookups by device time (CUDA-graph replay) against
     F.grid_sample on the float volume, host path beside it
  4. mcm_spectral_reset vs its plain version at 512^2 x 4 streams, two
     runs equal bit for bit; device time and host path
  5. mcm_spectral_step vs its plain version at 512^2 x 4 streams,
     2 dispatches (the oracle contract), and bit-identical reruns; the
     same at 64^2 x 2 streams with 24 bins (the kernel's >16-bin build);
     one dispatch timed
  6. the main path: RenderSession("mcm-spectral", ...) on the bench scene
     (512^2, 4 streams, 128^3 u8 sphere_in_cube, 12 bins, 8 steps),
     64 dispatches, launch counts and outputs checked; then the same
     dispatches by render_many (the session's state bit for bit) and
     through the plain step
  7. prb_tape_forward (K4) at 512^2 x 4 streams, 2 dispatches, every wrt
     field, on the u8 table and on an f32 table: its state equals K1's
     bit for bit, its tape equals the plain tape, two runs are identical
  8. prb_reverse (K5) on that tape, window mode, stride 1 / stride 4 /
     importance 4: within 1e-4 relative L2 of its plain version, two runs
     within 1e-5, gradients finite and nonzero
  9. K9 contract_corners and K10 pack_corners at the bench's table sizes,
     equal to their plain versions bit for bit; then the training path:
     fit_spectral(method="prb") on the bench scene at full width, 3
     iterations each at stride 1 / stride 4 / importance 4, launch counts
     (K4, K5, K9, K10), losses and params checked; then fwd+bwd windows
     timed as bench.py times them, split into the K4 sweep, K5, the
     reverse sweep and K9, against one window of the plain versions; at
     stride 1 also K5 without scatters (a tape of the carry's fields) and
     its volume-row scatter alone (K11 on the window's event rows)
 10. the gather tool (K6 gather_scalar, K7 gather_lanewise): exact
     against its plain versions on ragged shapes and at every size of the
     TPU tools at L and 16 L lookups, K7's plan (shared memory for
     N <= 2048), host-path and device (CUDA-graph) times
 11. majorant mode at full width: the sparse capability scene
     (Volume.sparse_spheres(512), its full 513^3 x 8 u8 corner table,
     majorant_blocks=16, 512^2 x 4 streams, frustum-filling camera); K1 in
     majorant mode equals its plain version in every state field over 2
     dispatches; exact and majorant paths 3 x 16 dispatches each (Mpaths/s,
     M lane-steps/s, ratio); image parity at matched dispatch count against
     the exact path's seed-to-seed floor; host set-up times printed
 12. environment map (256x512 equirect from a numpy seed) and quasicubic
     filter on the bench scene: K1 in each mode and in both equals plain;
     session.run(64) in environment mode, session.run(16) quasicubic
 13. hit-lane compaction on the bench scene at the default pose: compact
     K2/K1 equal plain in every field, K8 compact_image equals plain bit
     for bit, two runs give equal images, hit pixels match the full
     kernel (rtol 1e-5); K2 and K8 by device time; compact vs full
     Mpaths/s; one session with compaction + majorant + quasicubic +
     environment together
 14. the CLI: `python -m vpt_tpu_torch.cli render --device cuda
     --majorant-blocks 8 --compaction --envmap <seeded .npy> -o <tmp>.npy`
     exits 0, writes the image, prints the metrics JSON (and `--renderer`
     eam, mcm, mcs, dos and lao, phases 19-25)
 15. the scatter ceiling (bench.py's measure_ceilings method): K11
     scatter_rows, two float4 atomics per index on 16 x 1M uniform random
     rows of the 129^3-row table, equal to its plain version, timed by
     device time against index_add_
 16. the autodiff surrogate's kernels at 512^2 x 4 streams, 2 dispatches,
     exact, majorant (the bench scene, majorant_blocks=16), environment,
     environment+majorant and quasicubic mode, and over the bench scene's
     xy half-packed u8 table (8.5 MB) in exact, majorant, quasicubic and
     environment+majorant mode: K4's surrogate mode (its state equals K1's
     bit for bit, its tape the
     plain tape; timed beside K1 on the same state copy), K12
     surrogate_reverse on that tape within 1e-4 relative L2 of its plain
     version (two runs within 1e-5) with all four adjoints and (exact and
     majorant, full and xy) with the density's alone; both timed against
     their bounds (an xy lookup reads and scatters two 4-wide plane rows);
     then the window of render_sequence_diff against the autograd twin on
     the card (128^2 x 2, K = 2, all four tables, 1e-4) under both
     window_storage schedules, in each of those nine modes
 17. the autodiff training path: fit_spectral(method="autodiff") at full
     width on the bench scene and, routed by default, on the sparse 512^3
     majorant scene (3 iterations each, the launch counts set to 0 before:
     one K4 surrogate sweep and one K12 per iteration, K9 and K10
     required, no K1 inside the loss; seconds per iteration, peak device
     memory); the same scene's xy table with the same majorant blocks: one
     window's contracted density gradient against the full table's (1e-4
     relative L2, the loss equal), then method=None learning an f32 density
     (routed to the surrogate: one K4 xy+majorant sweep, one K12 xy launch,
     K9 contract_volume_xy and K10 pack_volume_xy per iteration); a K = 4
     surrogate window under "tape" and "forward" (gradients within 1e-4 of
     each other), the tape schedule split into the taped sweep, K12 and K9,
     beside phase 9's PRB stride-1 window; a checkpoint after iteration 2
     and a resume (losses rtol 1e-4, params 5e-4; K12's atomics make runs
     differ by rounding)
 18. raw and partly packed tables (pack_tables False, {material_tf,
     light_spectrum}, {material_tf}, {light_spectrum}, {density}, and the
     nearest filter) on the bench scene: K3's raw mode (linear, quasicubic,
     nearest) equal to plain, timed against F.grid_sample (run beside phase
     3); K1 in every layout equal to its plain version and to the packed K1
     bit for bit over 2 dispatches (nearest: to plain), one dispatch timed
     per layout; the sparse 512^3 scene over its raw 537 MB grid with the
     fused TF, exact and majorant mode, equal to plain and to the full
     table (run beside phase 11); session.run(16) over raw tables; K13
     raw_tape (state == K1, tape == plain bit for bit) and K14 raw_replay
     (within 1e-4 relative L2 of plain, two runs within 1e-5) in linear,
     quasicubic and nearest mode, timed against their bounds, and the raw
     replay backward driven through prb_render_and_grads
 19. the ray marchers (K15 march_kernel<EAM|DEPTH>, K16 mip_kernel, K17
     iso_kernel, K18 iso_shade_kernel) on the bench volume at 512^2 with
     the JAX renderers' defaults (EAM extinction 100, 64 slices; MIP 64
     steps; ISO 50 steps, isovalue 0.5; Depth extinction 100, 64 slices,
     threshold 0.1): each kernel equal to its plain version bit for bit on
     the u8 packed table, an f32 packed table, quasicubic and nearest over
     the raw grid, at offset 0 and a session's first (the first differing
     pixel printed otherwise); BASELINE config 1 (64^3, 256^2, 64 slices,
     extinction 80, offsets 0 and 0.37); K15's and K16's other instances
     (the f32 table under quasicubic, the raw grid under linear and
     quasicubic, a packed table beside the raw TF: every MarchMode) bit for
     bit at both offsets; K15 over sphere_in_cube(256) (a 136 MB u8 table,
     past the L2), checked and timed; each kernel timed by device time
     against its bound and its plain version, with its instance's
     registers, blocks an SM and waves, and for K15 and K16 the trips per
     ray (mean, p99, max; what a warp pays over a row of 32 and over an
     8 x 4 tile); a RenderSession per renderer, run(16) with the counts
     set to 0 before
     (16 launches of K15, K16 or K17, for ISO also 16 of K18), finite and
     non-empty images, a second run and a checkpoint round trip equal bit
     for bit. Phase 14 also runs `render --renderer eam --device cuda`.
 20. EAM training on the CLI's invert scene at full width (sphere_in_cube(64)
     as an f32 grid, 512^2, 32 slices, extinction 40, 4 orbit views, the
     ramp-alpha TF): K19 eam_backward against eam_backward_plain within
     1e-4 of max |g| (the TF's gradient against the plain version with
     the TF in float64) in the linear, quasicubic and nearest modes, with
     and without the TF, over 64^3 and the 128^3 bench volume; EAMFrame's
     forward (K15, the frame alone) equal to eam_frame bit for bit; both
     timed by device time against their bounds (K19's: the replayed grid
     entries read and their gradients written once, g_img, the TF row;
     the ray, the replayed samples and the reverse steps' operations);
     fit_density for 10 iterations without and with learn_tf, the counts
     set to 0 before (one K15 frame and one K19 launch an iteration, and
     nothing else), its losses against the same loop through the plain
     versions (iteration 0 bit for bit, then 1e-3 relative: all 10
     learning the density, the first 3 learning the TF too), seconds per
     iteration, the device busy share of an iteration (torch.profiler);
     `invert --device cuda --iterations 10` through the CLI.
 21. the RGB MCM renderer (K20 mcm_step, K21 mcm_reset, K8 on the RGB
     state) at 512^2 on the bench volume with the CLI's defaults
     (extinction 40, 8 bounces, 8 steps) and the grayscale ramp TF: K21
     and K20 (2 dispatches) equal to their plain versions in every state
     field bit for bit, two runs identical, on the u8 packed table, an
     f32 packed table, quasicubic, raw tables (pack_tables=False),
     nearest, phase 12's environment map and over a lane table (the
     default pose, with that map); K20 timed as the session calls it (one
     launch of 16 dispatches from the reset state) against its bound (the
     state read and written once, each volume entry and env texel its
     replayed lookups touch once, the TF's row 0; the replayed run's
     operations), K21 by device time; K8 on the RGB state equal to
     plain; the compacted render's hit pixels equal to the full render's
     over 10 dispatches;
     a RenderSession per mode, reset() and run(16) with the counts set to
     0 before (one K21 and one K20 launch, K8 when compacted); on the
     default a second run and a checkpoint round trip bit for bit and
     four run(16) calls profiled in a fresh process (every K20 launch
     seen; the device busy share). Phase 14 also runs `render
     --renderer mcm --envmap <npy> --compaction`.
 22. the single-scattering renderer MCS (K22 mcs_frames) on BASELINE config
     2's MCS tier (sphere_in_cube(128), u8; 512^2; extinction 50; the
     frustum-filling camera at z = 1.2; 16 frames a launch): K22 equal to
     its plain version bit for bit (acc and the frame count), two runs
     identical, over 2 frames from a running mean at frame 3 on the u8
     packed table, an f32 packed table, quasicubic, nearest over the raw
     grid, phase 12's environment map, majorant_blocks=8 and
     max_collisions=16 (the cap binds); the main scene's 16-frame launch,
     exact and majorant, from a zero state, bit for bit against the plain
     version and a replay of it, timed by device time (CUDA-graph replay)
     against the replay's bound (acc once, each volume entry, majorant cell
     and env texel touched once, the TF's row 0; the replayed trips' and
     lookups' operations), with the trips per lane and frame (mean, p99,
     max) and what a warp and the reference's lockstep frames pay; a
     RenderSession per mode, reset() and run(16) with the counts set to 0
     before (one K22 launch and nothing else of the port's kernels); on the
     default a second run and a checkpoint round trip bit for bit and four
     run(16) calls profiled in a fresh process (the device busy share).
     Phase 14 also runs `render --renderer mcs`.
 23. MCS's persistent lanes (K23 mcs_persistent) on phase 22's scene, BASELINE
     config 2's persistent tiers (512^2 x 4 streams, 8 steps, 16 dispatches
     a launch): K23 equal to its plain version bit for bit on all 16 state
     fields, two launches identical, over 2 dispatches from a mid-flight
     state on the u8 packed table, an f32 packed table, quasicubic, nearest
     over the raw grid, phase 12's environment map, majorant_blocks=8 and one
     stream; the main scene's 16-dispatch launch from a warm state, exact
     and majorant, bit for bit against the plain version run twice, once
     with its work counted (lane-steps, lookups, scatters, deposits, the
     volume entries, env texels and majorant cells touched); each launch
     timed by device time (CUDA-graph replay) against the bound of its
     counted work, with lane-steps/s, deposits/s and steps a deposit beside
     K22's 16-frame launch on the same tables (paths/s); a persistent
     RenderSession per mode, reset() and run(16) with the counts set to 0
     before (one K23 launch and nothing else of the port's kernels); on the
     default a second run and a checkpoint round trip bit for bit and four
     run(16) calls profiled in a fresh process (the busy share, the host's
     wait).
 24. the directional-occlusion renderer DOS (K24 dos_slice) on the bench
     volume at 512^2 with the JAX defaults (steps 50, slices 200, extinction
     100, aperture 30, 8 samples), the grayscale ramp TF: K24 equal to its
     plain version bit for bit (colour, occlusion, display) for one slice
     and for three (the occlusion buffers' ping-pong) from a mid-sweep state
     on the u8 packed table, an f32 packed table, quasicubic and nearest over
     the raw grid at 8 samples, and on the u8 table at 4; a whole sweep by
     RenderSession("dos").run(5), the counts set to 0 before (one K24 launch
     a slice and nothing else), equal to the plain versions' sweep on the
     card bit for bit, and a render past the end (one display launch, the
     same image); a slice launch by device time against its bound (the
     colour and both occlusion buffers once, the volume rows and the TF row
     its replay touches); ms per render and the busy share of four whole
     sweeps profiled in a fresh process. Phase 14 also runs `render
     --renderer dos`.
 25. the local-ambient-occlusion renderer LAO (K25
     lao_frame<LAO,SHADOWS,MODE>) on the bench volume at 512^2 with the JAX
     defaults but 64 slices: K25 equal to its plain version (and a second
     run) bit for bit in its five table modes (the same four and the f32
     table under the quasicubic filter), each in the four flag pairs, each
     mode's both-term frame by device time, the masked march equal to the
     early-stopping one; the u8 frame by device time against the bound of
     its work replayed through the plain version (volume entries and TF rows
     at (value, |gradient|) touched once, the operations per sample), with
     the trips per ray (mean, p99, max, what a warp of 8 x 4 pixels pays); RenderSession("lao").run(16), the counts set to 0 before
     (16 K25 launches and nothing else), equal to the plain frame; ms per
     frame and the busy share in a fresh process. Phase 14 also runs
     `render --renderer lao`.
 26. the slab-sharded render (K26 slab_rows, K27 slab_advance<MAJ>, K28
     slab_finish<NB,MAJ,ENV>) at world size 1 on a one-process NCCL group
     (the card is one GPU): K26 on the bench's 129^3 x 8 table, u8 and f32,
     at n x 1,048,576 requests with n = 1, 2, 4, 8 owners simulated in one
     process (each owner == its plain version, their sum == a local take,
     bit for bit), one owner by device time against its bound; render_slab
     on the bench scene, 2 dispatches == K1 from the same state in every
     field and the image, bit for bit, in the default, quasicubic, f32-table
     and environment modes (one all-gather, one reduce-scatter and one
     launch each of K27, K26, K28 a step); 16 dispatches timed beside K1's,
     the counts set to 0 before; K27 and K28 per launch by device time
     against their bounds; the collectives' share and the busy share from a
     profile in a fresh process; MCMSpectralRenderer(mesh=ray_mesh(...)) ==
     the renderer without a mesh. Beside phase 11, the sparse scene's
     513^3 x 8 u8 table in majorant mode: render_slab == K1 over 2
     dispatches, K27 and K28 in majorant mode timed, and the one-process
     group closed before phase 12. The slab entries' "launches_of" names
     the run their launches were counted over: the main path, or the
     check run of a mode off it (the f32 table, the majorant).
 27. the slab-sharded PRB backward and optimizer (K27 asking every lane's
     row, K28 slab_finish<NB,0,ENV,TAPE=1>, K5's ROUTED mode, K29
     slab_scatter, K30 slab_contract, K31 slab_pack) at world size 1 on a
     one-process NCCL group, the bench scene: the taped slab dispatch's
     tape and state == K4's bit for bit (default, quasicubic,
     environment); K31 == K10's table with pad_packed_for_slabs's zero
     planes for every owner at n = 1, 2, 4, 8, bit for bit; K5 ROUTED + K29
     == K5's adjoint over one tape at stride 1, stride 4 and importance 4
     (the carry bit for bit; K5 ROUTED's pair list == plain's: the same
     count, and sorted by slot id the slot ids, rows and values bit for
     bit); K29 and K30 (with the halos) at n simulated owners == one owner
     and K9; K29 timed in turns with index_add_ over the same list;
     prb_window_grads_slab (8 dispatches) == the replicated forward-storage
     window (the image and samples bit for bit) in the three modes; the
     main path fit_spectral_slab, 3 iterations of 8 dispatches, the counts
     set to 0 before, against fit_spectral(method="prb", scatter_stride=1)
     (losses rtol 1e-4, params rtol 5e-4 / atol 5e-6), its launches and
     collectives an iteration, seconds an iteration, peak memory, the busy
     share from a fresh process's profile; each new kernel and mode by
     device time (K5 ROUTED by CUDA events) against its bound, K29 beside
     index_add_ of the owned pairs. Beside phase 11, one fit_spectral_slab
     iteration over the sparse 512^3 raw grid (its f32 slab 4.3 GB): its
     seconds and peak memory. Every phase's seconds are logged and kept.
The line before the last is a JSON object with each kernel's launches,
error and times, its bound (the larger of the bytes it must move over the
HBM rate and the FP32 operations this run's data needs over the FP32
peak, H100 SXM data-sheet rates), which of the two binds, the share of
the bound reached, and the one PyTorch call that computes the same
function where there is one; the last line is {"ok": true, "device":
{...}}. Imports nothing of jax or of the JAX package vpt_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import os
import select
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

RES, STREAMS, VOLUME, STEPS, BINS, FRAMES = 512, 4, 128, 8, 12, 64
SOURCE = "vpt_tpu_torch/csrc/mcm_spectral.cu"
BWD_SOURCE = "vpt_tpu_torch/csrc/spectral_backward.cu"
GATHER_SOURCE = "vpt_tpu_torch/csrc/gather_bench.cu"
CORNERS_SOURCE = "vpt_tpu_torch/csrc/corners.cu"
MODES = ((1, "stride"), (4, "stride"), (4, "importance"))
CHUNK, FIT_ITERS, WINDOWS = 4, 3, 8
TAPE_SHARE_MIN = 0.999  # least share of lane-steps where K4's tape equals plain, per field
SPARSE, SPARSE_BLOCKS, SPARSE_BATCH, SPARSE_ROUNDS = 512, 16, 16, 3
ENV_SHAPE, ENV_FRAMES = (256, 512, 3), 64
# H100 SXM peaks (NVIDIA's data sheet, SXM part, dense rates
# table): HBM3 bytes/s and FP32 operations/s outside the tensor cores
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
# FP32 operations per event of the Woodcock step, counted from the
# reference's arithmetic (a lower bound: the integer hash chain and the
# HG scatter, whose count no state records, are left out). Every
# lane-step: the flight (2 uniforms, log, divide, 3 x mul-add), the
# out-of-bounds test (6), the wheel (uniform, 4, 2 compares). A lookup
# inside the volume: 3 axes (4 each), 8 u8 dequantizations, 7 trilinear
# lerps (3 each), the TF row's density axis (4) and 9 lerps, g (2). A
# respawn: the deposit (3 per bin), the disk (6), 4 uniforms, the screen
# point (8), two homogeneous transforms (31 each), the normalization
# (13), the slab test (24), the position (6), the wavelength (5 + a
# compare per bin boundary), its TF column (6).
OPS_STEP, OPS_LOOKUP, OPS_RESPAWN = 24, 74, 135
# FP32 operations of K12 (surrogate_reverse), counted from its source: per
# lane-step the carry, the extinction score and the position update (~30);
# per null or scatter event the re-read volume row (3 axes, 7 lerps) and TF
# row (9 lerps, 3 slopes), the event scores, the spatial gradient and the
# scatter weights (~100); per anisotropic scatter the sphere and cosine
# redraw and the HG reverse (~90)
OPS_SUR_STEP, OPS_SUR_EVENT, OPS_SUR_HG = 30, 100, 90
SUR_SOURCE = "vpt_tpu_torch/csrc/surrogate.cu"
# the xy half-packed volume (the reference's big-volume mode)
XY_TABLES = frozenset({"density_xy", "material_tf", "light_spectrum"})
RAW_SOURCE = "vpt_tpu_torch/csrc/raw_backward.cu"
# the raw and partly packed layouts of phase 18 (pack_tables values)
RAW_LAYOUTS = (("raw", False), ("raw grid + fused TF", frozenset({"material_tf", "light_spectrum"})),
               ("16-wide TF", frozenset({"material_tf"})),
               ("pair light", frozenset({"light_spectrum"})),
               ("packed volume + raw TF", frozenset({"density"})))
# FP32 operations of K14 (raw_replay), counted from its source, beside the
# replayed step's: per scoring event (null or scatter with q != 0) the
# re-derived material (3 axes and 7 lerps of the grid, 9 lerps and 3
# slopes of the TF), the scores (~20), the TF weights and 12 products, the
# trilinear weights and 8 products (~110); per escape with cb != 0 the
# light's coordinate and 2 weights (~12)
OPS_RAW_EVENT, OPS_RAW_ESCAPE = 110, 12
RM_SOURCE = "vpt_tpu_torch/csrc/raymarch.cu"
# phase 19, the ray marchers at the JAX renderers' defaults, R = 512
RM_RES, RM_EAM, RM_MIP_STEPS, RM_ISO, RM_DEPTH = (
    512, dict(extinction=100.0, slices=64), 64, dict(steps=50, isovalue=0.5),
    dict(extinction=100.0, slices=64, threshold=0.1))
RM_FRAMES = 16
# FP32 operations of K15-K18, counted from csrc/raymarch.cu: per pixel the
# ray (the screen point 8, two homogeneous transforms 31 each, the slab test
# 26, entry and exit 18, the segment length 10); per sample the position (9
# with its t), the volume lookup (3 axes, 8 dequantizations, 7 lerps: 41)
# and the TF row (2 axes, 12 lerps: 44) and the march's own update (~6);
# per shaded pixel 7 lookups and the normal and Lambert term (~30)
OPS_MARCH_RAY, OPS_MARCH_SAMPLE, OPS_SHADE = 127, 100, 7 * 85 + 30
# phase 20, EAM training on the CLI's invert scene: sphere_in_cube(64) as an
# f32 grid, R = 512, 32 slices, extinction 40, 4 orbit views (pitch -0.4),
# the ramp-alpha TF, Adam at fit_density's learning rate; 10 iterations
EAM_FIT = dict(volume=64, res=512, slices=32, extinction=40.0, views=4, iterations=10, lr=0.05)
# K19's bound counts the function's work: each active sample's forward once
# (OPS_MARCH_SAMPLE, which the reverse needs) and the reverse's own adjoint
# arithmetic per active step, counted from csrc/raymarch.cu: the recurrence
# and the cotangent of c (18), the TF row's slope (12) and the volume
# scatter's transposed lerps (14); learning the TF, the texels' transposed
# lerps (8). K19's replay of the TF value and the sample position in the
# reverse walk is its design's, not the function's, and is not counted.
OPS_EAM_BWD_STEP, OPS_EAM_BWD_TF = 44, 8
# K19 against its plain version: max |kernel - plain| <= this x max |plain|.
# Atomics add in no fixed order. The TF's gradient sums ~1e6 terms a texel
# (texel 0's alpha takes every empty-space sample), which a signed cotangent
# cancels ~1000-fold: K19 sums the TF's row in double, and its plain
# reference is the plain version run with the TF in float64, so that the
# reference's own float32 sums do not set the error. The chip read 1.3e-7 to
# 3.4e-7 (g_density) and 3.7e-8 to 1.7e-7 (g_tf) of max |g|; a float32 row
# reads 5.1e-5 to 8.6e-5 (probes/eam_tf_sums.py), which this limit refuses
EAM_BWD_RTOL = 1e-6
# fit_density's losses against the same loop through the plain versions, at
# most this relative per iteration (the chip read 0 for the density and
# 1.6e-6 learning the TF)
EAM_FIT_LOSS_RTOL = 1e-5
MCM_SOURCE = "vpt_tpu_torch/csrc/mcm.cu"
# phase 21, the RGB MCM renderer on the bench volume at R = 512 with the CLI's
# defaults (extinction 40, 8 bounces, 8 steps) and JAX's grayscale ramp TF
MCM_CONFIG = dict(extinction=40.0, bounces=8, steps=STEPS)
MCM_FRAMES = 16
# FP32 operations of K20, counted from csrc/mcm.cu: every lane-step the
# flight (a uniform, log, the quotient, 3 x mul-add: 11), the out-of-bounds
# test (6) and the wheel (a uniform, p_null, max3, the products and sums, 2
# compares: 11); a lookup inside the volume: 3 axes (4 each), 8 u8
# dequantizations, 7 lerps (3 each) and the TF row's 2 axes and 12 lerps
# (85); a respawn (a completed path): the running mean (10), the disk (10),
# the square and screen points (16), two homogeneous transforms (31 each),
# the normalization (13), the slab test (24), the position (6); an escape:
# the equirect coordinates (9), 2 axes (8), 9 lerps (27), the transmittance
# products (3); a scatter: the disk and sphere (20), the transmittance (3),
# and with |g| >= 1e-5 the HG cosine and frame (30, none at the phase's g = 0)
OPS_MCM_STEP, OPS_MCM_LOOKUP, OPS_MCM_RESPAWN, OPS_MCM_ESCAPE, OPS_MCM_SCATTER = (
    28, 85, 134, 47, 23)

MCS_SOURCE = "vpt_tpu_torch/csrc/mcs.cu"
# phase 22, the single-scattering renderer MCS on BASELINE config 2's MCS tier
# (tools/capability_configs.py:80-112): sphere_in_cube(128) (u8), R = 512,
# extinction 50, the frustum-filling camera at z = 1.2, 16 frames a launch,
# exact and with majorant_blocks=8; JAX's grayscale ramp TF, the white env
MCS_EXTINCTION, MCS_FRAMES, MCS_BLOCKS = 50.0, 16, 8
# FP32 operations that K22's function needs, counted from csrc/mcs.cu (work
# the kernel repeats or the compiler drops is not charged): per pixel and
# launch the camera ray (two homogeneous transforms, 31 each), the slab test
# (24), the entry and exit (12), the segment's length and divisor (7), the
# view direction (13) and its environment (the equirect coordinates 9, 2 axes
# 8, 9 lerps 27), the uv (4): 166; per lane and frame the running mean (13);
# per frame the light, one environment sample at the scattering direction
# (44); per trip of either loop the flight (a uniform, log, the negation, the
# quotient, the add, the escape compare: 7), with the majorant 13 more (3
# cells of a product, floor and conversion, the floor at 1e-12, the rate, the
# cap's compare and min); the point at a distance (the fraction and 3 lerps:
# 10), charged per lookup and per majorant trip whose starting point no
# earlier trip computed (one after a capped trip; the entry point is known);
# per lookup the volume row (3 axes of 4, 8 u8 dequantizations, 7 lerps: 41)
# and the TF's alpha at (density, 0) (one axis and one lerp: 7; row 0 at v =
# 0 is mixed with itself, and the loops read alpha only), then the
# acceptance (a uniform and the compare: 3) or the transmittance product
# (2), with the majorant alpha / m and its min (2); per collision shaded the
# light's exit and its segment (the slab quotients and differences 12, their
# maxima, minima and the clamp 6, the end point 6, the segment 10: 34), the
# diffuse's RGB on top of the last trip's lookup at the same point (3 lerps:
# 9) and the shading (7); where the last trip of the distance loop was capped
# and computed no point, the point and the lookup in full (58)
(OPS_MCS_PIXEL, OPS_MCS_FRAME, OPS_MCS_LIGHT, OPS_MCS_TRIP, OPS_MCS_TRIP_MAJ, OPS_MCS_POINT,
 OPS_MCS_LOOKUP, OPS_MCS_ACCEPT, OPS_MCS_PRODUCT, OPS_MCS_SHADE, OPS_MCS_FRESH) = (
    166, 13, 44, 7, 13, 10, 48, 3, 2, 50, 58)


# phase 23, MCS's persistent lanes on phase 22's scene: BASELINE config 2's
# persistent tiers (tools/capability_configs.py:126-133 through
# tools/mcs_profile.py:134-175): 512^2 x 4 streams, 8 steps, 16 dispatches a
# launch from a warm state (16 dispatches in), exact and majorant_blocks=8
MCSP_STEPS, MCSP_STREAMS, MCSP_DISPATCHES = 8, 4, 16
MCSP_LANE_BYTES = 73  # a lane's 16 fields: 13 f32, the phase byte, samples, acc
# FP32 operations that K23's function needs, counted from csrc/mcs.cu, each
# where the state takes its result (the hash chain is integer work, so a
# uniform whose value no lane reads costs none): per pixel and launch the
# camera ray, slab test, entry and exit (98), the segment, its length and
# direction (14): 112; per pixel whose lanes deposit the environment the view
# direction (13) and its environment (44): 57; per lane the chain's uv (6);
# per lane-step the flight (a uniform, log, the negation, the quotient, the
# add, the escape compare: 7), with the majorant 19 more (the start point 6,
# 3 cells of a product, floor and conversion, the floor at 1e-12, the rate,
# the cap's compare and min); per lookup the point (6), the volume row and
# the TF's alpha (48) and its min (1; with the majorant / m, 1 more), then
# the acceptance (its uniform and the compare: 3, distance phase) or the
# transmittance product (2, shadow phase); per scatter the TF's RGB on the
# lookup's row (9), the sphere (its two uniforms 4, the rest 17) and the
# shadow ray's cube exit (18); per deposit the mean (13), a shadow-phase one
# the light (44) and the shading (7) besides
(OPS_MCSP_PIXEL, OPS_MCSP_VIEW, OPS_MCSP_LANE, OPS_MCSP_STEP, OPS_MCSP_MAJ, OPS_MCSP_LOOKUP,
 OPS_MCSP_ACCEPT, OPS_MCSP_PRODUCT, OPS_MCSP_SCATTER, OPS_MCSP_DEPOSIT, OPS_MCSP_SHADE) = (
    112, 57, 6, 7, 19, 55, 3, 2, 48, 13, 51)

DOS_SOURCE = "vpt_tpu_torch/csrc/dos.cu"
LAO_SOURCE = "vpt_tpu_torch/csrc/lao.cu"
# phase 24, DOS on the bench volume at R = 512 with the JAX defaults (steps
# 50, slices 200, extinction 100, aperture 30, 8 samples); a whole sweep is
# RenderSession("dos").run(5)
DOS_KW = dict(steps=50, slices=200, extinction=100.0, aperture=30.0)
DOS_RENDERS = 5
# FP32 operations of K24, counted from csrc/dos.cu, each charged where the
# function first needs its result: per slice each disk offset's scale (2 a
# sample); per pixel the uv and NDC (2 adds and 2 quotients, 2 products and
# 2 subtractions: 8), the plane point (a homogeneous transform, 31) and the
# cube test (6), and on a render's last slice the display (7); per pixel
# inside the cube the volume row (3 axes, 8 dequantizations, 7 lerps: 41),
# the TF row at (d, 0) (2 axes, 12 lerps: 44), the extinction, its
# exponential and alpha (4), the compositing (1 - a, 3 x 4, the alpha's sum
# and clamp: 15), the mean and its attenuation (2); per occlusion sample the
# offset point (2), its bilinear texel lerps (2 axes, 3 lerps: 17) and the
# sum (1)
(OPS_DOS_SLICE_SAMPLE, OPS_DOS_PIXEL, OPS_DOS_DISPLAY, OPS_DOS_INSIDE, OPS_DOS_SAMPLE) = (
    2, 45, 7, 106, 20)
# phase 25, LAO on the bench volume at R = 512 with the JAX defaults but 64
# slices (lao_step 0.05: 20 cone points, light (2, -3, -5), radius 0.19)
LAO_SLICES = 64
LAO_FRAMES = 16
# FP32 operations of K25, counted from csrc/lao.cu, each charged where the
# function first needs its result: per frame g_rx = rand2(3.14, 2.71).x (the
# products and sum 3, the cosine, the scale and fract 4: 7) and the shadow
# direction's z (2): 9; per hit pixel the ray (127, as K15's), rx (the NDC 8,
# its scales 2, then 7: 17), t0 (4), the cone jitter (8), the shadow
# direction's x and y (4), norm (6) and scale (6), and the final alpha
# scale (5): 177; with the cone (LAO) per hit pixel and cone point the
# offset lao_dx * (lr * tt) and the light's three shifted axes (5); with the
# shadow (SHADOWS) per hit pixel its offsets sd * lr (3); per active sample
# t, the activity test and the position (2 + 2 + 9), 7 volume lookups (41
# each), the gradient (6 offsets, 3 differences, the norm 5 + sqrt: 15), the
# TF at (value, |gradient|) (2 axes, 12 lerps: 44), the tints (2 x 12 + 2)
# and the compositing (11): 396; per cone point the direction (3 + 5 +
# sqrt), 3 quotients and the point (9), the lookup (41) and the sum (2): 61,
# and the integral's quotient and clamp (3); the shadow its point (3), the
# lookup (41) and the remap (11): 55
(OPS_LAO_FRAME, OPS_LAO_PIXEL, OPS_LAO_CONE_PIXEL, OPS_LAO_SHADOW_PIXEL, OPS_LAO_SAMPLE,
 OPS_LAO_CONE, OPS_LAO_CONE_END, OPS_LAO_SHADOW) = (9, 177, 5, 3, 396, 61, 3, 55)
# phase 26, the slab render at world size 1 (one NCCL rank): K26 at owners
# simulated in one process, 16 render_slab dispatches of the bench scene
SLAB_SOURCE = "vpt_tpu_torch/csrc/slab.cu"
SLAB_OWNERS = (1, 2, 4, 8)
SLAB_DISPATCHES = 16
# FP32 operations of the slab step's halves, OPS_STEP and OPS_LOOKUP's count
# cut where K27 stops: K27 per lane-step the flight (2 uniforms, log,
# divide: 4), the position (6) and the out-of-bounds test (6), per lookup
# the 3 axes' rows and fractions (12); K28 per lane-step the position and
# the test again (12) and the wheel (7), per lookup the 7 lerps of the
# routed row (21), the TF's density axis (4), its 9 lerps (27) and g (2),
# per respawn OPS_RESPAWN and the deposit (4 a bin); K26 per owned u8
# request its 8 dequantizations
OPS_K27_STEP, OPS_K27_LOOKUP, OPS_K28_STEP, OPS_K28_LOOKUP, OPS_K26_U8 = 16, 12, 19, 54, 8
# the slab backward (phase 27): a window and a fit iteration of SLAB_WINDOW
# dispatches, SLAB_FIT_ITERS iterations; FP32 operations: K29 8 adds an
# owned pair, K30 one add a packed value (8 a row); K5 ROUTED as K5 (8 a
# lane-step, the scatters' arithmetic left out)
SLAB_WINDOW, SLAB_FIT_ITERS = 8, 3
OPS_K29_PAIR, OPS_K30_ROW = 8, 8
SLAB_WRT = frozenset({"density"})
# the slab backward's tolerances against the replicated path (atomics: the
# summation order differs): relative L2 of a gradient or adjoint
SLAB_BWD_RTOL = 1e-5

def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, by CUDA events,
    after one untimed call unless ``warm`` is False."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops, ms=None):
    """The least time the card could take for ``nbytes`` moved and ``ops``
    FP32 operations, which of the two binds, and the share reached by a
    kernel time ``ms``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    out = dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
               bound_bytes=int(nbytes), bound_ops=int(ops))
    if ms:
        out["bound_share"] = out["bound_ms"] / ms
    return out


def state_bytes(n_lanes, n_bins):
    """Bytes of a photon state read once and written once (10 lane words
    and the radiance bins; transmittance is never touched by a step)."""
    return 2 * n_lanes * (10 + n_bins) * 4


def table_bytes(ctx, lane_steps):
    """Bytes of the scene tables a step run reads: each table once, but the
    volume and TF tables no more than one lookup's values per lane-step (a
    full table's 8-wide row or an xy table's two 4-wide plane rows, a raw
    grid's 8 corners (1 for nearest) and a raw TF's 4 texels; most of a
    sparse volume is never read)."""
    from vpt_tpu_torch.kernels import mcm_spectral as K

    vol, tf = K.density_table(ctx), ctx.material_tf
    per_vol = 1 if vol.ndim == 3 and ctx.volume_filter == "nearest" else 8
    per_tf = 16 if tf.shape[-1] == 4 else tf.shape[-1]
    out = min(vol.numel(), lane_steps * per_vol) * vol.element_size()
    out += min(tf.numel(), lane_steps * per_tf) * 4
    light = None if tf.shape[-1] == 18 else ctx.light_spectrum
    for t in (ctx.majorant, ctx.environment, light):
        if t is not None:
            out += t.numel() * 4
    return out


def step_ops(lane_steps, respawns, n_bins, lookup_steps):
    """FP32 operations a step run needs: every lane-step, a respawn per
    completed path, and a material lookup on ``lookup_steps`` lane-steps."""
    return (lane_steps * OPS_STEP + respawns * (OPS_RESPAWN + 4 * n_bins)
            + lookup_steps * OPS_LOOKUP)


def step_bound(ctx, state, seeds, n_bins, ms, lanes=None, taped=0):
    """``bound`` of K1 (K4 with ``taped`` tape bytes) over ``seeds`` from
    ``state``: its state and tables once (and the tape), and the
    operations of this run's lane-steps. K4 looks up every lane-step; K1
    at least every lane-step that did not leave the volume, lane-steps
    minus respawns (in majorant mode a capped flight skips its lookup, so
    none are counted there)."""
    from vpt_tpu_torch.kernels import mcm_spectral as K

    st = clone_state(state)
    K.step(st, ctx, seeds, STEPS, n_bins, lanes)
    torch.cuda.synchronize()
    n = state.px.numel()
    lane_steps = n * STEPS * len(seeds)
    respawns = int(st.samples.sum()) - int(state.samples.sum())
    if taped:
        lookup_steps = lane_steps
    else:
        lookup_steps = 0 if ctx.majorant is not None else max(lane_steps - respawns, 0)
    nbytes = (state_bytes(n, n_bins) + table_bytes(ctx, lane_steps)
              + 3 * n * 4 * (lanes is not None) + taped)
    out = bound(nbytes, step_ops(lane_steps, respawns, n_bins, lookup_steps), ms)
    out["respawns"] = respawns
    return out


def kernel_line(entry, bnd, library_ms=None):
    """A kernels-line entry with its bound and library-call time."""
    entry.update(bnd)
    entry["library_ms"] = library_ms
    return entry


def device_ms(fn) -> float:
    """Device time per call of ``fn``: 20 calls captured into one CUDA graph
    and replayed between CUDA events (``tools/gather_bench.graph_ms``), so
    the wrapper's host path (checks, allocation, ctypes) runs only at
    capture. ``fn`` must copy nothing from the host."""
    from vpt_tpu_torch.tools import gather_bench as G

    return G.graph_ms(fn)


def bench_scene_args():
    """bench.py's scene: ramp TF, light (1, 0.2, 0.5), extinction 40."""
    from vpt_tpu_torch import (LightConfig, MaterialTF, MCMSpectralConfig,
                               SpectrumConfig, Volume)

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    return (Volume.sphere_in_cube(VOLUME), MaterialTF(table),
            LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
            MCMSpectralConfig(extinction=40.0, bounces=8, steps=STEPS))


def clone_state(state):
    return type(state)(*(t.clone() for t in state.tensors()))


def image_contract(img_a, img_b, samples_a, samples_b):
    """The oracle contract of tests/test_mcm_spectral_parity.py."""
    a, b = img_a.cpu().numpy(), img_b.cpu().numpy()
    diff = np.abs(a - b)
    frac = float(np.mean(diff / (np.abs(b) + 1e-3) < 1e-3))
    med = float(np.median(diff))
    same = float((samples_a == samples_b).float().mean())
    return dict(frac_channels=frac, median_abs=med, frac_samples_equal=same,
                max_abs=float(diff.max()),
                ok=frac >= 0.995 and med < 1e-5 and same >= 0.99)


def first_difference(a, b):
    """(field, lanes that differ, first flat index) of the first state
    field where two states differ bit for bit (NaN == NaN), or None."""
    for name, x, y in zip(a.field_names(), a.tensors(), b.tensors()):
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        ne = (x != y).reshape(-1)
        if bool(ne.any()):
            return name, int(ne.sum()), int(ne.nonzero()[0])
    return None


def check_mode(ctx, state0, seeds, n_bins, label, lanes=None):
    """K1 (in the ctx's mode) vs its plain version from one state: equal in
    every field, bit for bit; two kernel runs identical. Returns the states
    and the largest radiance difference (0.0 when equal)."""
    from vpt_tpu_torch.kernels import mcm_spectral as K

    sk, sk2, sp = clone_state(state0), clone_state(state0), clone_state(state0)
    K.step(sk, ctx, seeds, STEPS, n_bins, lanes)
    K.step(sk2, ctx, seeds, STEPS, n_bins, lanes)
    K.step_plain(sp, ctx, seeds, STEPS, n_bins, lanes)
    torch.cuda.synchronize()
    if first_difference(sk, sk2) is not None:
        raise AssertionError(f"K1 {label}: two runs differ in {first_difference(sk, sk2)}")
    diff = first_difference(sk, sp)
    err = float((sk.radiance - sp.radiance).abs().nan_to_num(0.0).max())
    shape = "x".join(map(str, sk.px.shape))
    log(f"# K1 {label} vs plain, {shape} lanes, {len(seeds)} dispatches: "
        + ("every state field equal bit for bit" if diff is None else
           f"first difference in {diff[0]} on {diff[1]} lanes (first flat lane {diff[2]}), "
           f"radiance max abs {err:.3g}")
        + f"; samples {int(sk.samples.sum())}")
    if diff is not None:
        raise AssertionError(f"K1 {label} != plain: {diff}")
    if int(sk.samples.sum()) <= 0:
        raise AssertionError(f"K1 {label} completed no samples")
    return sk, sp, err


def mode_entry(name, replaces, ctx, state0, n_bins, lanes=None, err=0.0):
    """A kernels-line entry for K1 in one mode: ms per dispatch, kernel vs
    plain, on the main path's shapes."""
    from vpt_tpu_torch.kernels import mcm_spectral as K

    sk, sp = clone_state(state0), clone_state(state0)
    one = [2654435761]
    ms = cuda_ms(lambda: K.step(sk, ctx, one, STEPS, n_bins, lanes), 20)
    plain_ms = cuda_ms(lambda: K.step_plain(sp, ctx, one, STEPS, n_bins, lanes), 2)
    b = step_bound(ctx, state0, one, n_bins, ms, lanes)
    log(f"# {name}: one dispatch {ms:.4f} ms kernel, plain {plain_ms:.4f} ms; bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bound_bytes']} B, {b['bound_ops']} "
        f"FP32 ops), share {b['bound_share']:.3f}")
    return kernel_line(dict(name=name, route="cuda", source=SOURCE, replaces=replaces,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms), b)


def require_launches(launches, keys, what):
    missing = [k for k in keys if launches.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{what} did not launch {missing}: {launches}")


def sparse_scene(dev):
    """The sparse capability scene of tools/capability_configs.py:286-366,
    with the full u8 corner table; returns (renderer, camera, host times)."""
    from vpt_tpu_torch import (Camera, LightConfig, MaterialTF, MCMSpectralConfig,
                               SpectrumConfig, Volume)
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    table = bench_scene_args()[1].table
    t0 = time.perf_counter()
    vol = Volume.sparse_spheres(SPARSE)
    host = dict(sparse_spheres_s=time.perf_counter() - t0)
    renderer = MCMSpectralRenderer(
        vol, MaterialTF(table), LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
        MCMSpectralConfig(extinction=40.0, bounces=8, steps=STEPS), resolution=RES,
        streams=STREAMS, majorant_blocks=SPARSE_BLOCKS, device=dev)
    host.update(pack_volume_s=renderer.build_seconds["pack_volume"],
                majorant_grid_s=renderer.build_seconds["majorant_grid"],
                occupancy=float((np.asarray(vol.density) > 0).mean()),
                table_bytes=renderer.vol_table.numel(),
                table_dtype=str(renderer.vol_table.dtype).replace("torch.", ""),
                majorant_grid=list(renderer.majorant.shape))
    return renderer, Camera(translation=np.array([0.0, 0.0, 1.2])), host


def phase_majorant(dev):
    """Phase 11: the majorant mode at full width against the exact path."""
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.models import mcm_spectral as TM

    renderer, cam, host = sparse_scene(dev)
    if host["table_dtype"] != "uint8":
        raise AssertionError(f"the sparse volume packed to {host['table_dtype']}, not uint8")
    log(f"# sparse scene {SPARSE}^3 ({host['occupancy']:.4%} occupancy): sparse_spheres "
        f"{host['sparse_spheres_s']:.2f} s, corner table ({host['table_bytes']} B u8) "
        f"{host['pack_volume_s']:.2f} s, majorant grid {host['majorant_grid']} "
        f"{host['majorant_grid_s']:.2f} s (host, outside every timed window)")
    ctx_m = renderer.ctx(cam, 7)
    ctx_e = dataclasses.replace(ctx_m, majorant=None)
    seeds2 = [2654435761 * k % 2**32 for k in (1, 2)]
    _, _, err = check_mode(ctx_m, renderer.reset(cam, 7), seeds2, BINS, "majorant mode")
    entry = mode_entry("mcm_spectral_step[majorant]", "vpt_tpu/models/mcm_spectral.py:228",
                       ctx_m, renderer.reset(cam, 7), BINS, err=err)

    def run(majorant: bool, seed_base: int):
        """Reset, one warm-up batch, then SPARSE_ROUNDS timed batches of
        SPARSE_BATCH dispatches (tools/capability_configs.py::config_sparse)."""
        seeds = lambda lo: [(seed_base + lo + k) * 2654435761 % 2**32  # noqa: E731
                            for k in range(SPARSE_BATCH)]
        if majorant:
            state = renderer.reset(cam, 1)
            step = lambda st, lo: renderer.render_many(st, cam, seeds(lo))  # noqa: E731
        else:
            ctx = dataclasses.replace(renderer.ctx(cam, 1), majorant=None)
            state = TM.full_reset(ctx, RES, BINS, STREAMS, device=dev)
            step = lambda st, lo: TM.render_many(st, ctx, seeds(lo), STEPS, BINS)  # noqa: E731
        state, _ = step(state, 0)
        torch.cuda.synchronize()
        s0 = int(state.samples.sum())
        t0 = time.perf_counter()
        for r in range(SPARSE_ROUNDS):
            state, img = step(state, (r + 1) * SPARSE_BATCH)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        paths = int(state.samples.sum()) - s0
        lane_steps = RES * RES * STREAMS * STEPS * SPARSE_BATCH * SPARSE_ROUNDS
        return img.cpu().numpy(), dict(seconds=dt, paths=paths, mpaths_per_s=paths / dt / 1e6,
                                       m_lane_steps_per_s=lane_steps / dt / 1e6)

    img_e, exact = run(False, 0)
    K.reset_launch_counts()
    img_m, major = run(True, 0)
    launches = dict(K.LAUNCHES)
    require_launches(launches, ("step_majorant", "reset"), "the majorant path")
    img_b, _ = run(False, 10_000)
    norm = max(float(np.abs(img_e).mean()), 1e-9)
    rel_l1 = float(np.abs(img_e - img_m).mean()) / norm
    floor = float(np.abs(img_e - img_b).mean()) / norm
    ok = bool(np.isfinite(img_m).all()) and rel_l1 < 2.0 * floor + 1e-3
    out = dict(host=host, exact=exact, majorant=major,
               mpaths_ratio=major["mpaths_per_s"] / exact["mpaths_per_s"],
               pixel_rel_l1_vs_exact=rel_l1, pixel_rel_l1_noise_floor=floor, parity_ok=ok)
    log(f"# sparse {SPARSE}^3, {SPARSE_ROUNDS} x {SPARSE_BATCH} dispatches: exact "
        f"{exact['mpaths_per_s']:.3f} Mpaths/s {exact['m_lane_steps_per_s']:.1f} M lane-steps/s; "
        f"majorant {major['mpaths_per_s']:.3f} Mpaths/s {major['m_lane_steps_per_s']:.1f} "
        f"M lane-steps/s; ratio {out['mpaths_ratio']:.3f}; image rel L1 {rel_l1:.4f} vs "
        f"floor {floor:.4f}; launches {launches}")
    if not ok:
        raise AssertionError(f"majorant image parity failed: {out}")
    entry["launches"] = launches["step_majorant"]
    return entry, out, renderer, cam


def phase_xy(camera, dev):
    """Phase 5, xy: K1 over the bench scene's xy half-packed table equals
    its plain version and the full-table K1 bit for bit in every state
    field (2 dispatches); one dispatch timed against the full table's;
    session.run(16) in xy mode."""
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    full = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS, device=dev)
    xy = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS,
                             pack_tables=XY_TABLES, device=dev)
    seeds2 = [2654435761 * k % 2**32 for k in (1, 2)]
    ctx_x, ctx_f = xy.ctx(camera, 7), full.ctx(camera, 7)
    sk, _, err = check_mode(ctx_x, xy.reset(camera, 7), seeds2, BINS, "xy volume")
    sf = full.reset(camera, 7)
    K.step(sf, ctx_f, seeds2, STEPS, BINS)
    torch.cuda.synchronize()
    if first_difference(sk, sf) is not None:
        raise AssertionError(f"K1 xy != K1 full table: {first_difference(sk, sf)}")
    entry = mode_entry("mcm_spectral_step[xy]", "vpt_tpu/ops/interp.py:226", ctx_x,
                       xy.reset(camera, 7), BINS, err=err)
    one = [2654435761]
    st = full.reset(camera, 7)
    entry["full_table_ms"] = cuda_ms(lambda: K.step(st, ctx_f, one, STEPS, BINS), 20)
    entry.update(table_bytes_xy=xy.vol_table.numel(), table_bytes_full=full.vol_table.numel())
    del full, xy
    _, rates, launches = run_session(dev, 16, pack_tables=XY_TABLES)
    require_launches(launches, ("step_xy",), "session.run in xy mode")
    entry["launches"] = launches["step_xy"]
    entry["session"] = rates
    log(f"# K1 xy == plain == K1 full table bit for bit; one dispatch {entry['ms']:.4f} ms xy vs "
        f"{entry['full_table_ms']:.4f} ms full; session.run(16) in xy mode "
        f"{rates['seconds']:.4f} s, {rates['mpaths_per_s']:.3f} Mpaths/s; launches {launches}")
    return entry


def prb_fit(label, target, renderer, camera, init, dev, mode):
    """fit_spectral(method="prb") at stride 1: FIT_ITERS iterations of CHUNK
    dispatches, the launch counts set to 0 just before; per iteration one
    K4 and one K5 launch, K9 and K10 per learned table, all in ``mode``
    (their ``_environment`` / ``_xy`` counts), and no K1; finite losses,
    moved params, seconds per iteration, peak device memory."""
    from vpt_tpu_torch.kernels import spectral_backward as TB
    from vpt_tpu_torch.optim import fit_spectral

    suffix = {"environment": "env", "xy": "xy"}[mode]
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, losses, info = fit_spectral(target, renderer, camera, init, dispatches_per_step=CHUNK,
                                        iterations=FIT_ITERS, learning_rate=0.02, seed=1,
                                        method="prb", scatter_stride=1, return_info=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {**launch_counts(), **TB.LAUNCHES}
    want = {"prb_tape_forward": FIT_ITERS, "prb_reverse": FIT_ITERS,
            f"prb_tape_forward_{mode}": FIT_ITERS, f"prb_reverse_{mode}": FIT_ITERS,
            f"contract_corners_{suffix}": FIT_ITERS, f"pack_corners_{suffix}": FIT_ITERS,
            "step": 0}
    bad = {k: launches.get(k) for k, v in want.items() if launches.get(k) != v}
    if bad or not np.isfinite(losses).all():
        raise AssertionError(f"fit_spectral prb ({label}): launches {bad} (want {want}), "
                             f"losses {losses}")
    (key, p), = params.items()
    moved = float((p - torch.as_tensor(init[key], device=dev)).abs().max())
    if moved == 0.0 or not bool(torch.isfinite(p).all()):
        raise AssertionError(f"fit_spectral prb ({label}): {key} moved {moved}")
    rec = dict(losses=losses, seconds=dt, seconds_per_iteration=dt / FIT_ITERS,
               max_param_change=moved, peak_memory_bytes=torch.cuda.max_memory_allocated(),
               launches={k: v for k, v in launches.items() if v}, method=info["method"])
    log(f"# fit_spectral prb ({label}, learning {key}): {FIT_ITERS} iterations x {CHUNK} "
        f"dispatches in {dt:.4f} s ({dt / FIT_ITERS:.4f} s per iteration); losses {losses}; max "
        f"param change {moved:.4g}; peak device memory {rec['peak_memory_bytes']} B; launches "
        f"{rec['launches']}")
    return rec


def phase_sparse_xy(renderer, cam, dev):
    """Phase 11, xy: the sparse 512^3 scene's xy table (half the full
    table's bytes) beside the full one: K1 equal to its plain version and
    to the full-table K1 bit for bit over 2 dispatches, in exact and in
    majorant mode (the full renderer's majorant grid); one dispatch timed
    on each table, in turns; then fit_spectral(method="prb") learning an
    f32 density into the xy table, exact mode."""
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    t0 = time.perf_counter()
    xy = MCMSpectralRenderer(renderer.volume, renderer.material_tf, renderer.light,
                             renderer.spectrum, renderer.config, resolution=RES, streams=STREAMS,
                             pack_tables=XY_TABLES, device=dev)
    out = dict(pack_xy_s=time.perf_counter() - t0, table_bytes_xy=xy.vol_table.numel(),
               table_bytes_full=renderer.vol_table.numel(),
               table_dtype=str(xy.vol_table.dtype).replace("torch.", ""))
    seeds2 = [2654435761 * k % 2**32 for k in (1, 2)]
    one = [2654435761]
    for mode, maj in (("exact", None), ("majorant", renderer.majorant)):
        ctx_x = dataclasses.replace(xy.ctx(cam, 7), majorant=maj)
        ctx_f = dataclasses.replace(renderer.ctx(cam, 7), majorant=maj)
        sk, _, err = check_mode(ctx_x, xy.reset(cam, 7), seeds2, BINS,
                                f"xy volume, sparse {SPARSE}^3, {mode} mode")
        sf = xy.reset(cam, 7)
        K.step(sf, ctx_f, seeds2, STEPS, BINS)
        torch.cuda.synchronize()
        if first_difference(sk, sf) is not None:
            raise AssertionError(f"sparse K1 xy ({mode}) != K1 full: {first_difference(sk, sf)}")
        st_x, st_f = xy.reset(cam, 7), xy.reset(cam, 7)
        times = dict(full=[], xy=[])
        for which in ("full", "xy", "xy", "full"):
            st, ctx = (st_x, ctx_x) if which == "xy" else (st_f, ctx_f)
            times[which].append(cuda_ms(lambda: K.step(st, ctx, one, STEPS, BINS), 10))
        rec = dict(xy_ms=float(np.mean(times["xy"])), full_ms=float(np.mean(times["full"])),
                   times=times, max_abs_err=err)
        rec.update(step_bound(ctx_x, xy.reset(cam, 7), one, BINS, rec["xy_ms"]))
        out[mode] = rec
        log(f"# sparse {SPARSE}^3 K1 {mode} mode: xy == plain == full table bit for bit; one "
            f"dispatch {rec['xy_ms']:.4f} ms xy ({out['table_bytes_xy']} B table) vs "
            f"{rec['full_ms']:.4f} ms full ({out['table_bytes_full']} B); bound "
            f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}, share {rec['bound_share']:.3f}")
    # the training path on the big-volume table: a learned f32 density
    # re-packed into xy rows (2.16 GB) each iteration
    seeds = [(3 + k) * 2654435761 % 2**32 for k in range(16)]
    _, target = xy.render_many(xy.reset(cam, 3), cam, seeds)
    init = np.clip(smoothed(renderer.volume.density, 16) * 0.8 + 0.05, 0.0, 1.0)
    out["fit"] = prb_fit(f"sparse {SPARSE}^3, xy, exact", target, xy, cam, {"density": init}, dev,
                         "xy")
    del xy
    torch.cuda.empty_cache()
    return out


def phase_sparse_raw(renderer, cam, dev):
    """Phase 18, sparse: the sparse 512^3 scene with
    pack_tables={"material_tf", "light_spectrum"} (the reference's own
    big-volume mode: the raw 537 MB f32 grid beside the fused TF), in exact
    and majorant mode (the full renderer's majorant grid): K1 equal to its
    plain version and to the full-table K1 bit for bit over 2 dispatches;
    one dispatch timed on each, in turns."""
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    t0 = time.perf_counter()
    raw = MCMSpectralRenderer(renderer.volume, renderer.material_tf, renderer.light,
                              renderer.spectrum, renderer.config, resolution=RES, streams=STREAMS,
                              pack_tables=RAW_LAYOUTS[1][1], device=dev)
    out = dict(upload_s=time.perf_counter() - t0, grid_bytes=raw.vol_table.numel() * 4,
               table_bytes_full=renderer.vol_table.numel())
    seeds2 = [2654435761 * k % 2**32 for k in (1, 2)]
    one = [2654435761]
    for mode, maj in (("exact", None), ("majorant", renderer.majorant)):
        ctx_r = dataclasses.replace(raw.ctx(cam, 7), majorant=maj)
        ctx_f = dataclasses.replace(renderer.ctx(cam, 7), majorant=maj)
        sk, _, err = check_mode(ctx_r, raw.reset(cam, 7), seeds2, BINS,
                                f"raw grid, sparse {SPARSE}^3, {mode} mode")
        sf = raw.reset(cam, 7)
        K.step(sf, ctx_f, seeds2, STEPS, BINS)
        torch.cuda.synchronize()
        if first_difference(sk, sf) is not None:
            raise AssertionError(f"sparse K1 raw ({mode}) != K1 full: {first_difference(sk, sf)}")
        st_r, st_f = raw.reset(cam, 7), raw.reset(cam, 7)
        times = dict(full=[], raw=[])
        for which in ("full", "raw", "raw", "full"):
            st, ctx = (st_r, ctx_r) if which == "raw" else (st_f, ctx_f)
            times[which].append(cuda_ms(lambda: K.step(st, ctx, one, STEPS, BINS), 10))
        rec = dict(raw_ms=float(np.mean(times["raw"])), full_ms=float(np.mean(times["full"])),
                   times=times, max_abs_err=err)
        rec.update(step_bound(ctx_r, raw.reset(cam, 7), one, BINS, rec["raw_ms"]))
        out[mode] = rec
        log(f"# sparse {SPARSE}^3 K1 {mode} mode over the raw grid: == plain == full table bit "
            f"for bit; one dispatch {rec['raw_ms']:.4f} ms raw ({out['grid_bytes']} B grid) vs "
            f"{rec['full_ms']:.4f} ms full ({out['table_bytes_full']} B); bound "
            f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}, share {rec['bound_share']:.3f}")
    del raw
    torch.cuda.empty_cache()
    return out


def raw_scene(camera, dev, pack=False, filt="linear"):
    """The bench scene over raw or partly packed tables: (renderer, ctx,
    reset state)."""
    from vpt_tpu_torch import Volume
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    args = list(bench_scene_args())
    args[0] = Volume(args[0].density, filter=filt)
    r = MCMSpectralRenderer(*args, resolution=RES, streams=STREAMS, pack_tables=pack, device=dev)
    return r, r.ctx(camera, 7), r.reset(camera, 7)


def raw_backward_check(ctx, s0, g_image, label):
    """K13 and K14 on one raw ctx against K1 and the plain versions: K13's
    state equals K1's bit for bit and its tape the plain tape; K14 within
    1e-4 relative L2 of plain per gradient, two runs within 1e-5. Returns
    (tape, g_rs, max relative error, the gradients)."""
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import spectral_backward as TB

    out, tape = TB.raw_tape(s0, ctx, STEPS, BINS)
    k1 = clone_state(s0)
    K.step(k1, ctx, [ctx.seed_bits], STEPS, BINS)
    tp = TB.raw_tape_plain(clone_state(s0), ctx, STEPS, BINS)
    torch.cuda.synchronize()
    if first_difference(out, k1) is not None:
        raise AssertionError(f"K13 ({label}) state != K1: {first_difference(out, k1)}")
    if not torch.equal(tape.view(torch.int32), tp.view(torch.int32)):
        raise AssertionError(f"K13 ({label}) tape != plain on "
                             f"{int((tape.view(torch.int32) != tp.view(torch.int32)).sum())} slots")
    g_rs = TB._deposit_cotangents(g_image, ctx, tuple(s0.px.shape), BINS, TB._m_final(out))
    gk = TB.raw_replay(s0, ctx, tape, g_rs, STEPS, BINS)
    gk2 = TB.raw_replay(s0, ctx, tape, g_rs, STEPS, BINS)
    gp = TB.raw_replay_plain(s0, ctx, tape, g_rs, STEPS, BINS, TB._inv_mu(ctx))
    torch.cuda.synchronize()
    errs, reruns = {}, {}
    for k in gp:
        ref = gp[k].double()
        scale = max(float(torch.linalg.norm(ref)), 1e-30)
        errs[k] = float(torch.linalg.norm(gk[k].double() - ref)) / scale
        reruns[k] = float(torch.linalg.norm(gk[k].double() - gk2[k].double())) / scale
        if not bool(torch.isfinite(gk[k]).all()) or float(ref.abs().sum()) == 0.0:
            raise AssertionError(f"K14 ({label}) {k}: not finite, or a zero gradient")
    log(f"# K13 raw_tape ({label}): state == K1, tape == plain bit for bit; K14 raw_replay vs "
        f"plain, relative L2 {json.dumps(errs)}, two runs {json.dumps(reruns)}")
    if max(errs.values()) > 1e-4 or max(reruns.values()) > 1e-5:
        raise AssertionError(f"K14 ({label}) vs plain {errs}, reruns {reruns}")
    return tape, g_rs, max(errs.values()), gk


def phase_raw(camera, dev):
    """Phase 18: raw and partly packed tables on the bench scene (the raw
    128^3 f32 grid, the raw (256, 256, 4) TF, the raw 256-texel light).
    K1 in every layout equals its plain version and the packed K1 bit for
    bit (2 dispatches), the nearest filter equals its plain version; one
    dispatch timed per layout; session.run(16) over raw tables; K13/K14
    checked in linear, quasicubic and nearest mode and timed, and driven
    through prb_render_and_grads with the counts set to 0 just before."""
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import spectral_backward as TB

    seeds2 = [2654435761 * k % 2**32 for k in (1, 2)]
    one = [2654435761]
    full, ctx_f, s0f = raw_scene(camera, dev, True)
    sf = clone_state(s0f)
    K.step(sf, ctx_f, seeds2, STEPS, BINS)
    st_full = clone_state(s0f)
    layouts = dict(full_table=cuda_ms(lambda: K.step(st_full, ctx_f, one, STEPS, BINS), 20))
    del full
    entry = None
    for label, pack in RAW_LAYOUTS + (("nearest", True),):
        r, ctx, s0 = raw_scene(camera, dev, pack, "nearest" if label == "nearest" else "linear")
        if not K.is_raw(ctx):
            raise AssertionError(f"{label}: the ctx does not select K1's raw instantiation")
        sk, _, err = check_mode(ctx, s0, seeds2, BINS, f"raw tables ({label})")
        if label != "nearest" and first_difference(sk, sf) is not None:
            raise AssertionError(f"K1 raw ({label}) != K1 packed: {first_difference(sk, sf)}")
        if label == "raw":
            entry = mode_entry("mcm_spectral_step[raw]", "vpt_tpu/models/mcm_spectral.py:296",
                               ctx, s0, BINS, err=err)
            layouts[label] = entry["ms"]
        else:
            st = clone_state(s0)
            layouts[label] = cuda_ms(lambda: K.step(st, ctx, one, STEPS, BINS), 20)
        del r
    entry["layouts_ms"] = layouts
    log(f"# K1 raw == plain == K1 packed bit for bit in every layout (nearest == plain); one "
        f"dispatch, ms: {json.dumps(layouts)}")
    _, rates, launches = run_session(dev, 16, pack_tables=False)
    require_launches(launches, ("step_raw",), "session.run over raw tables")
    entry["launches"], entry["session"] = launches["step_raw"], rates
    log(f"# session.run(16) over raw tables: {rates['seconds']:.4f} s, "
        f"{rates['mpaths_per_s']:.3f} Mpaths/s; launches {launches}")

    # the raw replay backward (B9)
    g_image = torch.as_tensor(np.random.default_rng(18).uniform(0.5, 1.5, (RES, RES, 3))
                              .astype(np.float32), device=dev)
    errs = {}
    for filt in ("quasicubic", "nearest", "linear"):
        _, ctx, s0 = raw_scene(camera, dev, False, filt)
        tape, g_rs, errs[filt], _ = raw_backward_check(ctx, s0, g_image, filt)
    n = s0.px.numel()
    lane_steps = n * STEPS
    flags = tape[:, 1].view(torch.int32)
    dep = (flags & 1) > 0
    respawns = int(dep.sum())
    carry = TB._raw_carry(tape, g_rs)
    scoring = sum(int(((c * cb != 0) & ~dep[k]).sum()) for k, (c, cb) in enumerate(carry))
    escapes = sum(int(((cb != 0) & dep[k]).sum()) for k, (_, cb) in enumerate(carry))
    k13_ms = cuda_ms(lambda: TB.raw_tape(s0, ctx, STEPS, BINS), 10)
    k13_plain = cuda_ms(lambda: TB.raw_tape_plain(clone_state(s0), ctx, STEPS, BINS), 1)
    k14_ms = cuda_ms(lambda: TB.raw_replay(s0, ctx, tape, g_rs, STEPS, BINS), 10)
    k14_plain = cuda_ms(lambda: TB.raw_replay_plain(s0, ctx, tape, g_rs, STEPS, BINS,
                                                    TB._inv_mu(ctx)), 1)
    tables = table_bytes(ctx, lane_steps)
    ops = step_ops(lane_steps, respawns, BINS, lane_steps - respawns)
    # K13: the state once, the tables once, the tape written once (with the
    # state copy the wrapper makes)
    b13 = bound(state_bytes(n, BINS) + tables + tape.numel() * 4, ops, k13_ms)
    # K14: the start state, the tape, the deposit cotangents and the tables
    # read once, the four raw adjoints written once
    adj_bytes = (ctx.density.numel() + ctx.material_tf.numel() + ctx.light_spectrum.numel()) * 4
    b14 = bound(n * 10 * 4 + tape.numel() * 4 + g_rs.numel() * 4 + tables + adj_bytes,
                ops + scoring * OPS_RAW_EVENT + escapes * OPS_RAW_ESCAPE, k14_ms)
    TB.reset_launch_counts()
    _, img, grads = TB.prb_render_and_grads(s0, ctx, g_image, STEPS, BINS)
    torch.cuda.synchronize()
    bwd = dict(TB.LAUNCHES)
    require_launches(bwd, ("raw_tape", "raw_replay"), "prb_render_and_grads over raw tables")
    if set(grads) != TB.ALL_WRT or not all(bool(torch.isfinite(g).all()) for g in grads.values()):
        raise AssertionError(f"the raw backward's gradients: {sorted(grads)}")
    log(f"# K13 raw_tape: {k13_ms:.4f} ms (with the state copy) vs plain {k13_plain:.4f}; bound "
        f"{b13['bound_ms']:.4f} ms by {b13['bound_by']}, share {b13['bound_share']:.3f}. K14 "
        f"raw_replay: {k14_ms:.4f} ms (with the adjoints' zeroing) vs plain {k14_plain:.4f}; "
        f"{scoring} scoring events, {escapes} escapes of {lane_steps} lane-steps; bound "
        f"{b14['bound_ms']:.4f} ms by {b14['bound_by']} ({b14['bound_bytes']} B, "
        f"{b14['bound_ops']} FP32 ops), share {b14['bound_share']:.3f}; prb_render_and_grads "
        f"launches {bwd}")
    k13 = kernel_line(dict(name="raw_tape", route="cuda", source=RAW_SOURCE,
                           replaces="vpt_tpu/kernels/spectral_backward.py:140", max_abs_err=0.0,
                           ms=k13_ms, plain_ms=k13_plain, launches=bwd["raw_tape"]), b13)
    k14 = kernel_line(dict(name="raw_replay", route="cuda", source=RAW_SOURCE,
                           replaces="vpt_tpu/kernels/spectral_backward.py:175",
                           max_abs_err=max(errs.values()), rel_l2_by_filter=errs, ms=k14_ms,
                           plain_ms=k14_plain, launches=bwd["raw_replay"],
                           scoring_events=scoring, escapes=escapes), b14)
    return entry, k13, k14


def seeded_envmap(seed: int = 2024) -> np.ndarray:
    """ENV_SHAPE's equirect map with structure in both angles
    (``tools/profile_fit.seeded_envmap``)."""
    from vpt_tpu_torch.tools.profile_fit import seeded_envmap as envmap

    return envmap(ENV_SHAPE, seed)


def mode_args(quasicubic: bool):
    from vpt_tpu_torch import Volume

    args = list(bench_scene_args())
    if quasicubic:
        args[0] = Volume(args[0].density, filter="quasicubic")
    return args


def run_session(dev, frames, hit_paths=None, **kw):
    """A RenderSession on the bench scene driven for ``frames`` dispatches
    with the launch counts set to 0 just before; returns (session, rates,
    launches). ``hit_paths(state)``: the paths completed by hit-pixel lanes,
    reported as ``hit_mpaths_per_s``."""
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.session import RenderSession

    quasicubic = kw.pop("quasicubic", False)
    K.reset_launch_counts()
    session = RenderSession("mcm-spectral", *mode_args(quasicubic), resolution=RES,
                            streams=STREAMS, device=dev, **kw)
    session.run(4)  # warm-up
    paths0 = int(session.state.samples.sum())
    hit0 = hit_paths(session.state) if hit_paths else 0
    t0 = time.perf_counter()
    session.run(frames)
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    hdr = session.hdr_image()
    if hdr.shape != (RES, RES, 3) or not np.isfinite(hdr).all():
        raise AssertionError(f"session {kw}: HDR image {hdr.shape}, finite "
                             f"{np.isfinite(hdr).all()}")
    paths = int(session.state.samples.sum()) - paths0
    lane_steps = session.state.px.numel() * STEPS * frames
    rates = dict(seconds=dt, paths=paths, mpaths_per_s=paths / dt / 1e6,
                 m_lane_steps_per_s=lane_steps / dt / 1e6, lanes=session.state.px.numel(),
                 ms_per_dispatch=dt / frames * 1e3)
    if hit_paths:
        rates["hit_mpaths_per_s"] = (hit_paths(session.state) - hit0) / dt / 1e6
    if paths <= 0:
        raise AssertionError(f"session {kw}: no paths completed")
    return session, rates, launches


def phase_env_quasicubic(dev):
    """Phase 12: K1 in environment and quasicubic mode (and both) against
    plain on the bench scene; session.run in each mode."""
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    env = seeded_envmap()
    cam = Camera()
    seeds2 = [2654435761 * k % 2**32 for k in (5, 6)]
    entries, errs = {}, {}
    for label, qc, e in (("environment", False, env), ("quasicubic", True, None),
                         ("environment+quasicubic", True, env)):
        r = MCMSpectralRenderer(*mode_args(qc), resolution=RES, streams=STREAMS,
                                environment=e, device=dev)
        ctx = r.ctx(cam, 7)
        _, _, errs[label] = check_mode(ctx, r.reset(cam, 7), seeds2, BINS, f"{label} mode")
        if label != "environment+quasicubic":
            entries[label] = mode_entry(
                f"mcm_spectral_step[{label}]",
                "vpt_tpu/models/mcm_spectral.py:148" if label == "environment"
                else "vpt_tpu/ops/interp.py:389", ctx, r.reset(cam, 7), BINS, err=errs[label])
        del r
    rates = {}
    for label, kw, frames in (("environment", dict(environment=env), ENV_FRAMES),
                              ("quasicubic", dict(quasicubic=True), 16)):
        _, rates[label], launches = run_session(dev, frames, **kw)
        require_launches(launches, (f"step_{label}",), f"session.run in {label} mode")
        entries[label]["launches"] = launches[f"step_{label}"]
        log(f"# session.run({frames}) in {label} mode: {rates[label]['seconds']:.4f} s, "
            f"{rates[label]['mpaths_per_s']:.3f} Mpaths/s, "
            f"{rates[label]['m_lane_steps_per_s']:.1f} M lane-steps/s; launches {launches}")
    return entries, rates


def phase_compaction(dev):
    """Phase 13: hit-lane compaction at the default pose (z = 2)."""
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer, SpectralState

    cam = Camera()
    comp = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS,
                               compaction=True, device=dev)
    t0 = time.perf_counter()
    t = comp._compact_tables(cam)
    tables_s = time.perf_counter() - t0
    lanes = (t["lane_ix"], t["lane_iy"], t["lane_seed_iy"])
    n_hit, shape = t["n_hit"], tuple(t["lane_ix"].shape)
    log(f"# compaction tables: {n_hit} of {RES * RES} pixels hit "
        f"({n_hit / RES / RES:.4f}), lanes {shape}; host {tables_s:.2f} s (hit mask, "
        f"lane tables, miss radiance quadrature; cached per pose)")
    ctx = comp.ctx(cam, 7)

    # K2 over the lane table
    got = SpectralState(**K.reset(ctx, RES, BINS, STREAMS, dev, lanes=lanes))
    plain = SpectralState(**K.reset_plain(ctx, RES, BINS, STREAMS, dev, lanes=lanes))
    torch.cuda.synchronize()
    if first_difference(got, plain) is not None:
        raise AssertionError(f"compact K2 != plain: {first_difference(got, plain)}")
    k2_ms = device_ms(lambda: K.reset(ctx, RES, BINS, STREAMS, dev, lanes=lanes))
    k2_host_ms = cuda_ms(lambda: K.reset(ctx, RES, BINS, STREAMS, dev, lanes=lanes), 20)
    k2_plain_ms = device_ms(lambda: K.reset_plain(ctx, RES, BINS, STREAMS, dev, lanes=lanes))
    log(f"# K2 over the lane table: every field equal to plain; device {k2_ms:.4f} ms kernel vs "
        f"{k2_plain_ms:.4f} ms plain; host path {k2_host_ms:.4f} ms")
    k2 = kernel_line(dict(name="mcm_spectral_reset[lane_table]", route="cuda", source=SOURCE,
                          replaces="vpt_tpu/models/mcm_spectral_compact.py:328", max_abs_err=0.0,
                          ms=k2_ms, plain_ms=k2_plain_ms, host_ms=k2_host_ms),
                     reset_bound(got.px.numel(), k2_ms, lanes=True))

    # K1 over the lane table, then K8 on its state
    seeds2 = [2654435761 * k % 2**32 for k in (1, 2)]
    sk, _, err = check_mode(ctx, got, seeds2, BINS, "lane table", lanes)
    k1 = mode_entry("mcm_spectral_step[lane_table]",
                    "vpt_tpu/models/mcm_spectral_compact.py:352", ctx, got, BINS, lanes, err)
    # the xy half-packed volume over the lane table: plain and the full
    # table's K1 bit for bit
    comp_xy = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS,
                                  compaction=True, pack_tables=XY_TABLES, device=dev)
    sk_xy, _, _ = check_mode(comp_xy.ctx(cam, 7), got, seeds2, BINS, "lane table, xy volume",
                             lanes)
    if first_difference(sk_xy, sk) is not None:
        raise AssertionError(f"K1 xy over the lane table != the full table's: "
                             f"{first_difference(sk_xy, sk)}")
    del comp_xy, sk_xy
    a = K.compact_radiance(sk.radiance, t["pixel_hit"], t["miss"], n_hit, STREAMS)
    b = K.compact_radiance(sk.radiance, t["pixel_hit"], t["miss"], n_hit, STREAMS)
    p = K.compact_radiance_plain(sk.radiance, t["pixel_hit"], t["miss"], n_hit, STREAMS)
    torch.cuda.synchronize()
    if not (torch.equal(a.view(torch.int32), p.view(torch.int32)) and torch.equal(a, b)):
        raise AssertionError(f"K8 compact_image != plain on {int((a != p).sum())} values")
    k8_ms = device_ms(lambda: K.compact_radiance(sk.radiance, t["pixel_hit"], t["miss"], n_hit,
                                                 STREAMS))
    k8_host_ms = cuda_ms(lambda: K.compact_radiance(sk.radiance, t["pixel_hit"], t["miss"],
                                                    n_hit, STREAMS), 50)
    k8_plain_ms = cuda_ms(lambda: K.compact_radiance_plain(sk.radiance, t["pixel_hit"],
                                                           t["miss"], n_hit, STREAMS), 10)
    log(f"# K8 compact_image: equal to plain bit for bit, reruns identical; device {k8_ms:.4f} "
        f"ms kernel vs {k8_plain_ms:.4f} ms plain; host path {k8_host_ms:.4f} ms")
    # K8 reads the S stream lanes of each hit pixel and the closed form of
    # every pixel, writes every pixel, per bin; no arithmetic to speak of
    n_pix = RES * RES
    k8_bytes = BINS * (STREAMS * n_hit + 2 * n_pix) * 4 + n_pix * 4
    k8 = kernel_line(dict(name="compact_image", route="cuda", source=SOURCE,
                          replaces="vpt_tpu/models/mcm_spectral_compact.py:380", max_abs_err=0.0,
                          ms=k8_ms, plain_ms=k8_plain_ms, host_ms=k8_host_ms),
                     bound(k8_bytes, BINS * STREAMS * n_hit, k8_ms))

    # two runs give equal images; hit pixels match the full kernel
    full = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS,
                               device=dev)
    seeds = [(k + 1) * 2654435761 % 2**32 for k in range(10)]
    i1 = comp.render_many(comp.reset(cam, seeds[0]), cam, seeds)[1]
    i2 = comp.render_many(comp.reset(cam, seeds[0]), cam, seeds)[1]
    i_full = full.render_many(full.reset(cam, seeds[0]), cam, seeds)[1]
    torch.cuda.synchronize()
    if not torch.equal(i1, i2):
        raise AssertionError("compacted renders differ between two runs")
    hit = t["hit"]
    torch.testing.assert_close(i1[hit], i_full[hit], rtol=1e-5, atol=1e-6)
    hit_err = float((i1[hit] - i_full[hit]).abs().max())
    log(f"# compaction: two runs equal; hit pixels vs the full kernel max abs {hit_err:.3g} "
        "(rtol 1e-5)")
    del full

    # scene Mpaths/s counts the full kernel's miss-lane churn (a miss lane
    # completes a path every step) and the compact padding lanes, so the
    # comparison is per dispatch and by the paths of hit-pixel lanes
    # (tools/compact_bench.py)
    def full_hits(state):
        return int(state.samples[:, hit].sum())

    def compact_hits(state):
        return int(state.samples.reshape(-1)[:STREAMS * n_hit].sum())

    rates, launches = {}, {}
    for label, kw in (("full", dict(hit_paths=full_hits)),
                      ("compact", dict(compaction=True, hit_paths=compact_hits))):
        _, rates[label], launches[label] = run_session(dev, FRAMES, **kw)
        log(f"# session.run({FRAMES}) {label}: {rates[label]['ms_per_dispatch']:.4f} ms per "
            f"dispatch, hit-pixel {rates[label]['hit_mpaths_per_s']:.3f} Mpaths/s, scene "
            f"{rates[label]['mpaths_per_s']:.3f} Mpaths/s over {rates[label]['lanes']} lanes, "
            f"{rates[label]['m_lane_steps_per_s']:.1f} M lane-steps/s; "
            f"launches {launches[label]}")
    require_launches(launches["compact"], ("step_lane_table", "reset_lane_table",
                                           "compact_radiance"), "the compacted session")
    k1["launches"] = launches["compact"]["step_lane_table"]
    k2["launches"] = launches["compact"]["reset_lane_table"]
    k8["launches"] = launches["compact"]["compact_radiance"]
    rates["dispatch_speedup"] = (rates["full"]["ms_per_dispatch"]
                                 / rates["compact"]["ms_per_dispatch"])
    rates["hit_mpaths_ratio"] = (rates["compact"]["hit_mpaths_per_s"]
                                 / rates["full"]["hit_mpaths_per_s"])
    log(f"# compaction: dispatch speedup {rates['dispatch_speedup']:.3f}, hit-pixel Mpaths/s "
        f"ratio {rates['hit_mpaths_ratio']:.3f}")

    # every mode at once
    _, rates["all_modes"], all_launches = run_session(
        dev, 16, compaction=True, majorant_blocks=8, quasicubic=True,
        environment=seeded_envmap(), pack_tables=XY_TABLES)
    require_launches(all_launches, ("step_lane_table", "step_majorant", "step_quasicubic",
                                    "step_environment", "step_xy", "compact_radiance"),
                     "the all-modes session")
    log(f"# compaction + majorant + quasicubic + environment + xy, session.run(16): "
        f"{rates['all_modes']['mpaths_per_s']:.3f} Mpaths/s; launches {all_launches}")
    rates.update(tables_host_s=tables_s, n_hit=n_hit, lane_shape=list(shape),
                 hit_max_abs_vs_full=hit_err)
    return [k1, k2, k8], rates


def phase_cli():
    """Phase 14: the port's CLI renders on the card in a subprocess."""
    with tempfile.TemporaryDirectory() as tmp:
        env_path, out = os.path.join(tmp, "env.npy"), os.path.join(tmp, "render.npy")
        np.save(env_path, seeded_envmap(7)[::4, ::4])
        cmd = [sys.executable, "-m", "vpt_tpu_torch.cli", "render", "--device", "cuda",
               "--majorant-blocks", "8", "--compaction", "--envmap", env_path, "-o", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        metrics = json.loads(proc.stdout.strip().splitlines()[-1])
        img = np.load(out)
    if img.shape != (512, 512, 3) or img.dtype != np.uint8 or metrics.get("paths", 0) <= 0:
        raise AssertionError(f"CLI wrote {img.shape} {img.dtype}, metrics {metrics}")
    if not metrics.get("device", "").startswith("cuda"):
        raise AssertionError(f"CLI ran on {metrics.get('device')}")
    log(f"# CLI render --device cuda --majorant-blocks 8 --compaction --envmap: exit 0 in "
        f"{dt:.2f} s (process), image {img.shape}, metrics {json.dumps(metrics)}")
    # the ray marcher EAM through the CLI (K15)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "eam.npy")
        cmd = [sys.executable, "-m", "vpt_tpu_torch.cli", "render", "--device", "cuda",
               "--renderer", "eam", "--frames", "16", "-o", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        dt_eam = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"CLI --renderer eam exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        m_eam = json.loads(proc.stdout.strip().splitlines()[-1])
        img = np.load(out)
    if (img.shape != (512, 512, 3) or img.dtype != np.uint8 or m_eam.get("frames") != 16
            or not m_eam.get("device", "").startswith("cuda") or not img.any()):
        raise AssertionError(f"CLI --renderer eam wrote {img.shape} {img.dtype}, metrics {m_eam}")
    log(f"# CLI render --device cuda --renderer eam --frames 16: exit 0 in {dt_eam:.2f} s "
        f"(process), image {img.shape}, metrics {json.dumps(m_eam)}")
    # the RGB renderer through the CLI (K20, K21, K8), env map and compaction
    with tempfile.TemporaryDirectory() as tmp:
        env_path, out = os.path.join(tmp, "env.npy"), os.path.join(tmp, "mcm.npy")
        np.save(env_path, seeded_envmap(7)[::4, ::4])
        cmd = [sys.executable, "-m", "vpt_tpu_torch.cli", "render", "--device", "cuda",
               "--renderer", "mcm", "--envmap", env_path, "--compaction", "--frames", "16",
               "-o", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        dt_mcm = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"CLI --renderer mcm exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        m_mcm = json.loads(proc.stdout.strip().splitlines()[-1])
        img = np.load(out)
    if (img.shape != (512, 512, 3) or img.dtype != np.uint8 or m_mcm.get("paths", 0) <= 0
            or not m_mcm.get("device", "").startswith("cuda") or not img.any()):
        raise AssertionError(f"CLI --renderer mcm wrote {img.shape} {img.dtype}, metrics {m_mcm}")
    log(f"# CLI render --device cuda --renderer mcm --envmap --compaction --frames 16: exit 0 "
        f"in {dt_mcm:.2f} s (process), image {img.shape}, metrics {json.dumps(m_mcm)}")
    # the single-scattering renderer through the CLI (K22), the reference's
    # defaults
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "mcs.npy")
        cmd = [sys.executable, "-m", "vpt_tpu_torch.cli", "render", "--device", "cuda",
               "--renderer", "mcs", "--frames", "16", "-o", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        dt_mcs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"CLI --renderer mcs exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        m_mcs = json.loads(proc.stdout.strip().splitlines()[-1])
        img = np.load(out)
    if (img.shape != (512, 512, 3) or img.dtype != np.uint8 or m_mcs.get("frames") != 16
            or not m_mcs.get("device", "").startswith("cuda") or not img.any()):
        raise AssertionError(f"CLI --renderer mcs wrote {img.shape} {img.dtype}, metrics {m_mcs}")
    log(f"# CLI render --device cuda --renderer mcs --frames 16: exit 0 in {dt_mcs:.2f} s "
        f"(process), image {img.shape}, metrics {json.dumps(m_mcs)}")
    # the occlusion renderers through the CLI (K24, K25), the reference's
    # defaults
    occl = {}
    for key in ("dos", "lao"):
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, f"{key}.npy")
            cmd = [sys.executable, "-m", "vpt_tpu_torch.cli", "render", "--device", "cuda",
                   "--renderer", key, "--frames", "16", "-o", out]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                                  cwd=os.path.dirname(os.path.abspath(__file__)))
            dt_k = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"CLI --renderer {key} exited {proc.returncode}: "
                                     f"{proc.stderr[-2000:]}")
            m_k = json.loads(proc.stdout.strip().splitlines()[-1])
            img = np.load(out)
        if (img.shape != (512, 512, 3) or img.dtype != np.uint8 or m_k.get("frames") != 16
                or not m_k.get("device", "").startswith("cuda") or not img.any()):
            raise AssertionError(f"CLI --renderer {key} wrote {img.shape} {img.dtype}, "
                                 f"metrics {m_k}")
        occl[key] = dict(seconds=dt_k, metrics=m_k)
        log(f"# CLI render --device cuda --renderer {key} --frames 16: exit 0 in {dt_k:.2f} s "
            f"(process), image {img.shape}, metrics {json.dumps(m_k)}")
    return dict(seconds=dt, metrics=metrics, eam=dict(seconds=dt_eam, metrics=m_eam),
                mcm=dict(seconds=dt_mcm, metrics=m_mcm), mcs=dict(seconds=dt_mcs, metrics=m_mcs),
                **occl)


def phase_k3(dev):
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.ops import interp

    codes = np.arange(256, dtype=np.uint8).reshape(4, 8, 8)
    raw = codes.astype(np.float32) / np.float32(255.0)
    pv = interp.pack_volume_auto(raw, dev)
    if pv.table.dtype != torch.uint8:
        raise AssertionError("an all-codes volume must pack to a u8 table")
    f32 = torch.as_tensor(interp.pack_volume_corners(raw).reshape(-1, 8), device=dev)
    rng = np.random.default_rng(0)
    u, v, w = (torch.as_tensor(rng.random(4096, dtype=np.float32), device=dev) for _ in range(3))
    got = K.sample_volume_packed(pv.table, pv.dims, u, v, w)
    plain = K.sample_volume_packed_plain(pv.table, pv.dims, u, v, w)
    from_f32 = K.sample_volume_packed(f32, pv.dims, u, v, w)
    torch.cuda.synchronize()
    if not torch.equal(got, plain):
        raise AssertionError(f"K3 u8 != plain on {(got != plain).sum().item()} of 4096")
    if not torch.equal(got, from_f32):
        raise AssertionError(f"K3 u8 != K3 f32 on {(got != from_f32).sum().item()} of 4096")
    # texel centres (power-of-two dims: frac == 0 exactly) return each code
    z, y, x = np.meshgrid(np.arange(4), np.arange(8), np.arange(8), indexing="ij")
    cu, cv, cw = (torch.as_tensor(((c.ravel() + 0.5) / n).astype(np.float32), device=dev)
                  for c, n in ((x, 8), (y, 8), (z, 4)))
    centres = K.sample_volume_packed(pv.table, pv.dims, cu, cv, cw).cpu().numpy()
    want = codes.ravel().astype(np.float32) / np.float32(255.0)
    if not np.array_equal(centres, want):
        raise AssertionError(f"u8 dequantization != k/255 on {(centres != want).sum()} codes")

    # time at the main path's table and lane count: 129^3 u8 rows, 1M lanes
    vol = interp.pack_volume_auto(bench_scene_args()[0].density, dev)
    n = RES * RES * STREAMS
    uu, vv, ww = (torch.rand(n, device=dev) for _ in range(3))
    ms = device_ms(lambda: K.sample_volume_packed(vol.table, vol.dims, uu, vv, ww))
    host_ms = cuda_ms(lambda: K.sample_volume_packed(vol.table, vol.dims, uu, vv, ww), 50)
    plain_ms = device_ms(lambda: K.sample_volume_packed_plain(vol.table, vol.dims, uu, vv, ww))
    got = K.sample_volume_packed(vol.table, vol.dims, uu, vv, ww)
    err = float((got - K.sample_volume_packed_plain(vol.table, vol.dims, uu, vv, ww)).abs().max())
    # the library call: trilinear grid_sample on the float volume, texel
    # centres at half a texel, edge-clamped; its grid built outside the timing
    dense = torch.as_tensor(bench_scene_args()[0].density, device=dev)[None, None]
    grid = (torch.stack([uu, vv, ww], -1) * 2.0 - 1.0).reshape(1, 1, 1, n, 3)

    def library():
        return torch.nn.functional.grid_sample(dense, grid, mode="bilinear",
                                               padding_mode="border", align_corners=False)

    lib_err = float((library().reshape(-1) - got).abs().max())
    if lib_err > 1e-5:
        raise AssertionError(f"grid_sample differs from K3 by {lib_err}: not the same function")
    library_ms = device_ms(library)
    library_host_ms = cuda_ms(library, 50)
    # 3 coordinates in and one value out per lookup, the table once; the
    # lookup's arithmetic: 3 axes (4 each), 8 dequantizations, 7 lerps
    b = bound(n * 16 + vol.table.numel(), n * 41, ms)
    log(f"# K3 sample_volume_packed: 256 codes exact, u8 == f32 == plain; device "
        f"{ms:.4f} ms kernel vs {plain_ms:.4f} ms plain vs {library_ms:.4f} ms "
        f"F.grid_sample (max abs {lib_err:.3g} from K3) per {n} lookups; host path "
        f"{host_ms:.4f} ms kernel vs {library_host_ms:.4f} ms F.grid_sample; bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']}, share {b['bound_share']:.3f}")
    k3 = kernel_line(dict(name="sample_volume_packed", route="cuda", source=SOURCE,
                          replaces="vpt_tpu/ops/interp.py:371", max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, host_ms=host_ms, library_host_ms=library_host_ms,
                          library_call="torch.nn.functional.grid_sample",
                          library_max_abs_err=lib_err), b, library_ms)

    # the xy table: two 4-wide plane rows per lookup, the same corner values
    # lerped in the same order, so every lookup equals the full table's
    full_codes = K.sample_volume_packed(pv.table, pv.dims, u, v, w)
    for dtype, table_of in (("u8", lambda: interp.pack_volume_auto(raw, dev, "xy").table),
                            ("f32", lambda: torch.as_tensor(
                                interp.pack_volume_corners_xy(raw).reshape(-1, 4), device=dev))):
        txy = table_of()
        dims_xy = (4, 9, 9)
        got_xy = K.sample_volume_packed(txy, dims_xy, u, v, w, "xy")
        plain_xy = K.sample_volume_packed_plain(txy, dims_xy, u, v, w, "xy")
        cxy = K.sample_volume_packed(txy, dims_xy, cu, cv, cw, "xy").cpu().numpy()
        torch.cuda.synchronize()
        if not (torch.equal(got_xy, plain_xy) and torch.equal(got_xy, full_codes)
                and np.array_equal(cxy, want)):
            raise AssertionError(f"K3 xy ({dtype}) != plain / the full table / k/255 on "
                                 f"{int((got_xy != full_codes).sum())} of 4096")
    vxy = interp.pack_volume_auto(bench_scene_args()[0].density, dev, "xy")
    ms_xy = device_ms(lambda: K.sample_volume_packed(vxy.table, vxy.dims, uu, vv, ww, "xy"))
    plain_xy_ms = device_ms(lambda: K.sample_volume_packed_plain(vxy.table, vxy.dims, uu, vv, ww,
                                                                 "xy"))
    got_xy = K.sample_volume_packed(vxy.table, vxy.dims, uu, vv, ww, "xy")
    if not torch.equal(got_xy, got):
        raise AssertionError("K3 xy != K3 full at the bench table")
    lib_err_xy = float((library().reshape(-1) - got_xy).abs().max())
    # 3 coordinates in, one value out, the xy table once; the same arithmetic
    bxy = bound(n * 16 + vxy.table.numel(), n * 41, ms_xy)
    log(f"# K3 sample_volume_packed[xy]: 256 codes exact (u8 and f32), equal to plain and to the "
        f"full table's lookup bit for bit; device {ms_xy:.4f} ms kernel ({ms:.4f} full table) vs "
        f"{plain_xy_ms:.4f} ms plain vs {library_ms:.4f} ms F.grid_sample per {n} lookups; "
        f"bound {bxy['bound_ms']:.4f} ms by {bxy['bound_by']} ({vxy.table.numel()} B table), "
        f"share {bxy['bound_share']:.3f}")
    k3_xy = kernel_line(dict(name="sample_volume_packed[xy]", route="cuda", source=SOURCE,
                             replaces="vpt_tpu/ops/interp.py:226", max_abs_err=0.0, ms=ms_xy,
                             plain_ms=plain_xy_ms, full_table_ms=ms,
                             library_call="torch.nn.functional.grid_sample",
                             library_max_abs_err=lib_err_xy), bxy, library_ms)
    return k3, k3_xy


def phase_k3_raw(dev):
    """Phase 18, K3 raw mode: the standalone lookup in the bench scene's raw
    128^3 f32 grid, linear, quasicubic and nearest, equal to the plain
    version bit for bit at 1M coordinates in [-0.2, 1.2]; timed by device
    time per filter, the linear one against F.grid_sample on the same grid."""
    from vpt_tpu_torch.kernels import mcm_spectral as K

    grid = torch.as_tensor(np.asarray(bench_scene_args()[0].density, np.float32), device=dev)
    n = RES * RES * STREAMS
    gen = torch.Generator(device=dev).manual_seed(18)
    ue, ve, we = (torch.rand(n, device=dev, generator=gen) * 1.4 - 0.2 for _ in range(3))
    uu, vv, ww = (torch.rand(n, device=dev, generator=gen) for _ in range(3))
    times, plain_times = {}, {}
    for mode in ("linear", "quasicubic", "nearest"):
        got = K.sample_volume_raw(grid, ue, ve, we, mode)
        plain = K.sample_volume_raw_plain(grid, ue, ve, we, mode)
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            raise AssertionError(f"K3 raw {mode} != plain on {int((got != plain).sum())} of {n}")
        times[mode] = device_ms(lambda: K.sample_volume_raw(grid, uu, vv, ww, mode))
        plain_times[mode] = device_ms(lambda: K.sample_volume_raw_plain(grid, uu, vv, ww, mode))
    got = K.sample_volume_raw(grid, uu, vv, ww)
    dense = grid[None, None]
    coords = (torch.stack([uu, vv, ww], -1) * 2.0 - 1.0).reshape(1, 1, 1, n, 3)

    def library():
        return torch.nn.functional.grid_sample(dense, coords, mode="bilinear",
                                               padding_mode="border", align_corners=False)

    lib_err = float((library().reshape(-1) - got).abs().max())
    if lib_err > 1e-5:
        raise AssertionError(f"grid_sample differs from K3 raw by {lib_err}: not the same function")
    library_ms = device_ms(library)
    # 3 coordinates in and one value out per lookup, the grid once; 3 axes
    # (4 each) and 7 lerps (3 each)
    b = bound(n * 16 + grid.numel() * 4, n * 33, times["linear"])
    log(f"# K3 sample_volume_raw (128^3 f32 grid): linear, quasicubic, nearest each == plain bit "
        f"for bit on {n} lookups in [-0.2, 1.2]; device ms {json.dumps(times)} kernel vs "
        f"{json.dumps(plain_times)} plain vs {library_ms:.4f} F.grid_sample (linear, max abs "
        f"{lib_err:.3g} from K3); bound {b['bound_ms']:.4f} ms by {b['bound_by']}, share "
        f"{b['bound_share']:.3f}")
    return kernel_line(dict(name="sample_volume_raw", route="cuda", source=SOURCE,
                            replaces="vpt_tpu/ops/interp.py:411", max_abs_err=0.0,
                            ms=times["linear"], plain_ms=plain_times["linear"],
                            ms_by_filter=times, plain_ms_by_filter=plain_times,
                            library_call="torch.nn.functional.grid_sample",
                            library_max_abs_err=lib_err), b, library_ms)


def phase_k2(renderer, camera, dev):
    from vpt_tpu_torch.kernels import mcm_spectral as K

    ctx = renderer.ctx(camera, 1)
    got = K.reset(ctx, RES, BINS, STREAMS, dev)
    again = K.reset(ctx, RES, BINS, STREAMS, dev)
    plain = K.reset_plain(ctx, RES, BINS, STREAMS, dev)
    torch.cuda.synchronize()
    for k in got:
        if not torch.equal(got[k].view(-1).view(torch.int32), again[k].view(-1).view(torch.int32)):
            raise AssertionError(f"K2 {k} differs between two runs")
    for k in ("bin", "samples", "bounces", "radiance", "transmittance"):
        if not torch.equal(got[k], plain[k]):
            raise AssertionError(f"K2 {k} != plain")
    err = 0.0
    for k in ("px", "py", "pz", "dx", "dy", "dz", "wavelength"):
        torch.testing.assert_close(got[k], plain[k], rtol=1e-5, atol=1e-6)
        err = max(err, float((got[k] - plain[k]).abs().max()))
    ms = device_ms(lambda: K.reset(ctx, RES, BINS, STREAMS, dev))
    host_ms = cuda_ms(lambda: K.reset(ctx, RES, BINS, STREAMS, dev), 20)
    plain_ms = device_ms(lambda: K.reset_plain(ctx, RES, BINS, STREAMS, dev))
    b = reset_bound(RES * RES * STREAMS, ms)
    log(f"# K2 mcm_spectral_reset: matches plain (max abs {err:.3g}), two runs equal bit for "
        f"bit; device {ms:.4f} ms kernel vs {plain_ms:.4f} ms plain; host path {host_ms:.4f} ms; "
        f"bound {b['bound_ms']:.4f} ms by {b['bound_by']}, share {b['bound_share']:.3f}")
    return kernel_line(dict(name="mcm_spectral_reset", route="cuda", source=SOURCE,
                            replaces="vpt_tpu/models/mcm_spectral.py:181", max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, host_ms=host_ms), b)


def reset_bound(n_lanes, ms, lanes=False):
    """K2 writes a fresh state (10 lane words, radiance and transmittance
    per bin) and reads a lane table when given; one respawn per lane."""
    nbytes = n_lanes * (10 + 2 * BINS) * 4 + 3 * n_lanes * 4 * lanes
    return bound(nbytes, n_lanes * (OPS_RESPAWN + BINS), ms)


def check_k1(renderer, camera, n_bins):
    """K1 vs its plain version over 2 dispatches from one reset state: the
    oracle contract, and bit-identical kernel reruns. Returns (ctx, kernel
    state, plain state, contract numbers)."""
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.models.mcm_spectral import radiance_to_rgb

    ctx = renderer.ctx(camera, 7)
    state0 = renderer.reset(camera, 7)
    seeds = [2654435761 * k % 2**32 for k in (1, 2)]
    sk, sk2, sp = clone_state(state0), clone_state(state0), clone_state(state0)
    K.step(sk, ctx, seeds, STEPS, n_bins)
    K.step(sk2, ctx, seeds, STEPS, n_bins)
    K.step_plain(sp, ctx, seeds, STEPS, n_bins)
    torch.cuda.synchronize()
    for a, b in zip(sk.tensors(), sk2.tensors()):
        if not torch.equal(a, b):
            raise AssertionError("K1 is not bit-identical across two runs")
    diff = first_difference(sk, sp)
    c = image_contract(radiance_to_rgb(sk.radiance, ctx.bin_xyz),
                       radiance_to_rgb(sp.radiance, ctx.bin_xyz), sk.samples, sp.samples)
    shape = "x".join(map(str, sk.px.shape))
    log(f"# K1 mcm_spectral_step vs plain, {shape} lanes, {n_bins} bins, 2 dispatches: "
        f"{json.dumps(c)}; every state field equal to plain bit for bit: {diff is None}")
    if diff is not None:
        raise AssertionError(f"K1 ({n_bins} bins) != plain: {diff}")
    if not c["ok"]:
        raise AssertionError(f"K1 fails the oracle contract against plain: {c}")
    if int(sk.samples.sum()) <= 0:
        raise AssertionError("K1 completed no samples")
    return ctx, sk, sp, c


def phase_k1(renderer, camera, dev):
    from vpt_tpu_torch import SpectrumConfig
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    # the kernel's other instantiation (17..32 bins), at a small shape
    args = list(bench_scene_args())
    args[3] = SpectrumConfig.uniform(24)
    check_k1(MCMSpectralRenderer(*args, resolution=64, streams=2, device=dev), camera, 24)

    ctx, sk, sp, c = check_k1(renderer, camera, BINS)
    one = [2654435761]
    s0 = clone_state(sk)
    ms = cuda_ms(lambda: K.step(sk, ctx, one, STEPS, BINS), 40)
    plain_ms = cuda_ms(lambda: K.step_plain(sp, ctx, one, STEPS, BINS), 3)
    b = step_bound(ctx, s0, one, BINS, ms)
    log(f"# K1 one dispatch ({STEPS} steps, {RES}^2 x {STREAMS}): {ms:.4f} ms kernel, "
        f"plain {plain_ms:.4f} ms; bound "
        f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bound_bytes']} B, {b['bound_ops']} "
        f"FP32 ops, {b['respawns']} respawns), share {b['bound_share']:.3f}")
    return kernel_line(dict(name="mcm_spectral_step", route="cuda", source=SOURCE,
                            replaces="vpt_tpu/models/mcm_spectral.py:212",
                            pallas_counterpart="tools/pallas_step.py:125",
                            max_abs_err=c["max_abs"], ms=ms, plain_ms=plain_ms,
                            frac_channels_within_rel_1e3=c["frac_channels"],
                            frac_samples_equal=c["frac_samples_equal"]), b)


def phase_main(dev):
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.session import RenderSession, frame_seed

    K.reset_launch_counts()
    session = RenderSession("mcm-spectral", *bench_scene_args(), resolution=RES,
                            streams=STREAMS, device=dev)
    session.run(4)  # warm-up
    before = clone_state(session.state)
    paths0 = int(session.state.samples.sum())
    seeds = [frame_seed(session.base_seed, session.frame + 1 + k) for k in range(FRAMES)]
    t0 = time.perf_counter()
    session.run(FRAMES)
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    if launches["reset"] < 1 or launches["step"] != 2:
        raise AssertionError(f"main path did not run through the kernels: {launches}")

    hdr = session.hdr_image()
    if not np.isfinite(hdr).all():
        raise AssertionError("HDR image is not finite")
    paths = int(session.state.samples.sum()) - paths0
    if paths <= 0:
        raise AssertionError("no paths completed")
    u8 = session.image_u8()
    if u8.shape != (RES, RES, 3) or u8.dtype != np.uint8:
        raise AssertionError(f"image_u8 shape {u8.shape} {u8.dtype}")
    lane_steps = RES * RES * STREAMS * STEPS * FRAMES
    kern = dict(seconds=dt, paths=paths, paths_per_s=paths / dt, lane_steps_per_s=lane_steps / dt)
    log(f"# main path (kernels): {FRAMES} dispatches in {dt:.4f} s; "
        f"{paths / dt / 1e6:.3f} Mpaths/s; {lane_steps / dt / 1e6:.1f} M lane-steps/s; "
        f"spp {session.metrics()['spp_mean']:.2f}; launches {launches}")

    # the main path's bound: the state and tables once, the operations of
    # the paths these 64 dispatches completed
    kern.update(bound(state_bytes(before.px.numel(), BINS) + table_bytes(session.renderer.ctx(
        session.camera, seeds[0]), lane_steps), step_ops(lane_steps, paths, BINS,
                                                         max(lane_steps - paths, 0)), dt * 1e3))
    log(f"# main path bound {kern['bound_ms']:.4f} ms by {kern['bound_by']} "
        f"({kern['bound_bytes']} B, {kern['bound_ops']} FP32 ops), share of the run's host time "
        f"{kern['bound_share']:.4f}")

    # the same dispatches by render_many: the session's state bit for bit
    st = clone_state(before)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, _ = session.renderer.render_many(st, session.camera, seeds)
    torch.cuda.synchronize()
    kern["render_many_s"] = time.perf_counter() - t0
    if first_difference(st, session.state) is not None:
        raise AssertionError(f"render_many != the session's state: "
                             f"{first_difference(st, session.state)}")
    log(f"# the same {FRAMES} dispatches by render_many: {kern['render_many_s']:.4f} s "
        f"({lane_steps / kern['render_many_s'] / 1e6:.1f} M lane-steps/s), the session's state "
        f"bit for bit")

    ctx = session.renderer.ctx(session.camera, seeds[0])
    t0 = time.perf_counter()
    K.step_plain(before, ctx, seeds, STEPS, BINS)
    torch.cuda.synchronize()
    dtp = time.perf_counter() - t0
    paths_p = int(before.samples.sum()) - paths0
    plain = dict(seconds=dtp, paths=paths_p, paths_per_s=paths_p / dtp,
                 lane_steps_per_s=lane_steps / dtp)
    log(f"# same dispatches through step_plain: {dtp:.4f} s; "
        f"{paths_p / dtp / 1e6:.3f} Mpaths/s; {lane_steps / dtp / 1e6:.1f} M lane-steps/s")
    return launches, kern, plain


def smoothed(density, factor: int = 8):
    """Blockwise-mean downsample + nearest upsample (the recovery init of
    tools/convergence_stride.py)."""
    d = np.asarray(density, np.float32)
    n = d.shape[0]
    c = d.reshape(n // factor, factor, n // factor, factor, n // factor, factor).mean(axis=(1, 3, 5))
    return np.repeat(np.repeat(np.repeat(c, factor, 0), factor, 1), factor, 2)


def f32_ctx(renderer, camera, dev):
    """The bench ctx with an f32 table, as the inverse loop re-packs a
    learned density: the density moved off the u8 grid."""
    from vpt_tpu_torch.ops import interp

    ctx = renderer.ctx(camera, 7)
    d = torch.as_tensor(np.asarray(renderer.volume.density, np.float32) * 0.9 + 0.05, device=dev)
    table = interp.pack_volume_corners_t(d).reshape(-1, 8).contiguous()
    return dataclasses.replace(ctx, density=interp.PackedVolume(table, ctx.density.dims))


def k4_check(ctx, s0, seeds, wrt, label):
    """K4 from ``s0`` over ``seeds``: its state equals K1's bit for bit,
    two runs are identical, its tape equals the plain tape on at least
    TAPE_SHARE_MIN of lane-steps in every field. Returns (per-field shares,
    the largest float difference, K4's state and tape)."""
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import spectral_backward as TB

    fields = TB.ctx_tape_fields(ctx, wrt)
    s1 = clone_state(s0)
    K.step(s1, ctx, seeds, STEPS, BINS)
    sk, tk = TB.tape_forward(s0, ctx, seeds, STEPS, BINS, wrt)
    _, tk2 = TB.tape_forward(s0, ctx, seeds, STEPS, BINS, wrt)
    sp = clone_state(s0)
    tp = TB.tape_forward_plain(sp, ctx, seeds, STEPS, BINS, wrt)
    torch.cuda.synchronize()
    diff = first_difference(sk, s1)
    if diff is not None:
        raise AssertionError(f"K4 ({label}) final state != K1's: {diff}")
    if not torch.equal(tk.view(torch.int32), tk2.view(torch.int32)):
        raise AssertionError(f"K4 ({label}) is not bit-identical across two runs")
    shares, max_abs = {}, 0.0
    for i, f in enumerate(fields):
        shares[f] = float((tk[:, :, i].view(torch.int32) == tp[:, :, i].view(torch.int32))
                          .float().mean())
        if f not in TB.INT_FIELDS and f not in TB.BOOL_FIELDS:
            max_abs = max(max_abs, float((tk[:, :, i] - tp[:, :, i]).abs().max()))
    worst = min(shares, key=shares.get)
    log(f"# K4 prb_tape_forward ({label}), {len(seeds)} dispatches x {STEPS} steps, "
        f"{len(fields)} fields: state == K1 bitwise, reruns identical; tape == plain on "
        f"{shares[worst]:.6f} of lane-steps in the worst field ({worst})")
    if shares[worst] < TAPE_SHARE_MIN:
        raise AssertionError(f"K4 ({label}) tape field {worst} equals plain on {shares[worst]}")
    return shares, max_abs, (sk, tk)


def k4_timed(out, ctx, s0, seeds, wrt, tape_numel):
    """K4's and its plain version's time over ``seeds``, and its bound."""
    from vpt_tpu_torch.kernels import spectral_backward as TB

    out["ms"] = cuda_ms(lambda: TB.tape_forward(s0, ctx, seeds, STEPS, BINS, wrt), 10)
    out["plain_ms"] = cuda_ms(lambda: TB.tape_forward_plain(clone_state(s0), ctx, seeds, STEPS,
                                                            BINS, wrt), 1)
    kernel_line(out, step_bound(ctx, s0, seeds, BINS, out["ms"], taped=tape_numel * 4))
    log(f"# {out['name']} {len(seeds)} dispatches: {out['ms']:.4f} ms kernel, plain "
        f"{out['plain_ms']:.4f} ms; bound {out['bound_ms']:.4f} ms by {out['bound_by']} "
        f"({out['bound_bytes']} B, {out['bound_ops']} FP32 ops), share {out['bound_share']:.3f}")
    return out


def phase_k4(renderer, camera, dev):
    """K4 vs K1 (state) and vs its plain version (tape), u8 and f32 tables."""
    from vpt_tpu_torch.kernels import spectral_backward as TB

    seeds = [2654435761 * k % 2**32 for k in (3, 4)]
    out = dict(name="prb_tape_forward", route="cuda", source=BWD_SOURCE,
               replaces="vpt_tpu/kernels/spectral_backward.py:660", max_abs_err=0.0,
               min_field_share_equal=1.0)
    keep = None
    for kind, ctx in (("u8", renderer.ctx(camera, 7)), ("f32", f32_ctx(renderer, camera, dev))):
        s0 = renderer.reset(camera, 7)
        shares, max_abs, (sk, tk) = k4_check(ctx, s0, seeds, TB.ALL_WRT, f"{kind} table")
        out["max_abs_err"] = max(out["max_abs_err"], max_abs)
        out["min_field_share_equal"] = min(out["min_field_share_equal"], min(shares.values()))
        out[f"share_equal_{kind}"] = shares
        if kind == "u8":
            keep = (ctx, s0, sk, tk)
    ctx, s0, _, tk = keep
    return k4_timed(out, ctx, s0, seeds, TB.ALL_WRT, tk.numel()), keep


def phase_k5(keep, dev, wrt=None, name="prb_reverse"):
    """K5 vs its plain version on K4's tape: stride 1, stride 4, importance 4."""
    from vpt_tpu_torch.kernels import spectral_backward as TB

    wrt = TB.ALL_WRT if wrt is None else wrt
    ctx, s0, sk, tape = keep
    fields = TB.ctx_tape_fields(ctx, wrt)
    seeds = [2654435761 * k % 2**32 for k in (3, 4)]
    lane, res, streams, n = TB._lanes(s0)
    rng = np.random.default_rng(0)
    g_img = torch.as_tensor(rng.uniform(-1, 1, (RES, RES, 3)).astype(np.float32), device=dev)
    g_rs = TB._deposit_cotangents(g_img, ctx, lane, BINS, TB._m_final(sk))
    out = dict(name=name, route="cuda", source=BWD_SOURCE,
               replaces="vpt_tpu/kernels/spectral_backward.py:781", max_abs_err=0.0,
               max_rel_l2=0.0, modes={})

    def run(stride, mode, plain):
        adj = TB._packed_adj_init(ctx, wrt)
        cot = dict(c=torch.zeros(n, device=dev), cb=torch.zeros(n, device=dev))
        phases = [TB._dispatch_phase(k, s, len(seeds), stride) for k, s in enumerate(seeds)]
        kw = dict(scatter_stride=stride, inv_mu=TB._inv_mu(ctx), resolution=res, streams=streams)
        if plain:
            TB.prb_reverse_plain(tape, fields, g_rs, cot, adj, phases, seeds,
                                 importance=mode == "importance", **kw)
        else:
            TB.prb_reverse(tape, fields, g_rs, cot, adj, phases, seeds, scatter_mode=mode, **kw)
        return adj

    for stride, mode in MODES:
        a, b, p = run(stride, mode, False), run(stride, mode, False), run(stride, mode, True)
        torch.cuda.synchronize()
        rec = {}
        for k in p:
            scale = float(p[k].norm())
            rel = float((a[k] - p[k]).norm()) / max(scale, 1e-30)
            rerun = float((a[k] - b[k]).norm()) / max(scale, 1e-30)
            mabs = float((a[k] - p[k]).abs().max())
            if not bool(torch.isfinite(a[k]).all()) or scale == 0.0:
                raise AssertionError(f"{name} {mode}{stride} {k}: not finite or all zero")
            if rel > 1e-4 or rerun > 1e-5:
                raise AssertionError(f"{name} {mode}{stride} {k}: rel L2 {rel:.3g} vs plain, "
                                     f"{rerun:.3g} between runs")
            rec[k] = dict(rel_l2=rel, max_abs=mabs, rerun_rel_l2=rerun)
            out["max_abs_err"] = max(out["max_abs_err"], mabs)
            out["max_rel_l2"] = max(out["max_rel_l2"], rel)
        rec["ms"] = cuda_ms(lambda: run(stride, mode, False), 5)
        rec["plain_ms"] = cuda_ms(lambda: run(stride, mode, True), 1)
        # the tape fields it must read (the carry's four on every step, the
        # scatter's on every stride-th step, all of them for importance), the
        # deposit cotangents, the carry in and out, the adjoints written once;
        # per lane-step the carry and the extinction score (8 FP32 ops; the
        # scatters' arithmetic is left out)
        n_steps, n_fields, n = tape.shape[0] * tape.shape[1], tape.shape[2], tape.shape[3]
        read_fields = (n_fields if mode == "importance" or stride == 1
                       else 4 + (n_fields - 4) / stride)
        adj_bytes = sum(v.numel() * 4 for v in p.values())
        rec.update(bound(n_steps * n * read_fields * 4 + g_rs.numel() * 4 + 4 * n * 4 + adj_bytes,
                         n_steps * n * 8, rec["ms"]))
        out["modes"][f"{mode}{stride}"] = rec
        log(f"# {name} {mode} {stride}, 2 dispatches: " + ", ".join(
            f"{k} rel {rec[k]['rel_l2']:.3g} abs {rec[k]['max_abs']:.3g} rerun "
            f"{rec[k]['rerun_rel_l2']:.3g}" for k in p)
            + f"; {rec['ms']:.4f} ms kernel vs {rec['plain_ms']:.4f} ms plain; bound "
            f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}, share {rec['bound_share']:.3f}")
    s1 = out["modes"]["stride1"]
    out["ms"], out["plain_ms"] = s1["ms"], s1["plain_ms"]
    return kernel_line(out, {k: s1[k] for k in ("bound_ms", "bound_by", "bound_bytes",
                                                "bound_ops", "bound_share")})


def phase_bwd_modes(camera, dev):
    """Phases 7-8 in the backward's environment, quasicubic and xy
    branches, on the bench scene at full width (the env-lit one with
    ENV_SHAPE's seeded map; the quasicubic filter; the xy half-packed
    table), 2 dispatches: K4 against K1 and its plain version, K5 against
    its plain version at stride 1, stride 4 and importance 4; all five
    keys in env mode."""
    from vpt_tpu_torch.kernels import spectral_backward as TB
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    env = seeded_envmap()
    seeds = [2654435761 * k % 2**32 for k in (3, 4)]
    k4s, k5s = {}, {}
    for mode, replaces in (("environment", "vpt_tpu/kernels/spectral_backward.py:690"),
                           ("quasicubic", "vpt_tpu/kernels/spectral_backward.py:735"),
                           ("xy", "vpt_tpu/kernels/spectral_backward.py:723")):
        r = MCMSpectralRenderer(*mode_args(mode == "quasicubic"), resolution=RES,
                                streams=STREAMS, environment=env if mode == "environment" else None,
                                pack_tables=XY_TABLES if mode == "xy" else True, device=dev)
        ctx, s0 = r.ctx(camera, 7), r.reset(camera, 7)
        wrt = TB.ALL_WRT | {"environment"} if mode == "environment" else TB.ALL_WRT
        shares, max_abs, (sk, tk) = k4_check(ctx, s0, seeds, wrt, f"{mode} mode")
        out = dict(name=f"prb_tape_forward[{mode}]", route="cuda", source=BWD_SOURCE,
                   replaces=replaces, max_abs_err=max_abs,
                   min_field_share_equal=min(shares.values()), share_equal=shares)
        k4s[mode] = k4_timed(out, ctx, s0, seeds, wrt, tk.numel())
        k5s[mode] = phase_k5((ctx, s0, sk, tk), dev, wrt, f"prb_reverse[{mode}]")
        k5s[mode]["replaces"] = {"environment": "vpt_tpu/kernels/spectral_backward.py:821",
                                 "quasicubic": "vpt_tpu/kernels/spectral_backward.py:844",
                                 "xy": "vpt_tpu/kernels/spectral_backward.py:849"}[mode]
        del r, tk, sk
        torch.cuda.empty_cache()
    return k4s, k5s


def plain_window(state, ctx, seeds, g_img, wrt, stride, mode):
    """One fwd+bwd window through the plain versions (tape mode), density
    gradients."""
    from vpt_tpu_torch.kernels import corners as C
    from vpt_tpu_torch.kernels import spectral_backward as TB

    st = clone_state(state)
    tapes = TB.tape_forward_plain(st, ctx, seeds, STEPS, BINS, wrt)
    lane, res, streams, n = TB._lanes(state)
    adj = TB._packed_adj_init(ctx, wrt)
    cot = dict(c=torch.zeros(n, device=g_img.device), cb=torch.zeros(n, device=g_img.device))
    phases = [TB._dispatch_phase(k, s, len(seeds), stride) for k, s in enumerate(seeds)]
    TB.prb_reverse_plain(tapes, TB.tape_fields(wrt),
                         TB._deposit_cotangents(g_img, ctx, lane, BINS, TB._m_final(st)), cot, adj,
                         phases, seeds, scatter_stride=stride, importance=mode == "importance",
                         inv_mu=TB._inv_mu(ctx), resolution=res, streams=streams)
    return st, {"density": C.contract_volume_plain(adj["g_vol"], ctx.density.dims)}


def phase_fit(camera, dev):
    """The training path: fit_spectral at full width in three modes, then
    fwd+bwd windows timed as bench.py measure_fwdbwd times them."""
    from vpt_tpu_torch.kernels import corners as C
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import spectral_backward as TB
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu_torch.optim import fit_spectral
    from vpt_tpu_torch.session import RenderSession
    from vpt_tpu_torch.tools import scatter_bench as SB

    args = bench_scene_args()
    session = RenderSession("mcm-spectral", *args, resolution=RES, streams=STREAMS, device=dev)
    session.run(64)
    target = session.hdr_image()
    renderer = MCMSpectralRenderer(*args, resolution=RES, streams=STREAMS, device=dev)
    init = smoothed(args[0].density, max(VOLUME // 16, 2))  # 8 at 128^3
    fits = {}
    K.reset_launch_counts()
    TB.reset_launch_counts()
    C.reset_launch_counts()
    for stride, mode in MODES:
        before = (dict(K.LAUNCHES), dict(TB.LAUNCHES), dict(C.LAUNCHES))
        t0 = time.perf_counter()
        params, losses = fit_spectral(target, renderer, camera, {"density": init},
                                      dispatches_per_step=CHUNK, iterations=FIT_ITERS,
                                      learning_rate=0.02, seed=1, scatter_stride=stride,
                                      scatter_mode=mode)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        d = params["density"]
        k4 = TB.LAUNCHES["prb_tape_forward"] - before[1]["prb_tape_forward"]
        k5 = TB.LAUNCHES["prb_reverse"] - before[1]["prb_reverse"]
        k1 = K.LAUNCHES["step"] - before[0]["step"]
        k9 = C.LAUNCHES["contract_corners"] - before[2]["contract_corners"]
        k10 = C.LAUNCHES["pack_corners"] - before[2]["pack_corners"]
        if (k4, k5, k1, k9, k10) != (FIT_ITERS, FIT_ITERS, 0, FIT_ITERS, FIT_ITERS):
            raise AssertionError(f"fit_spectral {mode}{stride} launched K4 {k4}, K5 {k5}, K1 {k1}, "
                                 f"K9 {k9}, K10 {k10} times in {FIT_ITERS} iterations")
        if not np.isfinite(losses).all():
            raise AssertionError(f"fit_spectral {mode}{stride}: losses {losses}")
        moved = float((d - torch.as_tensor(init, device=dev)).abs().max())
        if not bool(torch.isfinite(d).all()) or moved == 0.0 or float(d.min()) < 0 or float(d.max()) > 1:
            raise AssertionError(f"fit_spectral {mode}{stride}: params moved {moved}, "
                                 f"range [{float(d.min())}, {float(d.max())}]")
        fits[f"{mode}{stride}"] = dict(losses=losses, seconds=dt, max_param_change=moved,
                                       launches=dict(prb_tape_forward=k4, prb_reverse=k5,
                                                     contract_corners=k9, pack_corners=k10))
        log(f"# fit_spectral {mode} {stride}: {FIT_ITERS} iterations x {CHUNK} dispatches in "
            f"{dt:.4f} s; losses {losses}; max param change {moved:.4g}; K4/K5/K9/K10 launches "
            f"{k4}/{k5}/{k9}/{k10}")
    launches = {**TB.LAUNCHES, **C.LAUNCHES}

    # fwd+bwd windows (bench.py:125-168): chunk 4, wrt={density}, g = ones, u8 table
    ctx = renderer.ctx(camera, 1)
    g_img = torch.ones(RES, RES, 3, device=dev)
    wrt = frozenset({"density"})
    lanes = RES * RES * STREAMS
    windows = {}
    for stride, mode in MODES:
        def window(state, lo):
            seeds = [(lo + k) * 2654435761 % 2**32 for k in range(CHUNK)]
            return TB.prb_render_and_grads_many(state, ctx, seeds, g_img, STEPS, BINS, wrt=wrt,
                                                scatter_stride=stride, scatter_mode=mode)

        state, _, g = window(renderer.reset(camera, 1), 2)
        float(g["density"].sum())
        s_before = int(state.samples.sum())
        t0 = time.perf_counter()
        for k in range(WINDOWS):
            state, _, g = window(state, (k + 1) * CHUNK + 2)
        float(g["density"].sum())
        dt = time.perf_counter() - t0
        paths = int(state.samples.sum()) - s_before
        rec = dict(seconds=dt, mpaths_per_s=paths / dt / 1e6,
                   m_lane_steps_per_s=lanes * STEPS * CHUNK * WINDOWS / dt / 1e6)
        # one window split by piece: the K4 sweep, K5 alone, the reverse
        # sweep (deposit cotangents, adjoint init, K5, K9) by CUDA events; K9
        # by device time (CUDA-graph replay) and host path
        seeds = [(7 + k) * 2654435761 % 2**32 for k in range(CHUNK)]
        sf, tapes, _, m_final = TB._tape_forward_sweep(state, ctx, seeds, STEPS, BINS, wrt)
        rec["k4_ms"] = cuda_ms(lambda: TB._tape_forward_sweep(state, ctx, seeds, STEPS, BINS, wrt),
                               5)
        rec.update({f"k4_{k}": v for k, v in step_bound(ctx, state, seeds, BINS, rec["k4_ms"],
                                                         taped=tapes.numel() * 4).items()})
        lane, res, streams, n = TB._lanes(state)
        g_rs = TB._deposit_cotangents(g_img, ctx, lane, BINS, m_final)
        phases = [TB._dispatch_phase(k, s, CHUNK, stride) for k, s in enumerate(seeds)]
        adj5 = TB._packed_adj_init(ctx, wrt)

        def k5(tp, fields, adj):
            cot = dict(c=torch.zeros(n, device=dev), cb=torch.zeros(n, device=dev))
            TB.prb_reverse(tp, fields, g_rs, cot, adj, phases, seeds, scatter_stride=stride,
                           scatter_mode=mode, inv_mu=TB._inv_mu(ctx), resolution=res,
                           streams=streams)

        rec["k5_ms"] = cuda_ms(lambda: k5(tapes, TB.tape_fields(wrt), adj5), 5)
        rec["k5_contract_ms"] = cuda_ms(lambda: TB._tape_reverse_sweep(
            state, ctx, seeds, tapes, m_final, g_img, STEPS, BINS, wrt, stride, mode), 5)
        rec["contract_ms"] = device_ms(lambda: TB._contract_packed_adjoints(adj5, ctx, wrt))
        rec["contract_host_ms"] = cuda_ms(lambda: TB._contract_packed_adjoints(adj5, ctx, wrt), 20)
        rec["window_ms"] = cuda_ms(lambda: window(state, 99), 3)
        if (stride, mode) == (1, "stride"):
            # what binds K5: the same window's reverse with no scatter (a tape
            # of the carry's fields, wrt={extinction}), and its volume-row
            # scatter alone (K11 on the rows of the window's events)
            wrt_e = frozenset({"extinction"})
            _, tapes_e = TB.tape_forward(state, ctx, seeds, STEPS, BINS, wrt_e)
            carry_ms = cuda_ms(lambda: k5(tapes_e, TB.tape_fields(wrt_e),
                                          {"g_ext": torch.zeros(1, device=dev)}), 5)
            del tapes_e
            f = TB.tape_fields(wrt)
            rows = tapes[:, :, f.index("vol_row0")].reshape(-1).view(torch.int32)
            event = ((tapes[:, :, f.index("null")] > 0.5)
                     | (tapes[:, :, f.index("scatter")] > 0.5)).reshape(-1)
            rows = torch.where(event, rows, torch.full_like(rows, -1)).contiguous()
            table = torch.zeros_like(adj5["g_vol"])
            rec["k5_split"] = dict(
                k5_ms=rec["k5_ms"], carry_extinction_only_ms=carry_ms,
                scatter_alone_ms=device_ms(lambda: SB.scatter_rows(rows, table)),
                event_lane_steps=int(event.sum()), lane_steps=int(event.numel()))
            log(f"# K5 split, stride-1 window: {json.dumps(rec['k5_split'])}")
            del rows, event, table
        # the same window through the plain versions, once
        s_plain0 = int(state.samples.sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sp, gp = plain_window(state, ctx, seeds, g_img, wrt, stride, mode)
        float(gp["density"].sum())
        dtp = time.perf_counter() - t0
        _, _, gk = TB.prb_render_and_grads_many(state, ctx, seeds, g_img, STEPS, BINS, wrt=wrt,
                                                scatter_stride=stride, scatter_mode=mode)
        rel = float((gk["density"] - gp["density"]).norm() / gp["density"].norm().clamp_min(1e-30))
        rec["plain"] = dict(seconds=dtp, mpaths_per_s=(int(sp.samples.sum()) - s_plain0) / dtp / 1e6,
                            m_lane_steps_per_s=lanes * STEPS * CHUNK / dtp / 1e6,
                            grad_rel_l2_vs_kernel=rel)
        if rel > 1e-4:
            raise AssertionError(f"window {mode}{stride}: kernel grads differ from plain by {rel}")
        windows[f"{mode}{stride}"] = rec
        log(f"# fwd+bwd {mode} {stride} ({WINDOWS} windows x {CHUNK} dispatches): kernels "
            f"{rec['mpaths_per_s']:.3f} Mpaths/s, {rec['m_lane_steps_per_s']:.1f} M lane-steps/s "
            f"(window {rec['window_ms']:.3f} ms: K4 {rec['k4_ms']:.3f} (bound "
            f"{rec['k4_bound_ms']:.3f} by {rec['k4_bound_by']}, {rec['k4_bound_bytes']} B, "
            f"{rec['k4_bound_ops']} FP32 ops, share {rec['k4_bound_share']:.3f}), K5 "
            f"{rec['k5_ms']:.3f}, reverse sweep (K5 + K9 + set-up) {rec['k5_contract_ms']:.3f}, "
            f"K9 contract {rec['contract_ms']:.4f} device, {rec['contract_host_ms']:.4f} host "
            f"path); plain "
            f"{rec['plain']['mpaths_per_s']:.3f} Mpaths/s, "
            f"{rec['plain']['m_lane_steps_per_s']:.1f} M lane-steps/s; grads kernel vs plain "
            f"rel {rel:.3g}")

    # the quasicubic PRB window (K = 4, stride 1, wrt={density}) beside the
    # linear one, in turns; its launches counted from 0
    seeds = [(7 + k) * 2654435761 % 2**32 for k in range(CHUNK)]
    state = renderer.reset(camera, 1)

    def filt_window(filt):
        return TB.prb_render_and_grads_many(state, ctx, seeds, g_img, STEPS, BINS, filt, wrt=wrt)

    filt_window("quasicubic")
    TB.reset_launch_counts()
    _, _, gq = filt_window("quasicubic")
    torch.cuda.synchronize()
    qc_launches = dict(TB.LAUNCHES)
    require_launches(qc_launches, ("prb_tape_forward_quasicubic", "prb_reverse"),
                     "the quasicubic window")
    if not bool(torch.isfinite(gq["density"]).all()) or float(gq["density"].abs().sum()) == 0.0:
        raise AssertionError("the quasicubic window's density gradient is not finite or zero")
    times = dict(linear=[], quasicubic=[])
    for filt in ("linear", "quasicubic", "quasicubic", "linear"):
        times[filt].append(cuda_ms(lambda: filt_window(filt), 3))
    windows["quasicubic_stride1"] = dict(window_ms=float(np.mean(times["quasicubic"])),
                                         linear_window_ms=float(np.mean(times["linear"])),
                                         times=times, launches=qc_launches)
    log(f"# fwd+bwd window, stride 1, K = {CHUNK}: quasicubic "
        f"{windows['quasicubic_stride1']['window_ms']:.3f} ms vs linear "
        f"{windows['quasicubic_stride1']['linear_window_ms']:.3f} ms (in turns); launches "
        f"{qc_launches}")

    # the env-lit bench scene: fit_spectral(method="prb") learning the map
    env = seeded_envmap()
    session = RenderSession("mcm-spectral", *args, resolution=RES, streams=STREAMS,
                            environment=env, device=dev)
    session.run(64)
    target_env = session.hdr_image()
    del session
    env_r = MCMSpectralRenderer(*args, resolution=RES, streams=STREAMS, environment=env,
                                device=dev)
    fits["environment"] = prb_fit("env-lit bench scene", target_env, env_r, camera,
                                  {"environment": np.full(ENV_SHAPE, 0.5, np.float32)}, dev,
                                  "environment")
    return launches, fits, windows, qc_launches


def phase_corners(dev):
    """Phase 9, first half: K9 contract_corners and K10 pack_corners at the
    bench's table sizes (129^3 packed volume rows, the 257 x 257 fused TF),
    each equal to its plain version bit for bit and to a second run; timed
    by device time (CUDA-graph replay), with the host path beside it."""
    from vpt_tpu_torch.kernels import corners as C

    vol = torch.as_tensor(np.asarray(bench_scene_args()[0].density, np.float32), device=dev)
    dims = tuple(d + 1 for d in vol.shape)
    dims_xy = (vol.shape[0], dims[1], dims[2])
    gen = torch.Generator(device=dev).manual_seed(0)
    g_vol = torch.randn((int(np.prod(dims)), 8), device=dev, generator=gen)
    g_xy = torch.randn((int(np.prod(dims_xy)), 4), device=dev, generator=gen)
    th, tw = 256, 256
    g_tf = torch.randn((th + 1, tw + 1, 18), device=dev, generator=gen)
    mtf = torch.rand((th, tw, 4), device=dev, generator=gen)
    light = torch.rand(tw, device=dev, generator=gen)
    env = torch.as_tensor(seeded_envmap(), device=dev)
    eh, ew, _ = env.shape
    g_env = torch.randn((eh + 1, ew + 1, 12), device=dev, generator=gen)

    def bits(t):
        return t.contiguous().view(torch.int32)

    pairs = {
        "contract_volume": (lambda: C.contract_volume(g_vol, dims),
                            lambda: C.contract_volume_plain(g_vol, dims)),
        "contract_tf": (lambda: torch.cat([t.reshape(-1) for t in C.contract_tf(g_tf)]),
                        lambda: torch.cat([C.contract_tex2d_plain(g_tf).reshape(-1),
                                           C.contract_light_plain(g_tf)])),
        "pack_volume": (lambda: C.pack_volume(vol), lambda: C.pack_volume_plain(vol)),
        "pack_tf": (lambda: torch.cat([t.reshape(-1) for t in C.pack_tf(mtf, light, True)]),
                    lambda: torch.cat([t.reshape(-1) for t in C.pack_tf_plain(mtf, light, True)])),
        "contract_volume_xy": (lambda: C.contract_volume(g_xy, dims_xy, "xy"),
                               lambda: C.contract_volume_xy_plain(g_xy, dims_xy)),
        "contract_env": (lambda: C.contract_env(g_env),
                         lambda: C.contract_tex2d_plain(g_env, channels=3)),
        "pack_volume_xy": (lambda: C.pack_volume(vol, "xy"),
                           lambda: C.pack_volume_plain(vol, "xy")),
        "pack_env": (lambda: C.pack_env(env), lambda: C.pack_env_plain(env)),
    }
    rec = {}
    for name, (kern, plain) in pairs.items():
        a, b, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        if not (torch.equal(bits(a), bits(want)) and torch.equal(bits(a), bits(b))):
            raise AssertionError(f"{name}: kernel != plain on {int((a != want).sum())} values, "
                                 f"or two runs differ")
        rec[name] = dict(equal_plain_bitwise=True, numel=a.numel())
    timed = {
        "contract_volume": lambda: C.contract_volume(g_vol, dims),
        "contract_tf": lambda: C.contract_tf(g_tf),
        "pack_volume": lambda: C.pack_volume(vol),
        "pack_tf": lambda: C.pack_tf(mtf, light, True),
        "contract_volume_xy": lambda: C.contract_volume(g_xy, dims_xy, "xy"),
        "contract_env": lambda: C.contract_env(g_env),
        "pack_volume_xy": lambda: C.pack_volume(vol, "xy"),
        "pack_env": lambda: C.pack_env(env),
    }
    for name, fn in timed.items():
        rec[name].update(ms=device_ms(fn), host_ms=cuda_ms(fn, 20),
                         plain_ms=cuda_ms(pairs[name][1], 3))
    # bytes: each input read once, each output written once; operations:
    # one add per packed entry a contraction reads, none for a pack
    n_vol, n_packed = vol.numel(), g_vol.numel()
    n_tf_raw = th * tw * 4 + tw
    bounds = {
        "contract_volume": bound((n_packed + n_vol) * 4, n_packed),
        "pack_volume": bound((n_packed + n_vol) * 4, 0),
        "contract_tf": bound((g_tf.numel() + n_tf_raw) * 4, g_tf.numel()),
        "pack_tf": bound((n_tf_raw + g_tf.numel() + (tw + 1) * 2) * 4, 0),
        "contract_volume_xy": bound((g_xy.numel() + n_vol) * 4, g_xy.numel()),
        "pack_volume_xy": bound((g_xy.numel() + n_vol) * 4, 0),
        "contract_env": bound((g_env.numel() + env.numel()) * 4, g_env.numel()),
        "pack_env": bound((g_env.numel() + env.numel()) * 4, 0),
    }
    for name, r in rec.items():
        r.update(bounds[name])
        r["bound_share"] = r["bound_ms"] / r["ms"]
        log(f"# {name}: equal to plain bit for bit, reruns identical; device {r['ms']:.5f} ms "
            f"kernel (host path {r['host_ms']:.5f}), plain {r['plain_ms']:.4f} ms; bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']} ({r['bound_bytes']} B), share "
            f"{r['bound_share']:.3f}")
    keys = ("bound_ms", "bound_by", "bound_bytes", "bound_ops", "bound_share")
    k9 = kernel_line(dict(name="contract_corners", route="cuda", source=CORNERS_SOURCE,
                          replaces="vpt_tpu/kernels/spectral_backward.py:355", max_abs_err=0.0,
                          ms=rec["contract_volume"]["ms"], plain_ms=rec["contract_volume"]["plain_ms"],
                          host_ms=rec["contract_volume"]["host_ms"], tf=rec["contract_tf"]),
                     {k: rec["contract_volume"][k] for k in keys})
    k10 = kernel_line(dict(name="pack_corners", route="cuda", source=CORNERS_SOURCE,
                           replaces="vpt_tpu/optim.py:185", max_abs_err=0.0,
                           ms=rec["pack_volume"]["ms"], plain_ms=rec["pack_volume"]["plain_ms"],
                           host_ms=rec["pack_volume"]["host_ms"], tf=rec["pack_tf"]),
                      {k: rec["pack_volume"][k] for k in keys})
    modes = {}
    for name, mode, kernel, replaces in (
            ("contract_volume_xy", "xy", "contract_corners",
             "vpt_tpu/kernels/spectral_backward.py:379"),
            ("contract_env", "environment", "contract_corners",
             "vpt_tpu/kernels/spectral_backward.py:390"),
            ("pack_volume_xy", "xy", "pack_corners", "vpt_tpu/optim.py:200"),
            ("pack_env", "environment", "pack_corners", "vpt_tpu/optim.py:233")):
        r = rec[name]
        modes[f"{kernel}[{mode}]"] = kernel_line(
            dict(name=f"{kernel}[{mode}]", route="cuda", source=CORNERS_SOURCE, replaces=replaces,
                 max_abs_err=0.0, ms=r["ms"], plain_ms=r["plain_ms"], host_ms=r["host_ms"]),
            {k: r[k] for k in keys})
    return k9, k10, modes


def phase_scatter(dev):
    """Phase 15: the scatter ceiling (bench.py:210-276, measure_ceilings):
    K11 scatter_rows, two float4 atomics of ones per index, on bench.py's
    stream of 16 x 1M uniform random rows of the 129^3-row table; equal to
    its plain version bit for bit (sums of ones are exact); timed by device
    time against the library call index_add_ on the same inputs."""
    from vpt_tpu_torch.tools import scatter_bench as SB

    n_rows, idx = SB.bench_rows(VOLUME)
    rows = torch.as_tensor(idx, device=dev)
    a = torch.zeros((n_rows, 8), device=dev)
    want = torch.zeros((n_rows, 8), device=dev)
    SB.reset_launch_counts()
    SB.scatter_rows(rows, a)
    launches = SB.LAUNCHES["scatter_rows"]
    SB.scatter_rows_plain(rows, want)
    torch.cuda.synchronize()
    if not torch.equal(a, want):
        raise AssertionError(f"scatter_rows != plain on {int((a != want).sum())} values")
    table = torch.zeros((n_rows, 8), device=dev)
    ms = device_ms(lambda: SB.scatter_rows(rows, table))
    plain_ms = cuda_ms(lambda: SB.scatter_rows_plain(rows, table), 3)
    rows64, ones = rows.to(torch.int64), torch.ones((rows.numel(), 8), device=dev)
    library_ms = device_ms(lambda: table.index_add_(0, rows64, ones))
    # each index read once; each row it touches read and written once
    touched = int(torch.unique(rows).numel())
    b = bound(rows.numel() * 4 + touched * 32 * 2, rows.numel() * 8, ms)
    rate = rows.numel() / (ms * 1e-3)
    log(f"# K11 scatter_rows (scatter ceiling, {rows.numel()} rows of {n_rows}, {touched} "
        f"touched): equal to plain; device {ms:.4f} ms ({rate / 1e9:.3f} G lane-steps/s), "
        f"plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms; bound {b['bound_ms']:.4f} ms "
        f"by {b['bound_by']}, share {b['bound_share']:.3f}")
    return kernel_line(dict(name="scatter_rows", route="cuda", source=BWD_SOURCE,
                            replaces="bench.py:246", max_abs_err=0.0, launches=launches, ms=ms,
                            plain_ms=plain_ms, library_call="Tensor.index_add_",
                            scatter_ceiling_lane_steps_per_s=rate, rows_touched=touched), b,
                       library_ms)


def sur_adjoints(ctx, n, n_bins, seed):
    """A carry of seeded random adjoints (the state's end) and zero
    adjoints of every table, each of its table's kind, for K12."""
    from vpt_tpu_torch.kernels import surrogate as S

    rng = np.random.default_rng(seed)
    dev = ctx.material_tf.device

    def g(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)

    carry = dict(c=g(n), gp=[g(n) for _ in range(3)], gd=[g(n) for _ in range(3)],
                 grad=g(n_bins, n) / float(RES))
    # under an environment map the light is never read: its adjoint stays 0
    keys = [k for k in S.adjoint_shapes(ctx)
            if not (k == "g_light" and ctx.environment is not None)]
    return carry, S.zero_adjoints(ctx, keys)


def copy_carry(carry):
    return {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
            for k, v in carry.items()}


def sur_bound(tape, samples, adj, ctx, n_bins, ms):
    """K12's bound: the tape read once, the carry in and out, the sample
    counts, the scene tables read once (no more than a row per event
    lane-step), the packed adjoints present in ``adj`` written once (with
    wrt={density} the volume's alone); FP32 operations per
    lane-step (carry, deposit, extinction score, position: OPS_SUR_STEP),
    per event (the re-read material, the scores, the spatial gradient and
    the scatter weights: OPS_SUR_EVENT) and per anisotropic scatter (the
    redraw and the HG reverse: OPS_SUR_HG), counted from the tape's flags."""
    from vpt_tpu_torch.kernels import surrogate as S

    flags = tape[:, :, 0].view(torch.int32)
    events = int(((flags & (S.F_NULL | S.F_SCATTER)) != 0).sum())
    scatters = int(((flags & S.F_SCATTER) != 0).sum())
    n = tape.shape[-1]
    nbytes = (tape.numel() * 4 + 2 * n * (7 + n_bins) * 4 + n * 4
              + table_bytes(ctx, events) + sum(v.numel() * 4 for v in adj.values()))
    out = bound(nbytes, tape.shape[0] * tape.shape[1] * n * OPS_SUR_STEP
                + events * OPS_SUR_EVENT + scatters * OPS_SUR_HG, ms)
    out.update(event_lane_steps=events, scatter_lane_steps=scatters,
               lane_steps=tape.shape[0] * tape.shape[1] * n)
    return out


def phase_surrogate(renderer, camera, dev):
    """Phase 16: K4's surrogate mode and K12 at 512^2 x 4, 2 dispatches, in
    exact and majorant mode, with the environment map (alone and with the
    majorant) and with the quasicubic filter; then the kernel path of
    render_sequence_diff against the autograd twin on the card (the raw
    modes: phase_surrogate_raw)."""
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    seeds = [2654435761 * k % 2**32 for k in (3, 4)]
    k4 = dict(name="surrogate_tape_forward", route="cuda", source=BWD_SOURCE,
              replaces="vpt_tpu/models/mcm_spectral.py:508 (the residuals of render_diff)",
              max_abs_err=0.0, min_field_share_equal=1.0, modes={})
    k12 = dict(name="surrogate_reverse", route="cuda", source=SUR_SOURCE,
               replaces="vpt_tpu/models/mcm_spectral.py:508 (jax.grad of render_diff)",
               max_abs_err=0.0, max_rel_l2=0.0, modes={})
    # the bench scene with the super-voxel majorant (blocks of 16)
    maj_renderer = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS,
                                       majorant_blocks=16, device=dev)
    env = seeded_envmap()
    env_renderer = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS,
                                       environment=env, device=dev)
    # env and majorant at once: the instantiation the env-lit majorant fit runs
    env_maj_renderer = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS,
                                           environment=env, majorant_blocks=16, device=dev)
    qc_renderer = MCMSpectralRenderer(*mode_args(True), resolution=RES, streams=STREAMS,
                                      device=dev)
    # the xy half-packed volume (the bench scene's 8.5 MB u8 xy table) in
    # exact, majorant, quasicubic and environment+majorant mode
    xy_kw = dict(resolution=RES, streams=STREAMS, pack_tables=XY_TABLES, device=dev)
    xy_renderers = (
        ("xy", MCMSpectralRenderer(*bench_scene_args(), **xy_kw)),
        ("xy majorant", MCMSpectralRenderer(*bench_scene_args(), majorant_blocks=16, **xy_kw)),
        ("xy quasicubic", MCMSpectralRenderer(*mode_args(True), **xy_kw)),
        ("xy environment+majorant", MCMSpectralRenderer(*bench_scene_args(), environment=env,
                                                        majorant_blocks=16, **xy_kw)))
    for mode, r in (("exact", renderer), ("majorant", maj_renderer),
                    ("environment", env_renderer), ("environment+majorant", env_maj_renderer),
                    ("quasicubic", qc_renderer), *xy_renderers):
        wrts = 2 if mode in ("exact", "majorant", "xy", "xy majorant") else 1
        sur_mode(mode, r.ctx(camera, 7), r.reset(camera, 7), seeds, k4, k12, wrts)
    ex = k4["modes"]["exact"]
    k4.update(ms=ex["ms"], plain_ms=ex["plain_ms"], k1_ms=ex["k1_ms"])
    kernel_line(k4, {k: ex[k] for k in ("bound_ms", "bound_by", "bound_bytes", "bound_ops",
                                        "bound_share")})
    # the kernels line: all four adjoints (as the parent design was timed) and the main
    # path's wrt={density} beside it
    ex = k12["modes"]["exact/all"]
    k12.update(ms=ex["ms"], plain_ms=ex["plain_ms"],
               wrt_density_ms=k12["modes"]["exact/density"]["ms"],
               wrt_density_bound_ms=k12["modes"]["exact/density"]["bound_ms"])
    kernel_line(k12, {k: ex[k] for k in ("bound_ms", "bound_by", "bound_bytes", "bound_ops",
                                         "bound_share")})
    k12["library_call"] = "— (no single call)"
    keys = ("bound_ms", "bound_by", "bound_bytes", "bound_ops", "bound_share")
    modes = {}
    xy_replaces = "vpt_tpu/ops/interp.py:226 (_sample_volume_packed_xy under jax.grad)"
    for mode, replaces in (("environment", "vpt_tpu/models/mcm_spectral.py:148"),
                           ("environment+majorant",
                            "vpt_tpu/models/mcm_spectral.py:148 and :228"),
                           ("quasicubic", "vpt_tpu/ops/interp.py:389"),
                           ("xy", xy_replaces), ("xy majorant", xy_replaces),
                           ("xy quasicubic", xy_replaces),
                           ("xy environment+majorant", xy_replaces)):
        r4, r12 = k4["modes"][mode], k12["modes"][f"{mode}/all"]
        modes[f"surrogate_tape_forward[{mode}]"] = kernel_line(
            dict(name=f"surrogate_tape_forward[{mode}]", route="cuda", source=BWD_SOURCE,
                 replaces=replaces, max_abs_err=0.0,
                 min_field_share_equal=min(r4["share_equal"].values()), ms=r4["ms"],
                 plain_ms=r4["plain_ms"], k1_ms=r4["k1_ms"]), {k: r4[k] for k in keys})
        modes[f"surrogate_reverse[{mode}]"] = kernel_line(
            dict(name=f"surrogate_reverse[{mode}]", route="cuda", source=SUR_SOURCE,
                 replaces=replaces, max_abs_err=max(r12[k]["max_abs"] for k in r12
                                                    if isinstance(r12[k], dict)),
                 max_rel_l2=max(r12[k]["rel_l2"] for k in r12 if isinstance(r12[k], dict)),
                 ms=r12["ms"], plain_ms=r12["plain_ms"]), {k: r12[k] for k in keys})
    twin = twin_check(dev, camera)
    # launches of the env-only, quasicubic and xy instantiations: the twin's
    # window (render_sequence_diff); the env+majorant and xy+majorant ones':
    # phase 17's fits
    for mode in ("environment", "quasicubic", "xy", "xy quasicubic", "xy environment+majorant"):
        modes[f"surrogate_tape_forward[{mode}]"]["launches"] = twin["launches"][mode][
            "surrogate_tape_forward"]
        modes[f"surrogate_reverse[{mode}]"]["launches"] = twin["launches"][mode][
            "surrogate_reverse"]
    del maj_renderer, env_renderer, env_maj_renderer, qc_renderer, xy_renderers
    torch.cuda.empty_cache()
    return k4, k12, twin, modes


def sur_mode(mode, ctx, s0, seeds, k4, k12, wrts=1, rtol=1e-4):
    """One mode of phase 16 from the reset state ``s0``: K4's surrogate
    mode against K1 (the state bit for bit, two runs identical, the tape
    against the plain tape's fields) and timed beside K1 on the same copy;
    K12 on that tape against reverse_plain within ``rtol`` relative L2 (two
    runs within 1e-5), with the adjoints of every table and, for ``wrts``
    2, the density's alone. Records into ``k4["modes"]`` and
    ``k12["modes"]``."""
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import surrogate as S

    s1 = clone_state(s0)
    K.step(s1, ctx, seeds, STEPS, BINS)
    sk, tk = S.tape_forward(s0, ctx, seeds, STEPS, BINS)
    _, tk2 = S.tape_forward(s0, ctx, seeds, STEPS, BINS)
    sp = clone_state(s0)
    tp = S.tape_forward_plain(sp, ctx, seeds, STEPS, BINS)
    torch.cuda.synchronize()
    diff = first_difference(sk, s1)
    if diff is not None:
        raise AssertionError(f"K4 surrogate ({mode}) state != K1's: {diff}")
    if not torch.equal(tk.view(torch.int32), tk2.view(torch.int32)):
        raise AssertionError(f"K4 surrogate ({mode}) differs between two runs")
    flds = S.fields(ctx.majorant is not None)
    shares = {f: float((tk[:, :, i].view(torch.int32) == tp[:, :, i].view(torch.int32))
                       .float().mean()) for i, f in enumerate(flds)}
    worst = min(shares, key=shares.get)
    k4["min_field_share_equal"] = min(k4["min_field_share_equal"], shares[worst])
    for i, f in enumerate(flds):
        if f not in ("flags", "rng"):
            k4["max_abs_err"] = max(k4["max_abs_err"],
                                    float((tk[:, :, i] - tp[:, :, i]).abs().max()))
    if shares[worst] < TAPE_SHARE_MIN:
        raise AssertionError(f"K4 surrogate ({mode}) tape field {worst} equals plain on "
                             f"{shares[worst]}")
    rec4 = dict(share_equal=shares)
    # the wrapper copies the state, then launches; K1 timed on the same
    # copy, so the two differ by the kernels alone
    rec4["ms"] = cuda_ms(lambda: S.tape_forward(s0, ctx, seeds, STEPS, BINS), 10)
    rec4["k1_ms"] = cuda_ms(lambda: K.step(S.clone_steppable(s0), ctx, seeds, STEPS, BINS), 10)
    rec4["state_copy_ms"] = cuda_ms(lambda: S.clone_steppable(s0), 10)
    rec4["tape_bytes"] = tk.numel() * 4
    # the yardstick: K1 for the same dispatches plus the tape's bytes
    rec4["k1_plus_tape_ms"] = rec4["k1_ms"] + bound(rec4["tape_bytes"], 0)["bound_ms"]
    rec4["plain_ms"] = cuda_ms(lambda: S.tape_forward_plain(clone_state(s0), ctx, seeds,
                                                            STEPS, BINS), 1)
    rec4.update(step_bound(ctx, s0, seeds, BINS, rec4["ms"], taped=rec4["tape_bytes"]))
    k4["modes"][mode] = rec4
    log(f"# K4 surrogate mode ({mode}), 2 dispatches x {STEPS} steps, {len(flds)} fields: "
        f"state == K1 bitwise, reruns identical; tape == plain on {shares[worst]:.6f} of "
        f"lane-steps in the worst field ({worst}); {rec4['ms']:.4f} ms (state copy and "
        f"kernel) vs K1 {rec4['k1_ms']:.4f} ms on the same copy (the copy alone "
        f"{rec4['state_copy_ms']:.4f}); K1 + the tape's bytes {rec4['k1_plus_tape_ms']:.4f} "
        f"ms; plain {rec4['plain_ms']:.4f} ms; bound {rec4['bound_ms']:.4f} ms by "
        f"{rec4['bound_by']} ({rec4['bound_bytes']} B, {rec4['bound_ops']} FP32 ops), share "
        f"{rec4['bound_share']:.3f}")

    # K12 on the kernel's tape against its plain version, two runs, with
    # the adjoints of all four tables and with the density's alone
    n = s0.px.numel()
    carry0, adj_all = sur_adjoints(ctx, n, BINS, 11)
    adjs = (("all", adj_all), ("density", {"g_vol": adj_all["g_vol"]}))
    for wrt, adj0 in adjs[:wrts]:
        rec = k12_check(mode, wrt, tk, flds, sk.samples, carry0, adj0, ctx, k12, rtol)
        k12["modes"][f"{mode}/{wrt}"] = rec
    del tk, tk2, tp


def sur_raw_renderers(dev):
    """Phase 16's raw modes over the bench scene: (label, a function that
    builds its renderer), every layout of RAW_LAYOUTS, the xy table beside
    a raw TF, the nearest filter, a raw environment map (phase 12's), raw
    tables with majorant_blocks=16."""
    from vpt_tpu_torch import Volume
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    args = bench_scene_args()
    near = [Volume(args[0].density, filter="nearest"), *args[1:]]

    def make(a=args, **kw):
        return lambda: MCMSpectralRenderer(*a, resolution=RES, streams=STREAMS, device=dev, **kw)

    return ([(label, make(pack_tables=pack)) for label, pack in RAW_LAYOUTS]
            + [("xy + raw TF", make(pack_tables=frozenset({"density_xy"}))),
               ("nearest", make(near)),
               ("raw environment", make(pack_tables=False, environment=seeded_envmap())),
               ("raw majorant", make(pack_tables=False, majorant_blocks=16))])


def phase_surrogate_raw(camera, dev):
    """Phase 16, raw: K4's surrogate mode and K12 in their RAW mode at
    512^2 x 4, 2 dispatches, in each of sur_raw_renderers' modes: K4s RAW's
    state == K1 RAW's bit for bit, its tape equal between two runs and to
    the plain tape's fields, K12 RAW within 1e-5 relative L2 of
    reverse_plain on every output (with the adjoints of every table, and
    with the density's alone where the fits learn it), each timed against
    its bound. Returns the two kernels-line entries (the fully raw layout's
    numbers, every mode's under "modes")."""
    from vpt_tpu_torch.kernels import mcm_spectral as K

    seeds = [2654435761 * k % 2**32 for k in (3, 4)]
    replaces = "vpt_tpu/ops/interp.py:411 (the raw lookups of :411-648 under jax.grad)"
    k4 = dict(name="surrogate_tape_forward[raw]", route="cuda", source=BWD_SOURCE,
              replaces=replaces, max_abs_err=0.0, min_field_share_equal=1.0, modes={})
    k12 = dict(name="surrogate_reverse[raw]", route="cuda", source=SUR_SOURCE,
               replaces=replaces, max_abs_err=0.0, max_rel_l2=0.0, modes={})
    for mode, make in sur_raw_renderers(dev):
        r = make()
        ctx = r.ctx(camera, 7)
        if not K.is_raw(ctx):
            raise AssertionError(f"phase 16 raw mode {mode}: the ctx is not raw")
        sur_mode(mode, ctx, r.reset(camera, 7), seeds, k4, k12,
                 wrts=2 if mode in ("raw", "raw majorant") else 1, rtol=1e-5)
        del r, ctx
        torch.cuda.empty_cache()
    keys = ("bound_ms", "bound_by", "bound_bytes", "bound_ops", "bound_share")
    r4, r12 = k4["modes"]["raw"], k12["modes"]["raw/all"]
    k4.update(ms=r4["ms"], plain_ms=r4["plain_ms"], k1_ms=r4["k1_ms"])
    k12.update(ms=r12["ms"], plain_ms=r12["plain_ms"],
               wrt_density_ms=k12["modes"]["raw/density"]["ms"])
    kernel_line(k4, {k: r4[k] for k in keys})
    kernel_line(k12, {k: r12[k] for k in keys})
    k12["library_call"] = "— (no single call)"
    log("# phase 16 raw modes (ms, K4s RAW with the state copy / K1 RAW on the copy / K12 RAW "
        "all adjoints): " + "; ".join(
            f"{m} {k4['modes'][m]['ms']:.4f} / {k4['modes'][m]['k1_ms']:.4f} / "
            f"{k12['modes'][m + '/all']['ms']:.4f}" for m in k4["modes"]))
    return k4, k12


def k12_check(mode, wrt, tk, flds, samples, carry0, adj0, ctx, k12, rtol=1e-4):
    """K12 on a tape against reverse_plain (relative L2 <= ``rtol`` per
    output, two kernel runs within 1e-5), then timed (a fresh copy of the
    carry per call, made outside the timed span) against its bound."""
    from vpt_tpu_torch.kernels import surrogate as S

    def run(plain):
        carry, adj = copy_carry(carry0), {k: v.clone() for k, v in adj0.items()}
        (S.reverse_plain if plain else S.reverse)(tk, flds, samples, carry, adj, ctx, BINS)
        return carry, adj

    (ca, aa), (cb, ab), (cp, ap) = run(False), run(False), run(True)
    torch.cuda.synchronize()
    rec = {}
    pairs = {k: (aa[k], ab[k], ap[k]) for k in ap}
    pairs.update(c=(ca["c"], cb["c"], cp["c"]), grad=(ca["grad"], cb["grad"], cp["grad"]),
                 gp=tuple(torch.stack(x[k]) for x, k in ((ca, "gp"), (cb, "gp"), (cp, "gp"))),
                 gd=tuple(torch.stack(x[k]) for x, k in ((ca, "gd"), (cb, "gd"), (cp, "gd"))))
    for k, (a, b, p) in pairs.items():
        scale = float(p.norm())
        rel = float((a - p).norm()) / max(scale, 1e-30)
        rerun = float((a - b).norm()) / max(scale, 1e-30)
        mabs = float((a - p).abs().max())
        if not bool(torch.isfinite(a).all()) or scale == 0.0:
            raise AssertionError(f"K12 ({mode}, wrt {wrt}) {k}: not finite or all zero")
        if rel > rtol or rerun > 1e-5:
            raise AssertionError(f"K12 ({mode}, wrt {wrt}) {k}: rel L2 {rel:.3g} vs plain, "
                                 f"{rerun:.3g} between runs")
        rec[k] = dict(rel_l2=rel, max_abs=mabs, rerun_rel_l2=rerun)
        k12["max_abs_err"] = max(k12["max_abs_err"], mabs)
        k12["max_rel_l2"] = max(k12["max_rel_l2"], rel)
    del ca, cb, cp, aa, ab, ap
    reps = 5
    pool = [copy_carry(carry0) for _ in range(reps + 1)]
    adj_t = {k: v.clone() for k, v in adj0.items()}
    calls = iter(pool)
    rec["ms"] = cuda_ms(lambda: S.reverse(tk, flds, samples, next(calls), adj_t, ctx, BINS), reps)
    del pool
    rec["plain_ms"] = cuda_ms(lambda: run(True), 1)
    rec.update(sur_bound(tk, samples, adj0, ctx, BINS, rec["ms"]))
    log(f"# K12 surrogate_reverse ({mode}, wrt {wrt}), 2 dispatches: " + ", ".join(
        f"{k} rel {rec[k]['rel_l2']:.3g} rerun {rec[k]['rerun_rel_l2']:.3g}" for k in pairs)
        + f"; {rec['ms']:.4f} ms kernel vs {rec['plain_ms']:.4f} ms plain; bound "
        f"{rec['bound_ms']:.4f} ms by {rec['bound_by']} ({rec['bound_bytes']} B, "
        f"{rec['bound_ops']} FP32 ops; {rec['event_lane_steps']} event and "
        f"{rec['scatter_lane_steps']} scatter lane-steps of {rec['lane_steps']}), share "
        f"{rec['bound_share']:.3f}")
    return rec


def twin_check(dev, camera):
    """The kernel path of render_sequence_diff against the autograd twin,
    both on the card: 128^2 x 2 streams, K = 2 dispatches, gradients of an
    MSE loss w.r.t. all four tables, relative L2 <= 1e-4 each, the loss
    equal, in exact, majorant, environment, environment+majorant and
    quasicubic mode and over the xy half-packed volume in exact, majorant,
    quasicubic and environment+majorant mode, under both schedules of the
    window
    ("tape": K4's surrogate mode, K12, K10, K9; "forward": K1, then K4's
    surrogate mode and K12 per dispatch, K10, K9)."""
    from vpt_tpu_torch.kernels import corners as C
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.models import mcm_spectral as TM
    from vpt_tpu_torch.ops import interp

    res, streams, seeds = 128, 2, [8, 5100]
    out, launches = {}, {}
    env = seeded_envmap()
    for mode, blocks in (("exact", None), ("majorant", 16), ("environment", None),
                         ("environment+majorant", 16), ("quasicubic", None), ("xy", None),
                         ("xy majorant", 16), ("xy quasicubic", None),
                         ("xy environment+majorant", 16)):
        args = mode_args(mode.endswith("quasicubic"))
        lit = "environment" in mode
        r = TM.MCMSpectralRenderer(*args, resolution=res, streams=streams, majorant_blocks=blocks,
                                   environment=env if lit else None,
                                   pack_tables=XY_TABLES if mode.startswith("xy") else True,
                                   device=dev)
        base, s0 = r.ctx(camera, 7), r.reset(camera, 7)
        raw = dict(density=torch.as_tensor(np.asarray(args[0].density, np.float32), device=dev),
                   material_tf=torch.as_tensor(np.array(args[1].table, np.float32), device=dev),
                   light_spectrum=torch.as_tensor(np.asarray(args[2].spectrum_array(), np.float32),
                                                  device=dev),
                   extinction=torch.tensor(np.float32(args[4].extinction), device=dev))
        if lit:
            raw["environment"] = torch.as_tensor(env, device=dev)
        target = torch.full((res, res, 3), 0.25, device=dev)

        def ctx_of(p):
            kind = base.density.kind
            vol = interp.PackedVolume(C.pack_volume_diff(p["density"], kind), base.density.dims,
                                      kind)
            ctx = dataclasses.replace(base, density=vol, extinction=p["extinction"],
                                      material_tf=C.pack_tf_diff(p["material_tf"],
                                                                 p["light_spectrum"]))
            if "environment" in p:
                ctx = dataclasses.replace(ctx, environment=C.pack_env_diff(p["environment"]))
            return ctx

        def grads(loss_fn):
            p = {k: v.clone().requires_grad_(True) for k, v in raw.items()}
            loss = loss_fn(p)
            return float(loss.detach()), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

        def kernels(p, storage):
            img = TM.render_sequence_diff(seeds, s0, ctx_of(p), STEPS, BINS, base.volume_filter,
                                          window_storage=storage)
            return torch.mean((img - target) ** 2)

        def twin(p):
            ctx = ctx_of(p)
            st = {k: getattr(s0, k).clone() for k in K.STATE_FIELDS}
            score = torch.ones_like(s0.px)
            for s in seeds:
                st, score = K.render_diff_plain(st, score, dataclasses.replace(ctx, seed_bits=s),
                                                [s], STEPS, BINS)
            img = TM.radiance_to_rgb(st["radiance"], base.bin_xyz)
            return torch.mean((img - target) ** 2)

        lt, gt = grads(twin)
        for storage in ("tape", "forward"):
            reset_counts()
            lk, gk = grads(lambda p: kernels(p, storage))
            if storage == "tape":
                launches[mode] = launch_counts()
            rec = dict(loss=lk, loss_twin=lt)
            for k in gk:
                rel = float((gk[k] - gt[k]).norm() / gt[k].norm().clamp_min(1e-30))
                rec[k] = rel
                if lit and k == "light_spectrum":
                    # never sampled under an env map: zero on both paths
                    if float(gk[k].abs().sum()) != 0.0 or float(gt[k].abs().sum()) != 0.0:
                        raise AssertionError("env mode: a nonzero light_spectrum gradient")
                    continue
                if (not bool(torch.isfinite(gk[k]).all()) or float(gt[k].norm()) == 0.0
                        or rel > 1e-4):
                    raise AssertionError(f"render_sequence_diff ({mode}, {storage}) {k}: kernel "
                                         f"path vs twin rel L2 {rel:.3g}, norm "
                                         f"{float(gt[k].norm())}")
            if lk != lt:
                raise AssertionError(f"render_sequence_diff ({mode}, {storage}): loss {lk} != "
                                     f"twin's {lt}")
            out[f"{mode}/{storage}"] = rec
            log(f"# render_sequence_diff ({mode}, window_storage={storage!r}, {res}^2 x "
                f"{streams}, K = 2) kernel path vs the autograd twin on the card: loss equal "
                f"({lk:.6g}); " + ", ".join(f"{k} rel L2 {rec[k]:.3g}" for k in gk))
        del r
    require_launches(launches["environment"], ("surrogate_tape_forward_environment",
                                               "surrogate_reverse_environment",
                                               "contract_corners_env", "pack_corners_env"),
                     "the env-mode window")
    require_launches(launches["environment+majorant"],
                     ("surrogate_tape_forward_environment_majorant",
                      "surrogate_reverse_environment_majorant", "contract_corners_env",
                      "pack_corners_env"), "the env-lit majorant window")
    require_launches(launches["quasicubic"], ("surrogate_reverse_quasicubic",), "the "
                     "quasicubic window")
    for mode in ("xy", "xy majorant", "xy quasicubic", "xy environment+majorant"):
        require_launches(launches[mode], ("surrogate_tape_forward_xy", "surrogate_reverse_xy",
                                          "contract_corners_xy", "pack_corners_xy"),
                         f"the {mode} window")
    require_launches(launches["xy environment+majorant"],
                     ("surrogate_tape_forward_environment_majorant",
                      "surrogate_reverse_environment_majorant"), "the xy env-lit majorant window")
    out["launches"] = launches
    return out


def rm_modes(dev):
    """The ray marchers' table modes on the bench volume: (label, density,
    tf_table, filter): linear on the u8 packed table, an f32 packed table
    (a smoothed random density), quasicubic, nearest on the raw grid."""
    from vpt_tpu_torch.models import raymarch as TR
    from vpt_tpu_torch.scene.tf import TransferFunction2D

    tf = TransferFunction2D.grayscale_ramp()
    return [(label, *TR._pack_if_linear(v, tf, dev), v.filter) for label, v in mode_volumes()]


def mode_volumes():
    """The four table modes' volumes on the bench volume: (label, Volume)
    for linear on the u8 source, an f32 source (a smoothed random density),
    quasicubic and nearest."""
    from vpt_tpu_torch import Volume

    vol = Volume.sphere_in_cube(VOLUME)
    rng = np.random.default_rng(13)
    return (("linear u8", vol), ("f32", Volume(density=smoothed(rng.random(vol.shape, np.float32)))),
            ("quasicubic", Volume(vol.density, "quasicubic")),
            ("nearest", Volume(vol.density, "nearest")))


def rm_bitwise(label, kern, plain):
    """Kernel and plain outputs equal bit for bit, else the first differing
    pixel is printed and the check fails."""
    for k, (a, b) in enumerate(zip(kern, plain)):
        ne = (a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).reshape(-1)
        if bool(ne.any()):
            i = int(ne.nonzero()[0])
            raise AssertionError(f"{label}: output {k} differs on {int(ne.sum())} values; first "
                                 f"flat index {i}: kernel {a.reshape(-1)[i].item()!r}, plain "
                                 f"{b.reshape(-1)[i].item()!r}")


def rm_entries(dens, filt, x, y, z):
    """The volume table entries a lookup at (x, y, z) reads: a packed
    table's corner row, or a raw grid's 8 corner texels (1 for nearest)."""
    from vpt_tpu_torch.ops import interp

    if isinstance(dens, interp.PackedVolume):
        return [interp.volume_rows(dens.dims, x, y, z)[0]]
    D, H, W = dens.shape
    if filt == "nearest":
        ix, iy, iz = ([interp._nearest_coords(u, n)] for u, n in ((x, W), (y, H), (z, D)))
    else:
        ix, iy, iz = (interp._coords(u, n)[:2] for u, n in ((x, W), (y, H), (z, D)))
    return [(k * H + j) * W + i for k in iz for j in iy for i in ix]


class RmReads:
    """The lookups of a ray-march pass, replayed with the plain pieces: how
    many, each pixel's (``trips``), and which volume table entries (packed
    rows or raw texels) they touch, each counted once."""

    def __init__(self, dens, filt):
        from vpt_tpu_torch.ops import interp

        packed = isinstance(dens, interp.PackedVolume)
        vol = dens.table if packed else dens
        self.dens, self.filt, self.lookups, self.trips = dens, filt, 0, 0
        self.entry_bytes = vol.shape[-1] * vol.element_size() if packed else vol.element_size()
        self.touched = torch.zeros(vol.shape[0] if packed else vol.numel(), dtype=torch.bool,
                                   device=vol.device)

    def add(self, x, y, z, mask):
        self.lookups += int(mask.sum())
        self.trips = self.trips + mask.to(torch.int32)  # each pixel's lookups
        for e in rm_entries(self.dens, self.filt, x, y, z):
            self.touched[e[mask].to(torch.int64)] = True

    def volume_bytes(self):
        return int(self.touched.sum()) * self.entry_bytes


def rm_replay(kind, inv, dens, tft, filt, offset, eam=None):
    """The lookups K15 (EAM, Depth), K16 or K17 makes in one pass: its march
    and stop rule replayed with the plain pieces (a missing ray takes none;
    EAM stops at acc_a >= 0.99, Depth at the threshold, ISO, walking near ->
    far, at the first hit; MIP takes every step). ``eam``: another EAM
    march (res, slices, extinction) than phase 19's. Returns the
    ``RmReads`` and, for ISO, each pixel's hit t (-1 where none)."""
    from vpt_tpu_torch.kernels import raymarch as RK

    n = RM_MIP_STEPS if kind == "mip" else RM_ISO["steps"] if kind == "iso" else RM_EAM["slices"]
    res = RM_RES
    if eam is not None:
        n, res = eam["slices"], eam["res"]
    _, _, miss, entry, exit_, rsl, step = RK._march_setup(inv, res, tft.device, n)
    reads = RmReads(dens, filt)
    if kind == "mip":
        for k in range(n):
            o = float(np.remainder(np.float32(offset) + np.float32(k) * step, np.float32(1.0)))
            reads.add(*RK._mix3(entry, exit_, o), ~miss)
        return reads, None
    if kind == "iso":
        t_far = np.float32(1.0) - np.float32(offset) * step
        ts = [float(t_far - np.float32(k) * step) for k in range(n)]
        last, hit_t = torch.full_like(rsl, -1.0), torch.full_like(rsl, -1.0)
        for k, t in enumerate(ts):  # far -> near: the nearest hit survives
            c = RK.sample_tf(dens, tft, *RK._mix3(entry, exit_, t), filt)
            hit = (c[..., 3] >= RM_ISO["isovalue"]) & (t >= 0.0)
            last, hit_t = torch.where(hit, float(k), last), torch.where(hit, t, hit_t)
        for k, t in enumerate(ts):  # the kernel's walk, near -> far to that hit
            reads.add(*RK._mix3(entry, exit_, t), ~miss & ((last < 0) | (last <= k)))
        return reads, torch.where(miss, -1.0, hit_t)
    stop = 0.99 if kind == "eam" else RM_DEPTH["threshold"]
    ext = RM_EAM["extinction"] if kind == "eam" else RM_DEPTH["extinction"]
    if eam is not None:
        ext = eam["extinction"]
    a = torch.zeros_like(rsl)
    for k in range(n + 1):
        t = float(step * np.float32(offset) + np.float32(k) * step)
        active = (t < 1.0) & (a < stop) & ~miss
        pos = RK._mix3(entry, exit_, t)
        c = RK.sample_tf(dens, tft, *pos, filt)
        w = ((1.0 - a) * (c[..., 3] * rsl * ext) if kind == "eam"
             else (1.0 - a) * c[..., 3] * rsl * ext)
        a = torch.where(active, a + w, a)
        reads.add(*pos, active)
    return reads, None


def rm_trip_stats(trips, miss):
    """Samples per ray over the hit pixels (mean, p99, max) and what a warp
    pays when it marches 32 pixels of a row (K17's layout, and K15's and
    K16's before their redesign) or an 8 x 4 tile (K15's and K16's): the
    mean over warps with a hit of their longest ray, and the sample slots
    the warps hold (32 x their longest ray) over the samples the rays
    take."""
    hit = ~miss
    t = trips[hit].to(torch.float64)
    out = dict(hit_pixels=int(hit.sum()), ray_mean=float(t.mean()),
               ray_p99=float(torch.quantile(t, 0.99)), ray_max=int(t.max()))
    for name, warps in (("row", lambda x: x.reshape(-1, 32)), ("tile", lao_warps)):
        longest = warps(torch.where(hit, trips, 0)).amax(-1).to(torch.float64)
        busy = longest[warps(hit).any(-1)]
        out[f"{name}_warp_paid"] = float(busy.mean())
        out[f"{name}_slots_over_trips"] = float(32 * busy.sum() / t.sum())
    return out


def march_occupancy(kernel, template, res):
    """A ray-march kernel's instance as the card holds it: its registers
    (ptxas), the 128-thread blocks an SM holds by those registers (a warp's
    registers allocated in units of 256, 64K an SM, at most 16 blocks), the
    blocks of a pass at R x R (K15, K16: 16 x 8 pixel tiles; the others
    ceil(R^2 / 128)) and the waves they make over the card's SMs."""
    from vpt_tpu_torch.kernels import _build

    regs = {(k, t): g for k, t, g, *_ in _build.ptxas_table(_build.build_info["log"])}[
        (kernel, template)]
    per_sm = min(65536 // (-(-regs * 32 // 256) * 256 * 4), 16)
    blocks = (-(-res // 16) * -(-res // 8) if kernel in ("march_kernel", "mip_kernel")
              else -(-res * res // 128))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(instance=f"{kernel}<{template}>", registers=regs, blocks_per_sm=per_sm,
                blocks=blocks, waves=blocks / (per_sm * sms))


def rm_shade_reads(dens, filt, closest, h):
    """The lookups K18 makes: 7 at each pixel with a hit (ct > 0)."""
    cx, cy, cz, ct = closest
    h = float(np.float32(h))
    reads = RmReads(dens, filt)
    for p in ((cx + h, cy, cz), (cx - h, cy, cz), (cx, cy + h, cz), (cx, cy - h, cz),
              (cx, cy, cz + h), (cx, cy, cz - h), (cx, cy, cz)):
        reads.add(*p, ct > 0.0)
    return reads


def rm_iso_state_bytes(hit_t, closest):
    """The state bytes K17 moves on ``closest``: ct read where the ray hits,
    the four fields written where the merge takes the new hit."""
    ct = closest[3]
    hits = hit_t >= 0.0
    both = (hit_t > 0.0) & (ct > 0.0)
    take = hits & ((both & (hit_t < ct)) | (~both & (hit_t > 0.0)))
    return 4 * int(hits.sum()) + 16 * int(take.sum())


def rm_bound(reads, tft, state_bytes, ops):
    """``bound`` of a ray-march pass: the state bytes it touches, each
    volume table entry its lookups touch once, the TF row it reads (the
    classic TF at v = 0: a packed (Wp, 16) row or a raw (W, 4) row), and
    ``ops`` FP32 operations."""
    tf_row = tft[0].numel() * tft.element_size() if reads.lookups else 0
    return bound(state_bytes + reads.volume_bytes() + tf_row, ops)


def rm_passes(inv, dens, tft, filt, offset, dev):
    """K15-K18 and their plain versions on one table mode: each pass from
    the same inputs (EAM a random running average at frame 3, MIP a random
    max, ISO a state with earlier hits, shade on the merged hit); returns
    {name: (kernel fn, plain fn, check fn)} where check runs both once and
    compares them bit for bit."""
    from vpt_tpu_torch.kernels import raymarch as RK

    res = RM_RES
    gen = torch.Generator(device=dev).manual_seed(5)
    acc0 = torch.rand((res, res, 3), generator=gen, device=dev)
    frame = torch.tensor(3, dtype=torch.int32, device=dev)
    mip0 = torch.rand((res, res), generator=gen, device=dev) * 0.5
    iso0 = tuple(torch.full((res, res), -1.0, device=dev) for _ in range(4))
    RK.iso_pass(iso0, inv, dens, tft, RM_ISO["isovalue"], 0.61, RM_ISO["steps"], filt)
    light = np.array([0.26726124, -0.40089187, -0.8728716], np.float32)
    e, d, i = RM_EAM, RM_DEPTH, RM_ISO
    return {
        "march[eam]": (lambda st: RK.eam_pass(st, frame, inv, dens, tft, e["extinction"], offset,
                                              e["slices"], filt),
                       lambda st: RK.eam_pass_plain(st, frame, inv, dens, tft, e["extinction"],
                                                    offset, e["slices"], filt), acc0),
        "march[depth]": (lambda st: RK.depth_pass(inv, dens, tft, d["extinction"], d["threshold"],
                                                  offset, d["slices"], res, filt),
                         lambda st: RK.depth_pass_plain(inv, dens, tft, d["extinction"],
                                                        d["threshold"], offset, d["slices"], res,
                                                        filt), None),
        "mip": (lambda st: RK.mip_pass(st, inv, dens, tft, offset, RM_MIP_STEPS, filt),
                lambda st: RK.mip_pass_plain(st, inv, dens, tft, offset, RM_MIP_STEPS, filt),
                mip0),
        "iso": (lambda st: RK.iso_pass(st, inv, dens, tft, i["isovalue"], offset, i["steps"],
                                       filt),
                lambda st: RK.iso_pass_plain(st, inv, dens, tft, i["isovalue"], offset,
                                             i["steps"], filt), iso0),
        "iso_shade": (lambda st: RK.shade_pass(st, dens, tft, light, 0.005, filt),
                      lambda st: RK.iso_shade(st, dens, tft, light, 0.005, filt), iso0),
    }


def rm_clone(st):
    return None if st is None else (tuple(t.clone() for t in st) if isinstance(st, tuple)
                                    else st.clone())


def rm_check(passes, label):
    """Each kernel against its plain version from the same inputs, bit for
    bit; returns the kernels' outputs."""
    out = {}
    for name, (kern, plain, st0) in passes.items():
        a, b = rm_clone(st0), rm_clone(st0)
        ka, pb = kern(a), plain(b)
        torch.cuda.synchronize()
        ka = ka if isinstance(ka, tuple) else (ka,)
        pb = pb if isinstance(pb, tuple) else (pb,)
        rm_bitwise(f"{name} ({label})", ka, pb)
        out[name] = ka
    return out


RM_REPLACES = {
    "march[eam]": "vpt_tpu/models/raymarch.py:99",
    "march[depth]": "vpt_tpu/models/raymarch.py:343",
    "mip": "vpt_tpu/models/raymarch.py:179",
    "iso": "vpt_tpu/models/raymarch.py:229",
    "iso_shade": "vpt_tpu/models/raymarch.py:259",
}
RM_SESSIONS = (("eam", "march_eam"), ("mip", "mip"), ("iso", "iso"), ("depth", "march_depth"))
# each timed pass's instance on the u8 table (ptxas kernel, template), and
# the passes whose trips per ray phase 19 prints
RM_INSTANCES = {"march[eam]": ("march_kernel", "0,0"), "march[depth]": ("march_kernel", "1,0"),
                "mip": ("mip_kernel", "0"), "iso": ("iso_kernel", ""),
                "iso_shade": ("iso_shade_kernel", "")}
RM_TRIPS = ("march[eam]", "march[depth]", "mip")


def rm_session(key, dev, frames, checkpoint_at=None, tmp=None):
    """RenderSession(key) on the bench volume at R = 512: launch counts
    around run(frames), the HDR image, seconds; with ``checkpoint_at`` the
    run is split there by a save and a load into a fresh session."""
    from vpt_tpu_torch import Volume
    from vpt_tpu_torch.kernels import raymarch as RK
    from vpt_tpu_torch.session import RenderSession

    def make():
        return RenderSession(key, Volume.sphere_in_cube(VOLUME), device=dev, resolution=RM_RES)

    s = make()
    s.run(1)  # warm-up
    s.reset()
    RK.reset_launch_counts()
    t0 = time.perf_counter()
    if checkpoint_at is None:
        s.run(frames)
    else:
        s.run(checkpoint_at)
        path = os.path.join(tmp, f"{key}.npz")
        s.save_checkpoint(path)
        s = make().load_checkpoint(path)
        s.run(frames - checkpoint_at)
    dt = time.perf_counter() - t0
    return dict(RK.LAUNCHES), s.hdr_image(), dt, s.metrics()


def rm_profile(key, dev, frames, *args, calls=1, reset=False, ready=None, **kw):
    """``calls`` x ``RenderSession(key, volume, *args, **kw).run(frames)``
    (each after a ``reset()`` where ``reset``) under torch.profiler after a
    warm-up (and after ``ready()`` returns, where given): the device work by
    kernel name (ms and launches per frame), the device ms per frame and the
    profiled host ms per frame (which the profiler's own overhead
    lengthens). The volume is the bench scene's ``sphere_in_cube(VOLUME)``
    at R = RM_RES."""
    from torch.profiler import ProfilerActivity, profile

    from vpt_tpu_torch import Volume
    from vpt_tpu_torch.session import RenderSession
    from vpt_tpu_torch.tools.profile_fit import device_kernels

    s = RenderSession(key, Volume.sphere_in_cube(VOLUME), *args, device=dev, resolution=RM_RES,
                      **kw)
    s.run(2)
    if ready is not None:
        torch.cuda.synchronize()
        ready()
    n = frames * calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            if reset:
                s.reset()
            s.run(frames)
        host = time.perf_counter() - t0
    kernels = {name: dict(ms=k["ms"] / n, launches=k["launches"] / n)
               for name, k in device_kernels(prof).items()}
    return dict(kernels=kernels, device_ms=sum(k["ms"] for k in kernels.values()),
                profiled_host_ms=host * 1e3 / n)


def rm_profiles(specs):
    """``rm_profile(key, cuda:0, frames, **kw)`` for each (key, frames, kw)
    of ``specs``, in one fresh process (in-process profiles after earlier
    ones can lose the device's events, PERF.md question 10). A phase's busy
    share is such a profile's device ms per frame over the phase's own
    unprofiled ms per frame (PERF.md section 2)."""
    code = ("import json, torch, chip_smoke as CS\n"
            f"specs = {list(specs)!r}\n"
            "print(json.dumps([CS.rm_profile(key, torch.device('cuda:0'), frames, **kw) "
            "for key, frames, kw in specs]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"the profiling process exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for (key, *_), prof in zip(specs, out):
        if not prof["device_ms"] > 0:
            raise AssertionError(f"{key}: the profiler saw no device time")
    return out


def phase_raymarch(dev):
    """Phase 19: the ray marchers (K15-K18) on the bench volume at R = 512
    with the JAX renderers' defaults: each kernel bit for bit against its
    plain version in four table modes, BASELINE config 1, K15 over a 256^3
    volume, then a session per renderer (launch counts, images, two runs,
    a checkpoint round trip); each kernel timed by device time."""
    from vpt_tpu_torch import Camera, Volume
    from vpt_tpu_torch.kernels import raymarch as RK
    from vpt_tpu_torch.models import raymarch as TR
    from vpt_tpu_torch.scene.camera import OrbitController
    from vpt_tpu_torch.scene.tf import TransferFunction2D

    from vpt_tpu_torch.session import frame_seed

    t_phase = time.perf_counter()
    inv = Camera().inverse_mvp()
    offset = TR._seed_to_offset(frame_seed(0, 1))
    modes = rm_modes(dev)
    for label, dens, tft, filt in modes:
        for off in (0.0, offset):
            rm_check(rm_passes(inv, dens, tft, filt, off, dev), f"{label}, offset {off:.4f}")
        log(f"# K15-K18 ({label}: K15/K16 <{RK.march_mode(dens, tft, filt)}>) == plain bit for "
            f"bit at {RM_RES}^2, offsets 0 and {offset:.4f}")
    # K15's and K16's other instances: the f32 table under quasicubic, the
    # raw grid under linear and quasicubic beside the raw TF, and a packed
    # table beside the raw TF (the generic instance)
    raw_grid = torch.as_tensor(np.asarray(Volume.sphere_in_cube(VOLUME).density, np.float32),
                               device=dev)
    raw_tf = modes[3][2]
    others = (("f32 quasicubic", modes[1][1], modes[1][2], "quasicubic"),
              ("raw", raw_grid, raw_tf, "linear"),
              ("raw quasicubic", raw_grid, raw_tf, "quasicubic"),
              ("u8 + raw TF", modes[0][1], raw_tf, "linear"))
    for label, dens, tft, filt in others:
        for off in (0.0, offset):
            passes = rm_passes(inv, dens, tft, filt, off, dev)
            rm_check({k: passes[k] for k in ("march[eam]", "march[depth]", "mip")},
                     f"{label}, offset {off:.4f}")
        log(f"# K15/K16 <{RK.march_mode(dens, tft, filt)}> ({label}) == plain bit for bit at "
            f"{RM_RES}^2, offsets 0 and {offset:.4f}")
    seen = {RK.march_mode(d, t, f) for _, d, t, f in (*modes, *others)}
    if seen != set(RK.MARCH_MODES):
        raise AssertionError(f"phase 19 checked K15/K16 in {sorted(seen)}, not every instance")
    del raw_grid, others

    # BASELINE config 1: 64^3, 256^2, 64 slices, extinction 80, the oracle
    # test's TF and pose, raw tables as its eam_frame call takes them
    cam1 = Camera()
    OrbitController(yaw=0.5, pitch=-0.3).apply(cam1)
    tf1 = np.zeros((256, 256, 4), np.float32)
    tf1[..., :3] = (0.9, 0.7, 0.4)
    tf1[..., 3] = np.linspace(0, 1, 256)[None, :]
    d1 = torch.as_tensor(Volume.sphere_in_cube(64).density, device=dev)
    t1 = torch.as_tensor(tf1, device=dev)
    frame1 = torch.tensor(1, dtype=torch.int32, device=dev)
    for off in (0.0, 0.37):
        a, b = torch.zeros((256, 256, 3), device=dev), torch.zeros((256, 256, 3), device=dev)
        RK.eam_pass(a, frame1, cam1.inverse_mvp(), d1, t1, 80.0, off, 64)
        RK.eam_pass_plain(b, frame1, cam1.inverse_mvp(), d1, t1, 80.0, off, 64)
        torch.cuda.synchronize()
        rm_bitwise(f"BASELINE config 1, offset {off}", (a,), (b,))
        if not (float(a.max()) > 0.3 and float((a.sum(-1) == 0).float().mean()) > 0.1):
            raise AssertionError(f"BASELINE config 1 rendered {float(a.max())} max")
    log("# BASELINE config 1 (64^3, 256^2, 64 slices, extinction 80, offsets 0 and 0.37): "
        "K15 == plain bit for bit")

    # each kernel by device time at R = 512 on the u8 linear table
    _, dens, tft, filt = modes[0]
    miss = ray_miss(RM_RES, Camera(), dev)
    passes = rm_passes(inv, dens, tft, filt, offset, dev)
    kinds = {"march[eam]": "eam", "march[depth]": "depth", "mip": "mip", "iso": "iso"}
    n_px = RM_RES * RM_RES
    # state bytes each pass touches: EAM reads and writes acc (and reads the
    # frame count), Depth writes its image, MIP reads and writes acc; K18
    # reads ct everywhere, the hit point where ct > 0, and writes its image
    state_bytes = {"march[eam]": n_px * 3 * 4 * 2 + 4, "march[depth]": n_px * 3 * 4,
                   "mip": n_px * 4 * 2}
    entries = {}
    for name, (kern, plain, st0) in passes.items():
        st_k, st_p = rm_clone(st0), rm_clone(st0)
        ms = device_ms(lambda: kern(st_k))
        plain_ms = cuda_ms(lambda: plain(st_p), 2)
        if name == "iso_shade":
            reads = rm_shade_reads(dens, filt, st0, 0.005)
            shaded = reads.lookups // 7
            b = rm_bound(reads, tft, n_px * 4 + shaded * 12 + n_px * 3 * 4, shaded * OPS_SHADE)
        else:
            reads, hit_t = rm_replay(kinds[name], inv, dens, tft, filt, offset)
            # K17's timed calls run on the state their first call merged
            nbytes = rm_iso_state_bytes(hit_t, st_k) if name == "iso" else state_bytes[name]
            b = rm_bound(reads, tft, nbytes, n_px * OPS_MARCH_RAY + reads.lookups * OPS_MARCH_SAMPLE)
        b["bound_share"] = b["bound_ms"] / ms
        occ = march_occupancy(*RM_INSTANCES[name], RM_RES)
        extra = dict(occupancy=occ)
        if name in RM_TRIPS:
            extra["trips"] = rm_trip_stats(reads.trips, miss)
        entries[name] = kernel_line(dict(name=name, route="cuda", source=RM_SOURCE,
                                         replaces=RM_REPLACES[name], max_abs_err=0.0, ms=ms,
                                         plain_ms=plain_ms, samples=reads.lookups, **extra), b)
        log(f"# {name} at {RM_RES}^2: {ms:.5f} ms kernel (device), plain {plain_ms:.4f} ms; "
            f"{reads.lookups} lookups, {int(reads.touched.sum())} volume entries; bound "
            f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({b['bound_bytes']} B, "
            f"{b['bound_ops']} FP32 ops), share {b['bound_share']:.3f}; {occ['instance']}: "
            f"{occ['registers']} registers, {occ['blocks_per_sm']} blocks an SM, "
            f"{occ['blocks']} blocks, {occ['waves']:.3f} waves")
        if name in RM_TRIPS:
            tr = extra["trips"]
            log(f"# {name} trips per ray over the {tr['hit_pixels']} hit pixels: mean "
                f"{tr['ray_mean']:.3f}, p99 {tr['ray_p99']:.1f}, max {tr['ray_max']}; a warp with "
                f"a hit pays {tr['row_warp_paid']:.3f} over a row of 32 "
                f"({tr['row_slots_over_trips']:.3f}x the trips taken), "
                f"{tr['tile_warp_paid']:.3f} over an 8 x 4 tile "
                f"({tr['tile_slots_over_trips']:.3f}x)")

    # K15 over a 256^3 volume: its 136 MB u8 table does not fit in the L2
    big = TR._pack_if_linear(Volume.sphere_in_cube(256), TransferFunction2D.grayscale_ramp(), dev)
    big_passes = rm_passes(inv, *big, "linear", offset, dev)
    big_passes = {k: big_passes[k] for k in ("march[eam]",)}
    rm_check(big_passes, "256^3")
    kern, _, st0 = big_passes["march[eam]"]
    st = rm_clone(st0)
    big_ms = device_ms(lambda: kern(st))
    big_reads, _ = rm_replay("eam", inv, *big, "linear", offset)
    big_b = rm_bound(big_reads, big[1], state_bytes["march[eam]"],
                     n_px * OPS_MARCH_RAY + big_reads.lookups * OPS_MARCH_SAMPLE)
    big_b["bound_share"] = big_b["bound_ms"] / big_ms
    entries["march[eam]"]["volume_256"] = dict(ms=big_ms, table_bytes=big[0].table.numel(), **big_b)
    log(f"# march[eam] over sphere_in_cube(256) ({big[0].table.numel()} B u8 table) == plain bit "
        f"for bit; {big_ms:.5f} ms (device), bound {big_b['bound_ms']:.5f} ms by "
        f"{big_b['bound_by']}, share {big_b['bound_share']:.3f}")
    del big, big_passes, big_reads, st, st0, kern

    # a session per renderer: launches, images, two runs, a checkpoint
    sessions = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, counter in RM_SESSIONS:
            launches, img, dt, metrics = rm_session(key, dev, RM_FRAMES)
            want = {counter: RM_FRAMES, **({"iso_shade": RM_FRAMES} if key == "iso" else {})}
            if any(launches[k] != v for k, v in want.items()):
                raise AssertionError(f"RenderSession({key!r}).run({RM_FRAMES}) launched {launches}")
            if not np.isfinite(img).all() or img.shape != (RM_RES, RM_RES, 3):
                raise AssertionError(f"{key}: image {img.shape} not finite")
            background = 1.0 if key in ("iso", "depth") else 0.0
            if float(np.mean(img != background)) < 0.01:
                raise AssertionError(f"{key}: the image is empty")
            _, img2, _, _ = rm_session(key, dev, RM_FRAMES)
            _, img3, _, _ = rm_session(key, dev, RM_FRAMES, checkpoint_at=RM_FRAMES // 2, tmp=tmp)
            for other, what in ((img2, "a second run"), (img3, "a checkpoint round trip")):
                if not np.array_equal(img.view(np.int32), other.view(np.int32)):
                    raise AssertionError(f"{key}: {what} differs from the first run")
            sessions[key] = dict(launches=launches, seconds=dt, frames_per_s=RM_FRAMES / dt,
                                 metrics=metrics)
            log(f"# RenderSession({key!r}).run({RM_FRAMES}) at {RM_RES}^2: {dt:.4f} s "
                f"({RM_FRAMES / dt:.1f} frames/s); launches {launches}; a second run and a "
                f"checkpoint round trip equal bit for bit")
    profs = rm_profiles([(key, RM_FRAMES, {}) for key, _ in RM_SESSIONS])
    for (key, _), prof in zip(RM_SESSIONS, profs):
        frame_ms = sessions[key]["seconds"] * 1e3 / RM_FRAMES
        sessions[key].update(profile=prof, device_busy_share=prof["device_ms"] / frame_ms)
        log(f"# profiled run({RM_FRAMES}) of {key!r} (a fresh process), per frame: device "
            f"{prof['device_ms']:.5f} ms of {frame_ms:.5f} ms unprofiled (busy "
            f"{prof['device_ms'] / frame_ms:.3f}; profiled host {prof['profiled_host_ms']:.5f} "
            "ms); " + ", ".join(
                f"{n} {k['ms']:.5f} ms x{k['launches']:g}" for n, k in prof["kernels"].items()))
    entries["march[eam]"]["launches"] = sessions["eam"]["launches"]["march_eam"]
    entries["march[depth]"]["launches"] = sessions["depth"]["launches"]["march_depth"]
    entries["mip"]["launches"] = sessions["mip"]["launches"]["mip"]
    entries["iso"]["launches"] = sessions["iso"]["launches"]["iso"]
    entries["iso_shade"]["launches"] = sessions["iso"]["launches"]["iso_shade"]
    log(f"# phase 19 (ray marchers): {time.perf_counter() - t_phase:.1f} s")
    return list(entries.values()), sessions


def eam_fit_scene(dev, volume=None):
    """The CLI's invert scene (vpt_tpu_torch/cli.py, as vpt_tpu/cli.py): the
    f32 density of sphere_in_cube, the ramp-alpha TF, the orbit cameras."""
    from vpt_tpu_torch import Camera, Volume
    from vpt_tpu_torch.scene.camera import OrbitController

    F = EAM_FIT
    tf = np.zeros((256, 256, 4), np.float32)
    tf[..., :3] = 1.0
    tf[..., 3] = np.linspace(0, 1, 256)[None, :]
    cams = []
    for k in range(F["views"]):
        cam = Camera()
        OrbitController(yaw=2 * np.pi * k / F["views"], pitch=-0.4).apply(cam)
        cams.append(cam)
    truth = Volume.sphere_in_cube(volume or F["volume"]).density
    return (torch.as_tensor(np.asarray(truth, np.float32), device=dev),
            torch.as_tensor(tf, device=dev), cams)


def eam_bwd_check(g, inv, dens, tft, offset, filt, learn_tf, label):
    """K19 against eam_backward_plain on the same inputs: each gradient within
    EAM_BWD_RTOL of the plain one's largest magnitude (the TF's against the
    plain version with the TF in float64); returns the largest absolute
    difference."""
    from vpt_tpu_torch.kernels import raymarch as RK

    F = EAM_FIT
    rest = (F["extinction"], offset, F["slices"], filt)
    kd, kt = RK.eam_backward(g, inv, dens, tft, *rest, learn_tf)
    pd, _ = RK.eam_backward_plain(g, inv, dens, tft, *rest, False)
    pt = (RK.eam_backward_plain(g.double(), inv, dens, tft.double(), *rest, True)[1]
          if learn_tf else None)
    torch.cuda.synchronize()
    err = 0.0
    for name, k, p in (("g_density", kd, pd), ("g_tf", kt, pt)):
        if p is None:
            if k is not None:
                raise AssertionError(f"K19 ({label}) returned a TF gradient it was not asked for")
            continue
        scale, diff = float(p.abs().max()), float((k - p).abs().max())
        if not (scale > 0 and np.isfinite(diff) and diff <= EAM_BWD_RTOL * scale):
            raise AssertionError(f"K19 ({label}) {name}: max |kernel - plain| {diff} against "
                                 f"max |plain| {scale} (tolerance {EAM_BWD_RTOL} of it)")
        err = max(err, diff)
        log(f"# eam_backward ({label}) {name}: max |kernel - plain| {diff:.3e}, max |plain| "
            f"{scale:.3e} ({diff / scale:.2e} of it)")
    return err


def eam_bwd_bound(reads, tft, res, learn_tf):
    """``bound`` of K19 over a frame whose march ``reads`` replays: g_img
    read, each touched grid entry read once (the replay) and its gradient
    written once, the TF's row 0 read (and its gradient written with
    learn_tf); the ray, each active sample's forward once and its reverse's
    adjoint operations."""
    row = tft[0].numel() * tft.element_size()
    nbytes = (res * res * 3 * 4 + 2 * reads.volume_bytes() + row * (2 if learn_tf else 1))
    step = OPS_MARCH_SAMPLE + OPS_EAM_BWD_STEP + (OPS_EAM_BWD_TF if learn_tf else 0)
    ops = res * res * OPS_MARCH_RAY + reads.lookups * step
    return bound(nbytes, ops)


def eam_fit_run(targets, cams, tft, dev, learn_tf, plain=False, iterations=None):
    """fit_density on the card for ``iterations`` (EAM_FIT's) from a constant
    0.2 density, the ray-march counts set to 0 just before; ``plain`` runs
    the same loop through the plain frame under autograd (optim's
    ``eam_frame_diff`` replaced by ``eam_frame``). Returns (params, losses,
    seconds, launches)."""
    from vpt_tpu_torch import optim as TO
    from vpt_tpu_torch.kernels import raymarch as RK

    F = EAM_FIT
    init = np.full((F["volume"],) * 3, 0.2, np.float32)
    diff = TO.eam_frame_diff
    if plain:
        TO.eam_frame_diff = RK.eam_frame
    try:
        torch.cuda.synchronize()
        RK.reset_launch_counts()
        t0 = time.perf_counter()
        params, losses = TO.fit_density(targets, cams, init, tft, extinction=F["extinction"],
                                        slices=F["slices"], resolution=F["res"],
                                        learn_tf=learn_tf,
                                        iterations=iterations or F["iterations"],
                                        learning_rate=F["lr"], device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(RK.LAUNCHES)
    finally:
        TO.eam_frame_diff = diff
    return params, losses, dt, launches


def eam_fit_profile(targets, cams, tft, dev, iterations=5):
    """Iterations of make_inverse_step (as fit_density runs them, float(loss)
    each) under torch.profiler after two warm-up iterations: the device work
    by kernel name per iteration and the device ms per iteration."""
    from torch.profiler import ProfilerActivity, profile

    from vpt_tpu_torch import optim as TO
    from vpt_tpu_torch.models.raymarch import _seed_to_offset
    from vpt_tpu_torch.tools.profile_fit import device_kernels

    F = EAM_FIT
    static = dict(tf_table=tft, extinction=F["extinction"], slices=F["slices"],
                  resolution=F["res"], volume_filter="linear")
    params = {"density": torch.full((F["volume"],) * 3, 0.2, device=dev)}
    opt = TO.Adam(F["lr"])
    state = TO.InverseState(params, opt.init(params), 0)
    step = TO.make_inverse_step(opt, static)

    def run(first, n):
        nonlocal state
        for i in range(first, first + n):
            k = i % len(targets)
            state, loss = step(state, cams[k].inverse_mvp(), np.float32(_seed_to_offset(i)),
                               targets[k])
            float(loss)

    run(0, 2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(2, iterations)
    kernels = {name: dict(ms=k["ms"] / iterations, launches=k["launches"] / iterations)
               for name, k in device_kernels(prof).items()}
    return dict(kernels=kernels, device_ms=sum(k["ms"] for k in kernels.values()))


def phase_eam_fit(dev):
    """Phase 20: EAM training on the CLI's invert scene at full width (K15's
    frame alone and K19 eam_backward): K19 against its plain version in the
    linear, quasicubic and nearest modes with and without the TF, on the
    64^3 scene and the 128^3 bench volume; EAMFrame's forward against
    eam_frame bit for bit; both timed by device time against their bounds;
    fit_density for EAM_FIT's iterations with and without learn_tf (one K15
    and one K19 launch an iteration, the loss trajectory against the same
    loop through the plain versions), its device busy share under the
    profiler; the CLI's invert --iterations 10."""
    from vpt_tpu_torch.kernels import raymarch as RK
    from vpt_tpu_torch.models import raymarch as TR

    F = EAM_FIT
    t_phase = time.perf_counter()
    truth, tft, cams = eam_fit_scene(dev)
    res = F["res"]
    inv = cams[1].inverse_mvp()
    offset = np.float32(TR._seed_to_offset(1))
    gen = torch.Generator(device=dev).manual_seed(20)
    g = torch.rand((res, res, 3), generator=gen, device=dev) * 2.0 - 1.0
    big = eam_fit_scene(dev, 128)[0]

    # EAMFrame's forward (K15, the frame alone) == eam_frame bit for bit, and
    # K19 == plain, in the three filters, with and without the TF
    err = {"eam_backward": 0.0, "eam_backward[tf]": 0.0}
    for label, dens in ((f"{F['volume']}^3", truth), ("128^3", big)):
        for filt in ("linear", "quasicubic", "nearest"):
            leaf = dens.clone().requires_grad_(True)
            img = RK.eam_frame_diff(inv, leaf, tft, F["extinction"], offset, F["slices"], res, filt)
            ref = RK.eam_frame(inv, dens, tft, F["extinction"], offset, F["slices"], res, filt)
            torch.cuda.synchronize()
            rm_bitwise(f"EAMFrame forward ({label}, {filt})", (img.detach(),), (ref,))
            if not float(ref.max()) > 0.05:
                raise AssertionError(f"the EAM frame ({label}, {filt}) is empty")
            # the plain TF gradient takes ~7 s a call on the card (autograd's
            # index backward): with the TF on the fit's scene, and linear at 128^3
            for learn_tf in (False, True) if dens is truth or filt == "linear" else (False,):
                key = "eam_backward[tf]" if learn_tf else "eam_backward"
                err[key] = max(err[key], eam_bwd_check(
                    g, inv, dens, tft, offset, filt, learn_tf,
                    f"{label}, {filt}, {'with' if learn_tf else 'without'} the TF"))
        instances = ", ".join(RK.march_mode(dens, tft, f) for f in ("linear", "quasicubic",
                                                                     "nearest"))
        log(f"# EAMFrame forward == eam_frame bit for bit ({label}; linear, quasicubic, nearest: "
            f"K15 <{instances}>)")

    # device times against the bounds, on the fit's scene (linear)
    entries, reads = {}, rm_replay("eam", inv, truth, tft, "linear", offset,
                                   eam=dict(res=res, slices=F["slices"],
                                            extinction=F["extinction"]))[0]
    frame_args = (inv, truth, tft, F["extinction"], offset, F["slices"], res)
    ms = device_ms(lambda: RK.eam_frame_pass(*frame_args))
    plain_ms = cuda_ms(lambda: RK.eam_frame(*frame_args), 2)
    b = rm_bound(reads, tft, res * res * 3 * 4,
                 res * res * OPS_MARCH_RAY + reads.lookups * OPS_MARCH_SAMPLE)
    b["bound_share"] = b["bound_ms"] / ms
    occ = march_occupancy("march_kernel", "0,4", res)
    entries["march[eam_frame]"] = kernel_line(dict(
        name="march[eam_frame]", route="cuda", source=RM_SOURCE,
        replaces="vpt_tpu/models/raymarch.py:99", max_abs_err=0.0, ms=ms,
        plain_ms=plain_ms, samples=reads.lookups, occupancy=occ), b)
    log(f"# march[eam_frame] (K15, the frame alone) at {res}^2 over {F['volume']}^3: {ms:.5f} ms "
        f"(device), plain {plain_ms:.4f} ms; {reads.lookups} samples, "
        f"{int(reads.touched.sum())} grid entries; bound {b['bound_ms']:.5f} ms by "
        f"{b['bound_by']}, share {b['bound_share']:.3f}; {occ['instance']}: "
        f"{occ['registers']} registers, {occ['blocks_per_sm']} blocks an SM, {occ['waves']:.3f} "
        "waves")
    for learn_tf in (False, True):
        key = "eam_backward[tf]" if learn_tf else "eam_backward"
        args = (g, inv, truth, tft, F["extinction"], offset, F["slices"], "linear", learn_tf)
        ms = device_ms(lambda: RK.eam_backward(*args))
        # the plain versions ran in the checks above: no warm-up call
        plain_ms = cuda_ms(lambda: RK.eam_backward_plain(*args), 1 if learn_tf else 2, warm=False)
        b = eam_bwd_bound(reads, tft, res, learn_tf)
        b["bound_share"] = b["bound_ms"] / ms
        big_reads = rm_replay("eam", inv, big, tft, "linear", offset,
                              eam=dict(res=res, slices=F["slices"],
                                       extinction=F["extinction"]))[0]
        big_args = (g, inv, big, tft, F["extinction"], offset, F["slices"], "linear", learn_tf)
        big_ms = device_ms(lambda: RK.eam_backward(*big_args))
        big_b = eam_bwd_bound(big_reads, tft, res, learn_tf)
        big_b["bound_share"] = big_b["bound_ms"] / big_ms
        entries[key] = kernel_line(dict(
            name=key, route="cuda", source=RM_SOURCE,
            replaces="vpt_tpu/models/raymarch.py:99", max_abs_err=err[key], ms=ms,
            plain_ms=plain_ms, samples=reads.lookups,
            volume_128=dict(ms=big_ms, samples=big_reads.lookups, **big_b)), b)
        log(f"# {key} (K19) at {res}^2 over {F['volume']}^3, with the gradients' zeroing: "
            f"{ms:.5f} ms (device), plain {plain_ms:.4f} ms; {reads.lookups} samples; bound "
            f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({b['bound_bytes']} B, "
            f"{b['bound_ops']} FP32 ops), share {b['bound_share']:.3f}; over 128^3 "
            f"{big_ms:.5f} ms, {big_reads.lookups} samples, bound {big_b['bound_ms']:.5f} ms by "
            f"{big_b['bound_by']}, share {big_b['bound_share']:.3f}")
    del big

    # fit_density: targets at offset 0 (K15), then the loop with and without
    # learn_tf, and the same loops through the plain versions
    targets = [RK.eam_frame_pass(c.inverse_mvp(), truth, tft, F["extinction"], 0.0, F["slices"],
                                 res) for c in cams]
    fits = {}
    for learn_tf in (False, True):
        key = "learn_tf" if learn_tf else "density"
        eam_fit_run(targets, cams, tft, dev, learn_tf, iterations=2)  # warm-up
        params, losses, dt, launches = eam_fit_run(targets, cams, tft, dev, learn_tf)
        want = {"march_eam_frame": F["iterations"], "eam_backward": F["iterations"]}
        if any(launches[k] != v for k, v in want.items()) or sum(launches.values()) != sum(
                want.values()):
            raise AssertionError(f"fit_density ({key}) launched {launches}, not one K15 frame and "
                                 f"one K19 an iteration")
        # Adam moves an element whose gradient is rounding noise by up to the
        # learning rate; learning the TF, the trajectories may part after
        # iteration 5 (tests/test_torch_eam_grad.py), and the plain TF
        # gradient takes ~3.8 s an iteration: the plain loop runs the
        # iterations compared, 3 of them
        held = F["iterations"] if not learn_tf else 3
        _, plain_losses, plain_dt, plain_launches = eam_fit_run(targets, cams, tft, dev, learn_tf,
                                                                plain=True, iterations=held)
        if any(plain_launches.values()):
            raise AssertionError(f"the plain loop launched {plain_launches}")
        rel = np.abs(losses[:held] - plain_losses) / np.abs(plain_losses)
        if not (losses[0] == plain_losses[0] and (rel <= EAM_FIT_LOSS_RTOL).all()
                and np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise AssertionError(f"fit_density ({key}) losses {losses.tolist()} against the plain "
                                 f"loop's {plain_losses.tolist()}")
        d = params["density"]
        if not (float(d.min()) >= 0.0 and float(d.max()) <= 1.0 and float((d - 0.2).abs().max()) > 0):
            raise AssertionError(f"fit_density ({key}): the density left [0, 1] or did not move")
        fits[key] = dict(losses=losses.tolist(), plain_losses=plain_losses.tolist(), seconds=dt,
                         s_per_iteration=dt / F["iterations"], plain_s_per_iteration=plain_dt /
                         held, launches=launches, max_rel_loss_diff=float(rel.max()))
        log(f"# fit_density ({key}) at {res}^2 over {F['volume']}^3, {F['views']} views, "
            f"{F['iterations']} iterations: {dt / F['iterations']:.5f} s an iteration (plain "
            f"{plain_dt / held:.5f}); launches {launches}; losses {losses[0]:.6f} -> "
            f"{losses[-1]:.6f}, the first {held} against the plain loop's at most "
            f"{rel.max():.2e} relative (iteration 0 bit for bit)")
    prof = eam_fit_profile(targets, cams, tft, dev)
    if not prof["device_ms"] > 0:
        raise AssertionError("the profiler saw no device time in fit_density's iterations")
    it_ms = fits["density"]["s_per_iteration"] * 1e3
    fits["density"]["profile"] = prof
    fits["density"]["device_busy_share"] = prof["device_ms"] / it_ms
    log(f"# profiled fit_density iteration: device {prof['device_ms']:.5f} ms of {it_ms:.5f} ms "
        f"unprofiled (busy {prof['device_ms'] / it_ms:.3f}); " + ", ".join(
            f"{n} {k['ms']:.5f} ms x{k['launches']:g}" for n, k in prof["kernels"].items()))

    # the CLI: invert without --spectral on the card
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rec.npy")
        cmd = [sys.executable, "-m", "vpt_tpu_torch.cli", "invert", "--device", "cuda",
               "--volume-size", str(F["volume"]), "--resolution", str(res), "--extinction",
               str(F["extinction"]), "--views", str(F["views"]), "--iterations", "10", "-o", out]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        dt_cli = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"CLI invert exited {proc.returncode}: {proc.stderr[-2000:]}")
        metrics = json.loads(proc.stdout.strip().splitlines()[-1])
        rec = np.load(out)
    if (set(metrics) != {"final_loss", "density_mae"} or rec.shape != (F["volume"],) * 3
            or not np.isfinite(rec).all() or not all(np.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"CLI invert wrote {rec.shape}, metrics {metrics}")
    fits["cli"] = dict(seconds=dt_cli, metrics=metrics)
    log(f"# CLI invert --device cuda --iterations 10: exit 0 in {dt_cli:.2f} s (process), "
        f"{rec.shape} grid, metrics {json.dumps(metrics)}")
    entries["march[eam_frame]"]["launches"] = fits["density"]["launches"]["march_eam_frame"]
    entries["eam_backward"]["launches"] = fits["density"]["launches"]["eam_backward"]
    entries["eam_backward[tf]"]["launches"] = fits["learn_tf"]["launches"]["eam_backward"]
    log(f"# phase 20 (EAM training): {time.perf_counter() - t_phase:.1f} s")
    return list(entries.values()), fits


def mcm_modes():
    """Phase 21's modes: (label, volume, environment, pack_tables,
    compaction) on the bench volume; the environment is phase 12's seeded
    map."""
    from vpt_tpu_torch import Volume

    vol = Volume.sphere_in_cube(VOLUME)
    f32 = Volume(density=smoothed(np.random.default_rng(13).random(vol.shape, np.float32)))
    env = seeded_envmap()
    return (("u8", vol, None, True, False), ("f32", f32, None, True, False),
            ("quasicubic", Volume(vol.density, "quasicubic"), None, True, False),
            ("raw", vol, None, False, False), ("nearest", Volume(vol.density, "nearest"), None,
                                                True, False),
            ("environment", vol, env, True, False), ("lane_table", vol, env, True, True))


def mcm_renderer(vol, env, pack, compaction, dev):
    from vpt_tpu_torch.models.mcm import MCMRenderer
    from vpt_tpu_torch.utils.config import MCMConfig

    return MCMRenderer(vol, None, env, MCMConfig(**MCM_CONFIG), resolution=RES, pack_tables=pack,
                       compaction=compaction, device=dev)


def mcm_replay(ctx, state, seeds, lanes=None):
    """K20's work on ``state`` over ``seeds``, replayed with the plain
    version: lane-steps, lookups inside the volume (``RmReads``: each
    volume entry touched once), escapes and the environment texels they
    read (each once), scatters and completed paths."""
    from vpt_tpu_torch.kernels import mcm as KM
    from vpt_tpu_torch.ops import interp, sampling

    env = ctx.environment
    He, We, _ = env.shape
    reads = RmReads(ctx.density, ctx.volume_filter)
    env_touched = torch.zeros(He * We, dtype=torch.bool, device=env.device)
    n = dict(lane_steps=0, escapes=0, scatters=0)
    last = {}
    sample_volume, sample_environment, draw_hg = (interp.sample_volume, KM.sample_environment,
                                                  sampling.draw_hg)

    def volume_hook(density, x, y, z, mode="linear"):
        oob = (x > 1.0) | (x < 0.0) | (y > 1.0) | (y < 0.0) | (z > 1.0) | (z < 0.0)
        last["oob"] = oob
        n["lane_steps"] += oob.numel()
        n["escapes"] += int(oob.sum())
        reads.add(x, y, z, ~oob)
        return sample_volume(density, x, y, z, mode)

    def env_hook(e, dx, dy, dz):
        oob = last["oob"]
        u = torch.atan2(dx, -dz) * KM.INV_PI_HALF + 0.5
        v = torch.asin(torch.clamp(-dy, -1.0, 1.0)) * 2.0 * KM.INV_PI_HALF + 0.5
        xs, ys = interp._coords(u, We)[:2], interp._coords(v, He)[:2]
        for iy in ys:
            for ix in xs:
                env_touched[(iy * We + ix)[oob].to(torch.int64)] = True
        return sample_environment(e, dx, dy, dz)

    def hg_hook(rng, mask, *args):
        n["scatters"] += int(mask.sum())
        return draw_hg(rng, mask, *args)

    st = clone_state(state)
    interp.sample_volume, KM.sample_environment, sampling.draw_hg = volume_hook, env_hook, hg_hook
    try:
        KM.step_plain(st, ctx, seeds, STEPS, lanes)
    finally:
        interp.sample_volume, KM.sample_environment, sampling.draw_hg = (
            sample_volume, sample_environment, draw_hg)
    n["lookups"] = reads.lookups
    n["respawns"] = int(st.samples.sum()) - int(state.samples.sum())
    n["env_bytes"] = int(env_touched.sum()) * 12
    return reads, n


def mcm_step_bound(ctx, state, seeds, ms, lanes=None):
    """``bound`` of K20 over ``seeds`` from ``state``: the state read and
    written once (14 words a lane each way), the lane table, each volume
    entry and environment texel the replayed lookups touch once, the TF's
    row 0; the replayed run's operations."""
    reads, n = mcm_replay(ctx, state, seeds, lanes)
    lanes_n = state.px.numel()
    nbytes = (2 * 14 * 4 * lanes_n + 2 * 4 * lanes_n * (lanes is not None) + reads.volume_bytes()
              + (ctx.tf_table[0].numel() * 4 if n["lookups"] else 0) + n["env_bytes"])
    aniso = abs(float(ctx.anisotropy)) >= 1e-5
    ops = (n["lane_steps"] * OPS_MCM_STEP + n["lookups"] * OPS_MCM_LOOKUP
           + n["respawns"] * OPS_MCM_RESPAWN + n["escapes"] * OPS_MCM_ESCAPE
           + n["scatters"] * (OPS_MCM_SCATTER + 30 * aniso))
    out = bound(nbytes, ops, ms)
    out.update({k: v for k, v in n.items() if k != "env_bytes"})
    return out


def mcm_check(label, kern, plain):
    """Kernel and plain states equal in every field, bit for bit."""
    diff = first_difference(kern, plain)
    if diff is not None:
        raise AssertionError(f"{label} != plain: first difference in {diff[0]} on {diff[1]} lanes "
                             f"(first flat lane {diff[2]})")


def mcm_session(dev, vol, env, pack, compaction, frames, checkpoint_at=None, tmp=None):
    """RenderSession("mcm") at R = 512: the counts set to 0, then reset()
    and run(frames) (split by a save and a load into a fresh session at
    ``checkpoint_at``); returns (K20/K21 and K8 launches, HDR image,
    seconds)."""
    from vpt_tpu_torch.kernels import mcm as KM
    from vpt_tpu_torch.kernels import mcm_spectral as KS
    from vpt_tpu_torch.session import RenderSession
    from vpt_tpu_torch.utils.config import MCMConfig

    def make():
        return RenderSession("mcm", vol, None, env, MCMConfig(**MCM_CONFIG), resolution=RES,
                             pack_tables=pack, compaction=compaction, device=dev)

    s = make()
    s.run(1)  # warm-up
    KM.reset_launch_counts()
    KS.reset_launch_counts()
    t0 = time.perf_counter()
    s.reset()
    if checkpoint_at is None:
        s.run(frames)
    else:
        s.run(checkpoint_at)
        path = os.path.join(tmp, "mcm.npz")
        s.save_checkpoint(path)
        s = make().load_checkpoint(path)
        s.run(frames - checkpoint_at)
    dt = time.perf_counter() - t0
    launches = {**KM.LAUNCHES, "compact_radiance": KS.LAUNCHES["compact_radiance"]}
    return launches, s.hdr_image(), dt, s.metrics()


def mcm_profile():
    """``rm_profile`` of 4 x the default ``RenderSession("mcm").run(16)`` in
    a fresh process: in this one, after phase 20's profiles, torch.profiler
    returned none or some of K20's launches (my chip runs 2-3, PR 15)."""
    code = ("import json, torch, chip_smoke as CS; "
            "from vpt_tpu_torch.utils.config import MCMConfig; "
            "print(json.dumps(CS.rm_profile('mcm', torch.device('cuda:0'), CS.MCM_FRAMES, None, "
            "None, MCMConfig(**CS.MCM_CONFIG), calls=4)))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"the mcm profile exited {proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_mcm(dev):
    """Phase 21: the RGB MCM renderer (K20 mcm_step, K21 mcm_reset, K8 on the
    RGB state) at R = 512 on the bench volume with the CLI's defaults: K21
    and K20 bit for bit against their plain versions in every mode, each
    timed against its bound; K8 on the RGB state; compacted hit pixels
    against the full render; a RenderSession per mode (launches), the
    default's second run, checkpoint round trip and profiled busy share."""
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import mcm as KM
    from vpt_tpu_torch.kernels import mcm_spectral as KS
    from vpt_tpu_torch.models.mcm import MCMState

    t_phase = time.perf_counter()
    cam = Camera()
    seeds2 = [2654435761 * k % 2**32 for k in (3, 4)]
    frames = [(k + 1) * 2654435761 % 2**32 for k in range(MCM_FRAMES)]
    entries, sessions = {}, {}
    for label, vol, env, pack, compaction in mcm_modes():
        r = mcm_renderer(vol, env, pack, compaction, dev)
        ctx = r.ctx(cam, 7)
        lanes = None
        if compaction:
            t = r._compact_tables(cam)
            lanes = (t["lane_ix"], t["lane_iy"])
        # K21 against reset_plain, two runs identical
        s0 = MCMState(**KM.reset(ctx, RES, dev, lanes))
        s0b = MCMState(**KM.reset(ctx, RES, dev, lanes))
        sp = MCMState(**KM.reset_plain(ctx, RES, dev, lanes))
        torch.cuda.synchronize()
        mcm_check(f"K21 ({label})", s0, sp)
        mcm_check(f"K21 ({label}) second run", s0, s0b)
        # K20 against step_plain over 2 dispatches, two runs identical
        sk, sk2, sp = clone_state(s0), clone_state(s0), clone_state(s0)
        KM.step(sk, ctx, seeds2, STEPS, lanes)
        KM.step(sk2, ctx, seeds2, STEPS, lanes)
        KM.step_plain(sp, ctx, seeds2, STEPS, lanes)
        torch.cuda.synchronize()
        mcm_check(f"K20 ({label})", sk, sp)
        mcm_check(f"K20 ({label}) second run", sk, sk2)
        if int(sk.samples.sum()) <= 0:
            raise AssertionError(f"K20 ({label}) completed no samples")
        # K20 timed as the session calls it, one launch of MCM_FRAMES
        # dispatches (which amortizes the wrapper's host path), each call
        # from the reset state, so the replayed bound counts the timed work
        st_k, st_p = clone_state(s0), clone_state(s0)

        def from_s0(st, fn):
            for a, b0 in zip(st.tensors(), s0.tensors()):
                a.copy_(b0)
            fn(st, ctx, frames, STEPS, lanes)

        ms = cuda_ms(lambda: from_s0(st_k, KM.step), 10)
        plain_ms = cuda_ms(lambda: from_s0(st_p, KM.step_plain), 1)
        b = mcm_step_bound(ctx, s0, frames, ms, lanes)
        name = "mcm_step" if label == "u8" else f"mcm_step[{label}]"
        entries[name] = kernel_line(dict(
            name=name, route="cuda", source=MCM_SOURCE,
            replaces=("vpt_tpu/models/mcm_compact.py:55" if compaction
                      else "vpt_tpu/models/mcm.py:111"), max_abs_err=0.0, ms=ms,
            plain_ms=plain_ms, dispatches=MCM_FRAMES, ms_per_dispatch=ms / MCM_FRAMES), b)
        log(f"# K20 ({label}) == plain bit for bit over 2 dispatches ({tuple(sk.px.shape)} lanes, "
            f"{int(sk.samples.sum())} samples), K21 == plain; a launch of {MCM_FRAMES} dispatches "
            f"{ms:.5f} ms kernel ({ms / MCM_FRAMES:.5f} per dispatch), plain {plain_ms:.4f} ms; "
            f"{b['lookups']} lookups, {b['escapes']} escapes, {b['respawns']} paths; bound "
            f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({b['bound_bytes']} B, "
            f"{b['bound_ops']} FP32 ops), share {b['bound_share']:.3f}")
        if label in ("u8", "lane_table"):
            n = s0.px.numel()
            k21_ms = device_ms(lambda: KM.reset(ctx, RES, dev, lanes))
            k21_plain_ms = cuda_ms(lambda: KM.reset_plain(ctx, RES, dev, lanes), 2)
            # K21 writes the 14 state words of each lane (and reads the lane
            # table); one camera ray per lane
            kb = bound(14 * 4 * n + 2 * 4 * n * (lanes is not None), n * (OPS_MCM_RESPAWN - 10),
                       k21_ms)
            rname = "mcm_reset" if label == "u8" else "mcm_reset[lane_table]"
            entries[rname] = kernel_line(dict(
                name=rname, route="cuda", source=MCM_SOURCE,
                replaces=("vpt_tpu/models/mcm_compact.py:33" if compaction
                          else "vpt_tpu/models/mcm.py:94"), max_abs_err=0.0, ms=k21_ms,
                plain_ms=k21_plain_ms), kb)
            log(f"# K21 ({label}): device {k21_ms:.5f} ms kernel, plain {k21_plain_ms:.4f} ms; "
                f"bound {kb['bound_ms']:.5f} ms by {kb['bound_by']}, share "
                f"{kb['bound_share']:.3f}")
        if compaction:
            # K8 on the RGB state: the three channels as bins, one stream
            rad = torch.stack([sk.rr, sk.rg, sk.rb])
            a = KS.compact_radiance(rad, t["pixel_hit"], t["miss"], t["n_hit"], 1)
            p = KS.compact_radiance_plain(rad, t["pixel_hit"], t["miss"], t["n_hit"], 1)
            torch.cuda.synchronize()
            if not torch.equal(a.view(torch.int32), p.view(torch.int32)):
                raise AssertionError(f"K8 on the RGB state != plain on {int((a != p).sum())} "
                                     "values")
            k8_ms = device_ms(lambda: KS.compact_radiance(rad, t["pixel_hit"], t["miss"],
                                                          t["n_hit"], 1))
            k8_plain_ms = cuda_ms(lambda: KS.compact_radiance_plain(rad, t["pixel_hit"], t["miss"],
                                                                    t["n_hit"], 1), 10)
            n_pix, n_hit = RES * RES, t["n_hit"]
            k8b = bound(3 * (n_hit + 2 * n_pix) * 4 + n_pix * 4, 3 * n_hit, k8_ms)
            entries["compact_image[rgb]"] = kernel_line(dict(
                name="compact_image[rgb]", route="cuda", source=SOURCE,
                replaces="vpt_tpu/models/mcm_compact.py:79", max_abs_err=0.0, ms=k8_ms,
                plain_ms=k8_plain_ms), k8b)
            log(f"# K8 on the RGB state ({n_hit} hit pixels): equal to plain bit for bit; device "
                f"{k8_ms:.5f} ms kernel vs {k8_plain_ms:.4f} ms plain; bound "
                f"{k8b['bound_ms']:.5f} ms, share {k8b['bound_share']:.3f}")
            # compacted hit pixels against the full render, same seeds
            full = mcm_renderer(vol, env, pack, False, dev)
            seeds = [(k + 1) * 2654435761 % 2**32 for k in range(10)]
            i_full = full.render_many(full.reset(cam, seeds[0]), cam, seeds)[1]
            i_comp = r.render_many(r.reset(cam, seeds[0]), cam, seeds)[1]
            torch.cuda.synchronize()
            hit = t["hit"]
            if not torch.equal(i_comp[hit], i_full[hit]):
                raise AssertionError("compacted hit pixels differ from the full render")
            log(f"# compaction: the compacted render's {n_hit} hit pixels equal the full "
                "render's bit for bit over 10 dispatches")
            del full
        del r, s0, s0b, sp, sk, sk2, st_k, st_p
        # the mode's session: one K21 and one K20 launch per reset + run
        launches, img, dt, metrics = mcm_session(dev, vol, env, pack, compaction, MCM_FRAMES)
        modes = {"raw": ("step_raw",), "nearest": ("step_raw",),
                 "quasicubic": ("step_quasicubic",), "environment": ("step_environment",),
                 "lane_table": ("step_environment", "step_lane_table", "reset_lane_table",
                                "compact_radiance")}.get(label, ())
        want = dict(step=1, reset=1, **{k: 1 for k in modes})
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"RenderSession('mcm', {label}).run({MCM_FRAMES}) launched "
                                 f"{launches}")
        if img.shape != (RES, RES, 3) or not np.isfinite(img).all() or not img.any():
            raise AssertionError(f"mcm {label}: image {img.shape} empty or not finite")
        entries[name]["launches"] = launches["step"]
        if label == "u8":
            entries["mcm_reset"]["launches"] = launches["reset"]
        if compaction:
            entries["mcm_reset[lane_table]"]["launches"] = launches["reset_lane_table"]
            entries["compact_image[rgb]"]["launches"] = launches["compact_radiance"]
        sessions[label] = dict(launches=launches, seconds=dt, frames_per_s=MCM_FRAMES / dt,
                               metrics=metrics)
        log(f"# RenderSession('mcm', {label}).run({MCM_FRAMES}) at {RES}^2: {dt:.4f} s "
            f"({MCM_FRAMES / dt:.1f} frames/s, {metrics['paths'] / dt / 1e6:.3f} Mpaths/s); "
            f"launches {launches}")
        if label == "u8":
            with tempfile.TemporaryDirectory() as tmp:
                _, img2, _, _ = mcm_session(dev, vol, env, pack, compaction, MCM_FRAMES)
                _, img3, _, _ = mcm_session(dev, vol, env, pack, compaction, MCM_FRAMES,
                                            checkpoint_at=MCM_FRAMES // 2, tmp=tmp)
            for other, what in ((img2, "a second run"), (img3, "a checkpoint round trip")):
                if not np.array_equal(img.view(np.int32), other.view(np.int32)):
                    raise AssertionError(f"mcm: {what} differs from the first run")
            prof = mcm_profile()
            seen = sum(k["launches"] for n, k in prof["kernels"].items()
                       if n.startswith("mcm_step_kernel")) * MCM_FRAMES
            if seen != 1:
                raise AssertionError(f"mcm: the profiler saw {seen * 4:g} of 4 K20 launches")
            frame_ms = dt * 1e3 / MCM_FRAMES
            sessions[label].update(profile=prof, device_busy_share=prof["device_ms"] / frame_ms)
            log(f"# mcm: a second run and a checkpoint round trip equal bit for bit; profiled "
                f"4 x run({MCM_FRAMES}) per frame (a fresh process): device "
                f"{prof['device_ms']:.5f} ms of {frame_ms:.5f} ms unprofiled (busy "
                f"{prof['device_ms'] / frame_ms:.3f}; profiled host "
                f"{prof['profiled_host_ms']:.5f} ms); " + ", ".join(
                    f"{k} {v['ms']:.5f} ms x{v['launches']:g}" for k, v in prof["kernels"].items()))
        torch.cuda.empty_cache()
    log(f"# phase 21 (RGB MCM): {time.perf_counter() - t_phase:.1f} s")
    return list(entries.values()), sessions


def mcs_modes():
    """Phase 22's modes: (label, volume, environment, renderer kwargs) on
    config 2's volume; the f32 volume and the environment map are phase
    21's."""
    from vpt_tpu_torch import Volume

    vol = Volume.sphere_in_cube(VOLUME)
    f32 = Volume(density=smoothed(np.random.default_rng(13).random(vol.shape, np.float32)))
    return (("u8", vol, None, {}), ("f32", f32, None, {}),
            ("quasicubic", Volume(vol.density, "quasicubic"), None, {}),
            ("nearest", Volume(vol.density, "nearest"), None, {}),
            ("environment", vol, seeded_envmap(), {}),
            ("majorant", vol, None, dict(majorant_blocks=MCS_BLOCKS)),
            ("max_collisions=16", vol, None, dict(max_collisions=16)))


def mcs_camera():
    """Config 2's frustum-filling camera for MCS."""
    from vpt_tpu_torch import Camera

    return Camera(translation=np.array([0.0, 0.0, 1.2]))


def mcs_inputs(r, seeds):
    """The ctx of ``seeds[0]`` and the host's scattering directions."""
    from vpt_tpu_torch.models.mcs import _host_scatter_direction

    return r.ctx(mcs_camera(), seeds[0]), np.stack([_host_scatter_direction(s) for s in seeds])


def mcs_check(label, r, seeds, acc0, frame0):
    """K22 (two runs) and its plain version over ``seeds`` from (acc0,
    frame0): acc bit for bit and the frame count equal. Returns the kernel's
    (acc, frame) and the plain version's seconds."""
    from vpt_tpu_torch.kernels import mcs as KS

    ctx, dirs = mcs_inputs(r, seeds)
    out = []
    for fn in (KS.frames, KS.frames, KS.frames_plain):
        acc, frame = acc0.clone(), frame0.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(acc, frame, ctx, seeds, dirs, r.max_collisions, r.volume.filter)
        torch.cuda.synchronize()
        out.append((acc, frame, time.perf_counter() - t0))
    for (acc, frame, _), what in ((out[1], "a second run"), (out[2], "the plain version")):
        if int(frame) != int(out[0][1]) or int(frame) != int(frame0) + len(seeds):
            raise AssertionError(f"K22 ({label}): frame {int(out[0][1])}, {what} {int(frame)}")
        rm_bitwise(f"K22 ({label}) against {what}", [out[0][0]], [acc])
    if not bool(torch.isfinite(out[0][0]).all()):
        raise AssertionError(f"K22 ({label}): acc not finite")
    return out[0][0], out[0][1], out[2][2]


def mcs_device_ms(r, ctx, seeds, dirs):
    """K22's device time for one launch over ``seeds``: the kernel alone,
    launched through the library with its inputs uploaded once, 20 calls
    captured in a CUDA graph (``device_ms``); each call runs the same frames
    (the count is not advanced), so each does the same work."""
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import mcs as KS

    dev = r.device
    f, i = KS._params(ctx, RES, len(seeds), r.max_collisions, r.volume.filter)
    inputs = torch.as_tensor(KS._frame_inputs(seeds, dirs), device=dev)
    acc = torch.zeros((RES, RES, 4), dtype=torch.float32, device=dev)
    frame = torch.zeros((), dtype=torch.int32, device=dev)
    vol, lib = KS.RK._volume_tensor(ctx.density), _build.load()

    def launch():
        K._raise_on(lib.vpt_mcs_frames(
            f.ctypes.data, i.ctypes.data, vol.data_ptr(), ctx.tf_table.data_ptr(),
            ctx.environment.data_ptr(), K._ptr(ctx.majorant), inputs.data_ptr(), acc.data_ptr(),
            frame.data_ptr(), K._stream(dev)), "mcs_frames")

    return device_ms(launch)


def touch_env_texels(env, touched, dx, dy, dz, mask):
    """Mark in ``touched`` (He * We bools) the texels of the raw (He, We, 3)
    map that an equirect lookup in direction d reads where ``mask``."""
    from vpt_tpu_torch.kernels import mcm as KM
    from vpt_tpu_torch.ops import interp

    He, We, _ = env.shape
    u = torch.atan2(dx, -dz) * KM.INV_PI_HALF + 0.5
    v = torch.asin(torch.clamp(-dy, -1.0, 1.0)) * 2.0 * KM.INV_PI_HALF + 0.5
    for iy in interp._coords(v, He)[:2]:
        for ix in interp._coords(u, We)[:2]:
            touched[(iy * We + ix)[mask].to(torch.int64)] = True


def majorant_cells(maj, x, y, z):
    """The flat index of the (Gz, Gy, Gx, 2) majorant grid's cell at
    normalized (x, y, z), as ``_majorant_lookup`` addresses it."""
    from vpt_tpu_torch.ops import interp

    Gz, Gy, Gx, _ = maj.shape
    return ((interp._nearest_coords(z, Gz) * Gy + interp._nearest_coords(y, Gy)) * Gx
            + interp._nearest_coords(x, Gx)).to(torch.int64)


def mcs_replay(r, ctx, seeds, dirs):
    """K22's work over one launch from a zero state, replayed with the plain
    pieces (kernels/mcs.py) on the lanes and trips the kernel takes: per
    lane and frame the trips of both loops (a pixel whose ray misses the
    cube runs neither), each loop's lookups (a trip that neither escaped
    nor was capped; ``RmReads``, with a collision's diffuse: each volume
    entry touched once), the majorant trips whose starting point no earlier
    trip computed, the majorant cells and environment texels touched, the
    collisions shaded and those whose last distance trip computed no point.
    Returns the replay's acc (the caller holds it against the plain
    version's, bit for bit), the counts and the trips (F, R, R) of each
    loop."""
    from vpt_tpu_torch.kernels import mcm as KM
    from vpt_tpu_torch.kernels import mcs as KS
    from vpt_tpu_torch.kernels import raymarch as RK
    from vpt_tpu_torch.ops import geometry, sampling

    dev, filt, maj = r.device, r.volume.filter, ctx.majorant
    frm, to = RK.camera_rays(RES, ctx.inv_mvp, dev)
    tn, tf, miss = RK.ray_bounds(frm, to)
    entry, exit_ = RK._mix3(frm, to, tn), RK._mix3(frm, to, tf)
    view = geometry.normalize3(*(to[k] - frm[k] for k in range(3)))
    reads = RmReads(ctx.density, filt)
    env = ctx.environment
    He, We, _ = env.shape
    env_touched = torch.zeros(He * We, dtype=torch.bool, device=dev)
    maj_touched = None if maj is None else torch.zeros(maj[..., 0].numel(), dtype=torch.bool,
                                                       device=dev)

    def touch_env(dx, dy, dz, mask):
        touch_env_texels(env, env_touched, dx, dy, dz, mask)

    count = dict(distance_lookups=0, transmittance_lookups=0, majorant_points=0)

    def loop(c, rng, lanes, a, b, distance):
        max_dist = KS._length(a, b)
        denom = torch.clamp_min(max_dist, 1e-30)
        dist, trans = torch.zeros_like(max_dist), torch.ones_like(max_dist)
        done, trips = ~lanes, torch.zeros(max_dist.shape, dtype=torch.int32, device=dev)
        # the point at the lane's distance is known (the entry, or the last
        # trip's lookup); the last trip looked up
        known, looked = torch.ones_like(done), torch.zeros_like(done)
        for _ in range(r.max_collisions):
            if bool(done.all()):
                break
            active = ~done
            if maj is not None:
                count["majorant_points"] += int((active & ~known).sum())
                maj_touched[majorant_cells(maj, *RK._mix3(a, b, dist / denom))[active]] = True
            rng, step, capped, m = KS._flight(rng, active, c, a, b, dist, denom)
            dist = torch.where(active, dist + step, dist)
            escaped = active & (dist > max_dist)
            still = active & ~escaped & ~capped
            pos = RK._mix3(a, b, dist / denom)
            reads.add(*pos, still)
            count["distance_lookups" if distance else "transmittance_lookups"] += int(still.sum())
            known = torch.where(active, still, known)
            looked = torch.where(active, still, looked)
            alpha = KS._sample_tf(c, *pos, filt)[..., 3]
            if m is not None:
                alpha = torch.clamp_max(alpha / m, 1.0)
            trips += active.to(torch.int32)
            if distance:
                rng, u = sampling.draw(rng, still)
                done = done | escaped | (still & (u < alpha))
            else:
                trans = torch.where(still, trans * (1.0 - alpha), trans)
                done = done | escaped
        return rng, dist, max_dist, trans, trips, looked

    touch_env(*view, torch.ones_like(miss))  # every pixel's view, once a launch
    env_view = KS._with_alpha(KM.sample_environment(env, *view))
    acc = torch.zeros((RES, RES, 4), dtype=torch.float32, device=dev)
    d_trips, t_trips, shaded, fresh = [], [], 0, 0
    for k, (seed, sd) in enumerate(zip(seeds, dirs)):
        c = dataclasses.replace(ctx, seed_bits=int(seed), scatter_dir=sd)
        rng = KS.pixel_seeds(RES, c.seed_bits, dev)
        rng, dist, max_dist, _, dt, looked = loop(c, rng, ~miss, entry, exit_, True)
        escaped = dist > max_dist
        scat = RK._mix3(entry, exit_, dist / torch.clamp_min(max_dist, 1e-30))
        sdt = torch.as_tensor(sd, device=dev)
        sdir = tuple(sdt[i].expand(dist.shape) for i in range(3))
        stf = torch.clamp_min(geometry.intersect_cube(*scat, *sdir)[1], 0.0)
        need = ~miss & ~escaped
        reads.add(*scat, need)
        diffuse = KS._sample_tf(c, *scat, filt)
        touch_env(sdt[0:1], sdt[1:2], sdt[2:3], torch.ones(1, dtype=torch.bool, device=dev))
        light = KS._with_alpha(KM.sample_environment(env, sdt[0], sdt[1], sdt[2]))
        rng, _, _, trans, tt, _ = loop(c, rng, need, scat,
                                    tuple(scat[i] + sdir[i] * stf for i in range(3)), False)
        img = torch.where((miss | escaped)[..., None], env_view, diffuse * light * trans[..., None])
        acc = acc + (img - acc) / torch.full((), k + 1.0, dtype=torch.float32, device=dev)
        d_trips.append(dt)
        t_trips.append(tt)
        shaded += int(need.sum())
        fresh += int((need & ~looked).sum())
    n = dict(**count, shaded=shaded, fresh_diffuse=fresh, hit_pixels=int((~miss).sum()),
             trip_count=int(sum(int(t.sum()) for t in d_trips + t_trips)),
             env_bytes=int(env_touched.sum()) * 12,
             majorant_bytes=0 if maj is None else int(maj_touched.sum()) * 8)
    return acc, n, reads, torch.stack(d_trips), torch.stack(t_trips), ~miss


def mcs_trip_stats(d_trips, t_trips, hit):
    """The trips per lane and frame (both loops) over the pixels whose ray
    hits the cube (mean, p99, max), and per launch: a lane's mean total;
    the mean over warps of what a warp pays, with per-frame loops the sum
    over frames of each loop's slowest lane in the warp, with one stream of
    trips a lane its slowest lane's total trips over the launch (the
    stream's waits for turns come on top), each for warps of 32
    neighbouring pixels of a row and of 8 x 4 pixel tiles
    (``kernels.mcs.warp_tiles``, K22's layout: per-frame loops over tiles);
    and what the reference's lockstep loops pay, the sum over frames of
    each loop's slowest lane in the frame."""
    from vpt_tpu_torch.kernels import mcs as KS

    tr = (d_trips + t_trips)[:, hit].to(torch.float32).reshape(-1)
    warp = lambda t: t.reshape(t.shape[0], -1, 32).amax(-1).to(torch.float64)  # noqa: E731
    tiles = KS.warp_tiles(d_trips.shape[-1], d_trips.device)

    def tile(t):  # (..., R, R) -> (..., warps): each 8 x 4 tile's slowest lane
        flat = t.reshape(*t.shape[:-2], -1).to(torch.float64)
        return torch.where(tiles >= 0, flat[..., tiles.clamp_min(0)], 0.0).amax(-1)

    total = (d_trips + t_trips).sum(0).to(torch.float64)
    return dict(lane_frame_mean=float(tr.mean()),
                lane_frame_p99=float(torch.quantile(tr, 0.99)), lane_frame_max=int(tr.max()),
                distance_mean=float(d_trips[:, hit].to(torch.float32).mean()),
                transmittance_mean=float(t_trips[:, hit].to(torch.float32).mean()),
                launch_lane_mean=float((d_trips + t_trips).sum(0)[hit].to(torch.float32).mean()),
                launch_warp_paid=float((warp(d_trips) + warp(t_trips)).sum(0).mean()),
                launch_tile_loops_paid=float((tile(d_trips) + tile(t_trips)).sum(0).mean()),
                launch_stream_paid=float(total.reshape(-1, 32).amax(-1).mean()),
                launch_tile_paid=float(tile(total).mean()),
                launch_frame_paid=int((d_trips.reshape(d_trips.shape[0], -1).amax(-1)
                                       + t_trips.reshape(t_trips.shape[0], -1).amax(-1)).sum()))


def mcs_bound(r, ctx, n, reads, n_frames, ms):
    """``bound`` of K22 over one launch: acc read and written once, the
    count and the frame inputs, each volume entry, majorant cell and
    environment texel the replayed lookups touch once, the TF's row 0; the
    operations the replayed launch needs (``OPS_MCS_*``)."""
    maj = ctx.majorant is not None
    lookups = n["distance_lookups"] + n["transmittance_lookups"]
    tf_row = ctx.tf_table[0].numel() * 4 if lookups else 0
    nbytes = (2 * RES * RES * 16 + 4 + 16 * n_frames + reads.volume_bytes() + tf_row
              + n["env_bytes"] + n["majorant_bytes"])
    ops = (RES * RES * (OPS_MCS_PIXEL + n_frames * OPS_MCS_FRAME) + n_frames * OPS_MCS_LIGHT
           + n["trip_count"] * (OPS_MCS_TRIP + OPS_MCS_TRIP_MAJ * maj)
           + n["majorant_points"] * OPS_MCS_POINT
           + lookups * (OPS_MCS_POINT + OPS_MCS_LOOKUP + 2 * maj)
           + n["distance_lookups"] * OPS_MCS_ACCEPT + n["transmittance_lookups"] * OPS_MCS_PRODUCT
           + n["shaded"] * OPS_MCS_SHADE + n["fresh_diffuse"] * OPS_MCS_FRESH)
    return bound(nbytes, ops, ms)


def all_launches():
    """Every kernel launch count of the port, as module.key."""
    from vpt_tpu_torch.kernels import corners, dos, lao, mcm, mcm_spectral, mcs, raymarch, slab
    from vpt_tpu_torch.kernels import spectral_backward, surrogate

    return {f"{m.__name__.rsplit('.', 1)[1]}.{k}": v
            for m in (corners, dos, lao, mcm, mcm_spectral, mcs, raymarch, spectral_backward,
                      surrogate, slab)
            for k, v in m.LAUNCHES.items()}


def reset_all_counts():
    from vpt_tpu_torch.kernels import corners, dos, lao, mcm, mcm_spectral, mcs, raymarch, slab
    from vpt_tpu_torch.kernels import spectral_backward, surrogate

    for m in (corners, dos, lao, mcm, mcm_spectral, mcs, raymarch, spectral_backward, surrogate,
              slab):
        m.reset_launch_counts()


def mcs_make_session(dev, vol, env, kw):
    """RenderSession("mcs") on the MCS scene, warmed up by one frame."""
    from vpt_tpu_torch.session import RenderSession

    s = RenderSession("mcs", vol, None, env, extinction=MCS_EXTINCTION, resolution=RES,
                      camera=mcs_camera(), device=dev, **kw)
    s.run(1)
    return s


def mcs_session(s, frames, checkpoint_at=None, tmp=None):
    """The counts set to 0, then ``s.reset()`` and ``s.run(frames)``, split
    at ``checkpoint_at`` by a save, a reset and a load; returns (every
    launch count, HDR image, seconds)."""
    reset_all_counts()
    t0 = time.perf_counter()
    s.reset()
    if checkpoint_at is None:
        s.run(frames)
    else:
        s.run(checkpoint_at)
        path = os.path.join(tmp, "mcs.npz")
        s.save_checkpoint(path)
        s.reset()
        s.load_checkpoint(path).run(frames - checkpoint_at)
    dt = time.perf_counter() - t0
    return all_launches(), s.hdr_image(), dt


class McsProfile:
    """``rm_profile`` of 4 x the default ``RenderSession("mcs").run(16)`` on
    the MCS scene (with ``kw``, a source text of further renderer keywords),
    in a fresh process (as phase 21's), started early so
    that its start-up overlaps the phase's checks: it warms up, says
    "ready" and waits; ``ready()`` waits for that, after which the process
    holds the card idle until ``finish()`` lets it profile. ``close()``
    ends it whatever happened."""

    def __init__(self, kw=""):
        code = ("import json, sys, torch, chip_smoke as CS\n"
                "def ready():\n"
                "    print('ready', flush=True)\n"
                "    sys.stdin.readline()\n"
                "print(json.dumps(CS.rm_profile('mcs', torch.device('cuda:0'), CS.MCS_FRAMES, "
                f"calls=4, ready=ready, extinction=CS.MCS_EXTINCTION, camera=CS.mcs_camera(){kw})))")
        self.err = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen([sys.executable, "-c", code], stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=self.err, text=True,
                                     cwd=os.path.dirname(os.path.abspath(__file__)))

    def _fail(self, what):
        self.err.seek(0)
        raise AssertionError(f"the mcs profile {what}: {self.err.read()[-2000:]}")

    def ready(self):
        if not select.select([self.proc.stdout], [], [], 300)[0]:
            self._fail("was not ready within 300 s")
        if self.proc.stdout.readline().strip() != "ready":
            self._fail(f"exited {self.proc.wait()} before it was ready")

    def finish(self):
        out, _ = self.proc.communicate("go\n", timeout=300)
        if self.proc.returncode != 0:
            self._fail(f"exited {self.proc.returncode}")
        return json.loads(out.strip().splitlines()[-1])

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.err.close()


def phase_mcs(dev):
    """Phase 22: the single-scattering renderer MCS (K22 mcs_frames) on
    config 2's MCS scene at R = 512, in two passes over the modes. Checks:
    K22 bit for bit against its plain version over 2 frames in seven modes
    and over the main scene's 16-frame launch, exact and majorant, with a
    replay of that launch's work (its trip distribution). Then, once the
    profiling process (started first) waits: each launch timed by device
    time, the 16-frame ones against the replay's bound; a RenderSession
    per mode (exactly one K22 launch and nothing else), whose renderer the
    checks used; the default's second run, checkpoint round trip and
    profiled busy share. The phase's seconds by step close it."""
    from vpt_tpu_torch.kernels import mcs as KS

    t_phase = time.perf_counter()
    split = {}

    def timed(step, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        split[step] = split.get(step, 0.0) + time.perf_counter() - t0
        return out

    seeds2 = [2654435761 * k % 2**32 for k in (3, 4)]
    frames = [(k + 1) * 2654435761 % 2**32 for k in range(MCS_FRAMES)]
    rng = np.random.default_rng(22)
    acc0 = torch.as_tensor(rng.random((RES, RES, 4), np.float32), device=dev)
    frame0 = torch.full((), 3, dtype=torch.int32, device=dev)
    zero_acc = torch.zeros((RES, RES, 4), dtype=torch.float32, device=dev)
    zero_frame = torch.zeros((), dtype=torch.int32, device=dev)
    entries, sessions, trips, runs = {}, {}, {}, []
    profiler = McsProfile()
    try:
        for label, vol, env, kw in mcs_modes():
            s = timed("sessions built", mcs_make_session, dev, vol, env, kw)
            r = s.renderer
            timed("2-frame checks", mcs_check, label, r, seeds2, acc0, frame0)
            ctx, dirs = mcs_inputs(r, frames)
            log(f"# K22 ({label}) == plain bit for bit over 2 frames from a running mean at frame "
                "3 (acc and the count), two runs identical")
            replay = None
            if label in ("u8", "majorant"):
                # the main scene's 16-frame launch from a zero state: kernel
                # == plain == the replay
                acc, _, plain_s = timed(f"{MCS_FRAMES}-frame checks", mcs_check,
                                        f"{label}, {MCS_FRAMES} frames", r, frames, zero_acc,
                                        zero_frame)
                racc, n, reads, d_trips, t_trips, hit = timed("replays", mcs_replay, r, ctx,
                                                              frames, dirs)
                rm_bitwise(f"the replay of K22 ({label})", [acc], [racc])
                stats = mcs_trip_stats(d_trips, t_trips, hit)
                trips[label] = stats
                replay = (plain_s, n, reads, stats)
                log(f"# K22 ({label}) == plain == the replay bit for bit over the main scene's "
                    f"{MCS_FRAMES}-frame launch, plain {plain_s * 1e3:.1f} ms; "
                    f"{n['trip_count']} trips, {n['distance_lookups']} + "
                    f"{n['transmittance_lookups']} lookups (distance + transmittance), "
                    f"{n['majorant_points']} majorant points, {n['shaded']} shaded "
                    f"({n['fresh_diffuse']} after a capped trip)")
                log(f"# K22 ({label}) trips per lane and frame over the {int(hit.sum())} hit "
                    f"pixels: mean {stats['lane_frame_mean']:.3f} (distance "
                    f"{stats['distance_mean']:.3f}, transmittance "
                    f"{stats['transmittance_mean']:.3f}), p99 {stats['lane_frame_p99']:.1f}, max "
                    f"{stats['lane_frame_max']}; per launch a lane {stats['launch_lane_mean']:.2f},"
                    f" a warp pays with per-frame loops {stats['launch_warp_paid']:.2f} over a row,"
                    f" {stats['launch_tile_loops_paid']:.2f} over an 8 x 4 tile (K22), with one "
                    f"stream of trips {stats['launch_stream_paid']:.2f} over a row, "
                    f"{stats['launch_tile_paid']:.2f} over a tile; the reference's lockstep frames "
                    f"{stats['launch_frame_paid']}")
                del acc, racc, d_trips, t_trips
            runs.append((label, s, ctx, dirs, replay))
            torch.cuda.empty_cache()
        # the timings, with the profiling process idle
        timed("waiting for the profiling process", profiler.ready)
        for label, s, ctx, dirs, replay in runs:
            r = s.renderer
            ms = timed("device timing", mcs_device_ms, r, ctx, frames, dirs)
            if replay is not None:
                plain_s, n, reads, stats = replay
                call_ms = timed("device timing", cuda_ms, lambda: KS.frames(
                    zero_acc.clone(), zero_frame.clone(), ctx, frames, dirs, r.max_collisions,
                    r.volume.filter), 10)
                b = mcs_bound(r, ctx, n, reads, MCS_FRAMES, ms)
                name = "mcs_frames" if label == "u8" else f"mcs_frames[{label}]"
                entries[name] = kernel_line(dict(
                    name=name, route="cuda", source=MCS_SOURCE,
                    replaces="vpt_tpu/models/mcs.py:174", max_abs_err=0.0, ms=ms,
                    plain_ms=plain_s * 1e3, frames=MCS_FRAMES, ms_per_frame=ms / MCS_FRAMES,
                    call_ms=call_ms, trips=stats,
                    **{k: v for k, v in n.items() if k not in ("env_bytes", "majorant_bytes")}),
                    b)
                log(f"# K22 ({label}): the main scene's {MCS_FRAMES}-frame launch {ms:.5f} ms by "
                    f"device time ({ms / MCS_FRAMES:.5f} a frame; the wrapper's call "
                    f"{call_ms:.5f} ms), plain {plain_s * 1e3:.1f} ms; bound "
                    f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({b['bound_bytes']} B, "
                    f"{b['bound_ops']} FP32 ops), share {b['bound_share']:.3f}")
            else:
                log(f"# K22 ({label}): a {MCS_FRAMES}-frame launch {ms:.5f} ms by device time")
            # the mode's session: one K22 launch per run and nothing else
            launches, img, dt = timed("sessions run", mcs_session, s, MCS_FRAMES)
            modes = {"nearest": ("mcs.frames_raw",), "environment": ("mcs.frames_environment",),
                     "majorant": ("mcs.frames_majorant",)}.get(label, ())
            want = {"mcs.frames": 1, **{k: 1 for k in modes}}
            got = {k: v for k, v in launches.items() if v}
            if got != want:
                raise AssertionError(f"RenderSession('mcs', {label}).run({MCS_FRAMES}) "
                                     f"launched {got}")
            if img.shape != (RES, RES, 3) or not np.isfinite(img).all() or not img.any():
                raise AssertionError(f"mcs {label}: image {img.shape} empty or not finite")
            sessions[label] = dict(launches=got, seconds=dt, frames_per_s=MCS_FRAMES / dt,
                                   k22_ms=ms)
            if replay is not None:
                entries["mcs_frames" if label == "u8" else "mcs_frames[majorant]"]["launches"] = (
                    launches["mcs.frames"])
            log(f"# RenderSession('mcs', {label}).run({MCS_FRAMES}) at {RES}^2: {dt:.5f} s "
                f"({MCS_FRAMES / dt:.1f} frames/s); launches {got}")
            if label == "u8":
                with tempfile.TemporaryDirectory() as tmp:
                    _, img2, _ = timed("sessions run", mcs_session, s, MCS_FRAMES)
                    _, img3, _ = timed("sessions run", mcs_session, s, MCS_FRAMES,
                                       checkpoint_at=MCS_FRAMES // 2, tmp=tmp)
                for other, what in ((img2, "a second run"), (img3, "a checkpoint round trip")):
                    if not np.array_equal(img.view(np.int32), other.view(np.int32)):
                        raise AssertionError(f"mcs: {what} differs from the first run")
                log("# mcs: a second run and a checkpoint round trip equal bit for bit")
        del runs, s
        torch.cuda.empty_cache()
        prof = timed("the profile", profiler.finish)
    finally:
        profiler.close()
    seen = sum(k["launches"] for n, k in prof["kernels"].items()
               if n.startswith("mcs_frames_kernel")) * MCS_FRAMES
    if seen != 1:
        raise AssertionError(f"mcs: the profiler saw {seen * 4:g} of 4 K22 launches")
    frame_ms = sessions["u8"]["seconds"] * 1e3 / MCS_FRAMES
    sessions["u8"].update(profile=prof, device_busy_share=prof["device_ms"] / frame_ms)
    log(f"# mcs: profiled 4 x run({MCS_FRAMES}) per frame (a fresh process): device "
        f"{prof['device_ms']:.5f} ms of {frame_ms:.5f} ms unprofiled (busy "
        f"{prof['device_ms'] / frame_ms:.3f}; profiled host {prof['profiled_host_ms']:.5f} ms); "
        + ", ".join(f"{k} {v['ms']:.5f} ms x{v['launches']:g}" for k, v in prof["kernels"].items()))
    total = time.perf_counter() - t_phase
    split["other"] = total - sum(split.values())
    log(f"# phase 22 (MCS): {total:.1f} s: " + ", ".join(f"{k} {v:.1f} s" for k, v in split.items()))
    return list(entries.values()), dict(sessions=sessions, trips=trips, seconds=split)


def mcsp_modes():
    """Phase 23's modes: phase 22's tables and majorant at 4 streams, and the
    u8 table at one stream."""
    modes = [m for m in mcs_modes() if m[0] != "max_collisions=16"]
    return modes + [("streams=1", modes[0][1], None, dict(streams=1))]


def mcsp_clone(state):
    return type(state)(*(t.clone() for t in state.tensors()))


def mcsp_seeds(first, n):
    return [(first + k) * 2654435761 % 2**32 for k in range(n)]


class McspCounts:
    """The work of one K23 launch, counted from its plain version's
    iterations (``kernels/mcs.py``'s ``observe`` hook): lane-steps,
    distance-phase lane-steps, lookups (a step that neither escaped nor was
    capped; ``RmReads``, each volume entry touched once) by phase, scatters,
    deposits by phase, and the environment texels (the view's of a lane
    that deposits it, the light's of a shadow-phase deposit) and majorant
    cells the launch touches."""

    def __init__(self, ctx, filt):
        self.ctx, self.reads = ctx, RmReads(ctx.density, filt)
        dev = ctx.tf_table.device
        self.n = {}
        He, We, _ = ctx.environment.shape
        self.env = torch.zeros(He * We, dtype=torch.bool, device=dev)
        self.maj = (None if ctx.majorant is None else
                    torch.zeros(ctx.majorant[..., 0].numel(), dtype=torch.bool, device=dev))
        self.view = None

    def add(self, key, mask):
        self.n[key] = self.n.get(key, 0) + mask.sum()

    def __call__(self, d):
        shadow, tent, esc, p = d["shadow"], d["tentative"], d["escaped"], d["p"]
        self.add("lane_steps", torch.ones_like(shadow))
        self.add("distance_steps", ~shadow)
        self.add("distance_lookups", tent & ~shadow)
        self.add("shadow_lookups", tent & shadow)
        self.add("scatters", d["scatter"])
        self.add("env_deposits", esc & ~shadow)
        self.add("shaded_deposits", esc & shadow)
        self.reads.add(*d["point"], tent)
        touch_env_texels(self.ctx.environment, self.env, p.sdx, p.sdy, p.sdz, esc & shadow)
        view = esc & ~shadow
        self.view = view if self.view is None else self.view | view
        if d["start"] is not None:
            self.maj[majorant_cells(self.ctx.majorant, *d["start"]).reshape(-1)] = True

    def totals(self, res):
        """The counts as ints, with the pixels whose lanes deposited the
        environment (``view_pixels``) and their view texels, and the touched
        bytes."""
        from vpt_tpu_torch.kernels import raymarch as RK
        from vpt_tpu_torch.ops import geometry

        out = {k: int(v) for k, v in self.n.items()}
        frm, to = RK.camera_rays(res, self.ctx.inv_mvp, self.env.device)
        used = self.view.reshape(-1, res, res).any(0)
        out["view_pixels"] = int(used.sum())
        touch_env_texels(self.ctx.environment, self.env,
                         *geometry.normalize3(*(to[k] - frm[k] for k in range(3))), used)
        out["lookups"] = out["distance_lookups"] + out["shadow_lookups"]
        out["deposits"] = out["env_deposits"] + out["shaded_deposits"]
        out["env_bytes"] = int(self.env.sum()) * 12
        out["majorant_bytes"] = 0 if self.maj is None else int(self.maj.sum()) * 8
        out["volume_bytes"] = self.reads.volume_bytes()
        return out


def mcsp_bound(ctx, n, lanes, n_seeds, ms):
    """``bound`` of K23 over one launch: the state read and written once, the
    seeds, each volume entry, majorant cell and environment texel the
    launch's lookups touch once, the TF's row 0; the operations the
    launch's counted work needs (``OPS_MCSP_*``)."""
    maj = ctx.majorant is not None
    tf_row = ctx.tf_table[0].numel() * 4 if n["lookups"] else 0
    nbytes = (2 * lanes * MCSP_LANE_BYTES + 4 * n_seeds + n["volume_bytes"] + tf_row
              + n["env_bytes"] + n["majorant_bytes"])
    ops = (RES * RES * OPS_MCSP_PIXEL + n["view_pixels"] * OPS_MCSP_VIEW + lanes * OPS_MCSP_LANE
           + n["lane_steps"] * (OPS_MCSP_STEP + OPS_MCSP_MAJ * maj)
           + n["lookups"] * (OPS_MCSP_LOOKUP + maj)
           + n["distance_lookups"] * OPS_MCSP_ACCEPT + n["shadow_lookups"] * OPS_MCSP_PRODUCT
           + n["scatters"] * OPS_MCSP_SCATTER + n["deposits"] * OPS_MCSP_DEPOSIT
           + n["shaded_deposits"] * OPS_MCSP_SHADE)
    return bound(nbytes, ops, ms)


def mcsp_check(label, r, state0, seeds):
    """K23 (two launches) and its plain version over ``seeds`` from
    ``state0``, then the plain version again with the work counted
    (``McspCounts``): all four states equal on every field bit for bit.
    Returns (the kernel's state, the plain version's seconds, the counts)."""
    from vpt_tpu_torch.kernels import mcs as KS

    ctx = r.ctx(mcs_camera(), seeds[0])
    counts = McspCounts(ctx, r.volume.filter)
    out = []
    for fn, kw in ((KS.persistent, {}), (KS.persistent, {}), (KS.persistent_plain, {}),
                   (KS.persistent_plain, dict(observe=counts))):
        st = mcsp_clone(state0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(st, ctx, seeds, r.steps, r.volume.filter, r.streams, **kw)
        torch.cuda.synchronize()
        out.append((st, time.perf_counter() - t0))
    for (st, _), what in ((out[1], "a second launch"), (out[2], "the plain version"),
                          (out[3], "the counted plain version")):
        bad = [k for k in KS.PERSISTENT_FIELDS
               if not torch.equal(getattr(out[0][0], k).view(torch.uint8),
                                  getattr(st, k).view(torch.uint8))]
        if bad:
            a, b = getattr(out[0][0], bad[0]), getattr(st, bad[0])
            lanes = (a != b).reshape(a.shape[:state0.dist.ndim] + (-1,)).any(-1)
            raise AssertionError(f"K23 ({label}) differs from {what} in {bad}: "
                                 f"{int(lanes.sum())} lanes of {bad[0]}, the first "
                                 f"{[int(i) for i in lanes.nonzero()[0]]}")
    st = out[0][0]
    if not bool(torch.isfinite(st.acc).all()) or int(st.samples.sum()) <= int(state0.samples.sum()):
        raise AssertionError(f"K23 ({label}): acc not finite or no sample deposited")
    return st, out[2][1], counts.totals(RES)


def mcsp_device_ms(r, state0, seeds):
    """K23's device time for one launch over ``seeds`` from ``state0``: 20
    calls of (copy ``state0`` into a working state, launch) captured in a
    CUDA graph (``device_ms``), less 20 copies alone; the launch goes
    through the library with its inputs uploaded once, so each call does
    the same work."""
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import mcs as KS

    dev = r.device
    ctx = r.ctx(mcs_camera(), seeds[0])
    f, i = KS._params(ctx, RES, len(seeds), 0, r.volume.filter, r.steps, r.streams)
    seeds_dev = torch.as_tensor(np.asarray(seeds, np.uint32).view(np.int32), device=dev)
    work = mcsp_clone(state0)
    vol, lib = KS.RK._volume_tensor(ctx.density), _build.load()

    def copy():
        for a, b in zip(work.tensors(), state0.tensors()):
            a.copy_(b)

    def launch():
        copy()
        K._raise_on(lib.vpt_mcs_persistent(
            f.ctypes.data, i.ctypes.data, vol.data_ptr(), ctx.tf_table.data_ptr(),
            ctx.environment.data_ptr(), K._ptr(ctx.majorant), seeds_dev.data_ptr(),
            *(getattr(work, k).data_ptr() for k in KS.PERSISTENT_FIELDS),
            K._stream(dev)), "mcs_persistent")

    return device_ms(launch) - device_ms(copy)


def phase_mcs_persistent(dev):
    """Phase 23: MCS's persistent lanes (K23 mcs_persistent) on phase 22's
    scene at 512^2 x 4 streams, 8 steps. Checks: K23 bit for bit against
    its plain version (two launches, all 16 fields) over 2 dispatches from a
    mid-flight state in each mode (u8, f32, quasicubic, nearest, the
    environment map, majorant_blocks=8, one stream) and over the main
    scene's 16-dispatch launch from a warm state, exact and majorant. Then,
    once the profiling process (started first) waits: each launch timed by
    device time against the bound of its counted work, K22's 16-frame
    launch on the same tables beside it (paths/s against deposits/s); a
    persistent RenderSession per mode, reset() and run(16) with the counts
    set to 0 before (one K23 launch and nothing else of the port's
    kernels); on the default a second run and a checkpoint round trip bit
    for bit and four run(16) calls profiled in a fresh process (the device
    busy share). The phase's seconds by step close it."""
    from vpt_tpu_torch.kernels import mcs as KS

    t_phase = time.perf_counter()
    split = {}

    def timed(step, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        split[step] = split.get(step, 0.0) + time.perf_counter() - t0
        return out

    kw_p = dict(persistent=True, steps=MCSP_STEPS, streams=MCSP_STREAMS)
    entries, sessions, launches_ = {}, {}, []
    profiler = McsProfile(", persistent=True, steps=CS.MCSP_STEPS, streams=CS.MCSP_STREAMS")
    try:
        for label, vol, env, kw in mcsp_modes():
            s = timed("sessions built", mcs_make_session, dev, vol, env, {**kw_p, **kw})
            r = s.renderer
            # a mid-flight state: two dispatches from the reset state
            mid = r.reset(None)
            KS.persistent(mid, r.ctx(mcs_camera(), 1), mcsp_seeds(1, 2), r.steps,
                          r.volume.filter, r.streams)
            seeds2 = mcsp_seeds(3, 2)
            _, plain2_s, n2 = timed("2-dispatch checks", mcsp_check, label, r, mid, seeds2)
            log(f"# K23 ({label}) == plain on all 16 fields bit for bit over 2 dispatches from a "
                f"mid-flight state ({100 * float(mid.phase.float().mean()):.1f}% in the shadow "
                "phase), two launches identical")
            main = None
            if label in ("u8", "majorant"):
                # config 2's launch: 16 dispatches from a warm state (16 in)
                warm = r.reset(None)
                KS.persistent(warm, r.ctx(mcs_camera(), 1), mcsp_seeds(1, MCSP_DISPATCHES),
                              r.steps, r.volume.filter, r.streams)
                seeds16 = mcsp_seeds(1 + MCSP_DISPATCHES, MCSP_DISPATCHES)
                _, plain_s, n = timed(f"{MCSP_DISPATCHES}-dispatch checks", mcsp_check,
                                      f"{label}, {MCSP_DISPATCHES} dispatches", r, warm, seeds16)
                main = (warm, seeds16, plain_s, n)
                log(f"# K23 ({label}) == plain bit for bit over the main scene's "
                    f"{MCSP_DISPATCHES}-dispatch launch, plain {plain_s * 1e3:.1f} ms; "
                    f"{n['lane_steps']} lane-steps ({n['distance_steps']} in the distance phase), "
                    f"{n['distance_lookups']} + {n['shadow_lookups']} lookups (distance + shadow), "
                    f"{n['scatters']} scatters, {n['env_deposits']} + {n['shaded_deposits']} "
                    f"deposits (environment + shaded): {n['lane_steps'] / n['deposits']:.3f} "
                    "steps a deposit")
            launches_.append((label, s, mid, seeds2, plain2_s, n2, main))
            torch.cuda.empty_cache()
        timed("waiting for the profiling process", profiler.ready)
        k22 = {}
        for label, s, mid, seeds2, plain2_s, n2, main in launches_:
            r = s.renderer
            lanes = mid.dist.numel()
            name = "mcs_persistent" if label == "u8" else f"mcs_persistent[{label}]"
            ms2 = timed("device timing", mcsp_device_ms, r, mid, seeds2)
            if main is None:
                b = mcsp_bound(r.ctx(mcs_camera(), seeds2[0]), n2, lanes, 2, ms2)
                entries[name] = kernel_line(dict(
                    name=name, route="cuda", source=MCS_SOURCE,
                    replaces="vpt_tpu/models/mcs.py:473", max_abs_err=0.0, ms=ms2,
                    plain_ms=plain2_s * 1e3, dispatches=2, steps=r.steps, streams=r.streams,
                    counts={k: v for k, v in n2.items() if not k.endswith("_bytes")}), b)
                log(f"# K23 ({label}): a 2-dispatch launch {ms2:.5f} ms by device time, plain "
                    f"{plain2_s * 1e3:.1f} ms; bound {b['bound_ms']:.5f} ms by {b['bound_by']} "
                    f"({b['bound_bytes']} B, {b['bound_ops']} FP32 ops), share "
                    f"{b['bound_share']:.3f}")
            else:
                warm, seeds16, plain_s, n = main
                ms = timed("device timing", mcsp_device_ms, r, warm, seeds16)
                ctx22, dirs = mcs_inputs(r, mcsp_seeds(1, MCS_FRAMES))
                k22_ms = timed("device timing", mcs_device_ms, r, ctx22, mcsp_seeds(1, MCS_FRAMES),
                               dirs)
                b = mcsp_bound(r.ctx(mcs_camera(), seeds16[0]), n, lanes, MCSP_DISPATCHES, ms)
                rates = dict(lane_steps_per_s=n["lane_steps"] / ms * 1e3,
                             deposits_per_s=n["deposits"] / ms * 1e3,
                             steps_per_deposit=n["lane_steps"] / n["deposits"],
                             k22_ms=k22_ms, k22_paths_per_s=RES * RES * MCS_FRAMES / k22_ms * 1e3)
                rates["deposits_over_k22_paths"] = (rates["deposits_per_s"]
                                                    / rates["k22_paths_per_s"])
                k22[label] = rates
                entries[name] = kernel_line(dict(
                    name=name, route="cuda", source=MCS_SOURCE,
                    replaces="vpt_tpu/models/mcs.py:473", max_abs_err=0.0, ms=ms,
                    plain_ms=plain_s * 1e3, dispatches=MCSP_DISPATCHES, steps=r.steps,
                    streams=r.streams, two_dispatch_ms=ms2, two_dispatch_plain_ms=plain2_s * 1e3,
                    counts={k: v for k, v in n.items() if not k.endswith("_bytes")}, **rates), b)
                log(f"# K23 ({label}): the main scene's {MCSP_DISPATCHES}-dispatch launch "
                    f"{ms:.5f} ms by device time (2 dispatches {ms2:.5f}), plain "
                    f"{plain_s * 1e3:.1f} ms; bound {b['bound_ms']:.5f} ms by {b['bound_by']} "
                    f"({b['bound_bytes']} B, {b['bound_ops']} FP32 ops), share "
                    f"{b['bound_share']:.3f}; {rates['lane_steps_per_s'] / 1e9:.3f} G lane-steps/s,"
                    f" {rates['deposits_per_s'] / 1e9:.4f} G deposits/s, "
                    f"{rates['steps_per_deposit']:.3f} steps a deposit; K22's {MCS_FRAMES}-frame "
                    f"launch on the same tables {k22_ms:.5f} ms, "
                    f"{rates['k22_paths_per_s'] / 1e9:.4f} G paths/s: deposits/s over paths/s "
                    f"{rates['deposits_over_k22_paths']:.3f}")
            # the mode's session: one K23 launch per run and nothing else
            launches, img, dt = timed("sessions run", mcs_session, s, MCS_FRAMES)
            deposited = int(s.state.samples.sum())
            modes = {"nearest": ("mcs.persistent_raw",),
                     "environment": ("mcs.persistent_environment",),
                     "majorant": ("mcs.persistent_majorant",)}.get(label, ())
            want = {"mcs.persistent": 1, **{k: 1 for k in modes}}
            if r.streams > 1:
                want["mcs.persistent_streams"] = 1
            got = {k: v for k, v in launches.items() if v}
            if got != want:
                raise AssertionError(f"RenderSession('mcs', {label}, persistent).run({MCS_FRAMES})"
                                     f" launched {got}")
            if img.shape != (RES, RES, 3) or not np.isfinite(img).all() or not img.any():
                raise AssertionError(f"mcs persistent {label}: image {img.shape} empty or not "
                                     "finite")
            entries[name]["launches"] = launches["mcs.persistent"]
            sessions[label] = dict(launches=got, seconds=dt, dispatches_per_s=MCS_FRAMES / dt,
                                   deposits=deposited, deposits_per_s=deposited / dt)
            log(f"# RenderSession('mcs', {label}, persistent=True, steps={r.steps}, "
                f"streams={r.streams}).run({MCS_FRAMES}) at {RES}^2: {dt:.5f} s, {deposited} "
                f"deposits ({deposited / dt / 1e9:.4f} G/s); launches {got}")
            if label == "u8":
                with tempfile.TemporaryDirectory() as tmp:
                    _, img2, dt2 = timed("sessions run", mcs_session, s, MCS_FRAMES)
                    _, img3, _ = timed("sessions run", mcs_session, s, MCS_FRAMES,
                                       checkpoint_at=MCS_FRAMES // 2, tmp=tmp)
                for other, what in ((img2, "a second run"), (img3, "a checkpoint round trip")):
                    if not np.array_equal(img.view(np.int32), other.view(np.int32)):
                        raise AssertionError(f"mcs persistent: {what} differs from the first run")
                sessions[label]["second_run_seconds"] = dt2
                log(f"# mcs persistent: a second run ({dt2:.5f} s) and a checkpoint round trip "
                    "equal bit for bit")
        del launches_, s
        torch.cuda.empty_cache()
        prof = timed("the profile", profiler.finish)
    finally:
        profiler.close()
    seen = sum(k["launches"] for n, k in prof["kernels"].items()
               if n.startswith("mcs_persistent_kernel")) * MCS_FRAMES
    if seen != 1:
        raise AssertionError(f"mcs persistent: the profiler saw {seen * 4:g} of 4 K23 launches")
    # the device's share and the host's wait of the session's first and second
    # run(16): the first has read slower than the next (PERF.md, question 12)
    dev_ms = prof["device_ms"] * MCS_FRAMES
    runs = {which: dict(ms=sessions["u8"][key] * 1e3,
                        busy=dev_ms / (sessions["u8"][key] * 1e3),
                        host_wait_ms=sessions["u8"][key] * 1e3 - dev_ms)
            for which, key in (("first", "seconds"), ("second", "second_run_seconds"))}
    sessions["u8"].update(profile=prof, runs=runs)
    log(f"# mcs persistent: profiled 4 x run({MCS_FRAMES}) (a fresh process): device "
        f"{prof['device_ms']:.5f} ms a dispatch, {dev_ms:.5f} ms a run; unprofiled, "
        + "; ".join(f"the {k} run {v['ms']:.3f} ms, busy {v['busy']:.3f}, waits "
                    f"{v['host_wait_ms']:.3f} ms on the host" for k, v in runs.items())
        + f" (profiled host {prof['profiled_host_ms']:.5f} ms); "
        + ", ".join(f"{k} {v['ms']:.5f} ms x{v['launches']:g}" for k, v in prof["kernels"].items()))
    total = time.perf_counter() - t_phase
    split["other"] = total - sum(split.values())
    log(f"# phase 23 (MCS persistent): {total:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in split.items()))
    return list(entries.values()), dict(sessions=sessions, against_k22=k22, seconds=split)


def dos_state(res, depth_at, cam, dev, seed=24):
    """A mid-sweep DOS state: a random colour (alpha < 1) and occlusion, the
    sweep at ``depth_at`` of its depth range."""
    from vpt_tpu_torch.kernels import dos as KD

    lo, hi = KD.depth_range(cam)
    rng = np.random.default_rng(seed)
    color = rng.random((res, res, 4), np.float32) * np.float32(0.8)
    occ = rng.random((res, res), np.float32)
    return dict(color=torch.as_tensor(color, device=dev),
                occlusion=torch.as_tensor(occ, device=dev), depth=lo + (hi - lo) * depth_at,
                min_depth=lo, max_depth=hi)


def dos_check(label, dens, tft, filt, samples, state, schedule, sd, cam):
    """K24 (``dos_pass``) and its plain version over ``schedule`` from
    ``state``: colour, occlusion and display bit for bit."""
    from vpt_tpu_torch.kernels import dos as KD

    inv = cam.inverse_mvp()
    c_k, c_p = state["color"].clone(), state["color"].clone()
    o_k, spare = state["occlusion"].clone(), torch.empty_like(state["occlusion"])
    occ_k, img_k = KD.dos_pass(c_k, o_k, spare, inv, dens, tft, samples, schedule, sd,
                               DOS_KW["extinction"], filt)
    occ_p, img_p = KD.dos_pass_plain(c_p, state["occlusion"].clone(), inv, dens, tft, samples,
                                     schedule, sd, DOS_KW["extinction"], filt)
    torch.cuda.synchronize()
    rm_bitwise(f"K24 ({label})", (c_k, occ_k, img_k), (c_p, occ_p, img_p))
    return c_k, occ_k, img_k


def dos_reads(dens, tft, filt, state, depth_ndc, cam):
    """The lookups one K24 slice makes: each pixel inside the cube reads one
    volume entry (row) and the TF's row 0. Returns (RmReads, pixels inside)."""
    from vpt_tpu_torch.ops import geometry

    res = state["occlusion"].shape[0]
    dev = state["occlusion"].device
    i = torch.arange(res, dtype=torch.float32, device=dev)
    u2 = (i.view(1, -1).expand(res, res) + 0.5) / torch.tensor(float(res), device=dev)
    v2 = (i.view(-1, 1).expand(res, res) + 0.5) / torch.tensor(float(res), device=dev)
    px, py, pz = geometry.apply_homogeneous(cam.inverse_mvp(), u2 * 2.0 - 1.0, v2 * 2.0 - 1.0,
                                            float(depth_ndc))
    inside = ~((px > 1.0) | (px < 0.0) | (py > 1.0) | (py < 0.0) | (pz > 1.0) | (pz < 0.0))
    reads = RmReads(dens, filt)
    reads.add(px, py, pz, inside)
    return reads, int(inside.sum())


def dos_plain_sweep(s, renders):
    """``s``'s renderer driven ``renders`` times by the plain version on the
    card from ``s``'s reset state: the state and the last image."""
    from vpt_tpu_torch.kernels import dos as KD
    from vpt_tpu_torch.models.dos import slice_schedule

    r = s.renderer
    state = r.reset(s.camera)
    img = None
    for _ in range(renders):
        sched, sd, depth = slice_schedule(state, s.camera, r.steps, r.slices, r.aperture)
        occ, img = KD.dos_pass_plain(state["color"], state["occlusion"], s.camera.inverse_mvp(),
                                     r._density, r._tf_table, r._occl_samples, sched, sd,
                                     r.extinction, r.volume.filter)
        state = dict(state, occlusion=occ, depth=depth)
    return state, img


def phase_dos(dev):
    """Phase 24: DOS (K24 dos_slice) on the bench volume at R = 512 with the
    JAX defaults: K24 bit for bit against its plain version (colour,
    occlusion, display) for one slice and for three (the buffers'
    ping-pong) from a mid-sweep state, in four table modes at 8 samples and
    on the u8 table at 4; a whole sweep by RenderSession("dos").run(5), the
    counts set to 0 before (one K24 launch a slice, 201, and nothing else),
    equal to the plain versions' sweep on the card bit for bit; a render
    past the end (one display launch); the device time of a slice launch
    against its bound; ms per render, and the busy share of a whole sweep
    in a fresh process."""
    from vpt_tpu_torch import Camera, Volume
    from vpt_tpu_torch.kernels import dos as KD
    from vpt_tpu_torch.models.dos import slice_schedule
    from vpt_tpu_torch.session import RenderSession

    t_phase = time.perf_counter()
    cam = Camera()
    res = RM_RES
    state = dos_state(res, 0.45, cam, dev)
    sched1, sd, _ = slice_schedule(state, cam, 1, DOS_KW["slices"], DOS_KW["aperture"])
    sched3, _, _ = slice_schedule(state, cam, 3, DOS_KW["slices"], DOS_KW["aperture"])
    modes = rm_modes(dev)
    for n_samples in (8, 4):
        samples = torch.as_tensor(KD.generate_occlusion_samples(n_samples), device=dev)
        for label, dens, tft, filt in (modes if n_samples == 8 else modes[:1]):
            for sched in (sched1, sched3):
                dos_check(f"{label}, {n_samples} samples, {len(sched)} slices", dens, tft, filt,
                          samples, state, sched, sd, cam)
        log(f"# K24 == plain bit for bit (colour, occlusion, display) at {res}^2, {n_samples} "
            f"samples, 1 and 3 slices from a mid-sweep state: "
            + ", ".join(m[0] for m in (modes if n_samples == 8 else modes[:1])))

    # the whole sweep through the session: launches, images, the plain sweep
    s = RenderSession("dos", Volume.sphere_in_cube(VOLUME), device=dev, resolution=res)
    want = 0
    st = s.renderer.reset(cam)
    for _ in range(DOS_RENDERS):
        sched, _, depth = slice_schedule(st, cam, DOS_KW["steps"], DOS_KW["slices"],
                                         DOS_KW["aperture"])
        want += len(sched)
        st = dict(st, depth=depth)
    s.run(1)
    s.reset()
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(DOS_RENDERS)
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in all_launches().items() if v}
    if launches != {"dos.dos_slice": want}:
        raise AssertionError(f"RenderSession('dos').run({DOS_RENDERS}) launched {launches}, "
                             f"the schedule {want} slices")
    img = s.hdr_image()
    t0 = time.perf_counter()
    pstate, pimg = dos_plain_sweep(s, DOS_RENDERS)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    rm_bitwise("the DOS sweep against the plain sweep",
               (s.state["color"], s.state["occlusion"], torch.as_tensor(img, device=dev)),
               (pstate["color"], pstate["occlusion"], pimg))
    if s.state["depth"] != pstate["depth"] or not s.state["depth"] > s.state["max_depth"]:
        raise AssertionError(f"the sweep ended at depth {s.state['depth']}, plain "
                             f"{pstate['depth']}, max {s.state['max_depth']}")
    if not (np.isfinite(img).all() and img.shape == (res, res, 3) and float(img.min()) < 0.9):
        raise AssertionError(f"dos: image {img.shape} not finite or empty")
    reset_all_counts()
    s.run(1)
    past = {k: v for k, v in all_launches().items() if v}
    if past != {"dos.dos_display": 1} or not np.array_equal(s.hdr_image(), img):
        raise AssertionError(f"a render past the sweep's end launched {past} or changed the image")
    log(f"# RenderSession('dos').run({DOS_RENDERS}) at {res}^2: {dt * 1e3:.3f} ms "
        f"({dt * 1e3 / DOS_RENDERS:.3f} ms a render); {want} K24 launches ({DOS_KW['slices']} "
        "slices) and nothing else; "
        f"== the plain sweep on the card bit for bit (plain {plain_s:.2f} s); a render past the "
        "end: one display launch, the same image")

    # one slice launch by device time against its bound (u8 table, 8 samples)
    _, dens, tft, filt = modes[0]
    samples = torch.as_tensor(KD.generate_occlusion_samples(8), device=dev)
    c, o, spare = state["color"].clone(), state["occlusion"].clone(), torch.empty_like(
        state["occlusion"])
    ms = device_ms(lambda: KD.dos_pass(c, o, spare, cam.inverse_mvp(), dens, tft, samples, sched1,
                                       sd, DOS_KW["extinction"], filt))
    c, o = state["color"].clone(), state["occlusion"].clone()
    plain_ms = cuda_ms(lambda: KD.dos_pass_plain(c, o, cam.inverse_mvp(), dens, tft, samples,
                                                 sched1, sd, DOS_KW["extinction"], filt), 3)
    reads, inside = dos_reads(dens, tft, filt, state, sched1[0][0], cam)
    # the colour read and (inside the cube) written, the occlusion read and
    # written, the display written (the launch is its render's last slice)
    nbytes = (res * res * (16 + 4 + 4 + 12) + inside * 16 + reads.volume_bytes()
              + tft[0].numel() * 4 + samples.numel() * 4)
    ops = (8 * OPS_DOS_SLICE_SAMPLE + res * res * (OPS_DOS_PIXEL + OPS_DOS_DISPLAY)
           + inside * (OPS_DOS_INSIDE + 8 * OPS_DOS_SAMPLE))
    b = bound(nbytes, ops, ms)
    render_ms = dt * 1e3 / DOS_RENDERS
    prof = rm_profiles([("dos", DOS_RENDERS, dict(calls=4, reset=True))])[0]
    seen = prof["kernels"].get("dos_slice_kernel", {}).get("launches", 0) * DOS_RENDERS
    if abs(seen - want) > 1e-6:
        raise AssertionError(f"dos: the profiler saw {seen} K24 launches a sweep, not {want}")
    busy = prof["device_ms"] / render_ms
    entry = kernel_line(dict(
        name="dos_slice", route="cuda", source=DOS_SOURCE, replaces="vpt_tpu/models/dos.py:51",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, launches=launches["dos.dos_slice"],
        pixels_inside=inside, lookups=reads.lookups, render_ms=render_ms, sweep_ms=dt * 1e3), b)
    log(f"# K24 dos_slice at {res}^2 (u8, 8 samples): {ms:.5f} ms a slice (device), plain "
        f"{plain_ms:.4f} ms; {inside} pixels inside the cube; bound {b['bound_ms']:.5f} ms by "
        f"{b['bound_by']} ({b['bound_bytes']} B, {b['bound_ops']} FP32 ops), share "
        f"{b['bound_share']:.3f}")
    log(f"# profiled 4 x (reset, run({DOS_RENDERS})) of 'dos' (a fresh process), per render: "
        f"device {prof['device_ms']:.5f} ms of {render_ms:.5f} ms unprofiled (busy {busy:.3f}; "
        f"profiled host {prof['profiled_host_ms']:.5f} ms); " + ", ".join(
            f"{n} {k['ms']:.5f} ms x{k['launches']:g}" for n, k in prof["kernels"].items()))
    log(f"# phase 24 (DOS): {time.perf_counter() - t_phase:.1f} s")
    return [entry], dict(launches=launches, seconds=dt, render_ms=render_ms,
                         plain_sweep_s=plain_s, profile=prof, device_busy_share=busy)


LAO_FLAGS = ((True, True), (True, False), (False, True), (False, False))


def lao_inputs(r, cam):
    p = r.params
    return ((cam.inverse_mvp(), r._density, r._tf_table, r.light_position, p["extinction"],
             p["lao_weight"], p["shadows_weight"], p["light_radius"], p["light_coef"]),
            dict(lao_step=p["lao_step"], slices=r.slices, resolution=r.resolution,
                 volume_filter=r.volume.filter, **r.flags))


def lao_check(label, r, cam):
    """K25 (``lao_pass``, two runs) and the plain ``lao_frame`` on ``r``'s
    inputs, bit for bit; returns the image and the plain seconds."""
    from vpt_tpu_torch.kernels import lao as KL

    args, kw = lao_inputs(r, cam)
    a = KL.lao_pass(*args, **kw, cone=r._cone, exact=r.exact_stop)
    b = KL.lao_pass(*args, **kw, cone=r._cone, exact=r.exact_stop)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = KL.lao_frame(*args, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    rm_bitwise(f"K25 ({label}) against a second run", (a,), (b,))
    rm_bitwise(f"K25 ({label}) against the plain version", (a,), (p,))
    if not bool(torch.isfinite(a).all()) or not bool((a > 0).any()):
        raise AssertionError(f"K25 ({label}): the image is empty or not finite")
    return a, plain_s


def lao_replay(r, cam):
    """The work K25 does on ``r``'s frame, replayed through the plain
    version's ``observe`` hook: trips per hit pixel (its active samples),
    lookups, each volume entry and TF row they touch once."""
    from vpt_tpu_torch.kernels import lao as KL
    from vpt_tpu_torch.ops import interp

    args, kw = lao_inputs(r, cam)
    res = r.resolution
    trips = torch.zeros((res, res), dtype=torch.int32, device=r.device)
    reads = RmReads(r._density, r.volume.filter)
    tft = r._tf_table
    tf_rows = torch.zeros(tft.shape[0] * tft.shape[1], dtype=torch.bool, device=r.device)
    n = dict(tf_lookups=0)

    def observe(active, points, value, gmag):
        trips.add_(active.to(torch.int32))
        for x, y, z in points:
            reads.add(x, y, z, active)
        Hp, Wp = tft.shape[0] + (tft.shape[-1] == 4), tft.shape[1] + (tft.shape[-1] == 4)
        bx, _ = interp._base_and_frac(value, Wp - 1)
        by, _ = interp._base_and_frac(gmag, Hp - 1)
        if tft.shape[-1] == 4:  # a raw texture's texel rows
            by, bx = torch.clamp_max(by, Hp - 2), torch.clamp_max(bx, Wp - 2)
        tf_rows[(by * tft.shape[1] + bx)[active].to(torch.int64)] = True
        n["tf_lookups"] += int(active.sum())

    img = KL.lao_frame(*args, **kw, observe=observe)
    return img, trips, reads, int(tf_rows.sum()) * tft.shape[-1] * 4, n["tf_lookups"]


def ray_miss(res, cam, dev):
    """Which pixels' rays miss the cube (R, R)."""
    from vpt_tpu_torch.kernels import raymarch as RK

    return RK.ray_bounds(*RK.camera_rays(res, cam.inverse_mvp(), dev))[2]


def lao_warps(t):
    """An (R, R) image as K25's warps see it: (R * R / 32, 32), each row
    one 8 x 4 pixel tile (R a multiple of 8)."""
    r = t.shape[0]
    return t.reshape(r // 4, 4, r // 8, 8).permute(0, 2, 1, 3).reshape(-1, 32)


def lao_trip_stats(trips, miss):
    """Trips per hit pixel (mean, p99, max) and what a warp (K25's 8 x 4
    pixel tile) pays: the mean over warps with a hit of their longest ray,
    and the trip slots the warps hold (32 x their longest ray) over the
    trips the rays take."""
    hit = ~miss
    t = trips[hit].to(torch.float32)
    longest = lao_warps(torch.where(hit, trips, 0)).amax(-1).to(torch.float64)
    busy = longest[lao_warps(hit).any(-1)]
    return dict(hit_pixels=int(hit.sum()), ray_mean=float(t.mean()),
                ray_p99=float(torch.quantile(t, 0.99)), ray_max=int(t.max()),
                warp_paid=float(busy.mean()),
                warp_slots_over_trips=float(32 * busy.sum() / t.to(torch.float64).sum()))


def phase_lao(dev):
    """Phase 25: LAO (K25 lao_frame) on the bench volume at R = 512 with 64
    slices: K25 bit for bit against its plain version (and a second run)
    in its five table modes (the four of ``mode_volumes`` and the f32
    table under the quasicubic filter), each in the four flag pairs, and
    each mode's both-term frame by device time; the u8 frame against the
    bound of its replayed work (trips per ray: mean, p99, max, what a warp
    pays); a RenderSession run(16), the counts set to 0 before (16 K25
    launches and nothing else); ms per frame and the busy share in a fresh
    process."""
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import lao as KL
    from vpt_tpu_torch.models.lao import LAORenderer
    from vpt_tpu_torch.session import RenderSession

    from vpt_tpu_torch import Volume

    t_phase = time.perf_counter()
    cam = Camera()
    vols = mode_volumes()
    vols += (("f32 quasicubic", Volume(vols[1][1].density, "quasicubic")),)
    vol = vols[0][1]
    plain, modes_ms = {}, {}
    for label, v in vols:
        for lao_on, shadows_on in LAO_FLAGS:
            r = LAORenderer(v, slices=LAO_SLICES, resolution=RM_RES, lao_enabled=lao_on,
                            shadows_enabled=shadows_on, device=dev)
            if not (r.exact_stop and KL.cone_clear(cam.inverse_mvp(), r.light_position,
                                                   r.params["light_radius"],
                                                   r.params["lao_step"], r.slices)):
                raise AssertionError(f"LAO ({label}): the early stop is not exact on these inputs")
            _, plain[(label, lao_on, shadows_on)] = lao_check(
                f"{label}, lao {lao_on}, shadows {shadows_on}", r, cam)
            if lao_on and shadows_on:
                args, kw = lao_inputs(r, cam)
                modes_ms[f"{label} ({KL.kernel_mode(args[1], args[2], kw['volume_filter'])})"] = (
                    device_ms(lambda: KL.lao_pass(*args, **kw, cone=r._cone,
                                                  exact=r.exact_stop)))
    log(f"# K25 == plain bit for bit at {RM_RES}^2, {LAO_SLICES} slices: "
        + ", ".join(f"{k[0]} (lao {k[1]}, shadows {k[2]}: plain {v:.2f} s)"
                    for k, v in plain.items()))
    log("# K25 a frame (device ms, both terms) by table mode: "
        + ", ".join(f"{k} {v:.5f}" for k, v in modes_ms.items()))

    r = LAORenderer(vol, slices=LAO_SLICES, resolution=RM_RES, device=dev)
    args, kw = lao_inputs(r, cam)
    # the masked march without the early stop gives the same bits
    rm_bitwise("K25 masked against K25 stopping early",
               (KL.lao_pass(*args, **kw, cone=r._cone, exact=False),),
               (KL.lao_pass(*args, **kw, cone=r._cone, exact=True),))
    ms = device_ms(lambda: KL.lao_pass(*args, **kw, cone=r._cone, exact=r.exact_stop))
    img, trips, reads, tf_bytes, tf_lookups = lao_replay(r, cam)
    stats = lao_trip_stats(trips, ray_miss(RM_RES, cam, dev))
    n_cone = r._cone.shape[0]
    samples = int(trips.sum())
    nbytes = RM_RES * RM_RES * 12 + reads.volume_bytes() + tf_bytes + r._cone.numel() * 4
    ops = (OPS_LAO_FRAME
           + stats["hit_pixels"] * (OPS_LAO_PIXEL + n_cone * OPS_LAO_CONE_PIXEL
                                    + OPS_LAO_SHADOW_PIXEL)
           + samples * (OPS_LAO_SAMPLE + n_cone * OPS_LAO_CONE + OPS_LAO_CONE_END + OPS_LAO_SHADOW))
    b = bound(nbytes, ops, ms)
    log(f"# K25 lao_frame at {RM_RES}^2, {LAO_SLICES} slices (u8, both terms): {ms:.5f} ms "
        f"(device), plain {plain[('linear u8', True, True)] * 1e3:.1f} ms; {samples} samples, "
        f"{reads.lookups} volume lookups ({int(reads.touched.sum())} entries), {tf_lookups} TF "
        f"lookups; bound {b['bound_ms']:.5f} ms by {b['bound_by']} ({b['bound_bytes']} B, "
        f"{b['bound_ops']} FP32 ops), share {b['bound_share']:.3f}")
    log(f"# K25 trips per ray over the {stats['hit_pixels']} hit pixels: mean "
        f"{stats['ray_mean']:.3f}, p99 {stats['ray_p99']:.1f}, max {stats['ray_max']}; a warp "
        f"with a hit pays {stats['warp_paid']:.3f}, its trip slots "
        f"{stats['warp_slots_over_trips']:.3f}x the trips taken")

    s = RenderSession("lao", vol, slices=LAO_SLICES, device=dev, resolution=RM_RES)
    s.run(1)
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(LAO_FRAMES)
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in all_launches().items() if v}
    if launches != {"lao.lao_frame": LAO_FRAMES}:
        raise AssertionError(f"RenderSession('lao').run({LAO_FRAMES}) launched {launches}")
    simg = s.hdr_image()
    if not np.array_equal(simg.view(np.int32), img.cpu().numpy().view(np.int32)):
        raise AssertionError("the session's frame differs from the replayed plain frame")
    if int(s.state["frame"]) != LAO_FRAMES + 1:
        raise AssertionError(f"lao: frame count {int(s.state['frame'])}")
    frame_ms = dt * 1e3 / LAO_FRAMES
    prof = rm_profiles([("lao", LAO_FRAMES, dict(slices=LAO_SLICES))])[0]
    busy = prof["device_ms"] / frame_ms
    seen = sum(k["launches"] for n, k in prof["kernels"].items()
               if n.startswith("lao_frame_kernel"))
    if abs(seen - 1) > 1e-6:
        raise AssertionError(f"lao: the profiler saw {seen} K25 launches a frame")
    entry = kernel_line(dict(
        name="lao_frame", route="cuda", source=LAO_SOURCE, replaces="vpt_tpu/models/lao.py:51",
        max_abs_err=0.0, ms=ms, plain_ms=plain[("linear u8", True, True)] * 1e3,
        launches=launches["lao.lao_frame"], samples=samples, volume_lookups=reads.lookups,
        trips=stats, frame_ms=frame_ms, modes_ms=modes_ms), b)
    log(f"# RenderSession('lao').run({LAO_FRAMES}) at {RM_RES}^2: {dt * 1e3:.3f} ms "
        f"({frame_ms:.4f} ms a frame); launches {launches}; == the plain frame bit for bit")
    log(f"# profiled run({LAO_FRAMES}) of 'lao' (a fresh process), per frame: device "
        f"{prof['device_ms']:.5f} ms of {frame_ms:.5f} ms unprofiled (busy {busy:.3f}; profiled "
        f"host {prof['profiled_host_ms']:.5f} ms); " + ", ".join(
            f"{n} {k['ms']:.5f} ms x{k['launches']:g}" for n, k in prof["kernels"].items()))
    log(f"# phase 25 (LAO): {time.perf_counter() - t_phase:.1f} s")
    return [entry], dict(launches=launches, seconds=dt, frame_ms=frame_ms, trips=stats,
                         profile=prof, device_busy_share=busy)


def slab_requests(n_rows, n, seed=26):
    """n x N int32 row requests (N = RES^2 x STREAMS, one a lane) from a
    numpy seed, uniform over a table of ``n_rows`` rows; every 8th is -1 (a
    lane that looks nothing up)."""
    g = np.random.default_rng(seed + n)
    req = g.integers(0, n_rows, size=n * RES * RES * STREAMS).astype(np.int32)
    req[::8] = -1
    return req


def slab_rows_bound(table, req, ms):
    """K26's bound at requests ``req``: each request's index read and its
    32-byte row written once, each owned row of the table read once (its 8
    u8 codes dequantized)."""
    owned = torch.unique(req[req >= 0]).numel()
    row_bytes = 8 * table.element_size()
    n = req.numel()
    ops = int((req >= 0).sum()) * OPS_K26_U8 * (table.dtype == torch.uint8)
    return bound(4 * n + owned * row_bytes + 32 * n, ops, ms)


def slab_rows_check(flat, dims, label, dev):
    """K26 over the (rows, 8) ``flat`` table of dims (Dp, Hp, Wp) split
    into n = SLAB_OWNERS z-slabs simulated in one process, at n x N
    requests: each owner's rows equal its plain version bit for bit, and
    their sum a local take of the dequantized table (a zero row for -1).
    Returns the kernels-line entry of one owner at N requests (the main
    path's shape), by device time."""
    from vpt_tpu_torch.kernels import slab as KS
    from vpt_tpu_torch.ops import interp

    Dp, Hp, Wp = dims
    plane = Hp * Wp
    for n in SLAB_OWNERS:
        slab_z = -(-Dp // n)
        req = torch.as_tensor(slab_requests(flat.shape[0], n), device=dev)
        total = None
        for r in range(n):
            lo = r * slab_z * plane
            part = flat[lo:(r + 1) * slab_z * plane]
            if part.shape[0] < slab_z * plane:  # the zero pad of pad_packed_for_slabs
                part = torch.cat([part, part.new_zeros((slab_z * plane - part.shape[0], 8))])
            got = KS.slab_rows(part.contiguous(), lo, req)
            want = KS.slab_rows_plain(part, lo, req)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"K26 {label}, owner {r} of {n}: != its plain version")
            total = got if total is None else total + got
        take = interp.dequantize_rows(flat[req.clamp_min(0).to(torch.int64)])
        take = torch.where(req[:, None] >= 0, take, torch.zeros_like(take))
        if not torch.equal(total.view(torch.int32), take.view(torch.int32)):
            raise AssertionError(f"K26 {label}: the {n} owners' sum != a local take")
    log(f"# K26 slab_rows {label}: each of n = {SLAB_OWNERS} owners == its plain version and "
        f"their sum == a local take, bit for bit, at n x {RES * RES * STREAMS} requests")
    req = torch.as_tensor(slab_requests(flat.shape[0], 1), device=dev)
    ms = device_ms(lambda: KS.slab_rows(flat, 0, req))
    plain_ms = device_ms(lambda: KS.slab_rows_plain(flat, 0, req))
    b = slab_rows_bound(flat, req, ms)
    log(f"# K26 slab_rows {label}, one owner, {req.numel()} requests: {ms:.5f} ms (device), "
        f"plain {plain_ms:.5f} ms; bound {b['bound_ms']:.5f} ms by {b['bound_by']} "
        f"({b['bound_bytes']} B), share {b['bound_share']:.3f}")
    return kernel_line(dict(name="slab_rows" + ("" if flat.dtype == torch.uint8 else "[f32]"),
                            route="cuda", source=SLAB_SOURCE,
                            replaces="vpt_tpu/parallel/slab.py:64", max_abs_err=0.0, ms=ms,
                            plain_ms=plain_ms, requests=req.numel()), b)


def slab_ctx(ctx, mesh):
    """``ctx`` with its full packed table as this rank's slab (the whole
    table at world size 1)."""
    from vpt_tpu_torch.parallel import slab as TS

    table = ctx.density.table.view(*ctx.density.dims, 8)
    return dataclasses.replace(ctx, density=TS.shard_packed_volume(table, mesh))


def slab_check(label, ctx, state0, mesh, dims, seeds):
    """len(seeds) dispatches of render_slab (this rank = every row) against
    K1 from the same state: every state field and the image bit for bit.
    Returns the slab's launches (counts set to 0 before)."""
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import slab as KS
    from vpt_tpu_torch.models.mcm_spectral import radiance_to_rgb
    from vpt_tpu_torch.parallel import mesh as Mesh
    from vpt_tpu_torch.parallel import slab as TS

    k1 = clone_state(state0)
    K.step(k1, ctx, seeds, STEPS, BINS)
    sctx = slab_ctx(ctx, mesh)
    st = Mesh.shard_spectral_state(state0, mesh)
    KS.reset_launch_counts()
    Mesh.reset_collective_counts()
    for seed in seeds:
        st, img = TS.render_slab(st, dataclasses.replace(sctx, seed_bits=int(seed)), mesh, dims,
                                 STEPS, BINS, ctx.volume_filter)
    torch.cuda.synchronize()
    launches, coll = dict(KS.LAUNCHES), dict(Mesh.COLLECTIVES)
    diff = first_difference(st, k1)
    if diff is not None:
        raise AssertionError(f"render_slab {label} != K1: {diff}")
    ref = radiance_to_rgb(k1.radiance, ctx.bin_xyz)
    if not torch.equal(img.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError(f"render_slab {label}: the image != K1's")
    steps = STEPS * len(seeds)
    want = {"all_gather": steps, "reduce_scatter": steps, "gather_rows": len(seeds), "halo": 0,
            "all_reduce": 0}
    if coll != want or any(launches[k] != steps for k in ("slab_rows", "slab_advance",
                                                          "slab_finish")):
        raise AssertionError(f"render_slab {label}: collectives {coll}, launches {launches}")
    log(f"# render_slab {label} at world size 1, {'x'.join(map(str, state0.px.shape))} lanes, "
        f"{len(seeds)} dispatches: every state field and the image == K1 bit for bit; "
        f"samples {int(st.samples.sum())}; launches {launches}; collectives {coll}")
    return launches


def slab_step_entries(ctx, state0, mesh, dims, suffix, plain_reps=2):
    """K27 and K28 per launch by device time at one step of a dispatch
    from ``state0`` (the handoff of that step's K27 and routed rows), their
    plain versions by CUDA events, and their bounds from this step's data:
    K27 reads the lane's position and direction, its RNG word and the
    majorant cells, writes the row, fractions, flight (and majorant) and
    the word; K28 reads the state, its lane table, the word, the flight
    (and majorant, and in bounds its request), the routed row and fractions
    where the lane looked one up, the TF rows it looks up (and the env map),
    writes the state and the word."""
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import slab as KS
    from vpt_tpu_torch.parallel import mesh as Mesh
    from vpt_tpu_torch.parallel import slab as TS

    sctx = slab_ctx(ctx, mesh)
    streams = state0.px.shape[0] if state0.px.ndim == 3 else 1
    lanes = Mesh.lane_tables(mesh, state0.px.shape[-1], streams)
    st = Mesh.shard_spectral_state(state0, mesh)
    n = st.px.numel()
    rng = torch.empty(n, dtype=torch.int32, device=st.px.device)
    out = KS.slab_advance(st, sctx, lanes, ctx.seed_bits, True, rng, dims, BINS)
    rows = TS.distributed_rows(sctx.density.table, out[0], mesh)
    lookups = int((out[0] >= 0).sum())
    # K28 reads a lane's routed row and fractions only where it looked one
    # up, and its request only in majorant mode and in bounds
    in_bounds = int((~K.sample_position(KS._fields(st), out[2].view(st.px.shape))[3]).sum())
    samples0 = int(st.samples.sum())
    after = clone_state(st)
    KS.slab_finish(after, sctx, lanes, rows, *out[1:], out[0], rng.clone(), BINS, dims)
    respawns = int(after.samples.sum()) - samples0
    maj = ctx.majorant is not None
    k27_ms = device_ms(lambda: KS.slab_advance(st, sctx, lanes, ctx.seed_bits, False, rng, dims,
                                               BINS))
    k28_state, k28_rng = clone_state(st), rng.clone()
    k28_ms = device_ms(lambda: KS.slab_finish(k28_state, sctx, lanes, rows, *out[1:], out[0],
                                              k28_rng, BINS, dims))
    p_st, p_rng = clone_state(st), rng.clone()
    k27_plain = cuda_ms(lambda: KS.slab_advance_plain(p_st, sctx, lanes, ctx.seed_bits, False,
                                                      p_rng, dims), plain_reps)
    k28_plain = cuda_ms(lambda: KS.slab_finish_plain(p_st, sctx, lanes, rows, *out[1:], out[0],
                                                     p_rng, BINS), plain_reps)
    maj_bytes = min(ctx.majorant.numel() * 4, n * 8) if maj else 0
    k27_bytes = n * (24 + 4 + 4 + 12 + 4 + 4 + 4 * maj) + maj_bytes
    tf = ctx.material_tf
    env = 0 if ctx.environment is None else ctx.environment.numel() * 4
    k28_bytes = (state_bytes(n, BINS) + n * (8 + 4 + 4 + 4 + 4 * maj) + in_bounds * 4 * maj
                 + lookups * (32 + 12) + min(tf.numel(), lookups * 18) * 4 + env)
    b27 = bound(k27_bytes, n * OPS_K27_STEP + lookups * OPS_K27_LOOKUP, k27_ms)
    b28 = bound(k28_bytes, n * OPS_K28_STEP + lookups * OPS_K28_LOOKUP
                + respawns * (OPS_RESPAWN + 4 * BINS), k28_ms)
    for name, ms, pms, b in (("K27 slab_advance", k27_ms, k27_plain, b27),
                             ("K28 slab_finish", k28_ms, k28_plain, b28)):
        log(f"# {name}{suffix} per launch, {n} lanes ({lookups} lookups, {respawns} respawns): "
            f"{ms:.5f} ms (device), plain {pms:.4f} ms; bound {b['bound_ms']:.5f} ms by "
            f"{b['bound_by']} ({b['bound_bytes']} B, {b['bound_ops']} FP32 ops), share "
            f"{b['bound_share']:.3f}")
    common = dict(route="cuda", source=SLAB_SOURCE, replaces="vpt_tpu/parallel/slab.py:680",
                  max_abs_err=0.0, lanes=n, lookups=lookups, respawns=respawns)
    return (kernel_line(dict(name="slab_advance" + suffix, ms=k27_ms, plain_ms=k27_plain,
                             **common), b27),
            kernel_line(dict(name="slab_finish" + suffix, ms=k28_ms, plain_ms=k28_plain,
                             **common), b28))


def slab_sparse(renderer, cam, dev):
    """Phase 26 (c): the sparse 512^3 scene's full 513^3 x 8 u8 table
    (phase 11's renderer) in majorant mode: render_slab == K1 over 2
    dispatches, K27 and K28 in majorant mode timed."""
    from vpt_tpu_torch.parallel.mesh import ray_mesh

    t0 = time.perf_counter()
    mesh = ray_mesh(device=dev)
    ctx = renderer.ctx(cam, 7)
    dims = renderer.volume.density.shape
    launches = slab_check(f"sparse {SPARSE}^3 majorant", ctx, renderer.reset(cam, 7), mesh, dims,
                          [2654435761 * k % 2**32 for k in (1, 2)])
    k27, k28 = slab_step_entries(ctx, renderer.reset(cam, 7), mesh, dims, "[majorant]")
    for e, key in ((k27, "slab_advance_majorant"), (k28, "slab_finish_majorant")):
        e["launches"] = launches[key]
        e["launches_of"] = "the sparse majorant check run (2 dispatches)"
    torch.distributed.destroy_process_group()
    log(f"# phase 26 (c), the sparse slab: {time.perf_counter() - t0:.1f} s")
    return [k27, k28]


def slab_profile(dispatches):
    """``dispatches`` render_slab dispatches of the bench scene at world
    size 1 under torch.profiler, after a warm-up: the device work by
    kernel name (ms and launches a dispatch), the device ms a dispatch, the
    profiled host ms a dispatch. Run in a fresh process (``rm_profiles``)."""
    from torch.profiler import ProfilerActivity, profile

    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu_torch.parallel import mesh as Mesh
    from vpt_tpu_torch.parallel import slab as TS
    from vpt_tpu_torch.tools.profile_fit import device_kernels

    dev = torch.device("cuda:0")
    mesh = Mesh.ray_mesh(device=dev)
    r = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS, device=dev)
    cam = Camera()
    sctx = slab_ctx(r.ctx(cam, 7), mesh)
    st = Mesh.shard_spectral_state(r.reset(cam, 7), mesh)
    dims = r.volume.density.shape
    seeds = [2654435761 * k % 2**32 for k in range(1, 3 + dispatches)]
    for seed in seeds[:2]:
        TS.render_slab(st, dataclasses.replace(sctx, seed_bits=seed), mesh, dims, STEPS, BINS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for seed in seeds[2:]:
            TS.render_slab(st, dataclasses.replace(sctx, seed_bits=seed), mesh, dims, STEPS, BINS)
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    kernels = {name: dict(ms=k["ms"] / dispatches, launches=k["launches"] / dispatches)
               for name, k in device_kernels(prof).items()}
    torch.distributed.destroy_process_group()
    return dict(kernels=kernels, device_ms=sum(k["ms"] for k in kernels.values()),
                profiled_host_ms=host * 1e3 / dispatches)


def phase_slab(dev, sparse_entries):
    """Phase 26: the slab-sharded render (B14a) at world size 1 on a
    one-process NCCL group: (a) K26 on the bench's 129^3 x 8 table, u8 and
    f32, owners simulated; (b) render_slab on the bench scene against K1 bit
    for bit (default, quasicubic, f32 table, environment map), 16 dispatches
    timed beside K1's, K27/K26/K28 per launch, the collectives' share and the
    busy share (a fresh process's profile); (d) MCMSpectralRenderer(mesh=)
    against the renderer without a mesh. (c) ran beside phase 11."""
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import slab as KS
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu_torch.parallel import mesh as Mesh
    from vpt_tpu_torch.parallel import slab as TS

    t_phase = time.perf_counter()
    mesh = Mesh.ray_mesh(device=dev)
    cam = Camera()
    r = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS, device=dev)
    ctx = r.ctx(cam, 7)
    dims = r.volume.density.shape
    # (a) K26 alone
    k26 = slab_rows_check(ctx.density.table, ctx.density.dims, "u8", dev)
    f32 = f32_ctx(r, cam, dev)
    k26_f32 = slab_rows_check(f32.density.table, f32.density.dims, "f32", dev)
    # (b) render_slab against K1
    seeds2 = [2654435761 * k % 2**32 for k in (1, 2)]
    s0 = r.reset(cam, 7)
    slab_check("default", ctx, s0, mesh, dims, seeds2)
    slab_check("quasicubic", dataclasses.replace(ctx, volume_filter="quasicubic"), s0, mesh, dims,
               seeds2)
    k26_f32["launches"] = slab_check("f32 table", f32, s0, mesh, dims, seeds2)["slab_rows"]
    k26_f32["launches_of"] = "the f32-table check run (2 dispatches)"
    env_r = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS,
                                environment=seeded_envmap(), device=dev)
    slab_check("environment", env_r.ctx(cam, 7), env_r.reset(cam, 7), mesh, dims, seeds2)
    del env_r
    k27, k28 = slab_step_entries(ctx, s0, mesh, dims, "")
    # the main path: SLAB_DISPATCHES dispatches, the counts set to 0 just before
    sctx = slab_ctx(ctx, mesh)
    st = Mesh.shard_spectral_state(s0, mesh)
    seeds = [2654435761 * k % 2**32 for k in range(3, 3 + SLAB_DISPATCHES)]
    TS.render_slab(st, dataclasses.replace(sctx, seed_bits=1), mesh, dims, STEPS, BINS)
    torch.cuda.synchronize()
    reset_all_counts()
    Mesh.reset_collective_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for seed in seeds:
        st, img = TS.render_slab(st, dataclasses.replace(sctx, seed_bits=seed), mesh, dims, STEPS,
                                 BINS)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = {k: v for k, v in all_launches().items() if v}
    coll = dict(Mesh.COLLECTIVES)
    n_steps = SLAB_DISPATCHES * STEPS
    want = {"slab.slab_rows": n_steps, "slab.slab_rows_u8": n_steps,
            "slab.slab_advance": n_steps, "slab.slab_finish": n_steps}
    if launches != want or coll != {"all_gather": n_steps, "reduce_scatter": n_steps,
                                    "gather_rows": SLAB_DISPATCHES, "halo": 0, "all_reduce": 0}:
        raise AssertionError(f"render_slab x {SLAB_DISPATCHES}: launches {launches}, "
                             f"collectives {coll}")
    if not bool(torch.isfinite(img).all()) or tuple(img.shape) != (RES, RES, 3):
        raise AssertionError(f"render_slab's image: {tuple(img.shape)}, not finite")
    dispatch_ms = start.elapsed_time(end) / SLAB_DISPATCHES
    sk = clone_state(s0)
    k1_ms = cuda_ms(lambda: K.step(sk, ctx, [seeds[0]], STEPS, BINS), SLAB_DISPATCHES)
    k26["launches"] = launches["slab.slab_rows"]
    k27["launches"], k28["launches"] = launches["slab.slab_advance"], launches["slab.slab_finish"]
    for e in (k26, k27, k28):
        e["launches_of"] = "the main path"
    log(f"# render_slab on the bench scene (world size 1, NCCL), {SLAB_DISPATCHES} dispatches: "
        f"{dispatch_ms:.4f} ms a dispatch by CUDA events ({host_s * 1e3 / SLAB_DISPATCHES:.4f} ms "
        f"host), K1 {k1_ms:.4f} ms a dispatch ({dispatch_ms / k1_ms:.2f}x); launches {launches}; "
        f"collectives {coll}")
    prof = fresh_result("slab_profile", 4)
    coll_ms = sum(k["ms"] for name, k in prof["kernels"].items()
                  if "nccl" in name.lower() or "memcpy" in name.lower())
    busy = prof["device_ms"] / dispatch_ms
    log(f"# profiled render_slab (a fresh process), per dispatch: device {prof['device_ms']:.5f} "
        f"ms of {dispatch_ms:.5f} ms unprofiled (busy {busy:.3f}); the collectives "
        f"{coll_ms:.5f} ms ({coll_ms / prof['device_ms']:.3f} of the device time); " + ", ".join(
            f"{n} {k['ms']:.5f} ms x{k['launches']:g}" for n, k in prof["kernels"].items()))
    # (d) the mesh renderer at world size 1 against the renderer without one
    rm = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS, mesh=mesh,
                             device=dev)
    a, b = r.reset(cam, 7), rm.reset(cam, 7)
    a, img_a = r.render_many(a, cam, seeds2)
    b, img_b = rm.render_many(b, cam, seeds2)
    a, img_a = r.render(a, cam, 9)
    b, img_b = rm.render(b, cam, 9)
    torch.cuda.synchronize()
    diff = first_difference(a, b)
    if diff is not None or not torch.equal(img_a.view(torch.int32), img_b.view(torch.int32)):
        raise AssertionError(f"MCMSpectralRenderer(mesh=) != the renderer without a mesh: {diff}")
    log(f"# MCMSpectralRenderer(mesh=ray_mesh(device={dev})) == the renderer without a mesh bit "
        "for bit (reset, render_many of 2 seeds, render; every state field and both images)")
    torch.distributed.destroy_process_group()
    log(f"# phase 26 (the slab): {time.perf_counter() - t_phase:.1f} s")
    return ([k26, k26_f32, k27, k28, *sparse_entries],
            dict(dispatch_ms=dispatch_ms, host_ms=host_s * 1e3 / SLAB_DISPATCHES, k1_ms=k1_ms,
                 launches=launches, collectives=coll, profile=prof, device_busy_share=busy,
                 collective_ms=coll_ms))


def rel_l2(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def slab_tape_check(label, ctx, state0, mesh, dims, seed):
    """The taped slab dispatch (K27 asking every lane's row, all-gather,
    K26, reduce-scatter, K28 TAPE a step) against K4 from the same state
    and seed: the tape and every state field bit for bit."""
    from vpt_tpu_torch.kernels import spectral_backward as TB
    from vpt_tpu_torch.parallel import mesh as Mesh
    from vpt_tpu_torch.parallel import slab as TS

    fields = TB.ctx_tape_fields(ctx, SLAB_WRT)
    k4_state, k4_tape = TB.tape_forward(state0, ctx, [seed], STEPS, BINS, SLAB_WRT)
    st, tape = TS.tape_slab_dispatch(Mesh.shard_spectral_state(state0, mesh), slab_ctx(ctx, mesh),
                                     mesh, dims, STEPS, BINS, seed, fields)
    torch.cuda.synchronize()
    ne = tape.view(torch.int32) != k4_tape.view(torch.int32)
    if bool(ne.any()):
        bad = {f: int(ne[:, :, i].sum()) for i, f in enumerate(fields) if bool(ne[:, :, i].any())}
        raise AssertionError(f"K28 TAPE's tape ({label}) != K4's: lane-steps differing by field {bad}")
    diff = first_difference(st, k4_state)
    if diff is not None:
        raise AssertionError(f"the taped slab dispatch ({label}) left another state than K4: {diff}")
    log(f"# the taped slab dispatch ({label}, {'x'.join(map(str, state0.px.shape))} lanes, "
        f"{STEPS} steps): K28 TAPE's tape ({len(fields)} fields) and every state field == K4's "
        "bit for bit")


def slab_tape_entries(ctx, state0, mesh, dims):
    """K27 with every lane's request and K28 TAPE per launch by device time
    at the first step of a taped dispatch from ``state0``, their plain
    versions by CUDA events, and their bounds from this step's data: K27's
    as the forward's, every lane looking up; K28 TAPE reads the state, its
    lane table, the word, the flight, every lane's request, routed row and
    fractions and the TF rows looked up, writes the state, the word and the
    step's tape rows."""
    from vpt_tpu_torch.kernels import slab as KS
    from vpt_tpu_torch.kernels import spectral_backward as TB
    from vpt_tpu_torch.parallel import mesh as Mesh
    from vpt_tpu_torch.parallel import slab as TS

    sctx = slab_ctx(ctx, mesh)
    fields = TB.ctx_tape_fields(ctx, SLAB_WRT)
    lanes = Mesh.lane_tables(mesh, RES, STREAMS)
    st = Mesh.shard_spectral_state(state0, mesh)
    n = st.px.numel()
    rng = torch.empty(n, dtype=torch.int32, device=st.px.device)
    out = KS.slab_advance(st, sctx, lanes, ctx.seed_bits, True, rng, dims, BINS, tape=True)
    rows = TS.distributed_rows(sctx.density.table, out[0], mesh)
    tape = torch.empty((len(fields), n), dtype=torch.float32, device=st.px.device)
    after = clone_state(st)
    KS.slab_finish(after, sctx, lanes, rows, *out[1:], out[0], rng.clone(), BINS, dims, tape=tape,
                   fields=fields)
    respawns = int(after.samples.sum()) - int(st.samples.sum())
    k27_ms = device_ms(lambda: KS.slab_advance(st, sctx, lanes, ctx.seed_bits, False, rng, dims,
                                               BINS, tape=True))
    k28_state, k28_rng = clone_state(st), rng.clone()
    k28_ms = device_ms(lambda: KS.slab_finish(k28_state, sctx, lanes, rows, *out[1:], out[0],
                                              k28_rng, BINS, dims, tape=tape, fields=fields))
    p_st, p_rng, p_tape = clone_state(st), rng.clone(), tape.clone()
    k27_plain = cuda_ms(lambda: KS.slab_advance_plain(p_st, sctx, lanes, ctx.seed_bits, False,
                                                      p_rng, dims, tape=True), 2)
    k28_plain = cuda_ms(lambda: KS.slab_finish_plain(p_st, sctx, lanes, rows, *out[1:], out[0],
                                                     p_rng, BINS, p_tape, fields, dims), 2)
    tf = ctx.material_tf
    env = 0 if ctx.environment is None else ctx.environment.numel() * 4
    b27 = bound(n * (24 + 4 + 4 + 12 + 4 + 4), n * (OPS_K27_STEP + OPS_K27_LOOKUP), k27_ms)
    b28 = bound(state_bytes(n, BINS) + n * (8 + 4 + 4 + 4) + n * (32 + 12)
                + min(tf.numel(), n * 18) * 4 + env + n * len(fields) * 4,
                n * (OPS_K28_STEP + OPS_K28_LOOKUP) + respawns * (OPS_RESPAWN + 4 * BINS), k28_ms)
    for name, ms, pms, b in (("K27 slab_advance[tape]", k27_ms, k27_plain, b27),
                             ("K28 slab_finish[tape]", k28_ms, k28_plain, b28)):
        log(f"# {name} per launch, {n} lanes (every lane looks up; {respawns} respawns, "
            f"{len(fields)} tape fields): {ms:.5f} ms (device), plain {pms:.4f} ms; bound "
            f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({b['bound_bytes']} B, {b['bound_ops']} "
            f"FP32 ops), share {b['bound_share']:.3f}")
    common = dict(route="cuda", source=SLAB_SOURCE, max_abs_err=0.0, lanes=n, respawns=respawns)
    return (kernel_line(dict(name="slab_advance[tape]", ms=k27_ms, plain_ms=k27_plain,
                             replaces="vpt_tpu/parallel/slab.py:275", **common), b27),
            kernel_line(dict(name="slab_finish[tape]", ms=k28_ms, plain_ms=k28_plain,
                             replaces="vpt_tpu/kernels/spectral_backward.py:660",
                             tape_fields=len(fields), **common), b28))


def slab_pack_check(raw):
    """K31 against K10's table (``pack_volume`` of the same f32 grid) with
    pad_packed_for_slabs's zero planes, every owner at n = 1, 2, 4, 8, bit
    for bit; the whole table by device time against its bound (the grid
    read once, the table written once)."""
    from vpt_tpu_torch.kernels import corners as C
    from vpt_tpu_torch.kernels import slab as KS

    D, H, W = raw.shape
    plane = (H + 1) * (W + 1)
    table = C.pack_volume(raw)
    for n in SLAB_OWNERS:
        slab_z = -(-(D + 1) // n)
        padded = torch.cat([table, table.new_zeros(((slab_z * n - (D + 1)) * plane, 8))])
        for o in range(n):
            got = KS.slab_pack(raw, o * slab_z, slab_z)
            want = padded[o * slab_z * plane:(o + 1) * slab_z * plane]
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"K31 slab_pack, owner {o} of {n} != K10's padded table")
    ms = device_ms(lambda: KS.slab_pack(raw, 0, D + 1))
    plain_ms = cuda_ms(lambda: KS.slab_pack_plain(raw, 0, D + 1), 2)
    b = bound(raw.numel() * 4 + table.numel() * 4, 0, ms)
    log(f"# K31 slab_pack: each owner of n = {SLAB_OWNERS} == K10's padded table bit for bit; the "
        f"whole {D + 1}x{H + 1}x{W + 1} table {ms:.5f} ms (device), plain {plain_ms:.4f} ms; bound "
        f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({b['bound_bytes']} B), share "
        f"{b['bound_share']:.3f}")
    return kernel_line(dict(name="slab_pack", route="cuda", source=SLAB_SOURCE,
                            replaces="vpt_tpu/parallel/slab.py:405", max_abs_err=0.0, ms=ms,
                            plain_ms=plain_ms, rows=table.shape[0]), b)


def slab_routed_check(ctx, state0, mesh, dev):
    """K5 ROUTED + K29 against K5's own adjoint over one 2-dispatch tape
    (K4's) at stride 1, stride 4 and importance 4, the carry bit for bit;
    K5 ROUTED's pair list against its plain version's (the same count;
    sorted by slot id, the slot ids, rows and values bit for bit), K5
    ROUTED timed by CUDA events against its bound (the tape's fields read
    as K5 reads them, the pairs written); K29 at n = 1, 2, 4, 8 simulated
    owners (their slabs concatenated == one owner's scatter) and one owner
    by device time against its bound and, in turns, index_add_ of the
    list's owned pairs; K30 at the same owners, the halos added, against
    K9 contract_volume, one owner by device time. Returns the three
    kernels-line entries."""
    from vpt_tpu_torch.kernels import corners as C
    from vpt_tpu_torch.kernels import slab as KS
    from vpt_tpu_torch.kernels import spectral_backward as TB
    from vpt_tpu_torch.parallel import mesh as Mesh

    seeds = [2654435761 * k % 2**32 for k in (3, 4)]
    fields = TB.ctx_tape_fields(ctx, SLAB_WRT)
    sk, tape = TB.tape_forward(state0, ctx, seeds, STEPS, BINS, SLAB_WRT)
    lane, res, streams, n = TB._lanes(state0)
    lanes = Mesh.lane_tables(mesh, RES, STREAMS)
    g_img = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (RES, RES, 3)).astype(
        np.float32), device=dev)
    g_rs = TB._deposit_cotangents(g_img, ctx, lane, BINS, TB._m_final(sk))
    rows = ctx.density.table.shape[0]
    k5 = dict(name="prb_reverse[routed]", route="cuda", source=BWD_SOURCE,
              replaces="vpt_tpu/parallel/slab.py:279", max_abs_err=0.0, max_rel_l2=0.0, modes={})
    keep = None
    for stride, mode in MODES:
        phases = [TB._dispatch_phase(k, s, len(seeds), stride) for k, s in enumerate(seeds)]
        kw = dict(scatter_stride=stride, inv_mu=TB._inv_mu(ctx), resolution=res, streams=streams)
        slots = len(seeds) * (STEPS // stride)
        pairs = TB.pair_buffer(slots * n, dev)

        def carry():
            return dict(c=torch.zeros(n, device=dev), cb=torch.zeros(n, device=dev))

        def routed(buf=pairs):
            # a list is appended to: its count back to 0 (a 4-byte fill) each call
            TB.pair_views(buf)[0].zero_()
            cot = carry()
            TB.prb_reverse(tape, fields, g_rs, cot, {}, phases, seeds, scatter_mode=mode,
                           lanes=lanes, pairs=buf, **kw)
            return cot

        adj, cot = {"g_vol": torch.zeros((rows, 8), device=dev)}, carry()
        TB.prb_reverse(tape, fields, g_rs, cot, adj, phases, seeds, scatter_mode=mode, lanes=lanes,
                       **kw)
        cot_r = routed()
        got = KS.slab_scatter(torch.zeros((rows, 8), device=dev), 0, pairs, 1)
        plain_pairs = TB.pair_buffer(slots * n, dev)
        TB.prb_reverse_plain(tape, fields, g_rs, carry(), {}, phases, seeds,
                             importance=mode == "importance", lanes=lanes, pairs=plain_pairs, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(cot["c"], cot_r["c"]) and torch.equal(cot["cb"], cot_r["cb"])):
            raise AssertionError(f"K5 ROUTED {mode}{stride}: the carry != K5's")
        rel = rel_l2(got, adj["g_vol"])
        count = int(TB.pair_views(pairs)[0][0])
        p_count = int(TB.pair_views(plain_pairs)[0][0])
        ids, rws, upd = TB.pair_list(pairs)
        p_ids, p_rws, p_upd = TB.pair_list(plain_pairs)
        same = count == p_count and torch.equal(ids, p_ids) and torch.equal(rws, p_rws)
        rel_p = rel_l2(upd, p_upd) if same else float("inf")
        mabs = float((upd - p_upd).abs().sum(1).max()) if same and count else 0.0
        bits = same and torch.equal(upd.view(torch.int32), p_upd.view(torch.int32))
        if (not bits or rel > SLAB_BWD_RTOL or not float(adj["g_vol"].abs().max()) > 0):
            raise AssertionError(f"K5 ROUTED {mode}{stride}: + K29 vs K5 rel L2 {rel:.3g}; the list "
                                 f"vs plain: counts {count} / {p_count}, slot ids and rows equal "
                                 f"{same}, values bit for bit {bits} (rel L2 {rel_p:.3g})")
        rec = dict(rel_l2_vs_k5=rel, pairs_rel_l2_vs_plain=rel_p, max_abs=mabs, pairs=count,
                   slots=slots * n)
        k5["max_abs_err"] = max(k5["max_abs_err"], mabs)
        k5["max_rel_l2"] = max(k5["max_rel_l2"], rel_p)
        # K5 ROUTED and K5 adding the rows itself, on the same tape, in turns
        # (each call's host path, two small uploads, inside the events)
        acc = torch.zeros((rows, 8), device=dev)

        def atomic():
            TB.prb_reverse(tape, fields, g_rs, carry(), {"g_vol": acc}, phases, seeds,
                           scatter_mode=mode, lanes=lanes, **kw)

        turns = [(cuda_ms(routed, 5), cuda_ms(atomic, 5)) for _ in range(2)]
        rec["ms"] = min(t[0] for t in turns)
        rec["k5_atomic_ms"] = min(t[1] for t in turns)
        rec["turns_ms"] = turns
        rec["plain_ms"] = cuda_ms(lambda: TB.prb_reverse_plain(
            tape, fields, g_rs, carry(), {}, phases, seeds, importance=mode == "importance",
            lanes=lanes, pairs=TB.pair_buffer(slots * n, dev), **kw), 1)
        n_steps, n_fields = tape.shape[0] * tape.shape[1], tape.shape[2]
        read_fields = (n_fields if mode == "importance" or stride == 1
                       else 4 + (n_fields - 4) / stride)
        rec.update(bound(n_steps * n * read_fields * 4 + g_rs.numel() * 4 + 4 * n * 4
                         + 4 + rec["pairs"] * 40, n_steps * n * 8, rec["ms"]))
        k5["modes"][f"{mode}{stride}"] = rec
        log(f"# K5 ROUTED {mode} {stride}, 2 dispatches: the carry == K5's bit for bit, + K29 vs "
            f"K5's adjoint rel L2 {rel:.3g}; its list of {rec['pairs']} pairs (of {slots * n} "
            f"slots) == plain's sorted by slot, bit for bit; "
            f"{rec['ms']:.4f} ms vs {rec['plain_ms']:.4f} ms plain (K5 adding the rows itself "
            f"{rec['k5_atomic_ms']:.4f}; in turns, ms: {turns}); bound {rec['bound_ms']:.4f} ms "
            f"by {rec['bound_by']}, share {rec['bound_share']:.3f}")
        if stride == 1:
            keep = (pairs, got, adj["g_vol"])
    s1 = k5["modes"]["stride1"]
    k5["ms"], k5["plain_ms"] = s1["ms"], s1["plain_ms"]
    k5 = kernel_line(k5, {k: s1[k] for k in ("bound_ms", "bound_by", "bound_bytes", "bound_ops",
                                             "bound_share")})

    # K29 at n simulated owners, then one owner timed
    pairs, one, k5_adj = keep
    plane = ctx.density.dims[1] * ctx.density.dims[2]
    Dp = ctx.density.dims[0]
    err29 = 0.0
    for n_own in SLAB_OWNERS:
        per = -(-Dp // n_own) * plane
        total = torch.cat([KS.slab_scatter(torch.zeros((per, 8), device=dev), o * per, pairs, 1)
                           for o in range(n_own)])[:rows]
        r29 = rel_l2(total, one)
        err29 = max(err29, float((total - one).abs().max()))
        if r29 > SLAB_BWD_RTOL:
            raise AssertionError(f"K29 at {n_own} owners: their slabs vs one owner rel L2 {r29:.3g}")
    count, _, idx, upd = TB.pair_views(pairs)
    n_pairs = int(count[0])
    own_rows, own_upd = idx[:n_pairs].long(), upd[:n_pairs].contiguous()
    touched = int(torch.unique(own_rows).numel())
    acc = torch.zeros((rows, 8), device=dev)
    # K29 and index_add_ of the same list's pairs (its rows as int64, made
    # once), in turns
    turns29 = [(device_ms(lambda: KS.slab_scatter(acc, 0, pairs, 1)),
                device_ms(lambda: acc.index_add_(0, own_rows, own_upd))) for _ in range(3)]
    ms29, lib29 = (sorted(t[i] for t in turns29)[1] for i in (0, 1))
    plain29 = cuda_ms(lambda: KS.slab_scatter_plain(acc, 0, pairs, 1), 3)
    b29 = bound(4 + n_pairs * 36 + touched * 64, n_pairs * OPS_K29_PAIR, ms29)
    log(f"# K29 slab_scatter: n = {SLAB_OWNERS} owners' slabs == one owner's within rel L2 "
        f"{SLAB_BWD_RTOL}; one owner, a list of {n_pairs} pairs ({idx.numel()} slots, {touched} "
        f"rows touched): {ms29:.5f} ms (device, the median of 3 turns), plain {plain29:.4f} ms, "
        f"index_add_ of the list's pairs {lib29:.5f} ms (device; turns, ms: {turns29}); bound "
        f"{b29['bound_ms']:.5f} ms by {b29['bound_by']} ({b29['bound_bytes']} B), share "
        f"{b29['bound_share']:.3f}")
    k29 = kernel_line(dict(name="slab_scatter", route="cuda", source=SLAB_SOURCE,
                           replaces="vpt_tpu/parallel/slab.py:120", max_abs_err=err29, ms=ms29,
                           plain_ms=plain29, pair_slots=idx.numel(), pairs=n_pairs,
                           turns_ms=turns29), b29, library_ms=lib29)

    # K30 at n owners with the halos against K9, then one owner timed
    dims = tuple(d - 1 for d in ctx.density.dims)
    D, H, W = dims
    k9 = C.contract_volume(k5_adj, ctx.density.dims)
    err30 = 0.0
    for n_own in SLAB_OWNERS:
        slab_z = -(-Dp // n_own)
        padded = torch.cat([k5_adj, k5_adj.new_zeros((slab_z * n_own * plane - rows, 8))])
        total = torch.zeros((slab_z * n_own + 1, H, W), device=dev)
        for o in range(n_own):
            part = KS.slab_contract(padded[o * slab_z * plane:(o + 1) * slab_z * plane], o * slab_z,
                                    slab_z, dims)
            plain = KS.slab_contract_plain(padded[o * slab_z * plane:(o + 1) * slab_z * plane],
                                           o * slab_z, slab_z, dims)
            err30 = max(err30, float((part - plain).abs().max()))
            # raw plane lo - 1 + k lands at total[lo + k]; plane -1 is dropped
            total[o * slab_z:o * slab_z + slab_z + 1] += part
        r30 = rel_l2(total[1:D + 1], k9)
        if r30 > SLAB_BWD_RTOL:
            raise AssertionError(f"K30 at {n_own} owners with the halos vs K9: rel L2 {r30:.3g}")
    ms30 = device_ms(lambda: KS.slab_contract(k5_adj, 0, Dp, dims))
    plain30 = cuda_ms(lambda: KS.slab_contract_plain(k5_adj, 0, Dp, dims), 2)
    b30 = bound(rows * 32 + (Dp + 1) * H * W * 4, rows * OPS_K30_ROW, ms30)
    log(f"# K30 slab_contract: n = {SLAB_OWNERS} owners, the halos added, == K9 contract_volume "
        f"within rel L2 {SLAB_BWD_RTOL} (max abs vs plain {err30:.3g}); one owner {ms30:.5f} ms "
        f"(device), plain {plain30:.4f} ms; bound {b30['bound_ms']:.5f} ms by {b30['bound_by']} "
        f"({b30['bound_bytes']} B), share {b30['bound_share']:.3f}")
    k30 = kernel_line(dict(name="slab_contract", route="cuda", source=SLAB_SOURCE,
                           replaces="vpt_tpu/parallel/slab.py:160", max_abs_err=err30, ms=ms30,
                           plain_ms=plain30), b30)
    return k5, k29, k30


def slab_window_check(ctx, state0, mesh, dims, dev):
    """prb_window_grads_slab (SLAB_WINDOW dispatches) against
    prb_render_and_grads_many(window=True, window_storage="forward") from
    the same state at stride 1, stride 4 and importance 4: the image and
    the samples bit for bit, the density gradient within SLAB_BWD_RTOL;
    each window's ms (host clock, synchronised) beside the replicated
    one's."""
    from vpt_tpu_torch.kernels import spectral_backward as TB
    from vpt_tpu_torch.parallel import mesh as Mesh
    from vpt_tpu_torch.parallel import slab as TS

    sctx = slab_ctx(ctx, mesh)
    g_img = torch.ones(RES, RES, 3, device=dev)
    seeds = [2654435761 * k % 2**32 for k in range(11, 11 + SLAB_WINDOW)]
    out = {}
    for stride, mode in MODES:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, img, g = TS.prb_window_grads_slab(Mesh.shard_spectral_state(state0, mesh), sctx, mesh,
                                              dims, seeds, g_img, STEPS, BINS,
                                              scatter_stride=stride, scatter_mode=mode)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rs, ri, rg = TB.prb_render_and_grads_many(state0, ctx, seeds, g_img, STEPS, BINS,
                                                  wrt=SLAB_WRT, scatter_stride=stride,
                                                  scatter_mode=mode, window=True,
                                                  window_storage="forward")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rel = rel_l2(g["density"], rg["density"])
        if (not torch.equal(img.view(torch.int32), ri.view(torch.int32))
                or not torch.equal(st.samples, rs.samples) or rel > SLAB_BWD_RTOL
                or not float(rg["density"].abs().max()) > 0):
            raise AssertionError(f"prb_window_grads_slab {mode}{stride}: image equal "
                                 f"{torch.equal(img, ri)}, samples equal "
                                 f"{torch.equal(st.samples, rs.samples)}, density rel L2 {rel:.3g}")
        out[f"{mode}{stride}"] = dict(rel_l2=rel, max_abs=float((g["density"] - rg["density"])
                                                                .abs().max()),
                                      slab_ms=(t1 - t0) * 1e3, replicated_ms=(t2 - t1) * 1e3)
        log(f"# prb_window_grads_slab {mode} {stride}, {SLAB_WINDOW} dispatches: the image and the "
            f"samples == the replicated forward-storage window's bit for bit, the density rel L2 "
            f"{rel:.3g}; {(t1 - t0) * 1e3:.2f} ms against {(t2 - t1) * 1e3:.2f} ms replicated")
    return out


def slab_fit_profile():
    """One fit_spectral_slab iteration of the bench scene (SLAB_WINDOW
    dispatches) at world size 1 under torch.profiler, after a warm-up
    iteration: the device work by kernel name (ms and launches an
    iteration), its device ms, the profiled host ms. Run in a fresh
    process (``fresh_result``)."""
    from torch.profiler import ProfilerActivity, profile

    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu_torch.parallel import mesh as Mesh
    from vpt_tpu_torch.parallel import slab as TS
    from vpt_tpu_torch.tools.profile_fit import device_kernels

    dev = torch.device("cuda:0")
    mesh = Mesh.ray_mesh(device=dev)
    args = bench_scene_args()
    cam = Camera()
    r = MCMSpectralRenderer(*args, resolution=RES, streams=STREAMS,
                            pack_tables={"material_tf", "light_spectrum"}, mesh=mesh, device=dev)
    target = torch.full((RES, RES, 3), 0.1, device=dev)
    init = smoothed(args[0].density, max(VOLUME // 16, 2))
    kw = dict(dispatches_per_step=SLAB_WINDOW, learning_rate=0.02, seed=1, scatter_stride=1)
    TS.fit_spectral_slab(target, r, cam, init, mesh, iterations=1, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        TS.fit_spectral_slab(target, r, cam, init, mesh, iterations=1, **kw)
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    kernels = device_kernels(prof)
    torch.distributed.destroy_process_group()
    return dict(kernels=kernels, device_ms=sum(k["ms"] for k in kernels.values()),
                profiled_host_ms=host * 1e3)


def slab_sparse_fit(renderer, cam, dev):
    """Phase 27 (c): one fit_spectral_slab iteration (SLAB_WINDOW
    dispatches) over the sparse 512^3 scene's raw f32 grid (phase 11's
    volume, the fused TF, no majorant grid: the packed backward has none),
    the size the slab exists for (its f32 slab 513^3 x 8 x 4 B): its
    seconds, peak device memory, the launches and a finite loss and
    gradient step."""
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu_torch.parallel import mesh as Mesh
    from vpt_tpu_torch.parallel import slab as TS

    t0 = time.perf_counter()
    mesh = Mesh.ray_mesh(device=dev)
    r = MCMSpectralRenderer(renderer.volume, renderer.material_tf, renderer.light,
                            renderer.spectrum, renderer.config, resolution=RES, streams=STREAMS,
                            pack_tables={"material_tf", "light_spectrum"}, mesh=mesh, device=dev)
    init = r.ctx(cam, 3).density * 0.8
    target = torch.full((RES, RES, 3), 0.05, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    t1 = time.perf_counter()
    params, losses = TS.fit_spectral_slab(target, r, cam, init, mesh,
                                          dispatches_per_step=SLAB_WINDOW, iterations=1,
                                          learning_rate=0.02, seed=3)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in all_launches().items() if v}
    d = params["density"]
    moved = float((d - init).abs().max())
    if not (np.isfinite(losses).all() and bool(torch.isfinite(d).all()) and moved > 0
            and launches.get("slab.slab_pack") == 1 and launches.get("slab.slab_contract") == 1
            and launches.get("slab.slab_scatter") == SLAB_WINDOW):
        raise AssertionError(f"the sparse slab fit: losses {losses}, moved {moved}, launches "
                             f"{launches}")
    slab_bytes = (d.shape[0] + 1) * (d.shape[1] + 1) * (d.shape[2] + 1) * 32
    torch.distributed.destroy_process_group()
    del r, params, init
    torch.cuda.empty_cache()
    rec = dict(seconds_per_iteration=dt, peak_memory_bytes=peak, f32_slab_bytes=slab_bytes,
               loss=losses[0], max_param_change=moved, launches=launches,
               set_up_seconds=t1 - t0)
    log(f"# phase 27 (c): fit_spectral_slab over the sparse {SPARSE}^3 raw grid (fused TF, world "
        f"size 1, its f32 slab {slab_bytes} B), 1 iteration of {SLAB_WINDOW} dispatches: "
        f"{dt:.3f} s, peak device memory {peak} B, loss {losses[0]:.6g}, max param change "
        f"{moved:.3g}; launches {launches}")
    return rec


def phase_slab_backward(dev, sparse_fit):
    """Phase 27: the slab-sharded PRB backward and optimizer (B14b) at world
    size 1 on a one-process NCCL group, the bench scene: (a) the taped slab
    dispatch == K4 bit for bit (default, quasicubic, environment), K27 with
    every lane's request and K28 TAPE per launch; K31 == K10's padded table
    at n = 1, 2, 4, 8 owners; K5 ROUTED + K29 == K5, K29 and K30 at n owners
    (``slab_routed_check``); the window against the replicated one in three
    modes; (b) the main path: fit_spectral_slab, SLAB_FIT_ITERS iterations
    of SLAB_WINDOW dispatches, the counts set to 0 just before, against
    fit_spectral(method="prb", scatter_stride=1); the collectives and
    launches an iteration, seconds an iteration, peak memory, the busy
    share from a fresh process's profile. (c) ran beside phase 11."""
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu_torch.optim import fit_spectral
    from vpt_tpu_torch.parallel import mesh as Mesh
    from vpt_tpu_torch.parallel import slab as TS

    t_phase = time.perf_counter()
    split = {}

    def timed(step, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        split[step] = split.get(step, 0.0) + time.perf_counter() - t0
        return out

    mesh = Mesh.ray_mesh(device=dev)
    cam = Camera()
    args = bench_scene_args()
    r = MCMSpectralRenderer(*args, resolution=RES, streams=STREAMS, device=dev)
    ctx, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    dims = r.volume.density.shape
    seed = 2654435761 * 5 % 2**32
    timed("tape checks", slab_tape_check, "default", ctx, s0, mesh, dims, seed)
    timed("tape checks", slab_tape_check, "quasicubic",
          dataclasses.replace(ctx, volume_filter="quasicubic"), s0, mesh, dims, seed)
    env_r = MCMSpectralRenderer(*args, resolution=RES, streams=STREAMS,
                                environment=seeded_envmap(), device=dev)
    timed("tape checks", slab_tape_check, "environment", env_r.ctx(cam, 7), env_r.reset(cam, 7),
          mesh, dims, seed)
    del env_r
    k27t, k28t = timed("K27/K28 tape timing", slab_tape_entries, ctx, s0, mesh, dims)
    raw = torch.as_tensor(smoothed(args[0].density, max(VOLUME // 16, 2)), device=dev)
    k31 = timed("K31", slab_pack_check, raw)
    k5r, k29, k30 = timed("K5 ROUTED, K29, K30", slab_routed_check, ctx, s0, mesh, dev)
    windows = timed("windows", slab_window_check, ctx, s0, mesh, dims, dev)
    torch.cuda.empty_cache()

    # (b) the main path against the replicated fit
    st = r.reset(cam, 99)
    st, target = r.render_many(st, cam, [2654435761 * k % 2**32 for k in range(100, 116)])
    init = raw.cpu().numpy()
    kw = dict(dispatches_per_step=SLAB_WINDOW, iterations=SLAB_FIT_ITERS, learning_rate=0.02,
              seed=1, scatter_stride=1)
    ref_params, ref_losses = timed("replicated fit", fit_spectral, target, r, cam,
                                   {"density": init}, method="prb", **kw)
    del st
    torch.cuda.empty_cache()
    rs = MCMSpectralRenderer(*args, resolution=RES, streams=STREAMS,
                             pack_tables={"material_tf", "light_spectrum"}, mesh=mesh, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    Mesh.reset_collective_counts()
    t0 = time.perf_counter()
    params, losses = TS.fit_spectral_slab(target, rs, cam, init, mesh, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    split["the main path"] = dt
    peak = torch.cuda.max_memory_allocated()
    # the renderer's reset (K2 over the rank's lane table) aside
    launches = {k: v for k, v in all_launches().items()
                if v and not k.startswith("mcm_spectral.reset")}
    coll = dict(Mesh.COLLECTIVES)
    n, W, S = SLAB_FIT_ITERS, SLAB_WINDOW, STEPS
    want = {"slab.slab_pack": n, "slab.slab_advance": 2 * n * W * S,
            "slab.slab_advance_tape": n * W * S, "slab.slab_rows": 2 * n * W * S,
            "slab.slab_finish": 2 * n * W * S, "slab.slab_finish_tape": n * W * S,
            "spectral_backward.prb_reverse": n * W, "spectral_backward.prb_reverse_routed": n * W,
            "slab.slab_scatter": n * W, "slab.slab_contract": n}
    want_coll = {"all_gather": n * (2 * W * S + W), "reduce_scatter": n * 2 * W * S,
                 "gather_rows": n, "halo": n, "all_reduce": n}
    if launches != want or coll != want_coll:
        raise AssertionError(f"fit_spectral_slab x {n}: launches {launches} (want {want}), "
                             f"collectives {coll} (want {want_coll})")
    d, ref_d = params["density"], ref_params["density"]
    loss_rel = np.abs(np.asarray(losses) - np.asarray(ref_losses)) / np.abs(ref_losses)
    close = bool(torch.allclose(d, ref_d, rtol=5e-4, atol=5e-6))
    moved = float((d - raw).abs().max())
    if not ((loss_rel <= 1e-4).all() and close and moved > 0 and np.isfinite(losses).all()):
        raise AssertionError(f"fit_spectral_slab vs fit_spectral(prb): losses {losses} vs "
                             f"{ref_losses}, params close {close} (max abs "
                             f"{float((d - ref_d).abs().max()):.3g}), moved {moved}")
    log(f"# fit_spectral_slab (world size 1, NCCL), {n} iterations x {W} dispatches: "
        f"{dt / n:.4f} s an iteration, peak device memory {peak} B; losses {losses} against "
        f"fit_spectral(method='prb', scatter_stride=1)'s {ref_losses} (rel at most "
        f"{loss_rel.max():.2e}), params within rtol 5e-4 / atol 5e-6 (max abs "
        f"{float((d - ref_d).abs().max()):.3g}); per iteration launches "
        f"{ {k: v / n for k, v in launches.items()} }, collectives "
        f"{ {k: v / n for k, v in coll.items()} }")
    del rs, params, ref_params
    torch.cuda.empty_cache()
    prof = timed("the profile", fresh_result, "slab_fit_profile")
    it_ms = dt / n * 1e3
    busy = prof["device_ms"] / it_ms
    coll_ms = sum(k["ms"] for name, k in prof["kernels"].items()
                  if "nccl" in name.lower() or "memcpy" in name.lower())
    log(f"# profiled fit_spectral_slab iteration (a fresh process): device {prof['device_ms']:.3f} "
        f"ms of {it_ms:.3f} ms unprofiled (busy {busy:.3f}, the host's share {1 - busy:.3f}); "
        f"the collectives {coll_ms:.3f} ms; " + ", ".join(
            f"{nm} {k['ms']:.4f} ms x{k['launches']:g}" for nm, k in sorted(
                prof["kernels"].items(), key=lambda kv: -kv[1]["ms"])[:12]))
    torch.distributed.destroy_process_group()
    for e, key in ((k27t, "slab.slab_advance_tape"), (k28t, "slab.slab_finish_tape"),
                   (k5r, "spectral_backward.prb_reverse_routed"), (k29, "slab.slab_scatter"),
                   (k30, "slab.slab_contract"), (k31, "slab.slab_pack")):
        e["launches"] = launches[key]
        e["launches_of"] = "the main path (fit_spectral_slab, 3 iterations)"
    total = time.perf_counter() - t_phase
    split["other"] = total - sum(split.values())
    log(f"# phase 27 (the slab backward): {total:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in split.items()))
    return ([k27t, k28t, k5r, k29, k30, k31],
            dict(windows=windows, fit=dict(losses=losses, replicated_losses=ref_losses,
                                           seconds_per_iteration=dt / n, peak_memory_bytes=peak,
                                           launches_per_iteration={k: v / n for k, v in
                                                                   launches.items()},
                                           collectives_per_iteration={k: v / n for k, v in
                                                                      coll.items()}),
                 profile=prof, device_busy_share=busy, collective_ms=coll_ms,
                 sparse_512=sparse_fit, seconds=split))


def fresh_result(fn, *args):
    """``chip_smoke.<fn>(*args)``, a profile, in one fresh process (PERF.md
    question 10): its JSON result."""
    code = ("import json, torch, chip_smoke as CS\n"
            f"print(json.dumps(CS.{fn}(*{args!r})))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"the profiling process exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if not out["device_ms"] > 0:
        raise AssertionError(f"{fn}: the profiler saw no device time")
    return out


def launch_counts():
    from vpt_tpu_torch.kernels import corners as C
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import surrogate as S

    return {**K.LAUNCHES, **S.LAUNCHES, **C.LAUNCHES}


def reset_counts():
    from vpt_tpu_torch.kernels import corners as C
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import spectral_backward as TB
    from vpt_tpu_torch.kernels import surrogate as S

    for mod in (K, S, C, TB):
        mod.reset_launch_counts()


def autodiff_fit(label, target, renderer, camera, init, dev,
                 need=("contract_corners", "pack_corners"), **kw):
    """fit_spectral with the surrogate: FIT_ITERS iterations of CHUNK
    dispatches from ``init`` (a density, or a dict of learned tables), the
    launch counts set to 0 just before; checks the launches (per iteration
    one K4 surrogate sweep and one K12 and each of ``need``, K9 and K10 for
    a learned density, and no K1 inside the loss), finite losses and moved
    params."""
    from vpt_tpu_torch import optim as TO

    loss_fn = TO.spectral_render_loss
    inside_loss = []

    def counted_loss(*a, **kw):
        before = launch_counts()
        out = loss_fn(*a, **kw)
        after = launch_counts()
        inside_loss.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        return out

    reset_counts()
    TO.spectral_render_loss = counted_loss
    try:
        t0 = time.perf_counter()
        params, losses, info = TO.fit_spectral(target, renderer, camera, init,
                                               dispatches_per_step=CHUNK, iterations=FIT_ITERS,
                                               learning_rate=0.02, seed=1, return_info=True, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        TO.spectral_render_loss = loss_fn
    launches = launch_counts()
    require_launches(launches, ("surrogate_tape_forward", "surrogate_reverse", *need),
                     f"fit_spectral ({label})")
    per_iteration = (launches["surrogate_tape_forward"] == FIT_ITERS
                     and launches["surrogate_reverse"] == FIT_ITERS
                     and all(launches[k] >= FIT_ITERS for k in need))
    if (not per_iteration or len(inside_loss) != FIT_ITERS
            or any(d.get("step", 0) != 0 or d.get("surrogate_tape_forward", 0) != 1
                   for d in inside_loss)):
        raise AssertionError(f"fit_spectral ({label}): launches {launches}, inside each loss "
                             f"{inside_loss}; want one K4 surrogate sweep and one K12 per "
                             f"iteration and no K1 inside the loss")
    moved = max(float((params[k] - torch.as_tensor(np.asarray(v, np.float32), device=dev))
                      .abs().max()) for k, v in init.items())
    if (info["method"] != "autodiff" or not np.isfinite(losses).all() or moved == 0.0
            or not all(bool(torch.isfinite(p).all()) for p in params.values())):
        raise AssertionError(f"fit_spectral ({label}): method {info['method']}, losses {losses}, "
                             f"params moved {moved}")
    rec = dict(losses=losses, seconds=dt, seconds_per_iteration=dt / FIT_ITERS,
               max_param_change=moved, launches={k: v for k, v in launches.items() if v},
               launches_inside_each_loss=inside_loss)
    log(f"# fit_spectral autodiff ({label}): {FIT_ITERS} iterations x {CHUNK} dispatches in "
        f"{dt:.4f} s ({dt / FIT_ITERS:.4f} s per iteration); losses {losses}; max param change "
        f"{moved:.4g}; launches {rec['launches']}, inside each loss {inside_loss[0]}")
    return params, rec


def surrogate_window(renderer, camera, dev, init):
    """One K = 4 window of the surrogate, wrt={density}: the whole
    fwd+bwd (the re-pack, render_sequence_diff, the MSE loss, the backward
    and the contraction) by CUDA events under each schedule, "tape" (one K4
    surrogate sweep, one K12) and "forward" (K1 per dispatch, then a re-tape
    and a K12 per dispatch), whose gradients agree within 1e-4; then the
    tape schedule's pieces: the taped sweep (K4's surrogate mode over the 4
    dispatches, one launch), K12 over that tape, and K9 on the packed
    volume adjoint."""
    from vpt_tpu_torch.kernels import corners as C
    from vpt_tpu_torch.kernels import surrogate as S
    from vpt_tpu_torch.models.mcm_spectral import render_sequence_diff

    ctx = renderer.ctx(camera, 1)
    state = renderer.reset(camera, 1)
    seeds = [(7 + k) * 2654435761 % 2**32 for k in range(CHUNK)]
    target = torch.zeros(RES, RES, 3, device=dev)
    dens = torch.as_tensor(init, device=dev)

    def window(storage):
        d = dens.clone().requires_grad_(True)
        vol = dataclasses.replace(ctx.density, table=C.pack_volume_diff(d))
        img = render_sequence_diff(seeds, state, dataclasses.replace(ctx, density=vol), STEPS,
                                   BINS, window_storage=storage)
        return torch.autograd.grad(torch.mean((img - target) ** 2), [d])[0]

    g_tape, g_fwd = window("tape"), window("forward")
    rel = float((g_tape - g_fwd).norm() / g_fwd.norm().clamp_min(1e-30))
    if not bool(torch.isfinite(g_tape).all()) or float(g_fwd.norm()) == 0.0 or rel > 1e-4:
        raise AssertionError(f"surrogate window: the two schedules' gradients differ by rel L2 "
                             f"{rel:.3g}")
    del g_tape, g_fwd
    rec = dict(window_ms=cuda_ms(lambda: window("tape"), 3),
               forward_schedule_window_ms=cuda_ms(lambda: window("forward"), 3),
               schedules_rel_l2=rel)
    fctx = dataclasses.replace(ctx, density=dataclasses.replace(
        ctx.density, table=C.pack_volume(dens)))
    _, tape = S.tape_forward(state, fctx, seeds, STEPS, BINS)
    rec["taped_sweep_ms"] = cuda_ms(lambda: S.tape_forward(state, fctx, seeds, STEPS, BINS), 3)
    sf, _ = S.tape_forward(state, fctx, seeds, STEPS, BINS)
    n = state.px.numel()
    carry0, _ = sur_adjoints(fctx, n, BINS, 5)
    adj = {"g_vol": torch.zeros(fctx.density.table.shape, device=dev)}
    calls = iter([copy_carry(carry0) for _ in range(4)])
    rec["k12_ms"] = cuda_ms(lambda: S.reverse(tape, S.fields(False), sf.samples, next(calls), adj,
                                              fctx, BINS), 3)
    rec["k9_ms"] = device_ms(lambda: C.contract_volume(adj["g_vol"], fctx.density.dims))
    rec["tape_bytes"] = tape.numel() * 4
    log(f"# surrogate window (K = {CHUNK}, wrt={{density}}): {rec['window_ms']:.3f} ms fwd+bwd "
        f"under \"tape\", {rec['forward_schedule_window_ms']:.3f} ms under \"forward\" "
        f"(gradients within rel L2 {rel:.3g}); taped sweep {rec['taped_sweep_ms']:.3f} ms, K12 "
        f"{rec['k12_ms']:.3f} ms, K9 {rec['k9_ms']:.4f} ms (device); tape {rec['tape_bytes']} B")
    return rec


def phase_autodiff_fit(camera, dev, prb_windows, sparse_scene_):
    """Phase 17: fit_spectral(method="autodiff") at full width on the bench
    scene, the default routing on the sparse 512^3 majorant scene (phase
    11's renderer and camera, ``sparse_scene_``: its volume takes ~30 s of
    host set-up to build), a surrogate window split beside phase 9's PRB
    stride-1 window, and a checkpoint save and resume."""
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu_torch.session import RenderSession

    args = bench_scene_args()
    session = RenderSession("mcm-spectral", *args, resolution=RES, streams=STREAMS, device=dev)
    session.run(64)
    target = session.hdr_image()
    del session
    renderer = MCMSpectralRenderer(*args, resolution=RES, streams=STREAMS, device=dev)
    init = smoothed(args[0].density, max(VOLUME // 16, 2))
    out = {}
    params, out["bench"] = autodiff_fit("bench scene", target, renderer, camera,
                                        {"density": init}, dev, method="autodiff")
    out["window"] = surrogate_window(renderer, camera, dev, init)
    out["window"]["prb_stride1_window_ms"] = prb_windows["stride1"]["window_ms"]

    # the env-lit bench scene with the majorant grid, method=None: routed to
    # the surrogate (the majorant mode's one gradient path)
    env = seeded_envmap()
    session = RenderSession("mcm-spectral", *args, resolution=RES, streams=STREAMS,
                            environment=env, majorant_blocks=16, device=dev)
    session.run(64)
    target_env = session.hdr_image()
    del session
    env_maj = MCMSpectralRenderer(*args, resolution=RES, streams=STREAMS, environment=env,
                                  majorant_blocks=16, device=dev)
    _, out["env_majorant"] = autodiff_fit("env-lit bench scene, majorant, method=None",
                                          target_env, env_maj, camera, {"density": init}, dev)
    require_launches(out["env_majorant"]["launches"],
                     ("surrogate_tape_forward_environment_majorant",
                      "surrogate_reverse_environment_majorant"), "the env-lit majorant fit")
    del env_maj

    # checkpoint: 2 iterations saved, then resumed to 3, against the 3 above
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inverse.npz")
        from vpt_tpu_torch.optim import fit_spectral

        kw = dict(dispatches_per_step=CHUNK, learning_rate=0.02, seed=1, method="autodiff",
                  checkpoint=path)
        fit_spectral(target, renderer, camera, {"density": init}, iterations=FIT_ITERS - 1, **kw)
        resumed, losses = fit_spectral(target, renderer, camera, {"density": init},
                                       iterations=FIT_ITERS, **kw)
    straight = out["bench"]["losses"][-1]
    rel_loss = abs(losses[0] - straight) / abs(straight)
    dp = resumed["density"] - params["density"]
    rel_params = float(dp.abs().max()) / max(float(params["density"].abs().max()), 1e-30)
    ok = len(losses) == 1 and rel_loss <= 1e-4 and torch.allclose(
        resumed["density"], params["density"], rtol=5e-4, atol=5e-6)
    out["checkpoint"] = dict(resumed_loss=losses, straight_loss=straight, loss_rel=rel_loss,
                             params_max_rel=rel_params, ok=bool(ok))
    log(f"# checkpoint after iteration {FIT_ITERS - 1}, resumed: loss {losses} vs straight "
        f"{straight} (rel {rel_loss:.3g}), params max rel {rel_params:.3g} (K12's atomics make "
        f"runs differ by rounding)")
    if not ok:
        raise AssertionError(f"resumed trajectory differs: {out['checkpoint']}")
    del renderer, params, resumed
    torch.cuda.empty_cache()
    out["raw"] = raw_bench_fit(args, target, init, camera, dev)

    # the sparse 512^3 majorant scene, method=None: routed to the surrogate
    sparse, cam = sparse_scene_
    _, sparse_target = sparse.render_many(sparse.reset(cam, 3), cam,
                                          [(3 + k) * 2654435761 % 2**32 for k in range(16)])
    sparse_init = np.clip(smoothed(sparse.volume.density, 16) * 0.8 + 0.05, 0.0, 1.0)
    torch.cuda.reset_peak_memory_stats()
    _, out["sparse"] = autodiff_fit("sparse 512^3, majorant, method=None", sparse_target, sparse,
                                    cam, {"density": sparse_init}, dev)
    out["sparse"]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    log(f"# sparse autodiff fit: peak device memory {out['sparse']['peak_memory_bytes']} B")
    out["sparse_raw"] = sparse_raw_fit(sparse, cam, sparse_target, dev)
    xy, out["sparse_xy"] = sparse_xy_window(sparse, cam, sparse_target, sparse_init, dev)
    del sparse
    torch.cuda.empty_cache()
    out["sparse_xy"]["fit"] = sparse_xy_fit(xy, cam, sparse_target, sparse_init, dev)
    del xy
    torch.cuda.empty_cache()
    return out


def raw_fit_record(label, rec, r, cam, init, dev):
    """A raw fit's record completed: its RAW launches required, its peak
    memory (from the fit's start) and its window's device pieces."""
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    require_launches(rec["launches"], ("surrogate_tape_forward_raw", "surrogate_reverse_raw"),
                     label)
    seeds = [(11 + k) * 2654435761 % 2**32 for k in range(CHUNK)]
    rec["split"] = raw_window_split(r, cam, init, seeds, dev)
    log(f"# {label}: {rec['seconds_per_iteration']:.4f} s per iteration, peak device memory "
        f"{rec['peak_memory_bytes']} B; one window's pieces (ms, CUDA events): "
        + ", ".join(f"{k} {v:.4f}" for k, v in rec["split"].items()))
    return rec


def raw_bench_fit(args, target, init, camera, dev):
    """Phase 17, raw: fit_spectral with method=None on the fully raw bench
    scene (pack_tables=False: the 128^3 f32 grid, the raw TF and light),
    learning the density, which the loss packs into the full corner table
    (K10, K9 backward) as the reference's does: routed to the surrogate,
    one K4s RAW sweep and one K12 RAW launch per iteration."""
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    raw = MCMSpectralRenderer(*args, resolution=RES, streams=STREAMS, pack_tables=False,
                              device=dev)
    label = "bench scene, raw tables, method=None"
    torch.cuda.reset_peak_memory_stats()
    _, rec = autodiff_fit(label, target, raw, camera, {"density": init}, dev)
    rec = raw_fit_record(label, rec, raw, camera, {"density": init}, dev)
    del raw
    torch.cuda.empty_cache()
    return rec


def sparse_raw_fit(sparse, cam, target, dev):
    """Phase 17, sparse raw: fit_spectral with method=None on phase 18's
    sparse 512^3 renderer (pack_tables={"material_tf", "light_spectrum"}:
    the raw 537 MB f32 grid beside the fused TF) with the full renderer's
    majorant grid (majorant_blocks=16), learning the TF and the extinction:
    routed to the surrogate, whose loss packs the learned TF into the
    16-wide table beside the light's pair table, as the reference's does;
    one K4s RAW+majorant sweep and one K12 RAW launch per iteration."""
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    raw = MCMSpectralRenderer(sparse.volume, sparse.material_tf, sparse.light, sparse.spectrum,
                              sparse.config, resolution=RES, streams=STREAMS,
                              pack_tables=RAW_LAYOUTS[1][1], device=dev)
    raw.majorant = sparse.majorant
    table = np.asarray(sparse.material_tf.table, np.float32)
    init = {"material_tf": np.clip(table * 0.8 + 0.1, 0.0, 1.0).astype(np.float32),
            "extinction": np.float32(30.0)}
    label = f"sparse {SPARSE}^3 raw grid + fused TF, majorant, method=None (TF, extinction)"
    torch.cuda.reset_peak_memory_stats()
    _, rec = autodiff_fit(label, target, raw, cam, init, dev, need=())
    per_iteration = ("surrogate_tape_forward_raw", "surrogate_tape_forward_majorant",
                     "surrogate_reverse_raw")
    if any(rec["launches"].get(k, 0) != FIT_ITERS for k in per_iteration):
        raise AssertionError(f"{label}: launches {rec['launches']}; want each of "
                             f"{per_iteration} once per iteration")
    rec = raw_fit_record(label, rec, raw, cam, init, dev)
    del raw
    torch.cuda.empty_cache()
    return rec


def raw_window_split(r, cam, init, seeds, dev):
    """Where a raw fit's window goes on ``r``'s tables, each piece by CUDA
    events: the learned tables packed as the loss packs them (pack), the
    taped sweep (K4s RAW), K12 RAW over that tape into the learned tables'
    adjoints, and the packers' backward from those adjoints to the raw
    gradients (unpack: K9 for a density, torch ops for a TF)."""
    from vpt_tpu_torch import optim as TO
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import surrogate as S

    base = dataclasses.replace(r.ctx(cam, 1), volume_filter="linear")
    state = r.reset(cam, 1)
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev).requires_grad_(True)
              for k, v in init.items()}
    rec = dict(pack_ms=cuda_ms(lambda: TO.pack_loss_ctx(params, base), 3))
    ctx = TO.pack_loss_ctx(params, base)
    tables = {k: t for k, t in (("g_vol", K.density_table(ctx)), ("g_tf", ctx.material_tf),
                                ("g_light", ctx.light_spectrum), ("g_env", ctx.environment))
              if t is not None and t.requires_grad}
    rec["taped_sweep_ms"] = cuda_ms(lambda: S.tape_forward(state, ctx, seeds, STEPS, BINS), 3)
    end, tape = S.tape_forward(state, ctx, seeds, STEPS, BINS)
    carry0, _ = sur_adjoints(ctx, state.px.numel(), BINS, 5)
    adj = S.zero_adjoints(ctx, [*tables, *(["g_ext"] if "extinction" in params else [])])
    calls = iter([copy_carry(carry0) for _ in range(4)])
    rec["k12_ms"] = cuda_ms(lambda: S.reverse(tape, S.fields(ctx.majorant is not None),
                                              end.samples, next(calls), adj, ctx, BINS), 3)
    outs = list(tables.values())
    g_outs = [adj[k].reshape(t.shape) for k, t in tables.items()]
    leaves = [v for k, v in params.items() if k != "extinction"]
    rec["unpack_ms"] = cuda_ms(lambda: torch.autograd.grad(outs, leaves, g_outs,
                                                           retain_graph=True), 3)
    return rec


def sparse_xy_window(sparse, cam, target, init, dev):
    """Phase 17, xy: the sparse 512^3 scene's xy table (half the full
    table's bytes) with the same majorant blocks, and one window's
    contracted density gradient (spectral_render_loss, K = CHUNK) over it
    against the full table's on the same raw grid (relative L2 <= 1e-4:
    the same terms, summed through other rows and K12's atomics; the loss
    equal). Returns (the xy renderer, the record)."""
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu_torch.optim import spectral_render_loss

    t0 = time.perf_counter()
    xy = MCMSpectralRenderer(sparse.volume, sparse.material_tf, sparse.light, sparse.spectrum,
                             sparse.config, resolution=RES, streams=STREAMS,
                             majorant_blocks=SPARSE_BLOCKS, pack_tables=XY_TABLES, device=dev)
    out = dict(set_up_s=time.perf_counter() - t0, table_bytes_xy=xy.vol_table.numel(),
               table_bytes_full=sparse.vol_table.numel())
    seeds = [(11 + k) * 2654435761 % 2**32 for k in range(CHUNK)]

    def window_grad(r):
        ctx = dataclasses.replace(r.ctx(cam, 1), volume_filter="linear")
        d = torch.as_tensor(init, device=dev).requires_grad_(True)
        loss = spectral_render_loss({"density": d}, r.reset(cam, 1), ctx, seeds, target, STEPS,
                                    BINS)
        return float(loss.detach()), torch.autograd.grad(loss, [d])[0]

    (loss_f, g_full), (loss_x, g_xy) = window_grad(sparse), window_grad(xy)
    rel = float((g_xy - g_full).norm() / g_full.norm().clamp_min(1e-30))
    if loss_x != loss_f or not bool(torch.isfinite(g_xy).all()) or rel > 1e-4:
        raise AssertionError(f"sparse window over xy vs the full table: loss {loss_x} vs "
                             f"{loss_f}, density gradient rel L2 {rel:.3g}")
    out.update(window_loss=loss_x, window_grad_rel_l2=rel)
    log(f"# sparse {SPARSE}^3 surrogate window (K = {CHUNK}) over xy ({out['table_bytes_xy']} B "
        f"table) vs the full table ({out['table_bytes_full']} B): loss equal ({loss_x:.6g}), "
        f"contracted density gradient rel L2 {rel:.3g}")
    del g_full, g_xy
    out["split"] = {which: sparse_window_split(r, cam, init, seeds, dev)
                    for which, r in (("full", sparse), ("xy", xy))}
    log(f"# sparse {SPARSE}^3 window split, full vs xy (ms, CUDA events): " + "; ".join(
        f"{k} {out['split']['full'][k]:.4f} vs {out['split']['xy'][k]:.4f}"
        for k in out["split"]["full"]))
    return xy, out


def sparse_window_split(r, cam, init, seeds, dev):
    """Where a sparse fit's window goes on ``r``'s table: the re-pack of
    the learned f32 density (K10), the taped sweep over the window (K4's
    surrogate mode), K12 over that tape with wrt={density}, and the
    contraction of its adjoint (K9), each by CUDA events."""
    from vpt_tpu_torch.kernels import corners as C
    from vpt_tpu_torch.kernels import surrogate as S

    dens = torch.as_tensor(init, device=dev)
    base = r.ctx(cam, 1)
    kind, state = base.density.kind, r.reset(cam, 1)
    rec = dict(k10_ms=cuda_ms(lambda: C.pack_volume(dens, kind), 3))
    ctx = dataclasses.replace(base, volume_filter="linear", density=dataclasses.replace(
        base.density, table=C.pack_volume(dens, kind)))
    rec["taped_sweep_ms"] = cuda_ms(lambda: S.tape_forward(state, ctx, seeds, STEPS, BINS), 3)
    end, tape = S.tape_forward(state, ctx, seeds, STEPS, BINS)
    carry0, _ = sur_adjoints(ctx, state.px.numel(), BINS, 5)
    adj = {"g_vol": torch.zeros(ctx.density.table.shape, device=dev)}
    calls = iter([copy_carry(carry0) for _ in range(4)])
    rec["k12_ms"] = cuda_ms(lambda: S.reverse(tape, S.fields(ctx.majorant is not None),
                                              end.samples, next(calls), adj, ctx, BINS), 3)
    rec["k9_ms"] = cuda_ms(lambda: C.contract_volume(adj["g_vol"], ctx.density.dims, kind), 3)
    return rec


def sparse_xy_fit(xy, cam, target, init, dev):
    """fit_spectral with method=None on the sparse xy renderer with its
    majorant grid, learning an f32 density: routed to the surrogate over
    xy, one K4 xy+majorant sweep and one K12 xy launch, K10 pack_volume_xy
    and K9 contract_volume_xy each iteration; peak device memory from the
    fit's start."""
    torch.cuda.reset_peak_memory_stats()
    _, rec = autodiff_fit(f"sparse {SPARSE}^3 xy, majorant, method=None", target, xy, cam,
                          {"density": init}, dev)
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    per_iteration = ("surrogate_tape_forward_xy", "surrogate_tape_forward_majorant",
                     "surrogate_reverse_xy", "contract_corners_xy", "pack_corners_xy")
    if any(rec["launches"].get(k, 0) != FIT_ITERS for k in per_iteration):
        raise AssertionError(f"sparse xy fit: launches {rec['launches']}; want each of "
                             f"{per_iteration} once per iteration")
    log(f"# sparse xy autodiff fit: peak device memory {rec['peak_memory_bytes']} B")
    return rec


def phase_gather(dev):
    """The gather tool's own path: exact on ragged shapes and at every size
    of the TPU tools at L and 16 L lookups, with K7's plan, timed by host
    path and by device time (CUDA-graph replay)."""
    from vpt_tpu_torch.tools import gather_bench as G

    with torch.cuda.device(dev):
        limits = G.device_limits()
    log(f"# gather tool: card limits {json.dumps(limits)}")
    for name in G.check_ragged(dev):
        log(f"# gather exact: {name}")
    G.reset_launch_counts()
    rows = G.run(dev)
    launches = dict(G.LAUNCHES)
    for r in rows:
        log(f"# {r['name']}, {r['lookups']} lookups: exact; plan {json.dumps(r['plan'])}; device "
            f"{r['ms']:.5f} ms kernel vs {r['plain_ms']:.5f} plain "
            f"({r['glookups_per_s']:.2f} vs {r['plain_glookups_per_s']:.2f} Glookups/s); host path "
            f"{r['host_ms']:.5f} vs {r['plain_host_ms']:.5f} ms")
    per_size = len(G.SIZES)
    if (launches["gather_scalar"] < per_size
            or launches["gather_lanewise"] < len(G.LANEWISE_N) * per_size):
        raise AssertionError(f"gather tool did not launch its kernels: {launches}")
    for r in rows:
        n = int(r["name"].split("=")[1])
        if r["name"].startswith("gather_lanewise") and n <= 2048 and r["plan"]["route"] == "l2":
            raise AssertionError(f"{r['name']}: planned on the L2 route, not in shared memory")
    scalar = [r for r in rows if r["name"].startswith("gather_scalar")]
    lanewise = [r for r in rows if r["name"].startswith("gather_lanewise")]
    k7_main = next(r for r in lanewise if r["name"].endswith("N=2048") and r["lookups"] == G.L)
    common = dict(route="cuda", source=GATHER_SOURCE, max_abs_err=0.0,
                  timing="ms/plain_ms: device time per call (graph replay) at L lookups; "
                         "host_ms: CUDA events around back-to-back Python calls")
    # the one PyTorch call of each function on the same inputs (int64
    # indices made once, outside the timed call), by the same device timer;
    # the bound: each index read and each value written once, the table once
    library, bounds = {}, {}
    for name, _, _, tab, idx in G.cases(dev, lookups=G.L):
        idx64 = idx.to(torch.int64)
        if name.startswith("gather_scalar"):
            library[name] = G.graph_ms(lambda: torch.take(tab, idx64))
        elif name == k7_main["name"]:
            library[name] = G.graph_ms(lambda: torch.gather(tab, 0, idx64))
        bounds[name] = idx.numel() * 8 + tab.numel() * 4
    k6 = kernel_line(dict(name="gather_scalar", replaces="tools/gather_bench.py:54",
                          launches=launches["gather_scalar"], ms=scalar[0]["ms"],
                          plain_ms=scalar[0]["plain_ms"], host_ms=scalar[0]["host_ms"],
                          plain_host_ms=scalar[0]["plain_host_ms"], by_size=scalar, **common),
                     bound(bounds[scalar[0]["name"]], 0, scalar[0]["ms"]),
                     library[scalar[0]["name"]])
    k7 = kernel_line(dict(name="gather_lanewise", replaces="tools/gather_bench.py:75",
                          also_replaces=["tools/gather_bench2.py:76", "tools/gather_bench3.py:38"],
                          launches=launches["gather_lanewise"], ms=k7_main["ms"],
                          plain_ms=k7_main["plain_ms"], host_ms=k7_main["host_ms"],
                          plain_host_ms=k7_main["plain_host_ms"], by_size=lanewise, **common),
                     bound(bounds[k7_main["name"]], 0, k7_main["ms"]), library[k7_main["name"]])
    for k in (k6, k7):
        log(f"# {k['name']} at {G.L} lookups: {k['ms']:.5f} ms kernel, library call "
            f"{k['library_ms']:.5f} ms; bound {k['bound_ms']:.5f} ms by {k['bound_by']}, share "
            f"{k['bound_share']:.3f}")
    return k6, k7


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda:0")
    log(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    t0 = time.perf_counter()
    _build.load()
    log(f"# build: {time.perf_counter() - t0:.2f} s (one nvcc per source, all at once: "
        f"{_build.build_info['seconds']:.2f} s)")
    for line in _build.build_info["log"].splitlines():
        if "error" in line or line.startswith("=="):
            log(f"# ptxas: {line.strip()}")
    ptxas = [dict(kernel=k, template=a, registers=r, spill_store_bytes=s, spill_load_bytes=lo,
                  stack_frame_bytes=f)
             for k, a, r, s, lo, f in _build.ptxas_table(_build.build_info["log"])]
    for row in ptxas:
        log(f"# ptxas: {row['kernel']}<{row['template']}>: {row['registers']} registers, "
            f"{row['spill_store_bytes']} B spill stores, {row['spill_load_bytes']} B spill loads, "
            f"{row['stack_frame_bytes']} B stack frame")
    missing = set(_build.KERNELS) - {row["kernel"] for row in ptxas}
    if missing:
        raise AssertionError(f"no ptxas report of {sorted(missing)}")

    t_start = time.perf_counter()
    seconds = {}

    def run(label, fn, *args):
        """A phase, its seconds logged and kept (PERF.md reads them)."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[label] = seconds.get(label, 0.0) + time.perf_counter() - t0
        log(f"# seconds: {label} {time.perf_counter() - t0:.1f} s")
        return out

    k3, k3_xy = run("3 K3", phase_k3, dev)
    k3_raw = run("18 K3 raw", phase_k3_raw, dev)
    renderer = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS,
                                   device=dev)
    camera = Camera()
    k2 = run("4 K2", phase_k2, renderer, camera, dev)
    k1 = run("5 K1", phase_k1, renderer, camera, dev)
    k1_xy = run("5 xy", phase_xy, camera, dev)
    launches, kern, plain = run("6 main path", phase_main, dev)
    k4, keep = run("7 K4", phase_k4, renderer, camera, dev)
    k5 = run("8 K5", phase_k5, keep, dev)
    del keep
    k4_modes, k5_modes = run("7-8 backward modes", phase_bwd_modes, camera, dev)
    k9, k10, corner_modes = run("9 K9/K10", phase_corners, dev)
    bwd_launches, fits, windows, qc_launches = run("9 training", phase_fit, camera, dev)
    k6, k7 = run("10 gather", phase_gather, dev)
    del renderer
    torch.cuda.empty_cache()
    k1_maj, sparse, sparse_renderer, sparse_cam = run("11 majorant", phase_majorant, dev)
    sparse["xy"] = run("11 sparse xy", phase_sparse_xy, sparse_renderer, sparse_cam, dev)
    sparse["raw"] = run("18 sparse raw", phase_sparse_raw, sparse_renderer, sparse_cam, dev)
    slab_sparse_entries = run("26 sparse slab", slab_sparse, sparse_renderer, sparse_cam, dev)
    slab_sparse_512 = run("27 sparse slab fit", slab_sparse_fit, sparse_renderer, sparse_cam,
                          dev)
    k1_modes, mode_rates = run("12 environment, quasicubic", phase_env_quasicubic, dev)
    compact_kernels, compact = run("13 compaction", phase_compaction, dev)
    cli = run("14 CLI", phase_cli)
    k11 = run("15 scatter ceiling", phase_scatter, dev)
    k4_sur, k12, twin, sur_modes = run("16 surrogate", phase_surrogate, MCMSpectralRenderer(
        *bench_scene_args(), resolution=RES, streams=STREAMS, device=dev), camera, dev)
    k4_raw, k12_raw = run("16 surrogate raw", phase_surrogate_raw, camera, dev)
    autodiff = run("17 autodiff training", phase_autodiff_fit, camera, dev, windows,
                   (sparse_renderer, sparse_cam))
    del sparse_renderer
    torch.cuda.empty_cache()
    k1_raw, k13, k14 = run("18 raw tables", phase_raw, camera, dev)
    torch.cuda.empty_cache()
    rm_kernels, rm_sessions = run("19 ray marchers", phase_raymarch, dev)
    eam_kernels, eam_fits = run("20 EAM training", phase_eam_fit, dev)
    mcm_kernels, mcm_sessions = run("21 RGB MCM", phase_mcm, dev)
    mcs_kernels, mcs = run("22 MCS", phase_mcs, dev)
    mcsp_kernels, mcsp = run("23 MCS persistent", phase_mcs_persistent, dev)
    dos_kernels, dos = run("24 DOS", phase_dos, dev)
    lao_kernels, lao = run("25 LAO", phase_lao, dev)
    slab_kernels, slab = run("26 slab", phase_slab, dev, slab_sparse_entries)
    slab_bwd_kernels, slab_bwd = run("27 slab backward", phase_slab_backward, dev,
                                     slab_sparse_512)
    foreign = sorted(k for k in sys.modules
                     if k in ("jax", "vpt_tpu") or k.startswith(("jax.", "vpt_tpu.")))
    if foreign:
        raise AssertionError(f"imported {foreign[:5]}: the port must not load jax or vpt_tpu")

    k1["launches"], k2["launches"] = launches["step"], launches["reset"]
    k4_sur["launches"] = autodiff["bench"]["launches"]["surrogate_tape_forward"]
    k12["launches"] = autodiff["bench"]["launches"]["surrogate_reverse"]
    k3["launches"] = launches["sample_volume_packed"]
    k3_xy["launches"] = launches["sample_volume_packed_xy"]
    k3_raw["launches"] = launches["sample_volume_raw"]
    k4["launches"], k5["launches"] = bwd_launches["prb_tape_forward"], bwd_launches["prb_reverse"]
    k9["launches"], k10["launches"] = (bwd_launches["contract_corners"],
                                       bwd_launches["pack_corners"])
    if k9["launches"] < 1 or k10["launches"] < 1:
        raise AssertionError(f"the training path did not launch K9/K10: {bwd_launches}")
    # the new modes' launches: the env PRB fit, the sparse xy PRB fit, the
    # quasicubic window (phase 9), the env-lit majorant fit (phase 17)
    env_fit, xy_fit = fits["environment"]["launches"], sparse["xy"]["fit"]["launches"]
    k4_modes["environment"]["launches"] = env_fit["prb_tape_forward_environment"]
    k5_modes["environment"]["launches"] = env_fit["prb_reverse_environment"]
    k4_modes["xy"]["launches"] = xy_fit["prb_tape_forward_xy"]
    k5_modes["xy"]["launches"] = xy_fit["prb_reverse_xy"]
    k4_modes["quasicubic"]["launches"] = qc_launches["prb_tape_forward_quasicubic"]
    k5_modes["quasicubic"]["launches"] = qc_launches["prb_reverse"]
    for name, src in (("contract_corners[environment]", env_fit["contract_corners_env"]),
                      ("pack_corners[environment]", env_fit["pack_corners_env"]),
                      ("contract_corners[xy]", xy_fit["contract_corners_xy"]),
                      ("pack_corners[xy]", xy_fit["pack_corners_xy"])):
        corner_modes[name]["launches"] = src
    env_maj = autodiff["env_majorant"]["launches"]
    sur_modes["surrogate_tape_forward[environment+majorant]"]["launches"] = env_maj[
        "surrogate_tape_forward_environment_majorant"]
    sur_modes["surrogate_reverse[environment+majorant]"]["launches"] = env_maj[
        "surrogate_reverse_environment_majorant"]
    # the xy+majorant instantiation: the sparse xy fit (phase 17)
    xy_maj = autodiff["sparse_xy"]["fit"]["launches"]
    sur_modes["surrogate_tape_forward[xy majorant]"]["launches"] = xy_maj[
        "surrogate_tape_forward_xy"]
    sur_modes["surrogate_reverse[xy majorant]"]["launches"] = xy_maj["surrogate_reverse_xy"]
    # the RAW mode: phase 17's two raw fits
    for entry, key in ((k4_raw, "surrogate_tape_forward_raw"), (k12_raw, "surrogate_reverse_raw")):
        entry["launches"] = sum(autodiff[f]["launches"][key] for f in ("raw", "sparse_raw"))
    kernels = [k1, k2, k4, k5, k6, k7, k9, k10, k11, k1_maj, k1_modes["environment"],
               k1_modes["quasicubic"], *compact_kernels, k4_sur, k12, k1_xy, *k4_modes.values(),
               *k5_modes.values(), *corner_modes.values(), *sur_modes.values(), k4_raw, k12_raw,
               k1_raw, k13,
               k14, *rm_kernels, *eam_kernels, *mcm_kernels, *mcs_kernels, *mcsp_kernels,
               *dos_kernels, *lao_kernels, *slab_kernels, *slab_bwd_kernels]
    missing = [k["name"] for k in kernels + [k3, k3_xy, k3_raw]
               if not {"bound_ms", "bound_by", "library_ms", "launches", "ms", "plain_ms",
                       "max_abs_err"} <= set(k)]
    if missing:
        raise AssertionError(f"kernels without a bound, a time or launches: {missing}")
    unlaunched = [k["name"] for k in kernels if k["launches"] < 1]
    if unlaunched:
        raise AssertionError(f"kernels of the path launched no time: {unlaunched}")
    k5["split_stride1_window"] = windows["stride1"]["k5_split"]
    log(f"# chip_smoke: {time.perf_counter() - t_start:.1f} s after the build")
    result = {"kernels": kernels,
              "standalone": [k3, k3_xy, k3_raw],
              "main_path": {"kernel": kern, "plain_step": plain},
              "training_path": {"fit_spectral": fits, "fwd_bwd_windows": windows},
              "majorant_path": sparse, "mode_sessions": mode_rates, "compaction": compact,
              "cli": cli, "surrogate": {"twin_on_card": twin, "autodiff_fit": autodiff},
              "raymarch_sessions": rm_sessions, "eam_training": eam_fits,
              "mcm_sessions": mcm_sessions, "mcs": mcs, "mcs_persistent": mcsp, "dos": dos,
              "lao": lao, "slab": slab, "slab_backward": slab_bwd,
              "ptxas": ptxas, "gpu": smi, "phase_seconds": seconds}
    log(json.dumps(result))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
