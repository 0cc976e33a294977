"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi); no CUDA -> exit 1
  2. build the kernels of vpt_tpu_torch/csrc with nvcc (sm_90a, one nvcc
     per source, all at once); print the ptxas registers, spills and
     stack frame of every instantiation of K1, K4 (and its surrogate
     mode), K5, K9, K10, K11, K12, K13 and K14
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
     exits 0, writes the image, prints the metrics JSON
 15. the scatter ceiling (bench.py's measure_ceilings method): K11
     scatter_rows, two float4 atomics per index on 16 x 1M uniform random
     rows of the 129^3-row table, equal to its plain version, timed by
     device time against index_add_
 16. the autodiff surrogate's kernels at 512^2 x 4 streams, 2 dispatches,
     exact, majorant (the bench scene, majorant_blocks=16), environment,
     environment+majorant and quasicubic mode: K4's surrogate mode (its
     state equals K1's bit for bit, its tape the
     plain tape; timed beside K1 on the same state copy), K12
     surrogate_reverse on that tape within 1e-4 relative L2 of its plain
     version (two runs within 1e-5) with all four adjoints and with the
     density's alone; both timed against their bounds; then the window of
     render_sequence_diff against the autograd twin on the card (128^2 x
     2, K = 2, all four tables, 1e-4) under both window_storage schedules
 17. the autodiff training path: fit_spectral(method="autodiff") at full
     width on the bench scene and, routed by default, on the sparse 512^3
     majorant scene (3 iterations each, the launch counts set to 0 before:
     one K4 surrogate sweep and one K12 per iteration, K9 and K10
     required, no K1 inside the loss; seconds per iteration); a K = 4
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


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, by CUDA events."""
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
    packed row, or a raw grid's 8 corners (1 for nearest) and a raw TF's 4
    texels; most of a sparse volume is never read)."""
    from vpt_tpu_torch.kernels import mcm_spectral as K

    vol, tf = K.density_table(ctx), ctx.material_tf
    per_vol = vol.shape[-1] if vol.ndim == 2 else (1 if ctx.volume_filter == "nearest" else 8)
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
    return dict(seconds=dt, metrics=metrics)


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
    """A carry of seeded random adjoints (the state's end) and zero packed
    adjoints of every table, for K12."""
    from vpt_tpu_torch.kernels import spectral_backward as TB

    rng = np.random.default_rng(seed)
    dev = ctx.material_tf.device

    def g(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)

    carry = dict(c=g(n), gp=[g(n) for _ in range(3)], gd=[g(n) for _ in range(3)],
                 grad=g(n_bins, n) / float(RES))
    return carry, TB._packed_adj_init(ctx, TB.ALL_WRT | {"environment"})


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
    render_sequence_diff against the autograd twin on the card."""
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import surrogate as S
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
    for mode, r in (("exact", renderer), ("majorant", maj_renderer),
                    ("environment", env_renderer), ("environment+majorant", env_maj_renderer),
                    ("quasicubic", qc_renderer)):
        ctx = r.ctx(camera, 7)
        s0 = r.reset(camera, 7)
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
        wrts = (("all", adj_all), ("density", {"g_vol": adj_all["g_vol"]}))
        for wrt, adj0 in wrts[:2 if mode in ("exact", "majorant") else 1]:
            rec = k12_check(mode, wrt, tk, flds, sk.samples, carry0, adj0, ctx, k12)
            k12["modes"][f"{mode}/{wrt}"] = rec
        del tk, tk2, tp
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
    for mode, replaces in (("environment", "vpt_tpu/models/mcm_spectral.py:148"),
                           ("environment+majorant",
                            "vpt_tpu/models/mcm_spectral.py:148 and :228"),
                           ("quasicubic", "vpt_tpu/ops/interp.py:389")):
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
    # launches of the env-only and quasicubic instantiations: the twin's
    # window (render_sequence_diff); the env+majorant one's: phase 17's fit
    for mode in ("environment", "quasicubic"):
        modes[f"surrogate_tape_forward[{mode}]"]["launches"] = twin["launches"][mode][
            "surrogate_tape_forward"]
        modes[f"surrogate_reverse[{mode}]"]["launches"] = twin["launches"][mode][
            "surrogate_reverse"]
    del maj_renderer, env_renderer, env_maj_renderer, qc_renderer
    torch.cuda.empty_cache()
    return k4, k12, twin, modes


def k12_check(mode, wrt, tk, flds, samples, carry0, adj0, ctx, k12):
    """K12 on a tape against reverse_plain (relative L2 <= 1e-4 per output,
    two kernel runs within 1e-5), then timed (a fresh copy of the carry per
    call, made outside the timed span) against its bound."""
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
        if rel > 1e-4 or rerun > 1e-5:
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
    quasicubic mode, under both schedules of the window
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
                         ("environment+majorant", 16), ("quasicubic", None)):
        args = mode_args(mode == "quasicubic")
        lit = mode.startswith("environment")
        r = TM.MCMSpectralRenderer(*args, resolution=res, streams=streams, majorant_blocks=blocks,
                                   environment=env if lit else None, device=dev)
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
            vol = interp.PackedVolume(C.pack_volume_diff(p["density"]), base.density.dims)
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
    out["launches"] = launches
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


def autodiff_fit(label, target, renderer, camera, init, dev, **kw):
    """fit_spectral with the surrogate: FIT_ITERS iterations of CHUNK
    dispatches, the launch counts set to 0 just before; checks the launches
    (per iteration one K4 surrogate sweep and one K12, K9 and K10 at least
    once, and no K1 inside the loss), finite losses and moved params."""
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
        params, losses, info = TO.fit_spectral(target, renderer, camera, {"density": init},
                                               dispatches_per_step=CHUNK, iterations=FIT_ITERS,
                                               learning_rate=0.02, seed=1, return_info=True, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        TO.spectral_render_loss = loss_fn
    launches = launch_counts()
    require_launches(launches, ("surrogate_tape_forward", "surrogate_reverse",
                                "contract_corners", "pack_corners"), f"fit_spectral ({label})")
    per_iteration = (launches["surrogate_tape_forward"] == FIT_ITERS
                     and launches["surrogate_reverse"] == FIT_ITERS
                     and launches["contract_corners"] >= FIT_ITERS)
    if (not per_iteration or len(inside_loss) != FIT_ITERS
            or any(d.get("step", 0) != 0 or d.get("surrogate_tape_forward", 0) != 1
                   for d in inside_loss)):
        raise AssertionError(f"fit_spectral ({label}): launches {launches}, inside each loss "
                             f"{inside_loss}; want one K4 surrogate sweep and one K12 per "
                             f"iteration and no K1 inside the loss")
    d = params["density"]
    moved = float((d - torch.as_tensor(init, device=dev)).abs().max())
    if (info["method"] != "autodiff" or not np.isfinite(losses).all() or moved == 0.0
            or not bool(torch.isfinite(d).all())):
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


def phase_autodiff_fit(camera, dev, prb_windows):
    """Phase 17: fit_spectral(method="autodiff") at full width on the bench
    scene, the default routing on the sparse 512^3 majorant scene, a
    surrogate window split beside phase 9's PRB stride-1 window, and a
    checkpoint save and resume."""
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
    params, out["bench"] = autodiff_fit("bench scene", target, renderer, camera, init, dev,
                                        method="autodiff")
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
                                          target_env, env_maj, camera, init, dev)
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

    # the sparse 512^3 majorant scene, method=None: routed to the surrogate
    sparse, cam, host = sparse_scene(dev)
    _, sparse_target = sparse.render_many(sparse.reset(cam, 3), cam,
                                          [(3 + k) * 2654435761 % 2**32 for k in range(16)])
    sparse_init = np.clip(smoothed(sparse.volume.density, 16) * 0.8 + 0.05, 0.0, 1.0)
    torch.cuda.reset_peak_memory_stats()
    _, out["sparse"] = autodiff_fit("sparse 512^3, majorant, method=None", sparse_target, sparse,
                                    cam, sparse_init, dev)
    out["sparse"]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    log(f"# sparse autodiff fit: peak device memory {out['sparse']['peak_memory_bytes']} B")
    del sparse
    torch.cuda.empty_cache()
    return out


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
    k3, k3_xy = phase_k3(dev)
    k3_raw = phase_k3_raw(dev)
    renderer = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS,
                                   device=dev)
    camera = Camera()
    k2 = phase_k2(renderer, camera, dev)
    k1 = phase_k1(renderer, camera, dev)
    k1_xy = phase_xy(camera, dev)
    launches, kern, plain = phase_main(dev)
    k4, keep = phase_k4(renderer, camera, dev)
    k5 = phase_k5(keep, dev)
    del keep
    k4_modes, k5_modes = phase_bwd_modes(camera, dev)
    k9, k10, corner_modes = phase_corners(dev)
    bwd_launches, fits, windows, qc_launches = phase_fit(camera, dev)
    k6, k7 = phase_gather(dev)
    del renderer
    torch.cuda.empty_cache()
    k1_maj, sparse, sparse_renderer, sparse_cam = phase_majorant(dev)
    sparse["xy"] = phase_sparse_xy(sparse_renderer, sparse_cam, dev)
    sparse["raw"] = phase_sparse_raw(sparse_renderer, sparse_cam, dev)
    del sparse_renderer
    torch.cuda.empty_cache()
    k1_modes, mode_rates = phase_env_quasicubic(dev)
    compact_kernels, compact = phase_compaction(dev)
    cli = phase_cli()
    k11 = phase_scatter(dev)
    k4_sur, k12, twin, sur_modes = phase_surrogate(MCMSpectralRenderer(
        *bench_scene_args(), resolution=RES, streams=STREAMS, device=dev), camera, dev)
    autodiff = phase_autodiff_fit(camera, dev, windows)
    k1_raw, k13, k14 = phase_raw(camera, dev)
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
    kernels = [k1, k2, k4, k5, k6, k7, k9, k10, k11, k1_maj, k1_modes["environment"],
               k1_modes["quasicubic"], *compact_kernels, k4_sur, k12, k1_xy, *k4_modes.values(),
               *k5_modes.values(), *corner_modes.values(), *sur_modes.values(), k1_raw, k13,
               k14]
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
              "ptxas": ptxas, "gpu": smi}
    log(json.dumps(result))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
