"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. the card's name and power limit (nvidia-smi); no CUDA -> exit 1
  2. build the kernels of vpt_tpu_torch/csrc with nvcc (sm_90a)
  3. sample_volume_packed vs its plain version: all 256 u8 codes exact
  4. mcm_spectral_reset vs its plain version at 512^2 x 4 streams
  5. mcm_spectral_step vs its plain version at 512^2 x 4 streams,
     2 dispatches (the oracle contract), and bit-identical reruns; the
     same at 64^2 x 2 streams with 24 bins (the kernel's >16-bin build)
  6. the main path: RenderSession("mcm-spectral", ...) on the bench scene
     (512^2, 4 streams, 128^3 u8 sphere_in_cube, 12 bins, 8 steps),
     64 dispatches, launch counts and outputs checked; then the same
     dispatches through the plain step for comparison
The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.
Imports nothing of jax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

RES, STREAMS, VOLUME, STEPS, BINS, FRAMES = 512, 4, 128, 8, 12, 64
SOURCE = "vpt_tpu_torch/csrc/mcm_spectral.cu"


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
    ms = cuda_ms(lambda: K.sample_volume_packed(vol.table, vol.dims, uu, vv, ww), 50)
    plain_ms = cuda_ms(lambda: K.sample_volume_packed_plain(vol.table, vol.dims, uu, vv, ww), 10)
    err = float((K.sample_volume_packed(vol.table, vol.dims, uu, vv, ww)
                 - K.sample_volume_packed_plain(vol.table, vol.dims, uu, vv, ww)).abs().max())
    log(f"# K3 sample_volume_packed: 256 codes exact, u8 == f32 == plain; "
        f"{ms:.4f} ms kernel vs {plain_ms:.4f} ms plain per {n} lookups")
    return dict(name="sample_volume_packed", route="cuda", source=SOURCE,
                replaces="vpt_tpu/ops/interp.py:371", max_abs_err=err, ms=ms,
                plain_ms=plain_ms)


def phase_k2(renderer, camera, dev):
    from vpt_tpu_torch.kernels import mcm_spectral as K

    ctx = renderer.ctx(camera, 1)
    got = K.reset(ctx, RES, BINS, STREAMS, dev)
    plain = K.reset_plain(ctx, RES, BINS, STREAMS, dev)
    torch.cuda.synchronize()
    for k in ("bin", "samples", "bounces", "radiance", "transmittance"):
        if not torch.equal(got[k], plain[k]):
            raise AssertionError(f"K2 {k} != plain")
    err = 0.0
    for k in ("px", "py", "pz", "dx", "dy", "dz", "wavelength"):
        torch.testing.assert_close(got[k], plain[k], rtol=1e-5, atol=1e-6)
        err = max(err, float((got[k] - plain[k]).abs().max()))
    ms = cuda_ms(lambda: K.reset(ctx, RES, BINS, STREAMS, dev), 20)
    plain_ms = cuda_ms(lambda: K.reset_plain(ctx, RES, BINS, STREAMS, dev), 5)
    log(f"# K2 mcm_spectral_reset: matches plain (max abs {err:.3g}); "
        f"{ms:.4f} ms kernel vs {plain_ms:.4f} ms plain")
    return dict(name="mcm_spectral_reset", route="cuda", source=SOURCE,
                replaces="vpt_tpu/models/mcm_spectral.py:181", max_abs_err=err,
                ms=ms, plain_ms=plain_ms)


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
    c = image_contract(radiance_to_rgb(sk.radiance, ctx.bin_xyz),
                       radiance_to_rgb(sp.radiance, ctx.bin_xyz), sk.samples, sp.samples)
    shape = "x".join(map(str, sk.px.shape))
    log(f"# K1 mcm_spectral_step vs plain, {shape} lanes, {n_bins} bins, 2 dispatches: "
        f"{json.dumps(c)}")
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
    ms = cuda_ms(lambda: K.step(sk, ctx, one, STEPS, BINS), 20)
    plain_ms = cuda_ms(lambda: K.step_plain(sp, ctx, one, STEPS, BINS), 3)
    log(f"# K1 one dispatch ({STEPS} steps, {RES}^2 x {STREAMS}): "
        f"{ms:.4f} ms kernel vs {plain_ms:.4f} ms plain")
    return dict(name="mcm_spectral_step", route="cuda", source=SOURCE,
                replaces="vpt_tpu/models/mcm_spectral.py:212",
                pallas_counterpart="tools/pallas_step.py:125",
                max_abs_err=c["max_abs"], ms=ms, plain_ms=plain_ms,
                frac_channels_within_rel_1e3=c["frac_channels"],
                frac_samples_equal=c["frac_samples_equal"])


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
    log(f"# build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_info['seconds']:.2f} s)")
    for line in _build.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"# ptxas: {line.strip()}")

    k3 = phase_k3(dev)
    renderer = MCMSpectralRenderer(*bench_scene_args(), resolution=RES, streams=STREAMS,
                                   device=dev)
    camera = Camera()
    k2 = phase_k2(renderer, camera, dev)
    k1 = phase_k1(renderer, camera, dev)
    launches, kern, plain = phase_main(dev)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    k1["launches"], k2["launches"] = launches["step"], launches["reset"]
    k3["launches"] = launches["sample_volume_packed"]
    result = {"kernels": [k1, k2], "standalone": [k3],
              "main_path": {"kernel": kern, "plain_step": plain},
              "gpu": smi}
    log(json.dumps(result))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
