"""Where a ``fit_spectral`` iteration's time goes on the card: the PRB step
and the autodiff surrogate's step on the bench scene (512^2 x 4 streams,
128^3 u8 ``sphere_in_cube``, 12 bins, 8 steps, 4 dispatches per
iteration), profiled with ``torch.profiler``.

    python -m vpt_tpu_torch.tools.profile_fit [--iterations 3] [--mode default|env|xy]

``--mode``: "default" learns the density (``wrt={density}``), PRB and
autodiff; "env" lights the scene with a seeded 256x512x3 equirect map and
learns the map, PRB and autodiff; "xy" packs the volume into the xy
half-packed table and learns the density, PRB and autodiff.

Per method it prints one JSON line: the iterations' host-clock seconds
without the profiler, the device time of every kernel under the profiler
(summed by name, with launch counts), their total, the device's busy share
(kernel time over the profiled window's host time, which the profiler's
own overhead lengthens), and the device time and launches per iteration
split by piece: K1, K4 (PRB or surrogate mode), K5, K12, K9, K10, the
device-to-device copies, the copy kernels, the fills, and the other torch
ops. Needs a CUDA
device; exits 1 without.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def _bench_scene():
    from vpt_tpu_torch import (LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig,
                               Volume)

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    return (Volume.sphere_in_cube(128), MaterialTF(table), LightConfig(direction=(1.0, 0.2, 0.5)),
            SpectrumConfig(), MCMSpectralConfig(extinction=40.0, bounces=8, steps=8))


def seeded_envmap(shape=(256, 512, 3), seed: int = 2024) -> np.ndarray:
    """An equirect map with structure in both angles: smooth bands plus
    noise, from a numpy seed."""
    rng = np.random.default_rng(seed)
    h, w, _ = shape
    v, u = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = np.stack([0.6 + 0.4 * np.cos(2 * np.pi * u), 0.5 + 0.4 * v,
                     0.7 - 0.5 * v * u], axis=-1)
    return np.clip(base + rng.uniform(-0.1, 0.1, shape), 0.0, 1.0).astype(np.float32)


def _smoothed(density, factor):
    d = np.asarray(density, np.float32)
    n = d.shape[0]
    c = d.reshape(n // factor, factor, n // factor, factor, n // factor,
                  factor).mean(axis=(1, 3, 5))
    return np.repeat(np.repeat(np.repeat(c, factor, 0), factor, 1), factor, 2)


# pieces of an iteration's device time: (piece, substring of the kernel's
# name), the first match wins
PIECES = (("K12 surrogate_reverse", "surrogate_reverse_kernel"),
          ("K4 surrogate mode", "surrogate_tape_kernel"),
          ("K4 prb_tape_forward", "tape_forward_kernel"),
          ("K5 prb_reverse", "reverse_kernel"),
          ("K1 step", "step_kernel"),
          ("K9 contract_corners", "contract_"),
          ("K10 pack_corners", "pack_"),
          ("device-to-device copies", "Memcpy DtoD"),
          ("copy kernels", "direct_copy_kernel"),
          ("fills", "FillFunctor"))


def split(kernels: dict, iterations: int) -> dict:
    """Device ms and launches per iteration by piece (``PIECES``, then the
    other torch ops)."""
    out = {}
    for name, k in kernels.items():
        piece = next((p for p, sub in PIECES if sub in name), "other torch ops")
        acc = out.setdefault(piece, dict(ms=0.0, launches=0))
        acc["ms"] += k["ms"] / iterations
        acc["launches"] += k["launches"] / iterations
    return out


def device_kernels(prof) -> dict:
    """A profile's device work summed by kernel name: {name: {ms, launches}}."""
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].strip()
            k = kernels.setdefault(name, dict(ms=0.0, launches=0))
            k["ms"] += e.device_time_total / 1e3
            k["launches"] += e.count
    return kernels


MODES = ("default", "env", "xy")


def profile_method(method: str, iterations: int, dev, mode: str = "default") -> dict:
    from torch.profiler import ProfilerActivity, profile

    from vpt_tpu_torch import Camera
    from vpt_tpu_torch import optim as TO
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    args = _bench_scene()
    kw = {}
    if mode == "env":
        kw["environment"] = seeded_envmap()
    elif mode == "xy":
        kw["pack_tables"] = {"density_xy", "material_tf", "light_spectrum"}
    renderer = MCMSpectralRenderer(*args, resolution=512, streams=4, device=dev, **kw)
    cam = Camera()
    base, state0 = renderer.ctx(cam, 1), renderer.reset(cam, 1)
    target = torch.zeros(512, 512, 3, device=dev)
    opt = TO.Adam(0.02)
    if mode == "env":
        params = {"environment": torch.full((256, 512, 3), 0.5, device=dev)}
    else:
        params = {"density": torch.as_tensor(_smoothed(args[0].density, 8), device=dev)}
    istate = TO.InverseState(params, opt.init(params), 0)
    if method == "autodiff":
        step = TO.make_spectral_inverse_step(opt, 8, 12)
    else:
        step = TO.make_spectral_prb_step(opt, 8, 12, wrt=set(params))

    def run(first):
        nonlocal istate
        for i in range(first, first + iterations):
            seeds = [(7 + 4 * i + k) * 2654435761 % 2**32 for k in range(4)]
            istate, loss = step(istate, state0, base, seeds, target)
            float(loss)
        torch.cuda.synchronize()

    run(0)  # warm-up
    t0 = time.perf_counter()
    run(iterations)
    seconds = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(2 * iterations)
        profiled = time.perf_counter() - t0
    kernels = device_kernels(prof)
    device_ms = sum(k["ms"] for k in kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[:12])
    return dict(method=method, mode=mode, iterations=iterations, seconds=seconds,
                seconds_per_iteration=seconds / iterations, profiled_seconds=profiled,
                device_ms=device_ms, device_ms_per_iteration=device_ms / iterations,
                busy_share_profiled=device_ms / (profiled * 1e3),
                per_iteration=split(kernels, iterations), kernels=top)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m vpt_tpu_torch.tools.profile_fit")
    p.add_argument("--iterations", type=int, default=3)
    p.add_argument("--mode", choices=MODES, default="default")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fit: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda:0")
    for method in ("prb", "autodiff"):
        print(json.dumps(profile_method(method, args.iterations, dev, args.mode)))


if __name__ == "__main__":
    main()
