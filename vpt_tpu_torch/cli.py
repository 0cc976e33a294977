"""vpt-tpu-torch command line: the PyTorch/CUDA port's counterpart of
``vpt_tpu/cli.py``, with the same subcommands and flags plus ``--device``.

    python -m vpt_tpu_torch.cli render --device cuda --majorant-blocks 8 \\
        --compaction --envmap env.npy -o render.npy
    python -m vpt_tpu_torch.cli render --device cuda --renderer eam -o eam.npy
    python -m vpt_tpu_torch.cli render --device cuda --renderer dos -o dos.npy
    python -m vpt_tpu_torch.cli invert --device cuda --iterations 100 -o density.npy

Subcommands:
  render      progressive render to a PNG/NPY (metrics JSON on stdout)
  animate     turntable animation to a directory of PNGs
  renderers   list the port's registered renderers
  tonemappers list the tone mappers
  info        torch / CUDA / device report
  invert      inverse rendering: EAM density recovery (fit_density), or
              spectral MCM with --spectral --method prb|autodiff

``render`` and ``animate`` take ``--renderer mcm-spectral`` (the default),
the RGB renderers ``mcm`` and ``mcs``, one of the ray marchers ``eam``,
``mip``, ``iso``, ``depth`` or the occlusion renderers ``dos`` and ``lao``,
built as ``vpt_tpu/cli.py`` builds them (``mcm`` with ``--envmap``,
``--compaction``, ``--extinction``, ``--bounces`` and ``--steps`` and the
grayscale ramp TF; EAM with ``--extinction``; the others with their
defaults). ``--compaction`` is for ``mcm-spectral`` and ``mcm`` only.

``invert`` without ``--spectral`` recovers the volume's density from
``--views`` orbit renders by EAM (``optim.fit_density``), as
``vpt_tpu/cli.py`` does: the ramp-alpha TF, 32 slices, targets at offset 0,
a constant 0.2 start. ``invert --spectral`` always fits an
``MCMSpectralRenderer``. Like the reference, both ignore ``--renderer``.

``--device`` defaults to ``cuda``: the kernels run on the card, and a
machine without CUDA exits non-zero instead of falling back to the CPU.
``--device cpu`` runs the plain PyTorch versions. What the port has not
ported yet (``--devices > 1`` on ``mcm-spectral``, the one renderer the
reference builds a mesh for) exits non-zero with a message naming it;
every other renderer ignores ``--devices``, as the reference does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _ramp_tf():
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    return table


def _load_volume(args):
    from vpt_tpu_torch.scene.volume import Volume

    if args.volume == "sphere_in_cube":
        return Volume.sphere_in_cube(args.volume_size)
    if args.volume == "two_spheres":
        return Volume.two_spheres(args.volume_size)
    if args.volume.endswith(".bvp") or args.volume.endswith(".zip"):
        return Volume.from_bvp_file(args.volume)
    if args.volume.endswith(".raw"):
        if not args.dims:
            raise SystemExit("--dims WxHxD required for .raw volumes")
        w, h, d = (int(x) for x in args.dims.split("x"))
        return Volume.from_raw_file(args.volume, w, h, d)
    if args.volume.endswith(".npy"):
        return Volume(density=np.load(args.volume).astype(np.float32))
    raise SystemExit(f"unrecognized volume: {args.volume}")


def _load_envmap(args):
    """An equirect environment image -> (H, W, 3) float in [0, 1]; ``.npy``
    needs no PIL."""
    if not getattr(args, "envmap", None):
        return None
    if args.envmap.endswith(".npy"):
        img = np.load(args.envmap)
    else:
        from PIL import Image

        img = np.asarray(Image.open(args.envmap).convert("RGB"))
    img = np.asarray(img, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    return img[..., :3]


def _device(args):
    """The torch device of ``--device``; CUDA that is absent is an error,
    never a fallback to the CPU."""
    import torch

    try:
        dev = torch.device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device!r}: {e}") from None
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {args.device!r}: the port runs on cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: CUDA is not available on this machine "
                         "(--device cpu runs the plain PyTorch versions)")
    return dev


RAY_MARCHERS = ("eam", "mip", "iso", "depth")
OCCLUSION = ("dos", "lao")


PORTED = ("mcm-spectral", "mcm", "mcs", *RAY_MARCHERS, *OCCLUSION)


def _check_render_ported(args):
    """``render`` / ``animate``: every renderer of the reference.
    As in ``vpt_tpu/cli.py``, ``--devices`` builds a mesh for mcm-spectral
    only (not ported yet, so refused there) and every other renderer
    ignores it."""
    key = args.renderer
    if args.compaction and key not in ("mcm-spectral", "mcm"):
        raise SystemExit(f"--compaction is supported by mcm-spectral and mcm, not {key!r}")
    if key not in PORTED:
        raise SystemExit(f"renderer {key!r} is not ported to vpt_tpu_torch yet "
                         f"(ported: {', '.join(PORTED)})")
    if key == "mcm-spectral" and args.devices is not None and args.devices > 1:
        raise SystemExit("--devices > 1 (the multi-device mesh) is not ported to "
                         "vpt_tpu_torch yet")


def _make_session(args):
    from vpt_tpu_torch.scene.camera import OrbitController
    from vpt_tpu_torch.utils.config import (EAMConfig, LightConfig, MaterialTF, MCMConfig,
                                            MCMSpectralConfig, SpectrumConfig)
    from vpt_tpu_torch.session import RenderSession

    _check_render_ported(args)
    device = _device(args)
    volume = _load_volume(args)
    key = args.renderer
    common = dict(device=device, tonemapper=args.tonemapper, resolution=args.resolution,
                  base_seed=args.seed)
    if key == "mcm":
        sess = RenderSession(key, volume, None, _load_envmap(args),
                             MCMConfig(extinction=args.extinction, bounces=args.bounces,
                                       steps=args.steps),
                             compaction=args.compaction, **common)
    elif key == "eam":
        sess = RenderSession(key, volume, None, EAMConfig(extinction=args.extinction), **common)
    elif key in (*RAY_MARCHERS, *OCCLUSION, "mcs"):
        sess = RenderSession(key, volume, **common)
    else:
        material = (MaterialTF.from_uint8(np.load(args.material)) if args.material
                    else MaterialTF(_ramp_tf()))
        sess = RenderSession(
            key, volume, material,
            LightConfig(direction=tuple(args.light)),
            SpectrumConfig.uniform(args.bins),
            MCMSpectralConfig(extinction=args.extinction, bounces=args.bounces,
                              steps=args.steps),
            streams=args.streams, environment=_load_envmap(args),
            majorant_blocks=args.majorant_blocks, compaction=args.compaction, **common,
        )
    if args.orbit:
        yaw, pitch, dist = args.orbit
        OrbitController(yaw=yaw, pitch=pitch, focus_distance=dist).apply(sess.camera)
        sess.reset()
    return sess


def _save_image(img_u8, path):
    if path.endswith(".npy"):
        np.save(path, img_u8)
        return
    try:
        from PIL import Image

        Image.fromarray(img_u8).save(path)
    except ImportError:
        np.save(path + ".npy", img_u8)
        print(f"PIL unavailable; wrote {path}.npy instead", file=sys.stderr)


def cmd_render(args):
    sess = _make_session(args)
    t0 = time.perf_counter()
    sess.run(args.frames)
    metrics = sess.metrics()
    metrics["wall_seconds"] = time.perf_counter() - t0
    metrics["device"] = str(sess.device)
    _save_image(sess.image_u8(), args.output)
    print(json.dumps(metrics))
    print(f"wrote {args.output}", file=sys.stderr)
    if args.checkpoint:
        sess.save_checkpoint(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}", file=sys.stderr)


def cmd_animate(args):
    import os

    from vpt_tpu_torch.scene.camera import CircleAnimator

    sess = _make_session(args)
    os.makedirs(args.output, exist_ok=True)
    anim = CircleAnimator(center=[0.0, 0.0, args.orbit[2] if args.orbit else 2.0],
                          radius=args.radius)
    frames = sess.record_animation(
        anim, n_frames=args.n_frames, frames_per_pose=args.frames,
        progress=lambda p: print(f"\r{p:4.0%}", end="", file=sys.stderr))
    for i, f in enumerate(frames):
        _save_image(f, os.path.join(args.output, f"frame_{i:04d}.png"))
    print(f"\nwrote {len(frames)} frames to {args.output}", file=sys.stderr)


def cmd_renderers(_args):
    from vpt_tpu_torch.models import RENDERERS

    for key in sorted(RENDERERS):
        print(key)


def cmd_tonemappers(_args):
    from vpt_tpu_torch.postprocess.tonemap import TONEMAPPERS

    for key in sorted(TONEMAPPERS):
        print(key)


def cmd_info(_args):
    import torch

    from vpt_tpu_torch.scene import native_io

    cuda = torch.cuda.is_available()
    print(json.dumps({
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": cuda,
        "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                    if cuda else []),
        "native_io": native_io.available(),
    }, indent=2))


def _cmd_invert_eam(args):
    """EAM inverse rendering (BASELINE config 4's original form): targets
    rendered from the volume at offset 0, then ``fit_density`` from a
    constant 0.2 density."""
    import torch

    from vpt_tpu_torch.kernels.raymarch import eam_frame_pass
    from vpt_tpu_torch.optim import fit_density
    from vpt_tpu_torch.scene.camera import Camera, OrbitController

    device = _device(args)
    target_vol = _load_volume(args)
    tf = np.zeros((256, 256, 4), np.float32)
    tf[..., :3] = 1.0
    tf[..., 3] = np.linspace(0, 1, 256)[None, :]

    cameras = []
    for k in range(args.views):
        cam = Camera()
        OrbitController(yaw=2 * np.pi * k / args.views, pitch=-0.4).apply(cam)
        cameras.append(cam)
    density = torch.as_tensor(np.asarray(target_vol.density, np.float32), device=device)
    tf_t = torch.as_tensor(tf, device=device)
    targets = [eam_frame_pass(c.inverse_mvp(), density, tf_t, args.extinction, 0.0, 32,
                              args.resolution) for c in cameras]
    D = target_vol.density.shape[0]
    params, losses = fit_density(
        targets, cameras, np.full((D, D, D), 0.2, np.float32), tf, extinction=args.extinction,
        slices=32, resolution=args.resolution, iterations=args.iterations,
        progress=lambda i, l: print(f"iter {i}: loss {l:.6f}", file=sys.stderr), device=device)
    rec = params["density"].cpu().numpy()
    np.save(args.output, rec)
    err = float(np.abs(rec - target_vol.density).mean())
    print(json.dumps({"final_loss": float(losses[-1]), "density_mae": err}))


def cmd_invert(args):
    if not args.spectral:
        return _cmd_invert_eam(args)
    device = _device(args)

    from vpt_tpu_torch.scene.camera import Camera
    from vpt_tpu_torch.scene.volume import Volume
    from vpt_tpu_torch.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu_torch.optim import fit_spectral

    target_vol = _load_volume(args)
    table = _ramp_tf()

    def renderer(vol):
        return MCMSpectralRenderer(
            vol, MaterialTF(table), LightConfig(direction=(0.0, 0.0, 0.0)),
            SpectrumConfig(), MCMSpectralConfig(extinction=args.extinction, bounces=8, steps=8),
            resolution=args.resolution, streams=4, pack_tables=True, device=device)

    cam = Camera()
    r_true = renderer(target_vol)
    state = r_true.reset(cam, 999)
    _, target = r_true.render_many(
        state, cam, [(999 + k) * 2654435761 % 2**32 for k in range(128)])

    # heavily smoothed init preserving gross structure
    d = np.asarray(target_vol.density)
    f = max(d.shape[0] // 16, 4)
    n = d.shape[0]
    c = d[: n // f * f, : n // f * f, : n // f * f].reshape(
        n // f, f, n // f, f, n // f, f).mean(axis=(1, 3, 5))
    init = np.repeat(np.repeat(np.repeat(c, f, 0), f, 1), f, 2)
    init = np.pad(init, [(0, n - init.shape[i]) for i in range(3)],
                  mode="edge").astype(np.float32)

    params, losses = fit_spectral(
        target.cpu().numpy(), renderer(Volume(density=init)), cam, {"density": init},
        iterations=args.iterations, method=args.method, scatter_stride=args.scatter_stride,
        scatter_mode=args.scatter_mode,
        progress=lambda i, l: print(f"iter {i}: loss {l:.6f}", file=sys.stderr))
    rec = params["density"].detach().cpu().numpy()
    np.save(args.output, rec)
    err = float(np.abs(rec - d).mean())
    init_err = float(np.abs(init - d).mean())
    print(json.dumps({"final_loss": losses[-1], "density_mae": err,
                      "init_density_mae": init_err}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="vpt-tpu-torch",
                                description="volumetric path tracing, PyTorch + CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device: cuda (the kernels; the default) or cpu "
                             "(the plain PyTorch versions)")
        sp.add_argument("--volume", default="sphere_in_cube")
        sp.add_argument("--volume-size", type=int, default=64)
        sp.add_argument("--dims", help="WxHxD for .raw volumes")
        sp.add_argument("--renderer", default="mcm-spectral")
        sp.add_argument("--tonemapper", default="artistic")
        sp.add_argument("--resolution", type=int, default=512)
        sp.add_argument("--frames", type=int, default=64)
        sp.add_argument("--steps", type=int, default=8)
        sp.add_argument("--bounces", type=int, default=8)
        sp.add_argument("--bins", type=int, default=12)
        sp.add_argument("--extinction", type=float, default=40.0)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--light", type=float, nargs=3, default=[1.0, 0.2, 0.5])
        sp.add_argument("--material", help=".npy uint8 (256,256,4) material TF")
        sp.add_argument("--envmap", help="equirect environment image (PNG/NPY)")
        sp.add_argument("--streams", type=int, default=1,
                        help="parallel sample streams per pixel")
        sp.add_argument("--compaction", action="store_true",
                        help="hit-lane compaction (blur=0): march only pixels that can "
                             "hit the cube; miss pixels take the closed-form value")
        sp.add_argument("--majorant-blocks", type=int, default=None,
                        help="super-voxel majorant grid block size in voxels "
                             "(statistically exact empty-space skipping)")
        sp.add_argument("--devices", type=int, default=None,
                        help="devices to shard over (only 1 is ported)")
        sp.add_argument("--orbit", type=float, nargs=3, metavar=("YAW", "PITCH", "DIST"))

    sp = sub.add_parser("render", help="progressive render to an image")
    common(sp)
    sp.add_argument("--output", "-o", default="render.png")
    sp.add_argument("--checkpoint")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("animate", help="turntable animation")
    common(sp)
    sp.add_argument("--output", "-o", default="animation")
    sp.add_argument("--n-frames", type=int, default=24)
    sp.add_argument("--radius", type=float, default=0.5)
    sp.set_defaults(fn=cmd_animate)

    sp = sub.add_parser("renderers")
    sp.set_defaults(fn=cmd_renderers)
    sp = sub.add_parser("tonemappers")
    sp.set_defaults(fn=cmd_tonemappers)
    sp = sub.add_parser("info")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("invert", help="inverse rendering (EAM, or spectral MCM)")
    common(sp)
    sp.add_argument("--output", "-o", default="recovered.npy")
    sp.add_argument("--views", type=int, default=4)
    sp.add_argument("--iterations", type=int, default=200)
    sp.add_argument("--spectral", action="store_true",
                    help="spectral-MCM inverse rendering")
    sp.add_argument("--method", choices=["prb", "autodiff"], default=None,
                    help="gradient estimator: prb (the packed-adjoint backward, the default) "
                         "or autodiff (the score-function surrogate)")
    sp.add_argument("--scatter-stride", default="auto",
                    type=lambda s: s if s == "auto" else int(s),
                    help="PRB scatter thinning stride; 'auto' probes the live-gradient "
                         "fraction and anneals to exact on eval-loss stall")
    sp.add_argument("--scatter-mode", choices=["stride", "importance"], default="stride",
                    help="thinning step selection for a forced integer stride")
    sp.set_defaults(fn=cmd_invert)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
