"""The spectral MCM forward kernels: wrappers, plain versions, launch counts.

Three kernels of ``vpt_tpu_torch/csrc/mcm_spectral.cu``:

- ``step``: K render dispatches of ``steps`` Woodcock iterations, in place
  (replaces ``vpt_tpu/models/mcm_spectral.py::_render_body`` looped by
  ``render_many``); plain version ``step_plain``.
- ``reset``: fresh photons (replaces ``full_reset``); plain version
  ``reset_plain``.
- ``sample_volume_packed``: a standalone packed-volume lookup (replaces
  ``interp._sample_volume_packed``); plain version
  ``sample_volume_packed_plain``.

Each wrapper runs its plain version when its tensors lie on the CPU, and
launches the CUDA kernel when they lie on a CUDA device; anything else
raises. ``LAUNCHES`` counts kernel launches (never plain runs).

The plain versions take tensors on any device, so tests and
``chip_smoke.py`` can compare kernel and plain version on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.ops import geometry, interp, sampling

# must match MAX_BINS / F_COUNT / I_COUNT in csrc/mcm_spectral.cu
MAX_BINS = 32
_F_COUNT = 24 + MAX_BINS + 1
_I_COUNT = 14

LAUNCHES = {"step": 0, "reset": 0, "sample_volume_packed": 0}

STATE_FIELDS = ("px", "py", "pz", "dx", "dy", "dz", "bounces", "samples",
                "bin", "wavelength", "radiance", "transmittance")
_INT_FIELDS = ("bounces", "samples", "bin")


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _f32(x) -> float:
    """A Python float holding the float32 rounding of ``x``."""
    return float(np.float32(x))


def light_terms(light_direction):
    """Normalized light direction (float32) and whether the light is
    isotropic (|direction| < 1e-5), as the reference computes them."""
    ld = np.asarray(light_direction, np.float32)
    norm = np.sqrt(ld[0] * ld[0] + ld[1] * ld[1] + ld[2] * ld[2])
    ldn = ld / np.maximum(norm, np.float32(1e-30))
    return tuple(float(v) for v in ldn), bool(norm < np.float32(1e-5))


def _lane_shape(resolution: int, streams: int):
    return (resolution, resolution) if streams == 1 else (streams, resolution, resolution)


def _pixel_grid(resolution: int, streams: int, device):
    """(ix, iy, seed_iy) int64 lane tensors; stream s seeds as row y + s*H."""
    shape = (streams, resolution, resolution)
    s = torch.arange(streams, dtype=torch.int64, device=device).view(-1, 1, 1).expand(shape)
    iy = torch.arange(resolution, dtype=torch.int64, device=device).view(1, -1, 1).expand(shape)
    ix = torch.arange(resolution, dtype=torch.int64, device=device).view(1, 1, -1).expand(shape)
    seed_iy = iy + s * resolution
    lane = _lane_shape(resolution, streams)
    return ix.reshape(lane), iy.reshape(lane), seed_iy.reshape(lane)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def _wavelength_to_bin(lam, boundaries, n_bins):
    """bin = number of internal boundaries b_1..b_{n-1} that are <= lam."""
    b = torch.zeros(lam.shape, dtype=torch.int32, device=lam.device)
    for i in range(1, n_bins):
        b = b + (lam >= float(boundaries[i])).to(torch.int32)
    return b


def _respawn(rng, mask, sx, sy, ctx, n_bins):
    """New camera ray + hero wavelength where ``mask`` (draws: disk 2 +
    square 2 + wavelength 1). Returns (rng, dict of new lane values)."""
    inv_res = _f32(np.float32(1.0) / np.float32(sx.shape[-1]))
    rng, (fx, fy, fz), (tx, ty, tz) = geometry.unproject_rand(
        rng, mask, sx, sy, ctx.inv_mvp, inv_res, _f32(ctx.blur))
    ndx, ndy, ndz = geometry.normalize3(tx - fx, ty - fy, tz - fz)
    tnear, _ = geometry.intersect_cube(fx, fy, fz, ndx, ndy, ndz)
    tnear = torch.maximum(tnear, torch.zeros_like(tnear))
    bounds = np.asarray(ctx.boundaries, np.float32)
    lo, hi = bounds[0], bounds[n_bins]
    rng, u = sampling.draw(rng, mask)
    lam = u * float(hi - lo) + float(lo)
    return rng, dict(
        px=fx + tnear * ndx, py=fy + tnear * ndy, pz=fz + tnear * ndz,
        dx=ndx, dy=ndy, dz=ndz, wavelength=lam,
        bin=_wavelength_to_bin(lam, bounds, n_bins),
    )


def _render_body(p, rng, sx, sy, ctx, n_bins, light, collect: bool = False):
    """One Woodcock iteration over all lanes; ``p``: dict of lane tensors.
    Same order of operations and draws as the JAX ``_render_body``.

    ``collect``: also return the step's internals, the quantities the
    packed-adjoint backward tapes (``kernels/spectral_backward.py``), as
    the JAX ``_render_body(collect=True)`` returns them."""
    all_mask = torch.ones(rng.shape, dtype=torch.bool, device=rng.device)
    rng, dist = sampling.draw_exponential(rng, all_mask, _f32(ctx.extinction))
    px = p["px"] + dist * p["dx"]
    py = p["py"] + dist * p["dy"]
    pz = p["pz"] + dist * p["dz"]
    oob = (px > 1.0) | (px < 0.0) | (py > 1.0) | (py < 0.0) | (pz > 1.0) | (pz < 0.0)

    # material lookup (sampled, clamped, even when out of bounds)
    t = sampling.div_scalar(p["wavelength"] - 400.0, 300.0)
    dens = interp.sample_volume_packed(ctx.density.table, ctx.density.dims, px, py, pz)
    mat, light_raw, tf_extras = interp.sample_tex2d_fused1d(ctx.material_tf, t, dens,
                                                            return_extras=True)
    albedo = mat[..., 0]
    alpha = mat[..., 1]
    g = mat[..., 2] * 2.0 - 1.0

    zero = torch.zeros_like(alpha)
    p_null = 1.0 - alpha
    p_scatter = torch.where(p["bounces"] >= int(ctx.max_bounces), zero, alpha * albedo)
    p_absorb = 1.0 - p_null - p_scatter
    rng, wheel = sampling.draw(rng, all_mask)

    event = ~oob
    absorb = event & (wheel < p_absorb)
    scatter = event & ~absorb & (wheel < p_absorb + p_scatter)
    null = event & ~absorb & ~scatter
    respawn = oob | absorb

    # radiance deposit: incremental one-hot mean over all bins
    (lx, ly, lz), isotropic = light
    intensity = light_raw * 5.0
    if isotropic:
        escape = intensity
    else:
        dot = p["dx"] * lx + p["dy"] * ly + p["dz"] * lz
        escape = torch.maximum(dot * intensity, zero)
    emitted = torch.where(oob, escape, zero)
    samples = p["samples"] + respawn.to(torch.int32)
    bins = torch.arange(n_bins, dtype=torch.int32, device=rng.device)
    one_hot = bins.view((-1,) + (1,) * p["bin"].ndim) == p["bin"][None]
    target = torch.where(one_hot, emitted[None], torch.zeros_like(p["radiance"]))
    denom = torch.clamp_min(samples, 1).to(torch.float32)[None]
    radiance = torch.where(respawn[None], p["radiance"] + (target - p["radiance"]) / denom,
                           p["radiance"])

    rng, new = _respawn(rng, respawn, sx, sy, ctx, n_bins)
    rng, (hx, hy, hz) = sampling.draw_hg(rng, scatter, g, p["dx"], p["dy"], p["dz"])

    out = dict(
        px=torch.where(respawn, new["px"], px),
        py=torch.where(respawn, new["py"], py),
        pz=torch.where(respawn, new["pz"], pz),
        dx=torch.where(respawn, new["dx"], torch.where(scatter, hx, p["dx"])),
        dy=torch.where(respawn, new["dy"], torch.where(scatter, hy, p["dy"])),
        dz=torch.where(respawn, new["dz"], torch.where(scatter, hz, p["dz"])),
        bounces=torch.where(respawn, torch.zeros_like(p["bounces"]),
                            p["bounces"] + scatter.to(torch.int32)),
        samples=samples,
        bin=torch.where(respawn, new["bin"], p["bin"]),
        wavelength=torch.where(respawn, new["wavelength"], p["wavelength"]),
        radiance=radiance,
    )
    if collect:
        internals = dict(
            dist=dist, sample_pos=(px, py, pz), pre_dir=(p["dx"], p["dy"], p["dz"]),
            pre_bin=p["bin"], albedo=albedo, alpha=alpha, g=g, null=null,
            scatter=scatter, oob=oob, respawn=respawn, emitted=emitted,
            hg_cos=hx * p["dx"] + hy * p["dy"] + hz * p["dz"], tf_extras=tf_extras,
        )
        return out, rng, internals
    return out, rng


def step_plain(state, ctx, seeds, steps: int, n_bins: int):
    """Plain PyTorch ``step``: for each frame seed, re-seed every lane's
    chain and run ``steps`` Woodcock iterations. Updates ``state`` in place
    (the JAX version donates it) and returns it."""
    resolution = state.px.shape[-1]
    streams = state.px.shape[0] if state.px.ndim == 3 else 1
    device = state.px.device
    ix, iy, seed_iy = _pixel_grid(resolution, streams, device)
    sx, sy = geometry.screen_position(ix, iy, _f32(np.float32(1.0) / np.float32(resolution)))
    light = light_terms(ctx.light_direction)
    p = {k: getattr(state, k) for k in STATE_FIELDS if k != "transmittance"}
    for seed in np.asarray(seeds, np.uint32).reshape(-1):
        rng = sampling.seed_state(ix, seed_iy, int(seed))
        for _ in range(steps):
            p, rng = _render_body(p, rng, sx, sy, ctx, n_bins, light)
    for k, v in p.items():
        getattr(state, k).copy_(v)
    return state


def reset_plain(ctx, resolution: int, n_bins: int, streams: int, device):
    """Plain PyTorch ``reset``: dict of fresh state tensors (radiance and
    transmittance = 1, the reference's quirk)."""
    ix, iy, seed_iy = _pixel_grid(resolution, streams, device)
    sx, sy = geometry.screen_position(ix, iy, _f32(np.float32(1.0) / np.float32(resolution)))
    rng = sampling.seed_state(ix, seed_iy, ctx.seed_bits)
    mask = torch.ones(ix.shape, dtype=torch.bool, device=device)
    _, new = _respawn(rng, mask, sx, sy, ctx, n_bins)
    lane = ix.shape
    shape = (n_bins,) + tuple(lane)
    return dict(
        px=new["px"], py=new["py"], pz=new["pz"],
        dx=new["dx"], dy=new["dy"], dz=new["dz"],
        bounces=torch.zeros(lane, dtype=torch.int32, device=device),
        samples=torch.zeros(lane, dtype=torch.int32, device=device),
        bin=new["bin"], wavelength=new["wavelength"],
        radiance=torch.ones(shape, dtype=torch.float32, device=device),
        transmittance=torch.ones(shape, dtype=torch.float32, device=device),
    )


def sample_volume_packed_plain(table, dims, u, v, w):
    """Plain PyTorch ``sample_volume_packed``."""
    return interp.sample_volume_packed(table, dims, u, v, w)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def _route(*tensors) -> str:
    """"cpu" when every tensor lies on the CPU, "cuda" when all lie on one
    CUDA device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _check(t: torch.Tensor, name: str, dtype, shape=None, align: int = 4):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer not {align}-byte aligned")


def _stream(device) -> int:
    """PyTorch's current stream on ``device`` (callers hold the device
    current, so the launch goes to the same device)."""
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def _params(ctx, resolution, streams, n_bins, steps=0, n_seeds=0):
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins={n_bins} outside [1, {MAX_BINS}]")
    if streams * resolution * resolution >= 2**31:
        raise ValueError("more than 2**31 - 1 lanes")
    f = np.zeros(_F_COUNT, np.float32)
    f[0:16] = np.asarray(ctx.inv_mvp, np.float32).reshape(16)
    f[16] = ctx.extinction
    f[17] = ctx.blur
    f[18] = np.float32(1.0) / np.float32(resolution)
    (lx, ly, lz), isotropic = light_terms(ctx.light_direction)
    f[19:22] = (lx, ly, lz)
    bounds = np.asarray(ctx.boundaries, np.float32)
    if bounds.shape != (n_bins + 1,):
        raise ValueError(f"boundaries shape {bounds.shape} != ({n_bins + 1},)")
    f[22] = bounds[0]
    f[23] = bounds[n_bins] - bounds[0]
    f[24:24 + n_bins + 1] = bounds
    vol, tf = ctx.density, ctx.material_tf
    i = np.array([
        int(isotropic), n_bins, int(ctx.max_bounces), steps, n_seeds, streams,
        resolution, int(vol.table.dtype == torch.uint8), *vol.dims,
        tf.shape[0], tf.shape[1], streams * resolution * resolution,
    ], np.int32)
    assert i.shape == (_I_COUNT,)
    return f, i


def _check_layout(lib):
    if (lib.vpt_layout(0), lib.vpt_layout(1), lib.vpt_layout(2)) != (MAX_BINS, _F_COUNT, _I_COUNT):
        raise RuntimeError("kernel library parameter layout does not match the wrapper")


def _check_tables(ctx):
    vol = ctx.density
    _check(vol.table, "density table", vol.table.dtype, (int(np.prod(vol.dims)), 8), align=16)
    if ctx.material_tf.ndim != 3 or ctx.material_tf.shape[-1] != 18:
        raise ValueError(f"material_tf must be a fused (Hp, Wp, 18) table, got {tuple(ctx.material_tf.shape)}")
    _check(ctx.material_tf, "material_tf", torch.float32)


def _check_state(state, n_bins):
    lane = tuple(state.px.shape)
    if len(lane) not in (2, 3) or lane[-1] != lane[-2]:
        raise ValueError(f"lane shape must be (H, W) or (S, H, W) with H == W, got {lane}")
    for k in STATE_FIELDS:
        t = getattr(state, k)
        shape = (n_bins,) + lane if k in ("radiance", "transmittance") else lane
        _check(t, k, torch.int32 if k in _INT_FIELDS else torch.float32, shape)


def step(state, ctx, seeds, steps: int, n_bins: int):
    """K render dispatches (one per frame seed) of ``steps`` iterations,
    updating ``state`` in place; one kernel launch on a CUDA device."""
    tensors = [getattr(state, k) for k in STATE_FIELDS] + [ctx.density.table, ctx.material_tf]
    if _route(*tensors) == "cpu":
        return step_plain(state, ctx, seeds, steps, n_bins)
    _check_state(state, n_bins)
    _check_tables(ctx)
    seeds = np.asarray(seeds, np.uint32).reshape(-1)
    lane = tuple(state.px.shape)
    streams = lane[0] if len(lane) == 3 else 1
    f, i = _params(ctx, lane[-1], streams, n_bins, steps, len(seeds))
    lib = _build.load()
    _check_layout(lib)
    device = state.px.device
    seeds_dev = torch.as_tensor(seeds.view(np.int32), device=device)
    with torch.cuda.device(device):
        err = lib.vpt_mcm_spectral_step(
            f.ctypes.data, i.ctypes.data,
            *(getattr(state, k).data_ptr() for k in STATE_FIELDS[:11]),
            ctx.density.table.data_ptr(), ctx.material_tf.data_ptr(),
            seeds_dev.data_ptr(), _stream(device))
    _raise_on(err, "mcm_spectral_step")
    LAUNCHES["step"] += 1
    return state


def reset(ctx, resolution: int, n_bins: int, streams: int, device):
    """Fresh photon state (dict of tensors) on ``device``."""
    device = torch.device(device)
    route = _route(ctx.density.table, ctx.material_tf)
    if route != device.type:
        raise ValueError(f"scene tables lie on {route}, state requested on {device}")
    if route == "cpu":
        return reset_plain(ctx, resolution, n_bins, streams, device)
    _check_tables(ctx)
    device = ctx.density.table.device
    f, i = _params(ctx, resolution, streams, n_bins)
    lane = _lane_shape(resolution, streams)
    out = {k: torch.empty(lane, dtype=torch.int32 if k in _INT_FIELDS else torch.float32,
                          device=device) for k in STATE_FIELDS[:10]}
    for k in ("radiance", "transmittance"):
        out[k] = torch.empty((n_bins,) + lane, dtype=torch.float32, device=device)
    lib = _build.load()
    _check_layout(lib)
    with torch.cuda.device(device):
        err = lib.vpt_mcm_spectral_reset(
            f.ctypes.data, i.ctypes.data, int(ctx.seed_bits) & 0xFFFFFFFF,
            *(out[k].data_ptr() for k in STATE_FIELDS), _stream(device))
    _raise_on(err, "mcm_spectral_reset")
    LAUNCHES["reset"] += 1
    return out


def sample_volume_packed(table: torch.Tensor, dims, u, v, w):
    """Trilinear density at (u, v, w) from a flat (rows, 8) u8|f32 corner table."""
    if _route(table, u, v, w) == "cpu":
        return sample_volume_packed_plain(table, dims, u, v, w)
    dims = tuple(int(d) for d in dims)
    if table.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"table: expected uint8 or float32, got {table.dtype}")
    _check(table, "table", table.dtype, (int(np.prod(dims)), 8), align=16)
    n = u.numel()
    for t, name in ((u, "u"), (v, "v"), (w, "w")):
        _check(t, name, torch.float32, u.shape)
    out = torch.empty_like(u)
    lib = _build.load()
    with torch.cuda.device(table.device):
        err = lib.vpt_sample_volume_packed(
            table.data_ptr(), int(table.dtype == torch.uint8), *dims,
            u.data_ptr(), v.data_ptr(), w.data_ptr(), out.data_ptr(), n,
            _stream(table.device))
    _raise_on(err, "sample_volume_packed")
    LAUNCHES["sample_volume_packed"] += 1
    return out
