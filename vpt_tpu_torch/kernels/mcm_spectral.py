"""The spectral MCM forward kernels: wrappers, plain versions, launch counts.

Five kernels of ``vpt_tpu_torch/csrc/mcm_spectral.cu``:

- ``step``: K render dispatches of ``steps`` Woodcock iterations, in place
  (replaces ``vpt_tpu/models/mcm_spectral.py::_render_body`` looped by
  ``render_many``, and ``mcm_spectral_compact.render_compact_many`` over a
  lane table); plain version ``step_plain``. The ctx picks the mode: the
  super-voxel majorant (``ctx.majorant``), the environment map
  (``ctx.environment``), the quasicubic filter (``ctx.volume_filter``), the
  xy half-packed volume (``ctx.density.kind == "xy"``), raw or partly
  packed tables (``is_raw``: a raw grid, with the nearest filter too, a
  raw or 16-wide TF with the light's own table, a raw env map).
- ``reset``: fresh photons (replaces ``full_reset`` and ``compact_reset``);
  plain version ``reset_plain``.
- ``compact_radiance``: each hit pixel's mean over its stream lanes, the
  closed-form value elsewhere (replaces the scatter of
  ``mcm_spectral_compact.compact_image``); plain version
  ``compact_radiance_plain``.
- ``sample_volume_packed``: a standalone packed-volume lookup, full or xy
  table (replaces ``interp._sample_volume_packed`` and
  ``_sample_volume_packed_xy``); plain version ``sample_volume_packed_plain``.
- ``sample_volume_raw``: a standalone raw-grid lookup, linear, quasicubic
  or nearest (replaces ``interp.sample_volume`` on a raw grid); plain
  version ``sample_volume_raw_plain``.

``step`` and ``reset`` take an optional lane table ``lanes = (ix, iy,
seed_iy)``, int32 tensors of the lane shape (hit-lane compaction); without
one the lanes are the (S, H, W) pixel grid.

Each wrapper runs its plain version when its tensors lie on the CPU, and
launches the CUDA kernel when they lie on a CUDA device; anything else
raises. ``LAUNCHES`` counts kernel launches (never plain runs); a step
launch also counts under each mode it ran (``step_majorant``,
``step_environment``, ``step_quasicubic``, ``step_xy``, ``step_raw``,
``step_lane_table``),
a reset over a lane table under ``reset_lane_table``, a lookup in an xy
table under ``sample_volume_packed_xy``.

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
_I_COUNT = 28
# TfKind and LightKind of csrc/mcm_common.cuh
_TF_KIND = {18: 0, 4: 1, 16: 2}
_LIGHT_FUSED, _LIGHT_RAW, _LIGHT_PAIR = 0, 1, 2

LAUNCHES = {"step": 0, "reset": 0, "compact_radiance": 0, "sample_volume_packed": 0,
            "step_majorant": 0, "step_environment": 0, "step_quasicubic": 0, "step_xy": 0,
            "step_raw": 0, "step_lane_table": 0, "reset_lane_table": 0,
            "sample_volume_packed_xy": 0, "sample_volume_raw": 0}

# f32 constants of the environment lookup (vpt_tpu/models/mcm_spectral.py:155-158)
INV_PI = float(np.float32(1.0 / np.pi))
ENV_GAIN = float(np.float32(2.7))

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


def _lane_grid(resolution: int, streams: int, device, lanes=None):
    """(ix, iy, seed_iy) int64 lane tensors: the pixel grid, or the given
    lane table (hit-lane compaction)."""
    if lanes is None:
        return _pixel_grid(resolution, streams, device)
    return tuple(t.to(device=device, dtype=torch.int64) for t in lanes)


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


def sample_environment(env, dx, dy, dz, lam):
    """Escape radiance from a packed (He+1, We+1, 12) or raw (He, We, 3)
    equirect map: the
    reference's mapping (y quirk kept), gain 2.7, channel by wavelength
    (< 500 nm blue, < 600 green, else red). Same f32 operations, in the
    same order, as the JAX ``_sample_environment``."""
    u = torch.atan2(dx, -dz) * INV_PI * 0.5 + 0.5
    v = torch.asin(-dy) * 2.0 * INV_PI * 0.5 + 0.5
    color = interp.sample_tex2d(env, u, v) * ENV_GAIN
    return torch.where(lam < 500.0, color[..., 2],
                       torch.where(lam < 600.0, color[..., 1], color[..., 0]))


def env_addr(env, dx, dy, dz, lam):
    """Where an escape's lookup in a packed (He+1, We+1, 12) equirect map
    reads, as ``sample_environment`` addresses it: (row of the flat (rows,
    12) map, fx, fy, the wavelength's channel), row and channel int64."""
    Hp, Wp, _ = env.shape
    u = torch.atan2(dx, -dz) * INV_PI * 0.5 + 0.5
    v = torch.asin(-dy) * 2.0 * INV_PI * 0.5 + 0.5
    bx, fx = interp._base_and_frac(u, Wp - 1)
    by, fy = interp._base_and_frac(v, Hp - 1)
    band = torch.where(lam < 500.0, 2, torch.where(lam < 600.0, 1, 0))
    return (by * Wp + bx).to(torch.int64), fx, fy, band.to(torch.int64)


def add_env_texels_plain(g_env, row, band, g, fx, fy):
    """Plain ``add_env_texels`` (csrc/adjoint_common.cuh): adds ``g`` times
    the bilinear weights of (fx, fy) on channel ``band`` of the 4 corners of
    each lane's row of the (rows, 12) adjoint ``g_env``."""
    w = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
    v12 = torch.zeros((g.shape[0], 12), dtype=g.dtype, device=g.device)
    for k, wk in enumerate(w):
        v12.scatter_(1, (3 * k + band)[:, None], (g * wk)[:, None])
    g_env.index_add_(0, row, v12)


def _surrogate(prob, taken):
    """Score-function factor of an event: 1.0 where ``taken``, carrying
    d log P / d params under autograd (JAX ``_surrogate``); no gradient
    where P is below the 1e-12 floor, half of it at the floor."""
    safe = torch.maximum(prob, torch.full_like(prob, 1e-12))
    return torch.where(taken, safe / safe.detach(), torch.ones_like(prob))


def free_flight(p, rng, ctx):
    """The free flight of a Woodcock iteration (JAX ``_render_body``'s
    first draw): (rng, dist, maj, capped). With a majorant grid the flight
    samples at the local rate extinction * m of the pre-step position's
    cell and stops at its cap (``capped``); without one, maj and capped are
    None. ``ctx.extinction`` may be a 0-d tensor; the draw keeps its
    float32 value."""
    all_mask = torch.ones(rng.shape, dtype=torch.bool, device=rng.device)
    ext_f = _f32(float(torch.as_tensor(ctx.extinction).detach()))
    if ctx.majorant is None:
        rng, dist = sampling.draw_exponential(rng, all_mask, ext_f)
        return rng, dist, None, None
    Gz, Gy, Gx, _ = ctx.majorant.shape
    # the pre-step position's cell: clip(int32(floor(p*n)), 0, n-1) per axis
    cell = ((interp._nearest_coords(p["pz"], Gz) * Gy + interp._nearest_coords(p["py"], Gy))
            * Gx + interp._nearest_coords(p["px"], Gx))
    row = ctx.majorant.reshape(-1, 2)[cell.to(torch.int64)]
    maj = torch.clamp_min(row[..., 0], 1e-12)
    flight_cap = row[..., 1]
    rng, dist = sampling.draw_exponential(rng, all_mask, maj * ext_f)
    # a flight past the cap is a pure advance by the cap (no event)
    capped = dist >= flight_cap
    return rng, torch.minimum(dist, flight_cap), maj, capped


def sample_position(p, dist):
    """The flight's end (px, py, pz) and whether it left the unit cube."""
    px = p["px"] + dist * p["dx"]
    py = p["py"] + dist * p["dy"]
    pz = p["pz"] + dist * p["dz"]
    oob = (px > 1.0) | (px < 0.0) | (py > 1.0) | (py < 0.0) | (pz > 1.0) | (pz < 0.0)
    return px, py, pz, oob


def _render_body(p, rng, sx, sy, ctx, n_bins, light, collect: bool = False, score=None):
    """One Woodcock iteration over all lanes; ``p``: dict of lane tensors.
    Same order of operations and draws as the JAX ``_render_body``,
    including its majorant and environment branches.

    ``collect``: also return the step's internals, the quantities the
    packed-adjoint backward and the surrogate tape record
    (``kernels/spectral_backward.py``, ``kernels/surrogate.py``), as the
    JAX ``_render_body(collect=True)`` returns them.

    ``score``: the per-lane score weight of the autodiff surrogate (JAX
    ``diff=True``): the free flight in score form (the distance detached,
    d log p(dist) on the score), the event factors ``_surrogate``, the
    deposit times the score, 1 after a respawn. Returns (p, rng, score).
    Forward values equal the plain step's bit for bit; under torch
    autograd this is the surrogate's autograd twin, a test oracle.
    ``ctx.extinction`` may then be a 0-d tensor; the draw keeps its
    float32 value."""
    diff = score is not None
    rng, dist, maj, capped = free_flight(p, rng, ctx)
    if diff:
        # d log p(dist; extinction) on the score, the distance detached; in
        # majorant mode the rate extinction * m with m detached, and a
        # capped flight's log-survival term alone
        ext_t = torch.as_tensor(ctx.extinction, dtype=torch.float32, device=rng.device)
        if maj is not None:
            rate = ext_t * maj.detach()
            logp = (torch.where(capped, torch.zeros_like(dist), torch.log(rate))
                    - rate * dist.detach())
        else:
            logp = torch.log(ext_t) - ext_t * dist.detach()
        score = score * torch.exp(logp - logp.detach())
        dist = dist.detach()
    px, py, pz, oob = sample_position(p, dist)

    # material lookup (sampled, clamped, even when out of bounds)
    dens = interp.sample_volume(ctx.density, px, py, pz, ctx.volume_filter)
    return after_lookup(p, rng, sx, sy, ctx, n_bins, light, dist, maj, capped,
                        (px, py, pz), oob, dens, collect, score)


def after_lookup(p, rng, sx, sy, ctx, n_bins, light, dist, maj, capped, pos, oob, dens,
                 collect: bool = False, score=None):
    """The rest of a Woodcock iteration from the flight (``free_flight``,
    ``sample_position``) and the density at its end: the TF, the event
    wheel, the deposit, the respawn and the HG scatter; returns what
    ``_render_body`` returns."""
    diff = score is not None
    all_mask = torch.ones(rng.shape, dtype=torch.bool, device=rng.device)
    px, py, pz = pos
    t = sampling.div_scalar(p["wavelength"] - 400.0, 300.0)
    if ctx.material_tf.shape[-1] == 18:
        # the fused TF+light table: one row holds both
        mat, light_raw, tf_extras = interp.sample_tex2d_fused1d(ctx.material_tf, t, dens,
                                                                return_extras=True)
    else:
        # a raw or 16-wide TF and the light from its own raw or pair table
        mat, tf_extras = interp.sample_tex2d(ctx.material_tf, t, dens), None
        light_raw = interp.sample_tex1d(ctx.light_spectrum, t)
    albedo = mat[..., 0]
    alpha = mat[..., 1]
    g = mat[..., 2] * 2.0 - 1.0

    zero = torch.zeros_like(alpha)
    if maj is not None:
        # acceptance against the local majorant: real event with p alpha/m
        # (torch.minimum: half the gradient at a tie, like jnp.minimum)
        p_real = torch.minimum(alpha / maj.detach(), torch.ones_like(alpha))
        p_scatter = torch.where(p["bounces"] >= int(ctx.max_bounces), zero, p_real * albedo)
        p_absorb = p_real - p_scatter
        p_null = 1.0 - p_real
    else:
        p_null = 1.0 - alpha
        p_scatter = torch.where(p["bounces"] >= int(ctx.max_bounces), zero, alpha * albedo)
        p_absorb = 1.0 - p_null - p_scatter
    rng, wheel = sampling.draw(rng, all_mask)

    event = ~oob if maj is None else ~oob & ~capped
    absorb = event & (wheel < p_absorb)
    scatter = event & ~absorb & (wheel < p_absorb + p_scatter)
    null = event & ~absorb & ~scatter
    respawn = oob | absorb

    # radiance deposit: incremental one-hot mean over all bins
    (lx, ly, lz), isotropic = light
    intensity = light_raw * 5.0
    if ctx.environment is not None:
        escape = sample_environment(ctx.environment, p["dx"], p["dy"], p["dz"],
                                    p["wavelength"])
    elif isotropic:
        escape = intensity
    else:
        dot = p["dx"] * lx + p["dy"] * ly + p["dz"] * lz
        escape = torch.maximum(dot * intensity, zero)
    emitted = torch.where(oob, escape, zero)
    deposit = emitted * score if diff else emitted
    samples = p["samples"] + respawn.to(torch.int32)
    bins = torch.arange(n_bins, dtype=torch.int32, device=rng.device)
    one_hot = bins.view((-1,) + (1,) * p["bin"].ndim) == p["bin"][None]
    target = torch.where(one_hot, deposit[None], torch.zeros_like(p["radiance"]))
    denom = torch.clamp_min(samples, 1).to(torch.float32)[None]
    radiance = torch.where(respawn[None], p["radiance"] + (target - p["radiance"]) / denom,
                           p["radiance"])

    # the lane's chain before its disk draw (a respawn's or an HG scatter's)
    rng_disk = rng
    rng, new = _respawn(rng, respawn, sx, sy, ctx, n_bins)
    rng, (hx, hy, hz) = sampling.draw_hg(rng, scatter, g, p["dx"], p["dy"], p["dz"])
    if diff:
        score = score * _surrogate(p_null, null) * _surrogate(p_scatter, scatter)
        score = torch.where(respawn, torch.ones_like(score), score)

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
            pre_bin=p["bin"], dens=dens, albedo=albedo, alpha=alpha, g=g, null=null,
            scatter=scatter, oob=oob, respawn=respawn, emitted=emitted,
            hg_cos=hx * p["dx"] + hy * p["dy"] + hz * p["dz"], tf_extras=tf_extras,
            capped=capped, maj=maj, rng_disk=rng_disk, pre_wavelength=p["wavelength"],
        )
        return out, rng, internals
    if diff:
        return out, rng, score
    return out, rng


def render_diff_plain(p, score, ctx, seeds, steps: int, n_bins: int):
    """The autograd twin of the surrogate: ``steps`` iterations per frame
    seed of the diff ``_render_body`` on the state dict ``p`` (float
    fields may require grad) and the (lanes) score; returns (p, score),
    new tensors that torch autograd differentiates. A test oracle: the
    port's gradient comes from ``kernels/surrogate.py``."""
    resolution = p["px"].shape[-1]
    streams = p["px"].shape[0] if p["px"].ndim == 3 else 1
    device = p["px"].device
    ix, iy, seed_iy = _pixel_grid(resolution, streams, device)
    sx, sy = geometry.screen_position(ix, iy, _f32(np.float32(1.0) / np.float32(resolution)))
    light = light_terms(ctx.light_direction)
    p = {k: p[k] for k in STATE_FIELDS if k != "transmittance"}
    for seed in np.asarray(seeds, np.uint32).reshape(-1):
        rng = sampling.seed_state(ix, seed_iy, int(seed))
        for _ in range(steps):
            p, rng, score = _render_body(p, rng, sx, sy, ctx, n_bins, light, score=score)
    return p, score


def step_plain(state, ctx, seeds, steps: int, n_bins: int, lanes=None):
    """Plain PyTorch ``step``: for each frame seed, re-seed every lane's
    chain and run ``steps`` Woodcock iterations. Updates ``state`` in place
    (the JAX version donates it) and returns it. ``lanes``: a lane table
    (ix, iy, seed_iy) of the state's lane shape, or None for the grid."""
    resolution = state.px.shape[-1]
    streams = state.px.shape[0] if state.px.ndim == 3 else 1
    device = state.px.device
    ix, iy, seed_iy = _lane_grid(resolution, streams, device, lanes)
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


def reset_plain(ctx, resolution: int, n_bins: int, streams: int, device, lanes=None):
    """Plain PyTorch ``reset``: dict of fresh state tensors (radiance and
    transmittance = 1, the reference's quirk); over ``lanes`` when given."""
    ix, iy, seed_iy = _lane_grid(resolution, streams, device, lanes)
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


def sample_volume_packed_plain(table, dims, u, v, w, kind: str = "full"):
    """Plain PyTorch ``sample_volume_packed``."""
    return interp.sample_volume_packed(table, dims, u, v, w, kind=kind)


def compact_radiance_plain(radiance, pixel_hit, miss, n_hit: int, streams: int):
    """Plain PyTorch ``compact_radiance``. ``radiance``: (B, M, res) lane
    radiance with lane s*n_hit + k holding stream s of hit pixel k;
    ``pixel_hit``: (res*res,) int32, the hit index k of each pixel or -1;
    ``miss``: (B, res, res) closed-form radiance. Returns (B, res, res):
    for a hit pixel the sum over s = 0..S-1, in that order, divided by S
    (no atomics: the same bits on every run); elsewhere ``miss``."""
    B = radiance.shape[0]
    lanes = radiance.reshape(B, -1)[:, :streams * n_hit].reshape(B, streams, n_hit)
    acc = torch.zeros((B, n_hit), dtype=torch.float32, device=radiance.device)
    for s in range(streams):
        acc = acc + lanes[:, s]
    out = miss.clone().reshape(B, -1)
    hit = torch.nonzero(pixel_hit >= 0).reshape(-1)
    out[:, hit] = sampling.div_scalar(acc, float(streams))
    return out.reshape(miss.shape)


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


def _params(ctx, resolution, streams, n_bins, steps=0, n_seeds=0, n_lanes=None, vol_dims=None):
    """K1's parameter block (csrc/mcm_common.cuh FParam, IParam) for ``ctx``.
    ``vol_dims``: the padded (Dp, Hp, Wp) a packed lookup addresses, when
    not the table's own (a z-slab of the table, ``parallel/slab.py``)."""
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins={n_bins} outside [1, {MAX_BINS}]")
    if n_lanes is None:
        n_lanes = streams * resolution * resolution
    if n_lanes >= 2**31:
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
    vol, tf, light, env = ctx.density, ctx.material_tf, ctx.light_spectrum, ctx.environment
    # a raw table of n texels along an axis gives that axis as n + 1
    # (csrc/mcm_common.cuh IParam)
    vol_raw = not isinstance(vol, interp.PackedVolume)
    dims = tuple(d + 1 for d in vol.shape) if vol_raw else vol_dims or vol.dims
    tf_kind = _TF_KIND[tf.shape[-1]]
    tf_dims = (tf.shape[0] + 1, tf.shape[1] + 1) if tf_kind == 1 else tf.shape[:2]
    light_kind = (_LIGHT_FUSED if tf_kind == 0 else _LIGHT_PAIR if light.ndim == 2
                  else _LIGHT_RAW)
    light_n = light.shape[0] - (light.ndim == 2)
    env_raw = env is not None and env.shape[-1] == 3
    env_dims = (0, 0) if env is None else (env.shape[0] + env_raw, env.shape[1] + env_raw)
    maj = ctx.majorant.shape[:3] if ctx.majorant is not None else (0, 0, 0)
    i = np.array([
        int(isotropic), n_bins, int(ctx.max_bounces), steps, n_seeds, streams,
        resolution, int(not vol_raw and vol.table.dtype == torch.uint8), *dims,
        *tf_dims, n_lanes, int(ctx.volume_filter == "quasicubic"),
        *maj, *env_dims, int(not vol_raw and vol.kind == "xy"),
        int(is_raw(ctx)), int(vol_raw), int(ctx.volume_filter == "nearest"), tf_kind, light_kind,
        light_n, int(env_raw),
    ], np.int32)
    assert i.shape == (_I_COUNT,)
    return f, i


def _check_layout(lib):
    if (lib.vpt_layout(0), lib.vpt_layout(1), lib.vpt_layout(2)) != (MAX_BINS, _F_COUNT, _I_COUNT):
        raise RuntimeError("kernel library parameter layout does not match the wrapper")


def is_raw(ctx) -> bool:
    """Whether a ctx runs K1's RAW instantiation: a raw grid, a TF other
    than the fused table, or a raw environment map."""
    return (not isinstance(ctx.density, interp.PackedVolume) or ctx.material_tf.shape[-1] != 18
            or (ctx.environment is not None and ctx.environment.shape[-1] == 3))


def _check_tables(ctx):
    """Shapes, types and alignment of the scene tables. Not checked here, once
    per context instead (``convert.ctx_from_numpy``; the packers hold it by
    construction): every density row of a fused ``material_tf`` repeats the
    light pair, which K1 reads from row 0 for a lane that left the volume."""
    vol = ctx.density
    if isinstance(vol, interp.PackedVolume):
        _check(vol.table, "density table", vol.table.dtype,
               (int(np.prod(vol.dims)), vol.width), align=16)
        if ctx.volume_filter not in ("linear", "quasicubic"):
            raise ValueError(f"volume filter {ctx.volume_filter!r} needs a raw grid")
    else:
        if vol.ndim != 3:
            raise ValueError(f"a raw density must be a (D, H, W) grid, got {tuple(vol.shape)}")
        _check(vol, "density grid", torch.float32)
        if ctx.volume_filter not in ("linear", "quasicubic", "nearest"):
            raise ValueError(f"unknown volume filter {ctx.volume_filter!r}")
    tf = ctx.material_tf
    if tf.ndim != 3 or tf.shape[-1] not in _TF_KIND:
        raise ValueError("material_tf must be a fused (Hp, Wp, 18), packed (Hp, Wp, 16) or raw "
                         f"(H, W, 4) table, got {tuple(tf.shape)}")
    # the fused table's corners load as float2 (8-byte aligned), the others as float4
    _check(tf, "material_tf", torch.float32, align=8 if tf.shape[-1] == 18 else 16)
    if tf.shape[-1] != 18:
        light = ctx.light_spectrum
        if light.ndim == 2 and light.shape[1] != 2 or light.ndim not in (1, 2):
            raise ValueError(f"light_spectrum must be a raw (N,) or pair (N+1, 2) table, got "
                             f"{tuple(light.shape)}")
        _check(light, "light_spectrum", torch.float32, align=8)
    if ctx.majorant is not None:
        if ctx.majorant.ndim != 4 or ctx.majorant.shape[-1] != 2:
            raise ValueError(f"majorant must be a (Gz, Gy, Gx, 2) table, got "
                             f"{tuple(ctx.majorant.shape)}")
        _check(ctx.majorant, "majorant", torch.float32, align=8)
    if ctx.environment is not None:
        if ctx.environment.ndim != 3 or ctx.environment.shape[-1] not in (3, 12):
            raise ValueError(f"environment must be a packed (He+1, We+1, 12) or raw (He, We, 3) "
                             f"table, got {tuple(ctx.environment.shape)}")
        _check(ctx.environment, "environment", torch.float32)


def _check_lanes(lanes, lane_shape):
    for t, name in zip(lanes, ("lane_ix", "lane_iy", "lane_seed_iy")):
        _check(t, name, torch.int32, lane_shape)


def _check_state(state, n_bins, lanes=None):
    lane = tuple(state.px.shape)
    if lanes is not None:
        if len(lane) != 2:
            raise ValueError(f"a lane table's state has lane shape (M, res), got {lane}")
        _check_lanes(lanes, lane)
    elif len(lane) not in (2, 3) or lane[-1] != lane[-2]:
        raise ValueError(f"lane shape must be (H, W) or (S, H, W) with H == W, got {lane}")
    for k in STATE_FIELDS:
        t = getattr(state, k)
        shape = (n_bins,) + lane if k in ("radiance", "transmittance") else lane
        _check(t, k, torch.int32 if k in _INT_FIELDS else torch.float32, shape)


def density_table(ctx) -> torch.Tensor:
    """The ctx's volume tensor: the packed table or the raw grid."""
    return ctx.density.table if isinstance(ctx.density, interp.PackedVolume) else ctx.density


def _ctx_tensors(ctx):
    return [t for t in (density_table(ctx), ctx.material_tf, ctx.light_spectrum, ctx.majorant,
                        ctx.environment) if t is not None]


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _light_ptr(ctx) -> int:
    """The light's own table for K1, whose TF rows do not carry it; else 0."""
    return 0 if ctx.material_tf.shape[-1] == 18 else ctx.light_spectrum.data_ptr()


def step(state, ctx, seeds, steps: int, n_bins: int, lanes=None):
    """K render dispatches (one per frame seed) of ``steps`` iterations,
    updating ``state`` in place; one kernel launch on a CUDA device.
    ``lanes``: an int32 lane table (ix, iy, seed_iy) of the state's lane
    shape (hit-lane compaction), or None for the pixel grid."""
    tensors = [getattr(state, k) for k in STATE_FIELDS] + _ctx_tensors(ctx) + list(lanes or ())
    if _route(*tensors) == "cpu":
        return step_plain(state, ctx, seeds, steps, n_bins, lanes)
    _check_state(state, n_bins, lanes)
    _check_tables(ctx)
    seeds = np.asarray(seeds, np.uint32).reshape(-1)
    lane = tuple(state.px.shape)
    streams = lane[0] if len(lane) == 3 else 1
    f, i = _params(ctx, lane[-1], streams, n_bins, steps, len(seeds), state.px.numel())
    lib = _build.load()
    _check_layout(lib)
    device = state.px.device
    seeds_dev = torch.as_tensor(seeds.view(np.int32), device=device)
    ix, iy, seed_iy = lanes or (None, None, None)
    with torch.cuda.device(device):
        err = lib.vpt_mcm_spectral_step(
            f.ctypes.data, i.ctypes.data,
            *(getattr(state, k).data_ptr() for k in STATE_FIELDS[:11]),
            density_table(ctx).data_ptr(), ctx.material_tf.data_ptr(),
            _ptr(ctx.majorant), _ptr(ctx.environment),
            _ptr(ix), _ptr(iy), _ptr(seed_iy),
            seeds_dev.data_ptr(), _light_ptr(ctx), _stream(device))
    _raise_on(err, "mcm_spectral_step")
    LAUNCHES["step"] += 1
    for mode, on in (("majorant", ctx.majorant is not None),
                     ("environment", ctx.environment is not None),
                     ("quasicubic", ctx.volume_filter == "quasicubic"),
                     ("xy", getattr(ctx.density, "kind", None) == "xy"),
                     ("raw", is_raw(ctx)),
                     ("lane_table", lanes is not None)):
        LAUNCHES[f"step_{mode}"] += int(on)
    return state


def reset(ctx, resolution: int, n_bins: int, streams: int, device, lanes=None):
    """Fresh photon state (dict of tensors) on ``device``; over an int32
    lane table ``lanes`` (ix, iy, seed_iy) when given, whose shape is then
    the lane shape."""
    device = torch.device(device)
    route = _route(*_ctx_tensors(ctx), *(lanes or ()))
    if route != device.type:
        raise ValueError(f"scene tables lie on {route}, state requested on {device}")
    if route == "cpu":
        return reset_plain(ctx, resolution, n_bins, streams, device, lanes)
    _check_tables(ctx)
    device = density_table(ctx).device
    lane = tuple(lanes[0].shape) if lanes is not None else _lane_shape(resolution, streams)
    if lanes is not None:
        if len(lane) != 2 or lane[-1] != resolution:
            raise ValueError(f"a lane table must be (M, {resolution}), got {lane}")
        _check_lanes(lanes, lane)
    f, i = _params(ctx, resolution, streams, n_bins, n_lanes=int(np.prod(lane)))
    out = {k: torch.empty(lane, dtype=torch.int32 if k in _INT_FIELDS else torch.float32,
                          device=device) for k in STATE_FIELDS[:10]}
    for k in ("radiance", "transmittance"):
        out[k] = torch.empty((n_bins,) + lane, dtype=torch.float32, device=device)
    lib = _build.load()
    _check_layout(lib)
    ix, iy, seed_iy = lanes or (None, None, None)
    with torch.cuda.device(device):
        err = lib.vpt_mcm_spectral_reset(
            f.ctypes.data, i.ctypes.data, int(ctx.seed_bits) & 0xFFFFFFFF,
            *(out[k].data_ptr() for k in STATE_FIELDS), _ptr(ix), _ptr(iy), _ptr(seed_iy),
            _stream(device))
    _raise_on(err, "mcm_spectral_reset")
    LAUNCHES["reset"] += 1
    LAUNCHES["reset_lane_table"] += int(lanes is not None)
    return out


def compact_radiance(radiance, pixel_hit, miss, n_hit: int, streams: int):
    """Per-pixel radiance (B, res, res) of a compacted state: a hit pixel's
    mean over its ``streams`` lanes, ``miss`` elsewhere (see
    ``compact_radiance_plain``); one kernel launch on a CUDA device."""
    if _route(radiance, pixel_hit, miss) == "cpu":
        return compact_radiance_plain(radiance, pixel_hit, miss, n_hit, streams)
    B = radiance.shape[0]
    n_lanes = radiance[0].numel()
    if streams * n_hit > n_lanes:
        raise ValueError(f"{streams} x {n_hit} hit lanes > the state's {n_lanes} lanes")
    _check(radiance, "radiance", torch.float32)
    _check(miss, "miss", torch.float32)
    if miss.ndim != 3 or miss.shape[0] != B:
        raise ValueError(f"miss must be ({B}, res, res), got {tuple(miss.shape)}")
    _check(pixel_hit, "pixel_hit", torch.int32, (miss.shape[1] * miss.shape[2],))
    out = torch.empty_like(miss)
    lib = _build.load()
    device = radiance.device
    with torch.cuda.device(device):
        err = lib.vpt_compact_image(radiance.data_ptr(), n_lanes, pixel_hit.data_ptr(),
                                    miss.data_ptr(), out.data_ptr(), B, pixel_hit.numel(),
                                    int(n_hit), int(streams), _stream(device))
    _raise_on(err, "compact_image")
    LAUNCHES["compact_radiance"] += 1
    return out


def sample_volume_packed(table: torch.Tensor, dims, u, v, w, kind: str = "full"):
    """Trilinear density at (u, v, w) from a flat u8|f32 packed volume table:
    (rows, 8) of kind "full" or (rows, 4) of kind "xy"."""
    if kind not in ("full", "xy"):
        raise ValueError(f"packed volume kind must be 'full' or 'xy', got {kind!r}")
    if _route(table, u, v, w) == "cpu":
        return sample_volume_packed_plain(table, dims, u, v, w, kind)
    dims = tuple(int(d) for d in dims)
    if table.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"table: expected uint8 or float32, got {table.dtype}")
    _check(table, "table", table.dtype, (int(np.prod(dims)), 4 if kind == "xy" else 8), align=16)
    n = u.numel()
    for t, name in ((u, "u"), (v, "v"), (w, "w")):
        _check(t, name, torch.float32, u.shape)
    out = torch.empty_like(u)
    lib = _build.load()
    with torch.cuda.device(table.device):
        err = lib.vpt_sample_volume_packed(
            table.data_ptr(), int(table.dtype == torch.uint8), int(kind == "xy"), *dims,
            u.data_ptr(), v.data_ptr(), w.data_ptr(), out.data_ptr(), n,
            _stream(table.device))
    _raise_on(err, "sample_volume_packed")
    LAUNCHES["sample_volume_packed"] += 1
    LAUNCHES["sample_volume_packed_xy"] += int(kind == "xy")
    return out


_FILTERS = ("linear", "quasicubic", "nearest")


def sample_volume_raw_plain(grid, u, v, w, mode: str = "linear"):
    """Plain PyTorch ``sample_volume_raw``."""
    return interp.sample_volume_raw(grid, u, v, w, mode)


def sample_volume_raw(grid: torch.Tensor, u, v, w, mode: str = "linear"):
    """Density at (u, v, w) from a raw (D, H, W) f32 grid with the linear,
    quasicubic or nearest filter (K3's raw mode: 8 scalar gathers per
    lookup, 1 for nearest)."""
    if mode not in _FILTERS:
        raise ValueError(f"unknown volume filter {mode!r}")
    if _route(grid, u, v, w) == "cpu":
        return sample_volume_raw_plain(grid, u, v, w, mode)
    if grid.ndim != 3:
        raise ValueError(f"a raw grid must be (D, H, W), got {tuple(grid.shape)}")
    _check(grid, "grid", torch.float32)
    for t, name in ((u, "u"), (v, "v"), (w, "w")):
        _check(t, name, torch.float32, u.shape)
    out = torch.empty_like(u)
    lib = _build.load()
    with torch.cuda.device(grid.device):
        err = lib.vpt_sample_volume_raw(grid.data_ptr(), *grid.shape, _FILTERS.index(mode),
                                        u.data_ptr(), v.data_ptr(), w.data_ptr(), out.data_ptr(),
                                        u.numel(), _stream(grid.device))
    _raise_on(err, "sample_volume_raw")
    LAUNCHES["sample_volume_raw"] += 1
    return out
