"""The RGB MCM kernels: wrappers, plain versions, launch counts.

Two kernels of ``vpt_tpu_torch/csrc/mcm.cu``:

- ``step`` (K20 ``mcm_step``): K render dispatches of ``steps`` Woodcock
  iterations of the RGB multiple-scattering renderer, in place (replaces
  ``vpt_tpu/models/mcm.py::_render_body`` looped by ``render`` and
  ``render_many``, and ``mcm_compact.render_compact_many`` over a lane
  table); plain version ``step_plain``. K20 is an instance per table pair
  (``step_mode``).
- ``reset`` (K21 ``mcm_reset``): fresh photons (replaces ``full_reset`` and
  ``mcm_compact.compact_reset``); plain version ``reset_plain``.

The compacted image is K8 ``compact_image`` of ``kernels/mcm_spectral.py``
with the three colour channels as its bins and one stream
(``models/mcm_compact.py``).

The tables: the volume a packed "full" corner table (u8 or f32; linear or
quasicubic filter) or a raw (D, H, W) f32 grid (also nearest); the classic
2D TF the packed (257, 257, 16) corner table or the raw (256, 256, 4)
texture, read at (density, 0); the environment a raw (He, We, 3) equirect
map, read on every escape (the renderer's default is one white texel).

``step`` and ``reset`` take an optional lane table ``lanes = (ix, iy)``,
int32 tensors of the (M, resolution) lane shape (hit-lane compaction; one
stream, so a lane seeds its chain from its pixel's (ix, iy)); without one
the lanes are the (H, W) pixel grid.

Each wrapper runs its plain version when its tensors lie on the CPU and
launches its kernel when they lie on one CUDA device; anything else
raises. ``LAUNCHES`` counts kernel launches (never plain runs); a step
launch also counts under each mode it ran: ``step_raw`` (a raw grid and
TF), ``step_quasicubic``, ``step_environment`` (a map of more than one
texel), ``step_lane_table``; a reset over a lane table under
``reset_lane_table``. The plain versions take tensors on any device, so
tests and ``chip_smoke.py`` compare kernel and plain version on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.ops import geometry, interp, sampling

# must match MF_COUNT / MI_COUNT in csrc/mcm.cu
_F_COUNT = 20
_I_COUNT = 18
_FILTERS = ("linear", "quasicubic", "nearest")
# K20's instances, in the order of csrc/mcm.cu McmMode
STEP_MODES = ("u8", "f32", "u8 quasicubic", "f32 quasicubic", "raw", "raw quasicubic", "nearest",
              "generic")

# the equirect mapping's f32 constant INVPI * 0.5 (vpt_tpu/models/mcm.py:32, :67)
INV_PI_HALF = float(np.float32(0.31830988618 * 0.5))

STATE_FIELDS = ("px", "py", "pz", "dx", "dy", "dz", "bounces", "samples",
                "tr", "tg", "tb", "rr", "rg", "rb")
_INT_FIELDS = ("bounces", "samples")

LAUNCHES = {"step": 0, "reset": 0, "step_raw": 0, "step_environment": 0,
            "step_quasicubic": 0, "step_lane_table": 0, "reset_lane_table": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def sample_environment(env, dx, dy, dz):
    """RGB of the raw (He, We, 3) equirect map in direction d: the
    reference's mapping (y quirk kept) with -dy clipped to [-1, 1], all
    three channels, no gain; the f32 operations of the JAX version."""
    u = torch.atan2(dx, -dz) * INV_PI_HALF + 0.5
    v = torch.asin(torch.clamp(-dy, -1.0, 1.0)) * 2.0 * INV_PI_HALF + 0.5
    return interp.sample_tex2d(env, u, v)


def _pixel_grid(resolution: int, device):
    """(ix, iy) int64 tensors of the (H, W) pixel grid."""
    i = torch.arange(resolution, dtype=torch.int64, device=device)
    return (i.view(1, -1).expand(resolution, resolution),
            i.view(-1, 1).expand(resolution, resolution))


def _lanes(resolution: int, device, lanes=None):
    """(ix, iy) int64 lane tensors: the pixel grid or the given table."""
    if lanes is None:
        return _pixel_grid(resolution, device)
    return tuple(t.to(device=device, dtype=torch.int64) for t in lanes)


def _screen(ix, iy, resolution: int):
    return geometry.screen_position(ix, iy, K._f32(np.float32(1.0) / np.float32(resolution)))


def _respawn(rng, mask, sx, sy, ctx):
    """resetPhoton: a new camera ray where ``mask`` (draws: disk 2 + square
    2, no wavelength). ``inv_res`` is 1 / the lanes' last axis, the
    resolution for the grid and for a (M, resolution) lane table."""
    inv_res = K._f32(np.float32(1.0) / np.float32(sx.shape[-1]))
    rng, (fx, fy, fz), (tx, ty, tz) = geometry.unproject_rand(
        rng, mask, sx, sy, ctx.inv_mvp, inv_res, K._f32(ctx.blur))
    ndx, ndy, ndz = geometry.normalize3(tx - fx, ty - fy, tz - fz)
    tnear, _ = geometry.intersect_cube(fx, fy, fz, ndx, ndy, ndz)
    tnear = torch.maximum(tnear, torch.zeros_like(tnear))
    return rng, dict(px=fx + tnear * ndx, py=fy + tnear * ndy, pz=fz + tnear * ndz,
                     dx=ndx, dy=ndy, dz=ndz)


def _render_body(p, rng, sx, sy, ctx):
    """One Woodcock iteration over all lanes; ``p``: dict of lane tensors.
    The JAX ``_render_body``'s operations and draws in its order: the
    flight, the TF at (density, 0), the wheel, the env deposit as a running
    mean, then a respawn or an HG scatter with the global anisotropy."""
    all_mask = torch.ones(rng.shape, dtype=torch.bool, device=rng.device)
    rng, dist = sampling.draw_exponential(rng, all_mask, K._f32(ctx.extinction))
    px = p["px"] + dist * p["dx"]
    py = p["py"] + dist * p["dy"]
    pz = p["pz"] + dist * p["dz"]

    d = interp.sample_volume(ctx.density, px, py, pz, ctx.volume_filter)
    tf4 = interp.sample_tex2d(ctx.tf_table, d, torch.zeros_like(d))
    cr, cg, cb, alpha = tf4[..., 0], tf4[..., 1], tf4[..., 2], tf4[..., 3]

    zero = torch.zeros_like(alpha)
    p_null = 1.0 - alpha
    max3 = torch.maximum(cr, torch.maximum(cg, cb))
    p_scatter = torch.where(p["bounces"] >= int(ctx.max_bounces), zero, alpha * max3)
    p_absorb = 1.0 - p_null - p_scatter

    rng, wheel = sampling.draw(rng, all_mask)

    oob = (px > 1.0) | (px < 0.0) | (py > 1.0) | (py < 0.0) | (pz > 1.0) | (pz < 0.0)
    absorb = ~oob & (wheel < p_absorb)
    scatter = ~oob & ~absorb & (wheel < p_absorb + p_scatter)
    respawn = oob | absorb

    env = sample_environment(ctx.environment, p["dx"], p["dy"], p["dz"])
    samples = p["samples"] + respawn.to(torch.int32)
    denom = torch.clamp_min(samples, 1).to(torch.float32)
    out = {}
    for c, (t, r) in enumerate((("tr", "rr"), ("tg", "rg"), ("tb", "rb"))):
        e = torch.where(oob, p[t] * env[..., c], zero)
        out[r] = torch.where(respawn, p[r] + (e - p[r]) / denom, p[r])

    rng, new = _respawn(rng, respawn, sx, sy, ctx)
    g = torch.full_like(p["dx"], K._f32(ctx.anisotropy))
    rng, (hx, hy, hz) = sampling.draw_hg(rng, scatter, g, p["dx"], p["dy"], p["dz"])

    one = torch.ones_like(alpha)
    out.update(
        px=torch.where(respawn, new["px"], px),
        py=torch.where(respawn, new["py"], py),
        pz=torch.where(respawn, new["pz"], pz),
        dx=torch.where(respawn, new["dx"], torch.where(scatter, hx, p["dx"])),
        dy=torch.where(respawn, new["dy"], torch.where(scatter, hy, p["dy"])),
        dz=torch.where(respawn, new["dz"], torch.where(scatter, hz, p["dz"])),
        bounces=torch.where(respawn, torch.zeros_like(p["bounces"]),
                            p["bounces"] + scatter.to(torch.int32)),
        samples=samples,
        tr=torch.where(respawn, one, torch.where(scatter, p["tr"] * cr, p["tr"])),
        tg=torch.where(respawn, one, torch.where(scatter, p["tg"] * cg, p["tg"])),
        tb=torch.where(respawn, one, torch.where(scatter, p["tb"] * cb, p["tb"])),
    )
    return out, rng


def step_plain(state, ctx, seeds, steps: int, lanes=None):
    """Plain PyTorch ``step``: for each frame seed, re-seed every lane's
    chain from (ix, iy, seed) and run ``steps`` Woodcock iterations.
    Updates ``state`` in place (the JAX version donates it) and returns
    it. ``lanes``: a lane table (ix, iy) of the state's lane shape, or
    None for the grid."""
    resolution = state.px.shape[-1]
    ix, iy = _lanes(resolution, state.px.device, lanes)
    sx, sy = _screen(ix, iy, resolution)
    p = {k: getattr(state, k) for k in STATE_FIELDS}
    for seed in np.asarray(seeds, np.uint32).reshape(-1):
        rng = sampling.seed_state(ix, iy, int(seed))
        for _ in range(steps):
            p, rng = _render_body(p, rng, sx, sy, ctx)
    for k in STATE_FIELDS:
        getattr(state, k).copy_(p[k])
    return state


def reset_plain(ctx, resolution: int, device, lanes=None):
    """Plain PyTorch ``reset``: dict of fresh state tensors (transmittance
    and radiance 1, the reference's quirk; counters 0); over ``lanes`` when
    given."""
    ix, iy = _lanes(resolution, device, lanes)
    sx, sy = _screen(ix, iy, resolution)
    rng = sampling.seed_state(ix, iy, ctx.seed_bits)
    _, new = _respawn(rng, torch.ones(ix.shape, dtype=torch.bool, device=device), sx, sy, ctx)
    out = {k: new[k] for k in STATE_FIELDS[:6]}
    for k in STATE_FIELDS[6:]:
        out[k] = (torch.zeros(ix.shape, dtype=torch.int32, device=device) if k in _INT_FIELDS
                  else torch.ones(ix.shape, dtype=torch.float32, device=device))
    return out


def full_reset(ctx, resolution: int, device):
    """The JAX ``full_reset``: ``reset_plain`` over the pixel grid."""
    return reset_plain(ctx, resolution, device)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def _ctx_tensors(ctx):
    return [K.density_table(ctx), ctx.tf_table, ctx.environment]


def _check_tables(ctx):
    vol = ctx.density
    if isinstance(vol, interp.PackedVolume):
        if vol.kind != "full":
            raise ValueError(f"mcm reads a full packed volume table, not {vol.kind!r}")
        K._check(vol.table, "density table", vol.table.dtype, (int(np.prod(vol.dims)), 8),
                 align=16)
        if ctx.volume_filter not in ("linear", "quasicubic"):
            raise ValueError(f"volume filter {ctx.volume_filter!r} needs a raw grid")
    else:
        if vol.ndim != 3:
            raise ValueError(f"a raw density must be a (D, H, W) grid, got {tuple(vol.shape)}")
        K._check(vol, "density grid", torch.float32)
        if ctx.volume_filter not in _FILTERS:
            raise ValueError(f"unknown volume filter {ctx.volume_filter!r}")
    tf = ctx.tf_table
    if tf.ndim != 3 or tf.shape[-1] not in (4, 16):
        raise ValueError(f"tf_table must be a packed (Hp, Wp, 16) or raw (H, W, 4) table, got "
                         f"{tuple(tf.shape)}")
    K._check(tf, "tf_table", torch.float32, align=16)
    env = ctx.environment
    if env.ndim != 3 or env.shape[-1] != 3:
        raise ValueError(f"environment must be a raw (He, We, 3) map, got {tuple(env.shape)}")
    K._check(env, "environment", torch.float32)


def _check_state(state, lanes=None):
    lane = tuple(state.px.shape)
    if len(lane) != 2 or (lanes is None and lane[0] != lane[1]):
        raise ValueError(f"lane shape must be (H, W) with H == W, or (M, res) over a lane "
                         f"table, got {lane}")
    for k in STATE_FIELDS:
        K._check(getattr(state, k), k, torch.int32 if k in _INT_FIELDS else torch.float32, lane)
    if lanes is not None:
        _check_lanes(lanes, lane)


def _check_lanes(lanes, lane):
    if len(lanes) != 2:
        raise ValueError("a lane table is (ix, iy)")
    for t, name in zip(lanes, ("lane_ix", "lane_iy")):
        K._check(t, name, torch.int32, lane)


def step_mode(density, tf_table, volume_filter: str) -> str:
    """K20's instance for these tables (csrc/mcm.cu McmMode; K15's and
    K16's too, csrc/raymarch.cu MarchMode): "u8" / "f32"
    (a packed corner table, linear), "u8 quasicubic" / "f32 quasicubic",
    each beside the packed (Hp, Wp, 16) TF, or "raw" / "raw quasicubic" /
    "nearest" (the raw (D, H, W) grid under that filter beside the raw
    (H, W, 4) TF), the pairs ``MCMRenderer`` builds; any other pair the
    wrapper takes runs the "generic" instance, which reads the table kinds
    at run time."""
    tf_raw = tf_table.shape[-1] == 4
    if not isinstance(density, interp.PackedVolume):
        raw = {"linear": "raw", "quasicubic": "raw quasicubic", "nearest": "nearest"}
        return raw.get(volume_filter, "generic") if tf_raw else "generic"
    if tf_raw or volume_filter not in ("linear", "quasicubic"):
        return "generic"
    kind = "u8" if density.table.dtype == torch.uint8 else "f32"
    return kind + (" quasicubic" if volume_filter == "quasicubic" else "")


def _params(ctx, resolution: int, n_lanes: int, steps: int = 0, n_seeds: int = 0):
    if n_lanes >= 2**31:
        raise ValueError("more than 2**31 - 1 lanes")
    f = np.zeros(_F_COUNT, np.float32)
    f[0:16] = np.asarray(ctx.inv_mvp, np.float32).reshape(16)
    f[16] = ctx.extinction
    f[17] = ctx.blur
    f[18] = np.float32(1.0) / np.float32(resolution)
    f[19] = ctx.anisotropy
    vol, tf, env = ctx.density, ctx.tf_table, ctx.environment
    vol_raw = not isinstance(vol, interp.PackedVolume)
    # a raw axis of n texels is given as n + 1, as a packed table's would be
    dims = tuple(d + 1 for d in vol.shape) if vol_raw else vol.dims
    tf_raw = tf.shape[-1] == 4
    i = np.array([
        int(ctx.max_bounces), steps, n_seeds, resolution, n_lanes, int(vol_raw),
        int(not vol_raw and vol.table.dtype == torch.uint8), *dims,
        int(ctx.volume_filter == "quasicubic"), int(ctx.volume_filter == "nearest"), int(tf_raw),
        tf.shape[0] + tf_raw, tf.shape[1] + tf_raw, env.shape[0], env.shape[1],
        STEP_MODES.index(step_mode(vol, tf, ctx.volume_filter)),
    ], np.int32)
    assert i.shape == (_I_COUNT,)
    return f, i


def _check_layout(lib):
    if (lib.vpt_mcm_layout(0), lib.vpt_mcm_layout(1)) != (_F_COUNT, _I_COUNT):
        raise RuntimeError("kernel library parameter layout does not match the wrapper")


def step(state, ctx, seeds, steps: int, lanes=None):
    """K render dispatches (one per frame seed) of ``steps`` iterations,
    updating ``state`` in place; one kernel launch on a CUDA device, of
    K20's instance for the tables' ``step_mode``. ``lanes``: an int32 lane
    table (ix, iy) of the state's (M, resolution) lane shape, or None for
    the pixel grid."""
    tensors = [getattr(state, k) for k in STATE_FIELDS] + _ctx_tensors(ctx) + list(lanes or ())
    if K._route(*tensors) == "cpu":
        return step_plain(state, ctx, seeds, steps, lanes)
    _check_state(state, lanes)
    _check_tables(ctx)
    seeds = np.asarray(seeds, np.uint32).reshape(-1)
    f, i = _params(ctx, state.px.shape[-1], state.px.numel(), steps, len(seeds))
    lib = _build.load()
    _check_layout(lib)
    device = state.px.device
    seeds_dev = torch.as_tensor(seeds.view(np.int32), device=device)
    ix, iy = lanes or (None, None)
    with torch.cuda.device(device):
        err = lib.vpt_mcm_step(
            f.ctypes.data, i.ctypes.data, *(getattr(state, k).data_ptr() for k in STATE_FIELDS),
            K.density_table(ctx).data_ptr(), ctx.tf_table.data_ptr(),
            ctx.environment.data_ptr(), K._ptr(ix), K._ptr(iy), seeds_dev.data_ptr(),
            K._stream(device))
    K._raise_on(err, "mcm_step")
    LAUNCHES["step"] += 1
    for mode, on in (("raw", not isinstance(ctx.density, interp.PackedVolume)),
                     ("environment", ctx.environment.numel() > 3),
                     ("quasicubic", ctx.volume_filter == "quasicubic"),
                     ("lane_table", lanes is not None)):
        LAUNCHES[f"step_{mode}"] += int(on)
    return state


def reset(ctx, resolution: int, device, lanes=None):
    """Fresh photon state (dict of tensors) on ``device``; over an int32
    lane table ``lanes`` (ix, iy) when given, whose (M, resolution) shape
    is then the lane shape."""
    device = torch.device(device)
    route = K._route(*_ctx_tensors(ctx), *(lanes or ()))
    if route != device.type:
        raise ValueError(f"scene tables lie on {route}, state requested on {device}")
    if route == "cpu":
        return reset_plain(ctx, resolution, device, lanes)
    _check_tables(ctx)
    device = ctx.tf_table.device
    lane = tuple(lanes[0].shape) if lanes is not None else (resolution, resolution)
    if lanes is not None:
        if len(lane) != 2 or lane[-1] != resolution:
            raise ValueError(f"a lane table must be (M, {resolution}), got {lane}")
        _check_lanes(lanes, lane)
    f, i = _params(ctx, resolution, int(np.prod(lane)))
    out = {k: torch.empty(lane, dtype=torch.int32 if k in _INT_FIELDS else torch.float32,
                          device=device) for k in STATE_FIELDS}
    lib = _build.load()
    _check_layout(lib)
    ix, iy = lanes or (None, None)
    with torch.cuda.device(device):
        err = lib.vpt_mcm_reset(f.ctypes.data, i.ctypes.data, int(ctx.seed_bits) & 0xFFFFFFFF,
                                *(out[k].data_ptr() for k in STATE_FIELDS), K._ptr(ix), K._ptr(iy),
                                K._stream(device))
    K._raise_on(err, "mcm_reset")
    LAUNCHES["reset"] += 1
    LAUNCHES["reset_lane_table"] += int(lanes is not None)
    return out
