"""The autodiff surrogate's backward by hand: the surrogate tape (K4's
surrogate mode) and its reverse pass K12 ``surrogate_reverse``. Wrappers,
plain versions, launch counts.

Counterpart of ``jax.grad`` through ``vpt_tpu/models/mcm_spectral.py::
render_diff`` (``:508-556``, the ``diff`` branches of ``_render_body``
and ``_surrogate``). The surrogate differentiates the discrete events by
their scores (the free flight in score form, P / stop_grad(P) on null and
scatter events, as PRB does) and the continuous chains pathwise: the HG
inversion through g and the incoming direction, the position through the
trilinear lookup's spatial gradient (through the smoothstep warp's
derivative under the quasicubic filter), and the directional light or the
environment map's equirect lookup through the direction. So its reverse
carries, per lane, the score cotangent ``c``, the
adjoints of the position and the direction, and the radiance adjoint per
bin, across steps and dispatches.

- ``tape_forward`` (K4's surrogate mode, ``surrogate_tape_kernel`` in
  ``csrc/spectral_backward.cu``): K dispatches from a state, one tape row
  per lane-step; the state it leaves equals K1's bit for bit, in exact and
  majorant mode, and it looks up the material only where K1 does. Plain
  version ``tape_forward_plain``.
- ``reverse`` (K12, ``csrc/surrogate.cu``): the reverse pass over K stored
  dispatch tapes. Its inputs are the adjoints at the last dispatch's end,
  which it replaces in place by those at the first dispatch's start; it
  adds into the adjoints of the tables (over the packed tables one
  18-wide TF+light row and one 8-wide volume row per event lane-step, or
  over an xy half-packed volume the two 4-wide rows of the z0 and z1
  planes, the 4 texel terms of an escape's 12-wide environment row; over
  raw tables the texels a lookup read) and the extinction adjoint. Plain
  version ``reverse_plain``: the same derivation in torch ops, in K12's
  order.

``models/mcm_spectral.py::_RenderWindow`` runs a window of K dispatches as
one launch of each: ``tape_forward`` over the K seeds in its forward, the
tapes kept (1.34 GB for 4 dispatches at 512^2 x 4 streams), and ``reverse``
over them in its backward into one packed adjoint per learned table. Above
the PRB window's tape limit it keeps each dispatch's start state instead and
re-tapes the dispatches one by one in the backward.

The tape is one f32 tensor (K, steps, F, lanes) of ``SUR_FIELDS`` (``maj``
in majorant mode only): the step's flags and bin, the flight, the
pre-step direction, the chain's state before its disk draw, the sample
position and the wavelength. What the reverse needs besides is recomputed
from them with the forward's own code, which gives the forward's values
bit for bit: the emitted light (from the wavelength's light pair and the
direction), the HG sample (redrawn from the chain's state), the material
and its slopes (the volume row re-gathered at the sample position, then
the TF row), and the deposit counts (counted down from the final
``samples``). Taping those instead would take 15 more fields per
lane-step; the re-gathers read a volume row and an L2-resident TF row on
the event steps only.

Gradients mirror ``jax.grad``: ties of ``max``/``min`` split in half, no
gradient below the 1e-12 probability floor or where ``alpha / m`` is
clipped, and the HG inversion's inf/NaN at a degenerate cosine. One
difference: JAX evaluates the HG inversion densely, so a lane that did not
scatter can get NaN when its unused cosine sample lands exactly on +-1;
here the HG adjoint is computed on scattering lanes only.

Each wrapper runs its plain version when its tensors lie on the CPU and
launches its kernel when they lie on a CUDA device; anything else raises.
``LAUNCHES`` counts kernel launches only (a launch in env mode also under
its ``_environment`` key, in env and majorant mode at once, one
instantiation of its own, under ``_environment_majorant``, K12 with the
quasicubic filter under ``surrogate_reverse_quasicubic``, a launch over an
xy half-packed volume also under its ``_xy`` key, one over raw or partly
packed tables under its ``_raw`` key).

Raw and partly packed tables (``K.is_raw``: the reference's ``pack_tables``
other than True, and every ``nearest`` volume) run the kernels' RAW mode,
whose table kinds are runtime flags, as K1's RAW instantiation reads them
(PR 10): the volume a raw (D, H, W) f32 grid (8 corners, 1 voxel under the
nearest filter) or a packed full or xy table; the TF fused (18 wide), packed
(16 wide, the light then in its own table) or raw (H, W, 4); the light a raw
(N,) or pair (N+1, 2) table beside a TF that does not carry it; the
environment map packed (12 wide) or raw (He, We, 3). Each adjoint has the
kind of its table, flattened to rows (``adjoint_shapes``). A raw axis of n
texels scales its spatial slope by n (``ops/interp.py`` ``_coords`` leaves
the fraction unclamped; at a clamped edge both corners are the same texel,
which takes both terms). Under the nearest filter the density gradient goes
to the one voxel read and the position gets none (``floor`` has no
gradient), as under ``jax.grad``; the raw PRB backward's trilinear scatter
of a nearest lookup (``kernels/spectral_backward.py``) is its own path.

At the poles of the environment map (|dy| = 1) the slope of asin is
unbounded: an escape there gets an inf or NaN direction adjoint, as under
``jax.grad`` (ROADMAP C, "Env-mode deposits").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.ops import geometry, interp, sampling

# tape fields in the order of SurField in csrc/surrogate.cu
SUR_FIELDS = ("flags", "dist", "dx", "dy", "dz", "rng", "px", "py", "pz", "lam", "maj")
# flag bits of the "flags" field; bits 8.. hold the pre-step bin
F_RESPAWN, F_OOB, F_NULL, F_SCATTER, F_CAPPED = 1, 2, 4, 8, 16
EPS = 1e-5

LAUNCHES = {"surrogate_tape_forward": 0, "surrogate_tape_forward_majorant": 0,
            "surrogate_tape_forward_environment": 0,
            "surrogate_tape_forward_environment_majorant": 0, "surrogate_tape_forward_xy": 0,
            "surrogate_tape_forward_raw": 0,
            "surrogate_reverse": 0, "surrogate_reverse_environment": 0,
            "surrogate_reverse_environment_majorant": 0, "surrogate_reverse_quasicubic": 0,
            "surrogate_reverse_xy": 0, "surrogate_reverse_raw": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def fields(majorant: bool) -> tuple:
    """The tape's fields, in slot order."""
    return SUR_FIELDS if majorant else SUR_FIELDS[:-1]


def check_ctx(ctx):
    """The tables and modes the surrogate's backward covers: every layout
    that K1 renders (``K.is_raw``: raw or partly packed tables too), in
    exact or majorant mode, with the linear, quasicubic or (raw grid)
    nearest filter, with a directional or isotropic light or an
    environment map. Raises ``ValueError`` on a malformed table."""
    vol, tf, env = ctx.density, ctx.material_tf, ctx.environment
    if ctx.volume_filter not in ("linear", "quasicubic", "nearest"):
        raise ValueError(f"unknown volume filter {ctx.volume_filter!r}")
    if isinstance(vol, interp.PackedVolume):
        if ctx.volume_filter == "nearest":
            raise ValueError("the nearest filter needs a raw (D, H, W) grid, got a packed "
                             f"{vol.kind} table")
    elif vol.ndim != 3:
        raise ValueError(f"a raw density must be a (D, H, W) grid, got {tuple(vol.shape)}")
    if tf.ndim != 3 or tf.shape[-1] not in K._TF_KIND:
        raise ValueError("the surrogate needs a fused (Hp, Wp, 18), packed (Hp, Wp, 16) or raw "
                         f"(H, W, 4) TF, got {tuple(tf.shape)}")
    if tf.shape[-1] != 18:
        light = ctx.light_spectrum
        if light.ndim not in (1, 2) or (light.ndim == 2 and light.shape[1] != 2):
            raise ValueError("beside a TF without the light the surrogate needs a raw (N,) or "
                             f"pair (N+1, 2) light table, got {tuple(light.shape)}")
    if env is not None and (env.ndim != 3 or env.shape[-1] not in (3, 12)):
        raise ValueError("the surrogate needs a packed (He+1, We+1, 12) or raw (He, We, 3) "
                         f"environment map, got {tuple(env.shape)}")


def adjoint_shapes(ctx) -> dict:
    """The shape of each table's adjoint, the table flattened to rows:
    g_vol (rows, 8) or (rows, 4) over a packed volume, (D*H*W,) over a raw
    grid; g_tf (rows, 18 | 16 | 4); g_light (N,) or (N+1, 2) beside a TF
    that does not carry the light; g_env (rows, 12 | 3); g_ext (1,)."""
    vol, tf = ctx.density, ctx.material_tf
    out = dict(g_ext=(1,), g_tf=(tf.shape[0] * tf.shape[1], tf.shape[2]),
               g_vol=(tuple(vol.table.shape) if isinstance(vol, interp.PackedVolume)
                      else (vol.numel(),)))
    if tf.shape[-1] != 18:
        out["g_light"] = tuple(ctx.light_spectrum.shape)
    if ctx.environment is not None:
        env = ctx.environment
        out["g_env"] = (env.shape[0] * env.shape[1], env.shape[2])
    return out


def zero_adjoints(ctx, keys) -> dict:
    """Zero f32 adjoints (``adjoint_shapes``) of ``keys`` on the ctx's
    device; a key the ctx has no table for is left out."""
    shapes = adjoint_shapes(ctx)
    dev = ctx.material_tf.device
    return {k: torch.zeros(shapes[k], dtype=torch.float32, device=dev) for k in keys
            if k in shapes}


def clone_steppable(state):
    """A copy of the state fields a dispatch updates; the transmittance,
    which no dispatch changes, is shared with ``state``."""
    return dataclasses.replace(state, **{k: getattr(state, k).detach().clone()
                                         for k in K.STATE_FIELDS[:11]})


def _u32_to_f(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> their bits in an f32 slot."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).view(torch.float32)


def _f_to_u32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32).to(torch.int64) & sampling.MASK32


# ---------------------------------------------------------------------------
# K4's surrogate mode: the taped forward
# ---------------------------------------------------------------------------
def _tape_row(it, flds):
    flags = (it["respawn"].to(torch.int32) | (it["oob"].to(torch.int32) << 1)
             | (it["null"].to(torch.int32) << 2) | (it["scatter"].to(torch.int32) << 3)
             | (it["pre_bin"].to(torch.int32) << 8))
    if it["capped"] is not None:
        flags = flags | (it["capped"].to(torch.int32) << 4)
    (px, py, pz), (dx, dy, dz) = it["sample_pos"], it["pre_dir"]
    v = dict(flags=flags.view(torch.float32), dist=it["dist"], dx=dx, dy=dy, dz=dz,
             rng=_u32_to_f(it["rng_disk"]), px=px, py=py, pz=pz, lam=it["pre_wavelength"],
             maj=it["maj"])
    return torch.stack([v[f].reshape(-1) for f in flds])


def tape_forward_plain(state, ctx, seeds, steps: int, n_bins: int):
    """Plain ``tape_forward``: updates ``state`` in place and returns the
    tapes (K, steps, F, lanes)."""
    check_ctx(ctx)
    flds = fields(ctx.majorant is not None)
    lane = tuple(state.px.shape)
    resolution, streams = lane[-1], (lane[0] if len(lane) == 3 else 1)
    ix, iy, seed_iy = K._pixel_grid(resolution, streams, state.px.device)
    sx, sy = geometry.screen_position(ix, iy, K._f32(np.float32(1.0) / np.float32(resolution)))
    light = K.light_terms(ctx.light_direction)
    p = {k: getattr(state, k) for k in K.STATE_FIELDS if k != "transmittance"}
    tapes = []
    for seed in np.asarray(seeds, np.uint32).reshape(-1):
        rng = sampling.seed_state(ix, seed_iy, int(seed))
        rows = []
        for _ in range(steps):
            p, rng, it = K._render_body(p, rng, sx, sy, ctx, n_bins, light, collect=True)
            rows.append(_tape_row(it, flds))
        tapes.append(torch.stack(rows))
    for k, val in p.items():
        getattr(state, k).copy_(val)
    return torch.stack(tapes)


def _slots(flds) -> np.ndarray:
    slot = np.full(len(SUR_FIELDS), -1, np.int32)
    for i, f in enumerate(flds):
        slot[SUR_FIELDS.index(f)] = i
    return slot


def _check_layout(lib):
    got = tuple(lib.vpt_sur_layout(k) for k in range(3))
    want = (len(SUR_FIELDS), K._F_COUNT, K._I_COUNT)
    if got != want:
        raise RuntimeError(f"surrogate kernel layout {got} does not match the wrapper's {want}")


def _kernel_ctx(ctx):
    """The ctx with its extinction as a float32 scalar (a learned
    extinction is a 0-d tensor, read here; the window reads it once and
    passes the scalar)."""
    return dataclasses.replace(
        ctx, extinction=np.float32(float(torch.as_tensor(ctx.extinction).detach())))


def tape_forward(state, ctx, seeds, steps: int, n_bins: int):
    """K taped surrogate dispatches (one per frame seed) from ``state``,
    which stays untouched: (state_out, tapes (K, steps, F, lanes) f32);
    one kernel launch on a CUDA device."""
    check_ctx(ctx)
    ctx = _kernel_ctx(ctx)
    out = clone_steppable(state)
    tensors = out.tensors() + K._ctx_tensors(ctx)
    if K._route(*tensors) == "cpu":
        return out, tape_forward_plain(out, ctx, seeds, steps, n_bins)
    K._check_state(out, n_bins)
    K._check_tables(ctx)
    seeds = np.asarray(seeds, np.uint32).reshape(-1)
    lane = tuple(out.px.shape)
    streams = lane[0] if len(lane) == 3 else 1
    f, i = K._params(ctx, lane[-1], streams, n_bins, steps, len(seeds), out.px.numel())
    flds = fields(ctx.majorant is not None)
    lib = _build.load()
    _check_layout(lib)
    device = out.px.device
    tapes = torch.empty((len(seeds), steps, len(flds), out.px.numel()), dtype=torch.float32,
                        device=device)
    seeds_dev = torch.as_tensor(seeds.view(np.int32), device=device)
    with torch.cuda.device(device):
        err = lib.vpt_surrogate_tape_forward(
            f.ctypes.data, i.ctypes.data, _slots(flds).ctypes.data, len(flds),
            *(getattr(out, k).data_ptr() for k in K.STATE_FIELDS[:11]),
            K.density_table(ctx).data_ptr(), ctx.material_tf.data_ptr(), K._ptr(ctx.majorant),
            K._ptr(ctx.environment), seeds_dev.data_ptr(), tapes.data_ptr(), K._light_ptr(ctx),
            K._stream(device))
    K._raise_on(err, "surrogate_tape_forward")
    _count("surrogate_tape_forward", ctx, majorant=True)
    return out, tapes


def _count(name, ctx, majorant=False, quasicubic=False):
    """Counts a launch under ``name`` and under each mode it ran."""
    env, maj = ctx.environment is not None, ctx.majorant is not None
    LAUNCHES[name] += 1
    for mode, on in (("majorant", majorant and maj), ("environment", env),
                     ("environment_majorant", env and maj),
                     ("quasicubic", quasicubic and ctx.volume_filter == "quasicubic"),
                     ("xy", getattr(ctx.density, "kind", None) == "xy"),
                     ("raw", K.is_raw(ctx))):
        if on:
            LAUNCHES[f"{name}_{mode}"] += 1


# ---------------------------------------------------------------------------
# K12: the reverse pass
# ---------------------------------------------------------------------------
def _tie_max(x, lo: float):
    """d max(x, lo) / dx as jnp/torch give it: 1 above, 1/2 at a tie."""
    one = torch.ones_like(x)
    return torch.where(x > lo, one, torch.where(x == lo, 0.5 * one, 0.0 * one))


def _tie_min(x, hi: float):
    one = torch.ones_like(x)
    return torch.where(x < hi, one, torch.where(x == hi, 0.5 * one, 0.0 * one))


def _volume_corners(vol, px, py, pz, filt: str = "linear"):
    """The forward's volume lookup at the sample position, with what its
    adjoint needs: (dens, where it read, the unwarped fractions, the
    weights (fx, fy, fz), corners (8 tensors)). A full table's corners are
    its row0's 8 and it read (row0, row0); an xy table's are the 4 of the
    z0 plane's row0, then the 4 of the z1 plane's row1; a raw grid's are
    the 8 voxels it read, in the packed row's order (bit 2 z, bit 1 y,
    bit 0 x), and their flat indices; the same values in the same order
    every way. Under the nearest filter: (dens, the voxel's flat index,
    None, None, None)."""
    if not isinstance(vol, interp.PackedVolume):
        D, H, W = vol.shape
        flat = vol.reshape(-1)
        if filt == "nearest":
            idx = ((interp._nearest_coords(pz, D) * H + interp._nearest_coords(py, H)) * W
                   + interp._nearest_coords(px, W)).to(torch.int64)
            return flat[idx], idx, None, None, None
        x0, x1, fx = interp._coords(px, W)
        y0, y1, fy = interp._coords(py, H)
        z0, z1, fz = interp._coords(pz, D)
        idx = [((zi * H + yi) * W + xi).to(torch.int64)
               for zi in (z0, z1) for yi in (y0, y1) for xi in (x0, x1)]
        c = [flat[i] for i in idx]
        raw = (fx, fy, fz)
    else:
        row0, row1, *raw = interp.volume_rows(vol.dims, px, py, pz, vol.kind)
        row0, row1 = row0.to(torch.int64), row1.to(torch.int64)
        if vol.kind == "xy":
            rows = interp.dequantize_rows(torch.cat([vol.table[row0], vol.table[row1]], dim=-1))
        else:
            rows = interp.dequantize_rows(vol.table[row0])
        c = [rows[..., k] for k in range(8)]
        idx = (row0, row1)
    fx, fy, fz = (interp.quasicubic_warp(f) for f in raw) if filt == "quasicubic" else raw
    c00 = c[0] + (c[1] - c[0]) * fx
    c01 = c[2] + (c[3] - c[2]) * fx
    c10 = c[4] + (c[5] - c[4]) * fx
    c11 = c[6] + (c[7] - c[6]) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    return c0 + (c1 - c0) * fz, idx, tuple(raw), (fx, fy, fz), c


def _volume_scales(vol) -> tuple:
    """d(fraction) / d(position) along x, y, z: the axis lengths W, H, D
    for every kind (a full table's dims are D+1, H+1, W+1, an xy table's
    D, H+1, W+1)."""
    if not isinstance(vol, interp.PackedVolume):
        D, H, W = vol.shape
        return float(W), float(H), float(D)
    D0, Hp, Wp = vol.dims
    return float(Wp - 1), float(Hp - 1), float(D0 if vol.kind == "xy" else D0 - 1)


def _tf_corners(tf, t_coord, dens):
    """The forward's TF lookup at (wavelength coordinate, density): (the 4
    corners (y0x0, y0x1, y1x0, y1x1), each (lanes, >= 3), fx, fy, the
    density axis's scale, where the corners lie). A fused (18) or packed
    (16) table reads one row (``sample_tex2d``'s packed path; where: the
    row), a raw (H, W, 4) one 4 texels (its raw path; where: the 4
    texels)."""
    H0, W0, CC = tf.shape
    flat = tf.reshape(-1, CC)
    if CC == 4:
        x0, x1, fx = interp._coords(t_coord, W0)
        y0, y1, fy = interp._coords(dens, H0)
        where = [(yi * W0 + xi).to(torch.int64) for yi in (y0, y1) for xi in (x0, x1)]
        return [flat[i] for i in where], fx, fy, float(H0), where
    bx, fx = interp._base_and_frac(t_coord, W0 - 1)
    by, fy = interp._base_and_frac(dens, H0 - 1)
    row = (by * W0 + bx).to(torch.int64)
    rows = flat[row]
    return [rows[..., 4 * q:4 * q + 4] for q in range(4)], fx, fy, float(H0 - 1), row


def _light_add(g_light, light, t_coord, g):
    """Adds the adjoint ``g`` of the light's value at ``t_coord`` into
    ``g_light``, of the light table's kind: a raw (N,) table's two texels,
    a pair (N+1, 2) table's row (``interp.sample_tex1d``)."""
    if light.ndim == 2:
        b, f = interp._base_and_frac(t_coord, light.shape[0] - 1)
        g_light.index_add_(0, b.to(torch.int64), torch.stack([g * (1 - f), g * f], dim=-1))
        return
    x0, x1, f = interp._coords(t_coord, light.shape[0])
    g_light.index_add_(0, x0.to(torch.int64), g * (1 - f))
    g_light.index_add_(0, x1.to(torch.int64), g * f)


def _env_reverse(env, d, lam, g_emit, oob, adj):
    """The escape's environment lookup in reverse (K12's ``env_reverse``,
    in its order), for the adjoint ``g_emit`` of the emitted value on the
    escaping lanes ``oob``: adds the 4 texel terms into ``adj["g_env"]``
    when present and returns the direction's adjoint (3 tensors). A packed
    (He+1, We+1, 12) map reads one row, a raw (He, We, 3) one 4 texels
    (``sample_environment``'s lookups); the band's channel of each."""
    dx, dy, dz = d
    H0, W0, CC = env.shape
    u = torch.atan2(dx, -dz) * K.INV_PI * 0.5 + 0.5
    v = torch.asin(-dy) * 2.0 * K.INV_PI * 0.5 + 0.5
    band = torch.where(lam < 500.0, 2, torch.where(lam < 600.0, 1, 0)).to(torch.int64)
    if CC == 3:
        x0, x1, fx = interp._coords(u, W0)
        y0, y1, fy = interp._coords(v, H0)
        where = [(yi * W0 + xi).to(torch.int64) * 3 + band for yi in (y0, y1) for xi in (x0, x1)]
        scale_x, scale_y = float(W0), float(H0)
    else:
        bx, fx = interp._base_and_frac(u, W0 - 1)
        by, fy = interp._base_and_frac(v, H0 - 1)
        row = (by * W0 + bx).to(torch.int64) * 12 + band
        where = [row + 3 * k for k in range(4)]
        scale_x, scale_y = float(W0 - 1), float(H0 - 1)
    flat = env.reshape(-1)
    a = [flat[i] for i in where]
    c0 = a[0] + (a[1] - a[0]) * fx
    c1 = a[2] + (a[3] - a[2]) * fx
    zero = torch.zeros_like(g_emit)
    g = torch.where(oob, g_emit, zero) * K.ENV_GAIN
    if "g_env" in adj:
        w = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
        for i, wk in zip(where, w):
            adj["g_env"].view(-1).index_add_(0, i, torch.where(oob, g * wk, zero))
    g_fx = g * (1 - fy) * (a[1] - a[0]) + g * fy * (a[3] - a[2])
    g_fy = g * (c1 - c0)
    g_at = g_fx * scale_x * 0.5 * K.INV_PI
    g_as = g_fy * scale_y * 0.5 * 2.0 * K.INV_PI
    r2 = dx * dx + dz * dz
    gdl = (g_at * -dz / r2, -(g_as / torch.sqrt(1.0 - dy * dy)), g_at * dx / r2)
    return tuple(torch.where(oob, t, zero) for t in gdl)


def _hg_reverse(g, d, u, ucos, go):
    """Adjoints (g_g, g_d) of sampling.draw_hg's anisotropic branch at
    (g, d) with sphere sample ``u`` and cosine draw ``ucos``, for the output
    adjoint ``go``: its forward ops, then their transposes in reverse."""
    dx, dy, dz = d
    ux, uy, uz = u
    g2 = g * g
    den = 1.0 - g + 2.0 * g * ucos
    cc = (1.0 - g2) / den
    num = 1.0 + g2 - cc * cc
    g2x = 2.0 * g
    h = num / g2x
    udotd = ux * dx + uy * dy + uz * dz
    cx, cy, cz = ux - udotd * dx, uy - udotd * dy, uz - udotd * dz
    cl = cx * cx + cy * cy + cz * cz
    pos = cl > 0
    m_cl = torch.maximum(cl, torch.full_like(cl, 1e-30))
    y = torch.sqrt(m_cl)
    cn = torch.where(pos, 1.0 / y, torch.zeros_like(cl))
    m_arg = 1.0 - h * h
    sn = torch.sqrt(torch.clamp_min(m_arg, 0.0))
    gox, goy, goz = go
    # o = (sn * c) * cn + h * d
    g_h = gox * dx + goy * dy + goz * dz
    gdx, gdy, gdz = gox * h, goy * h, goz * h
    gtx, gty, gtz = gox * cn, goy * cn, goz * cn
    g_cn = gox * (sn * cx) + goy * (sn * cy) + goz * (sn * cz)
    g_sn = gtx * cx + gty * cy + gtz * cz
    gcx, gcy, gcz = gtx * sn, gty * sn, gtz * sn
    # sn = sqrt(max(1 - h^2, 0)); inf / NaN at sn == 0, as jax.grad gives
    g_marg = g_sn / (2.0 * sn) * _tie_max(m_arg, 0.0)
    g_h = g_h - 2.0 * h * g_marg
    # cn = 1 / sqrt(max(cl, 1e-30)) where cl > 0
    g_y = -(g_cn * cn * cn)
    g_cl = torch.where(pos, g_y / (2.0 * y) * _tie_max(cl, 1e-30), torch.zeros_like(cl))
    gcx, gcy, gcz = gcx + 2.0 * cx * g_cl, gcy + 2.0 * cy * g_cl, gcz + 2.0 * cz * g_cl
    # c = u - (u . d) d
    g_ud = -(gcx * dx + gcy * dy + gcz * dz)
    gdx, gdy, gdz = gdx - udotd * gcx, gdy - udotd * gcy, gdz - udotd * gcz
    gdx, gdy, gdz = gdx + g_ud * ux, gdy + g_ud * uy, gdz + g_ud * uz
    # h = (1 + g^2 - c^2) / (2 g), c = (1 - g^2) / (1 - g + 2 g ucos)
    g_num = g_h / g2x
    g_g = 2.0 * (-(g_h * h / g2x))
    g_cc = -2.0 * cc * g_num
    g_den = -(g_cc * cc / den)
    g_g2 = g_num - g_cc / den
    g_g = g_g - g_den + 2.0 * ucos * g_den + 2.0 * g * g_g2
    return g_g, (gdx, gdy, gdz)


def reverse_plain(tapes, flds, samples, carry, adj, ctx, n_bins: int):
    """Plain ``reverse``: walks the K dispatch tapes backwards, updating
    the carry (dict: c (lanes,), gp (3, lanes), gd (3, lanes), grad
    (n_bins, lanes)) and adding into ``adj`` (any of g_ext, g_tf, g_vol,
    g_light, g_env, each of its table's kind: ``adjoint_shapes``), both in
    place. ``samples``: each lane's sample count at the end of the last
    dispatch."""
    check_ctx(ctx)
    n_disp, steps = tapes.shape[:2]
    col = {f: i for i, f in enumerate(flds)}
    (lx, ly, lz), isotropic = K.light_terms(ctx.light_direction)
    mu = K._f32(float(torch.as_tensor(ctx.extinction).detach()))
    inv_mu = K._f32(np.float32(1.0) / np.float32(mu))
    tf = ctx.material_tf
    fused = tf.shape[-1] == 18
    tf_flat = tf.reshape(-1, tf.shape[-1])
    vol = ctx.density
    filt = ctx.volume_filter
    raw_vol = not isinstance(vol, interp.PackedVolume)
    scales = _volume_scales(vol)
    majorant = "maj" in col
    env = ctx.environment
    c = carry["c"].clone()
    gp = [t.clone() for t in carry["gp"]]
    gd = [t.clone() for t in carry["gd"]]
    grad = carry["grad"].clone()
    n = samples.reshape(-1).to(torch.int32).clone()
    zero = torch.zeros_like(c)
    ext_lane = torch.zeros_like(c)
    for k in range(n_disp - 1, -1, -1):
        for it in range(steps - 1, -1, -1):
            t = tapes[k, it]
            flags = t[col["flags"]].view(torch.int32)
            respawn, oob = (flags & F_RESPAWN) != 0, (flags & F_OOB) != 0
            null, scat = (flags & F_NULL) != 0, (flags & F_SCATTER) != 0
            pre_bin = flags >> 8
            dist = t[col["dist"]]
            d = (t[col["dx"]], t[col["dy"]], t[col["dz"]])
            pos = (t[col["px"]], t[col["py"]], t[col["pz"]])
            # the deposit: g/n to the deposit, g (1 - 1/n) stays
            denom = torch.clamp_min(n, 1).to(torch.float32)
            ok = respawn & (pre_bin >= 0) & (pre_bin < n_bins)
            sel = torch.gather(grad, 0, pre_bin.clamp(0, n_bins - 1).to(torch.int64)[None])[0]
            g_dep = torch.where(ok, sel / denom, zero)
            grad = torch.where(respawn[None], grad - grad / denom[None], grad)
            n = n - respawn.to(torch.int32)
            # the escape light, recomputed from the wavelength's light pair
            # in the fused TF rows or from the light's own table (or the
            # environment map)
            t_coord = sampling.div_scalar(t[col["lam"]] - 400.0, 300.0)
            bx, tfx = interp._base_and_frac(t_coord, tf.shape[1] - 1)
            if fused:
                pair = tf_flat[bx.to(torch.int64)]
                light_raw = pair[:, 16] + (pair[:, 17] - pair[:, 16]) * tfx
            else:
                light_raw = interp.sample_tex1d(ctx.light_spectrum, t_coord)
            intensity = light_raw * 5.0
            if env is not None:
                emitted = K.sample_environment(env, *d, t[col["lam"]])
            elif isotropic:
                emitted = intensity
            else:
                ddot = d[0] * lx + d[1] * ly + d[2] * lz
                prod = ddot * intensity
                emitted = torch.maximum(prod, zero)
            emitted = torch.where(oob, emitted, zero)
            # score cotangent: cut at a respawn, restarted by its deposit
            c_mid = torch.where(respawn, zero, c)
            gs1 = c_mid + g_dep * emitted
            if majorant:
                maj = t[col["maj"]]
                capped = (flags & F_CAPPED) != 0
                rate = mu * maj
                ext_lane = ext_lane + (torch.where(capped, zero, gs1 / rate) - gs1 * dist) * maj
            else:
                ext_lane = ext_lane + (gs1 * inv_mu - gs1 * dist)
            # the light's pathwise terms (escaping lanes)
            g_esc = torch.where(oob, g_dep, zero)
            if env is not None:
                gdl = _env_reverse(env, d, t[col["lam"]], g_dep, oob, adj)
                g_int = zero
            elif isotropic:
                g_int = g_esc
                gdl = (zero, zero, zero)
            else:
                g_prod = g_esc * _tie_max(prod, 0.0)
                g_int = g_prod * ddot
                g_dot = g_prod * intensity
                gdl = (g_dot * lx, g_dot * ly, g_dot * lz)
            g_light = g_int * 5.0
            if "g_light" in adj:
                _light_add(adj["g_light"], ctx.light_spectrum, t_coord, g_light)
            # the material at the sample position (the forward's lookups)
            dens, vwhere, vraw, vf, corner = _volume_corners(vol, *pos, filt)
            tk, fx, fy, th, twhere = _tf_corners(tf, t_coord, dens)
            cx0 = tk[0][..., :3] + (tk[1][..., :3] - tk[0][..., :3]) * fx[..., None]
            cx1 = tk[2][..., :3] + (tk[3][..., :3] - tk[2][..., :3]) * fx[..., None]
            mat = cx0 + (cx1 - cx0) * fy[..., None]
            albedo, alpha, g = mat[..., 0], mat[..., 1], mat[..., 2] * 2.0 - 1.0
            # event scores
            if majorant:
                x = alpha / maj
                p_real = torch.minimum(x, torch.ones_like(x))
                p_null, p_s = 1.0 - p_real, p_real * albedo
            else:
                p_null, p_s = 1.0 - alpha, alpha * albedo
            g_pn = torch.where(null, c_mid / torch.maximum(p_null, torch.full_like(zero, 1e-12))
                               * _tie_max(p_null, 1e-12), zero)
            g_ps = torch.where(scat, c_mid / torch.maximum(p_s, torch.full_like(zero, 1e-12))
                               * _tie_max(p_s, 1e-12), zero)
            if majorant:
                g_preal = -g_pn + g_ps * albedo
                g_albedo = g_ps * p_real
                g_alpha = g_preal * _tie_min(x, 1.0) / maj
            else:
                g_alpha = -g_pn + g_ps * albedo
                g_albedo = g_ps * alpha
            # the HG inversion, pathwise (scattering anisotropic lanes)
            aniso = scat & (torch.abs(g) >= EPS)
            s = _f_to_u32(t[col["rng"]])
            s, u = sampling.draw_sphere(s, torch.ones_like(scat))
            _, ucos = sampling.draw(s, torch.ones_like(scat))
            gs = torch.where(aniso, g, torch.full_like(g, 0.5))
            go = tuple(torch.where(aniso, gdi, zero) for gdi in gd)
            g_g, gd_hg = _hg_reverse(gs, d, u, ucos, go)
            g_g = torch.where(aniso, g_g, zero)
            gd_hg = [torch.where(aniso, v, zero) for v in gd_hg]
            g_mat2 = g_g * 2.0
            # the TF corners (events) and, in the fused table, the light
            # pair (escapes): one row; a 16-wide row; or 4 raw texels
            w = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
            if "g_tf" in adj and fused:
                cols = []
                for wk in w:
                    cols += [g_albedo * wk, g_alpha * wk, g_mat2 * wk, zero]
                cols += [g_light * (1 - tfx), g_light * tfx]
                row = torch.where(oob, bx.to(torch.int64), twhere)
                adj["g_tf"].index_add_(0, row, torch.stack(cols, dim=-1))
            elif "g_tf" in adj:
                # each corner's 4 channels as a row of the (-1, 4) view
                g4 = adj["g_tf"].view(-1, 4)
                for q, wk in enumerate(w):
                    at = twhere * 4 + q if tf.shape[-1] == 16 else twhere[q]
                    g4.index_add_(0, at, torch.stack([g_albedo * wk, g_alpha * wk, g_mat2 * wk,
                                                      zero], dim=-1))
            # the density: slopes, then the corner weights and the position
            slope = (cx1 - cx0) * th
            g_dens = g_albedo * slope[..., 0] + g_alpha * slope[..., 1] + g_mat2 * slope[..., 2]
            if corner is None:
                # the nearest voxel: its density alone, no spatial gradient
                if "g_vol" in adj:
                    adj["g_vol"].index_add_(0, vwhere, g_dens)
                gpd = (zero, zero, zero)
            else:
                vfx, vfy, vfz = vf
                if "g_vol" in adj:
                    w4 = ((1 - vfy) * (1 - vfx), (1 - vfy) * vfx, vfy * (1 - vfx), vfy * vfx)
                    a0, a1 = g_dens * (1 - vfz), g_dens * vfz
                    t0 = [a0 * wk for wk in w4]
                    t1 = [a1 * wk for wk in w4]
                    if raw_vol:
                        # the 8 voxels; at a clamped edge two are one voxel
                        for i, term in zip(vwhere, t0 + t1):
                            adj["g_vol"].index_add_(0, i, term)
                    elif vol.kind == "xy":
                        # two plane rows; at a clamped z plane both land on one
                        adj["g_vol"].index_add_(0, vwhere[0], torch.stack(t0, dim=-1))
                        adj["g_vol"].index_add_(0, vwhere[1], torch.stack(t1, dim=-1))
                    else:
                        adj["g_vol"].index_add_(0, vwhere[0], torch.stack(t0 + t1, dim=-1))
                cc = corner
                l00 = cc[0] + (cc[1] - cc[0]) * vfx
                l01 = cc[2] + (cc[3] - cc[2]) * vfx
                l10 = cc[4] + (cc[5] - cc[4]) * vfx
                l11 = cc[6] + (cc[7] - cc[6]) * vfx
                l0 = l00 + (l01 - l00) * vfy
                l1 = l10 + (l11 - l10) * vfy
                g_fz = g_dens * (l1 - l0)
                g_l0, g_l1 = g_dens * (1 - vfz), g_dens * vfz
                g_fy = g_l0 * (l01 - l00) + g_l1 * (l11 - l10)
                g_fx = (g_l0 * (1 - vfy) * (cc[1] - cc[0]) + g_l0 * vfy * (cc[3] - cc[2])
                        + g_l1 * (1 - vfy) * (cc[5] - cc[4]) + g_l1 * vfy * (cc[7] - cc[6]))
                if filt == "quasicubic":
                    # the warp's derivative 6f(1 - f) at the unwarped fraction
                    g_fx, g_fy, g_fz = (gf * (6.0 * f * (1.0 - f))
                                        for gf, f in zip((g_fx, g_fy, g_fz), vraw))
                gpd = (g_fx * scales[0], g_fy * scales[1], g_fz * scales[2])
            # position and direction adjoints before the step
            keep = ~respawn
            gps = [torch.where(keep, gp[a], zero) + gpd[a] for a in range(3)]
            gd = [torch.where(keep, torch.where(scat, gd_hg[a], gd[a]), zero) + gdl[a]
                  + dist * gps[a] for a in range(3)]
            gp = gps
            c = gs1
    carry["c"].copy_(c)
    for a in range(3):
        carry["gp"][a].copy_(gp[a])
        carry["gd"][a].copy_(gd[a])
    carry["grad"].copy_(grad)
    if "g_ext" in adj:
        adj["g_ext"] += ext_lane.double().sum().to(torch.float32)


def reverse(tapes, flds, samples, carry, adj, ctx, n_bins: int):
    """The reverse pass over K stored surrogate dispatch tapes (dispatch K-1
    first): ``carry`` (the adjoints at the end, replaced by those at the
    start) and ``adj`` are updated in place; see ``reverse_plain``. One
    kernel launch on a CUDA device."""
    check_ctx(ctx)
    ctx = _kernel_ctx(ctx)
    n_disp, steps, n_fields, n_lanes = tapes.shape
    if tuple(flds) != fields(ctx.majorant is not None) or n_fields != len(flds):
        raise ValueError("the tape's fields do not match the ctx's mode")
    shapes = adjoint_shapes(ctx)
    unknown = set(adj) - set(shapes)
    if unknown:
        raise ValueError(f"adjoints {sorted(unknown)} have no table in this ctx (its adjoints: "
                         f"{sorted(shapes)})")
    tensors = ([tapes, samples, carry["c"], carry["grad"], *carry["gp"], *carry["gd"],
                *adj.values()] + K._ctx_tensors(ctx))
    if K._route(*tensors) == "cpu":
        return reverse_plain(tapes, flds, samples, carry, adj, ctx, n_bins)
    K._check(tapes, "tapes", torch.float32)
    K._check(samples.reshape(-1), "samples", torch.int32, (n_lanes,))
    K._check(carry["c"], "c", torch.float32, (n_lanes,))
    K._check(carry["grad"], "grad", torch.float32, (n_bins, n_lanes))
    for name in ("gp", "gd"):
        for a in range(3):
            K._check(carry[name][a], f"{name}[{a}]", torch.float32, (n_lanes,))
    # the vector atomics' alignment: float2 into TF+light rows and pairs,
    # float4 into 16-wide TF rows, raw texels and packed volume rows
    align = dict(g_tf={18: 8, 16: 16, 4: 16}[shapes["g_tf"][1]], g_light=8,
                 g_vol=16 if len(shapes["g_vol"]) == 2 else 4)
    for k, v in adj.items():
        K._check(v, k, torch.float32, shapes[k], align=align.get(k, 4))
    K._check_tables(ctx)
    # the lanes' pixels play no part in the reverse: resolution 1, 1 stream
    f, i = K._params(ctx, 1, 1, n_bins, steps, n_disp, n_lanes)
    lib = _build.load()
    _check_layout(lib)
    device = tapes.device
    # the extinction score, summed across blocks in f64 (csrc block_add)
    ext_acc = torch.zeros(1, dtype=torch.float64, device=device) if "g_ext" in adj else None
    with torch.cuda.device(device):
        err = lib.vpt_surrogate_reverse(
            f.ctypes.data, i.ctypes.data, _slots(flds).ctypes.data, len(flds), tapes.data_ptr(),
            samples.data_ptr(), carry["c"].data_ptr(), *(t.data_ptr() for t in carry["gp"]),
            *(t.data_ptr() for t in carry["gd"]), carry["grad"].data_ptr(),
            K.density_table(ctx).data_ptr(), ctx.material_tf.data_ptr(), K._light_ptr(ctx),
            K._ptr(ctx.environment), K._ptr(ext_acc), K._ptr(adj.get("g_tf")),
            K._ptr(adj.get("g_vol")), K._ptr(adj.get("g_light")), K._ptr(adj.get("g_env")),
            K._stream(device))
    K._raise_on(err, "surrogate_reverse")
    _count("surrogate_reverse", ctx, quasicubic=True)
    if ext_acc is not None:
        adj["g_ext"] += ext_acc.to(torch.float32)
