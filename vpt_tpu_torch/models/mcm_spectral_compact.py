"""Hit-lane compaction for the spectral MCM renderer (opt-in mode).

Counterpart of ``vpt_tpu/models/mcm_spectral_compact.py``. At the default
pose (camera z=2) about 2/3 of the pixels never meet the unit cube; their
value is known in closed form. Compaction therefore

1. classifies pixels on the host with a conservative pixel-pyramid vs
   cube test (``hit_pixel_mask``: a pixel is "miss" only if its whole
   anti-aliasing ray bundle provably misses);
2. marches lanes for hit pixels only, packed into an (M, resolution) lane
   table (``build_lane_tables``): lane s*n_hit + k is stream s of hit pixel
   k and seeds its chain from that pixel's (ix, iy + s*resolution), so a
   hit pixel's estimate is the full kernel's for the same seeds; padding
   lanes march pixel (0, 0)'s chain and are never read back;
3. gives miss pixels the closed-form expectation of the same estimator
   (``analytic_miss_radiance`` for the light, ``analytic_miss_radiance_env``
   for an environment map).

The numpy host helpers are ports of the JAX module's (which imports jax),
with the same arithmetic; the device path runs the step and reset kernels
over the lane table and the compact_image kernel
(``vpt_tpu_torch/kernels/mcm_spectral.py``).

Restrictions (``ValueError`` in the renderer): blur == 0, one device (no
mesh).
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.models.mcm_spectral import SpectralState, radiance_to_rgb

EPS = 1e-5


# --------------------------------------------------------------------------
# Host-side classification + closed forms (numpy, once per camera pose)
# --------------------------------------------------------------------------
def _unproject_np(inv_mvp, x, y, z):
    """Host replica of geometry.apply_homogeneous (row-major, w-divide)."""
    m = np.asarray(inv_mvp, np.float64)
    rx = m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3]
    ry = m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3]
    rz = m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3]
    rw = m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3]
    return np.stack([rx / rw, ry / rw, rz / rw], axis=-1)


def hit_pixel_mask(inv_mvp, resolution: int) -> np.ndarray:
    """(H, W) bool: True where the pixel's ray bundle MAY hit the cube.

    Separating-plane test of the pixel pyramid (apex: the pixel centre's
    near-plane point, the blur=0 ray origin; base: the pixel's far-plane
    quad, the jitter footprint) against the unit cube: miss only if all 8
    cube corners lie strictly outside one of the 4 side planes."""
    res = resolution
    cx = (np.arange(res + 1) / res - 0.5) * 2.0
    cy = (np.arange(res + 1) / res - 0.5) * -2.0
    sx = ((np.arange(res) + 0.5) / res - 0.5) * 2.0
    sy = ((np.arange(res) + 0.5) / res - 0.5) * -2.0

    # far-plane corner grid (res+1, res+1, 3), indexed [ix, iy]
    FX, FY = np.meshgrid(cx, cy, indexing="ij")
    far = _unproject_np(inv_mvp, FX, FY, 1.0)
    AX, AY = np.meshgrid(sx, sy, indexing="ij")
    apex = _unproject_np(inv_mvp, AX, AY, -1.0)
    far_c = _unproject_np(inv_mvp, AX, AY, 1.0)

    c00 = far[:-1, :-1] - apex
    c10 = far[1:, :-1] - apex
    c11 = far[1:, 1:] - apex
    c01 = far[:-1, 1:] - apex
    center = far_c - apex

    corners = np.stack(np.meshgrid([0.0, 1.0], [0.0, 1.0], [0.0, 1.0],
                                   indexing="ij"), axis=-1).reshape(8, 3)

    miss = np.zeros((res, res), bool)
    for e0, e1 in ((c00, c10), (c10, c11), (c11, c01), (c01, c00)):
        n = np.cross(e0, e1)
        # orient inward (positive toward the pixel's centre ray)
        sgn = np.sign(np.einsum("xyk,xyk->xy", n, center))
        n = n * np.where(sgn == 0, 1.0, sgn)[..., None]
        d = (np.einsum("xyk,ck->xyc", n, corners)
             - np.einsum("xyk,xyk->xy", n, apex)[..., None])
        miss |= (d < 0).all(axis=-1)
    return ~miss.T  # [ix, iy] -> (H=iy, W=ix)


def _light_raw_np(light_256, t):
    """Host replica of the fused table's light interpolation."""
    lt = np.asarray(light_256, np.float64)
    N = lt.shape[0]
    s = np.asarray(t, np.float64) * N - 0.5
    i0 = np.floor(s)
    f = s - i0
    b = np.clip(i0.astype(np.int64) + 1, 0, N)
    p = np.pad(lt, 1, mode="edge")  # p[k] = lt[clip(k-1, 0, N-1)]
    return p[b] + (p[b + 1] - p[b]) * f


def bin_light_integrals(light_256, boundaries, n_bins: int,
                        samples: int = 200_000) -> np.ndarray:
    """I_b = E_{l~U(lo,hi)}[1{bin(l)=b} * raw(l)] per bin, by midpoint
    quadrature of the kernel's own lookup arithmetic."""
    bounds = np.asarray(boundaries, np.float64)
    lo, hi = bounds[0], bounds[n_bins]
    lam = lo + (np.arange(samples) + 0.5) / samples * (hi - lo)
    raw = _light_raw_np(light_256, (lam - 400.0) / 300.0)
    b = np.zeros(samples, np.int64)
    for i in range(1, n_bins):
        b += (lam >= bounds[i]).astype(np.int64)
    out = np.zeros(n_bins, np.float64)
    np.add.at(out, b, raw)
    return out / samples


def _apex_grid(inv_mvp, res):
    sx = ((np.arange(res) + 0.5) / res - 0.5) * 2.0
    sy = ((np.arange(res) + 0.5) / res - 0.5) * -2.0
    AX, AY = np.meshgrid(sx, sy, indexing="xy")  # (H=iy rows, W=ix cols)
    return AX, AY, _unproject_np(inv_mvp, AX, AY, -1.0)


def _jitter_dirs(inv_mvp, res, k):
    """Unit ray directions of each pixel over a k x k midpoint quadrature
    of the jitter square, one (H, W, 3) array at a time."""
    AX, AY, apex = _apex_grid(inv_mvp, res)
    inv_res = 1.0 / res
    for a in range(k):
        for b in range(k):
            jx = ((a + 0.5) / k * 2.0 - 1.0) * inv_res
            jy = ((b + 0.5) / k * 2.0 - 1.0) * inv_res
            d = _unproject_np(inv_mvp, AX + jx, AY + jy, 1.0) - apex
            d /= np.linalg.norm(d, axis=-1, keepdims=True)
            yield d


def mean_gain_image(inv_mvp, resolution: int, light_direction,
                    k: int = 8) -> np.ndarray:
    """(H, W) subpixel-averaged directional factor E[max(dot(dir, ldn), 0)];
    all ones for an isotropic light (|light_direction| < EPS)."""
    ld = np.asarray(light_direction, np.float64)
    norm = float(np.sqrt((ld * ld).sum()))
    if norm < EPS:
        return np.ones((resolution, resolution), np.float64)
    ldn = ld / norm
    acc = np.zeros((resolution, resolution), np.float64)
    for d in _jitter_dirs(inv_mvp, resolution, k):
        acc += np.maximum(d @ ldn, 0.0)
    return acc / (k * k)


def analytic_miss_radiance(inv_mvp, resolution, light_256, light_direction,
                           boundaries, n_bins) -> np.ndarray:
    """(B, H, W) f32 converged per-bin radiance of miss pixels: 5 * I_b *
    mean_gain."""
    I = bin_light_integrals(light_256, boundaries, n_bins)
    g = mean_gain_image(inv_mvp, resolution, light_direction)
    return (5.0 * I[:, None, None] * g[None]).astype(np.float32)


def band_bin_fractions(boundaries, n_bins: int) -> np.ndarray:
    """(B, 3) P(lambda in bin b AND the band of channel c), lambda uniform
    over the bins; channel 2 below 500 nm, 1 in [500, 600), 0 above."""
    bounds = np.asarray(boundaries, np.float64)
    lo, hi = bounds[0], bounds[n_bins]
    total = hi - lo
    bands = {2: (-np.inf, 500.0), 1: (500.0, 600.0), 0: (600.0, np.inf)}
    out = np.zeros((n_bins, 3), np.float64)
    for b in range(n_bins):
        b_lo, b_hi = bounds[b], bounds[b + 1]
        for c, (c_lo, c_hi) in bands.items():
            out[b, c] = max(0.0, min(b_hi, c_hi) - max(b_lo, c_lo)) / total
    return out


def _bilinear_np(tex, u, v):
    """Host replica of a bilinear lookup of a raw (H, W, C) texture (texel
    centres at (i+0.5)/N, clamp-to-edge)."""
    t = np.asarray(tex, np.float64)
    H, W, _ = t.shape

    def coords(x, n):
        s = np.asarray(x, np.float64) * n - 0.5
        i0 = np.floor(s)
        f = s - i0
        lo = np.clip(i0.astype(np.int64), 0, n - 1)
        hi = np.clip(i0.astype(np.int64) + 1, 0, n - 1)
        return lo, hi, f

    x0, x1, fx = coords(u, W)
    y0, y1, fy = coords(v, H)
    c0 = t[y0, x0] + (t[y0, x1] - t[y0, x0]) * fx[..., None]
    c1 = t[y1, x0] + (t[y1, x1] - t[y1, x0]) * fx[..., None]
    return c0 + (c1 - c0) * fy[..., None]


def mean_env_image(inv_mvp, resolution: int, env_raw, k: int = 8) -> np.ndarray:
    """(H, W, 3) subpixel-averaged equirect lookup E_jitter[env(dir)], with
    the kernel's addressing (the reference's y quirk kept)."""
    acc = np.zeros((resolution, resolution, 3), np.float64)
    inv_pi = 1.0 / np.pi
    for d in _jitter_dirs(inv_mvp, resolution, k):
        u = np.arctan2(d[..., 0], -d[..., 2]) * inv_pi * 0.5 + 0.5
        v = np.arcsin(np.clip(-d[..., 1], -1.0, 1.0)) * 2.0 * inv_pi * 0.5 + 0.5
        acc += _bilinear_np(env_raw, u, v)
    return acc / (k * k)


def analytic_miss_radiance_env(inv_mvp, resolution, env_raw, boundaries,
                               n_bins) -> np.ndarray:
    """(B, H, W) f32 converged per-bin radiance of miss pixels under an
    environment map: 2.7 * sum_c frac[b, c] * mean_env[:, :, c]."""
    frac = band_bin_fractions(boundaries, n_bins)
    env = mean_env_image(inv_mvp, resolution, env_raw)
    return (2.7 * np.einsum("bc,hwc->bhw", frac, env)).astype(np.float32)


# --------------------------------------------------------------------------
# Lane tables (host, once per camera pose)
# --------------------------------------------------------------------------
def build_lane_tables(hit: np.ndarray, resolution: int, streams: int,
                      row_bucket: int = 64):
    """Pack hit pixels (x streams) into (M, resolution) uint32 lane arrays
    and the flat pixel index of each lane (padding lanes -> the dump row
    n_pixels). M is rounded up to a multiple of ``row_bucket``, so nearby
    poses share one lane shape."""
    iy, ix = np.nonzero(hit)
    n_hit = ix.size
    n_pixels = resolution * resolution
    L = n_hit * streams
    M = max((L + resolution - 1) // resolution, 1)
    if row_bucket > 1:
        M = -(-M // row_bucket) * row_bucket
    pad = M * resolution - L

    s = np.repeat(np.arange(streams, dtype=np.uint32), n_hit)
    lane_ix = np.tile(ix.astype(np.uint32), streams)
    lane_iy = np.tile(iy.astype(np.uint32), streams)
    lane_seed_iy = lane_iy + s * np.uint32(resolution)
    lane_pixel = (lane_iy.astype(np.int64) * resolution + lane_ix).astype(np.int32)

    def padded(a, fill):
        return np.concatenate([a, np.full(pad, fill, a.dtype)])

    return dict(
        lane_ix=padded(lane_ix, 0).reshape(M, resolution),
        lane_iy=padded(lane_iy, 0).reshape(M, resolution),
        lane_seed_iy=padded(lane_seed_iy, 0).reshape(M, resolution),
        lane_pixel=padded(lane_pixel, n_pixels),
        n_hit=n_hit, pad=pad, M=M,
    )


def hit_pixel_index(hit: np.ndarray) -> np.ndarray:
    """(H*W,) int32: each hit pixel's index k in raster order (the order of
    ``build_lane_tables``), -1 for a miss pixel."""
    flat = np.asarray(hit, bool).reshape(-1)
    out = np.full(flat.size, -1, np.int32)
    out[flat] = np.arange(int(flat.sum()), dtype=np.int32)
    return out


def device_tables(inv_mvp, resolution: int, streams: int, spectrum, light_raw,
                  light_direction, env_raw, device) -> dict:
    """One pose's compaction tables on ``device``: hit mask, closed-form
    miss radiance (B, res, res), int32 lane tables (M, res), lane_pixel,
    pixel_hit and n_hit."""
    hit = hit_pixel_mask(inv_mvp, resolution)
    t = build_lane_tables(hit, resolution, streams)
    if env_raw is not None:
        miss = analytic_miss_radiance_env(inv_mvp, resolution, env_raw,
                                          spectrum.boundaries, spectrum.n_bins)
    else:
        miss = analytic_miss_radiance(inv_mvp, resolution, light_raw, light_direction,
                                      spectrum.boundaries, spectrum.n_bins)

    def dev(a, dtype=None):
        a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
        return torch.as_tensor(a, device=device)

    return dict(hit=dev(hit), miss=dev(miss), lane_ix=dev(t["lane_ix"], np.int32),
                lane_iy=dev(t["lane_iy"], np.int32),
                lane_seed_iy=dev(t["lane_seed_iy"], np.int32),
                lane_pixel=dev(t["lane_pixel"]), pixel_hit=dev(hit_pixel_index(hit)),
                n_hit=int(t["n_hit"]))


# --------------------------------------------------------------------------
# Device path
# --------------------------------------------------------------------------
def compact_reset(ctx, lane_ix, lane_iy, lane_seed_iy, n_bins: int,
                  resolution: int) -> SpectralState:
    """``full_reset`` over an explicit (M, resolution) int32 lane table."""
    return SpectralState(**K.reset(ctx, resolution, n_bins, 1, lane_ix.device,
                                   lanes=(lane_ix, lane_iy, lane_seed_iy)))


def render_compact_many(state: SpectralState, ctx, seeds, lane_ix, lane_iy, lane_seed_iy,
                        steps: int, n_bins: int, resolution: int) -> SpectralState:
    """K dispatches over the compact lane set, in place (one step-kernel
    launch on a CUDA device). The lane math is the full kernel's; only
    the pixel of each lane comes from the table."""
    if state.px.shape[-1] != resolution:
        raise ValueError(f"lane rows of {state.px.shape[-1]} != resolution {resolution}")
    K.step(state, ctx, seeds, steps, n_bins, lanes=(lane_ix, lane_iy, lane_seed_iy))
    return state


def compact_image(state: SpectralState, pixel_hit, n_hit: int, miss_radiance, bin_xyz,
                  streams: int):
    """(res, res, 3) linear RGB: each hit pixel's mean over its stream lanes
    (as ``radiance_to_rgb`` averages streams), the closed-form radiance for
    miss pixels. ``pixel_hit`` is ``hit_pixel_index`` of the hit mask."""
    rad = K.compact_radiance(state.radiance, pixel_hit, miss_radiance, n_hit, streams)
    return radiance_to_rgb(rad, bin_xyz)
