"""The local-ambient-occlusion kernel: wrapper, plain version, launch counts.

One kernel of ``vpt_tpu_torch/csrc/lao.cu``:

- ``lao_pass`` (K25 ``lao_frame_kernel<LAO, SHADOWS, MODE>``): one LAO
  frame (replaces ``vpt_tpu/models/lao.py::lao_frame``); plain version
  ``lao_frame``, the masked fixed-trip scan of the JAX code, with its name
  and arguments. MODE is the table kind (``kernel_mode``): the packed u8
  or f32 corner table, linear or quasicubic, beside the packed TF, or the
  raw grid under the nearest filter beside the raw TF, the tables
  ``LAORenderer`` builds; on a CUDA device other pairs raise.

Per pixel: the camera ray clamped to the cube (``raymarch.camera_rays``,
``ray_bounds``), a per-pixel constant "random" value ``rx`` from the trig
hash ``rand2`` of the pixel's NDC (the NDC by division by the resolution),
then ``slices + 1`` samples starting at a jittered t0. Each sample reads the
volume 7 times (the value and a +-1/32 central difference), 20 times along
the light cone (``ceil(0.999 / lao_step)`` points at ``tt = 0.001 + i *
lao_step``, weighted ``(1 - tt)^2``) when ``lao_enabled``, once toward the
light for the soft shadow when ``shadows_enabled``, and the 2D TF at (value,
|gradient|); the two terms tint the TF colour, and the colour composites
front to back until the accumulated alpha passes 0.9. The light is
``inv_mvp @ [light, 1]`` without the perspective divide (``light_view``).

Constants that the reference folds in Python float64 enter as the f32
rounding of the double: the cone table (``cone_table``: tt and (1 - tt)^2),
``1/slices``, ``1/32`` and the shadow remap's ``1.0 * (1.0 - 1.2)``.
Divisions are IEEE (``ops.sampling.div_scalar`` for a scalar divisor: on
CUDA, PyTorch turns ``tensor / python_scalar`` into a multiply by the
reciprocal).

The wrapper runs the plain version when its tensors lie on the CPU and
launches the kernel when they lie on one CUDA device; anything else raises.
``LAUNCHES`` counts kernel launches (never plain runs): ``lao_frame``.
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.kernels import raymarch as RK
from vpt_tpu_torch.kernels.raymarch import _mix3, camera_rays, ray_bounds
from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.ops.sampling import div_scalar

# must match LF_COUNT / LI_COUNT in csrc/lao.cu
_F_COUNT = 28
_I_COUNT = 14
# the reference's hardcoded gradient voxel size
H_GRAD = np.float32(1.0 / 32.0)
# the shadow remap's bias, folded in float64 by the reference
SHADOW_BIAS = np.float32(1.0 * (1.0 - 1.2))

LAUNCHES = {"lao_frame": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# host-side constants
# ---------------------------------------------------------------------------
def n_lao_steps(lao_step: float) -> int:
    """The cone's sample count, ``ceil((1 - 0.001) / lao_step)``."""
    return int(np.ceil((1.0 - 0.001) / float(lao_step)))


def cone_table(lao_step: float) -> np.ndarray:
    """(n, 2) f32: each cone sample's ``tt = 0.001 + i * lao_step`` and
    weight ``(1 - tt)^2``, each folded in float64 and rounded to f32."""
    n = n_lao_steps(lao_step)
    out = np.empty((n, 2), np.float32)
    for i in range(n):
        tt = 0.001 + i * float(lao_step)
        out[i] = (np.float32(tt), np.float32((1.0 - tt) ** 2))
    return out


def light_view(inv_mvp, light_position) -> np.ndarray:
    """``inv_mvp @ [light, 1]``'s first three rows in f32, summed in the
    order of the reference's matrix-vector product, without the divide."""
    m = np.asarray(inv_mvp, np.float32)
    v = np.append(np.asarray(light_position, np.float32), np.float32(1.0))
    out = np.zeros(3, np.float32)
    for r in range(3):
        acc = m[r, 0] * v[0]
        for c in range(1, 4):
            acc = np.float32(acc + m[r, c] * v[c])
        out[r] = acc
    return out


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def rand2(px, py):
    """The reference's ``rand`` mixin: a trig hash of a 2-vector -> two
    uniforms, ``fract(cos(dx) * 1235.6789)`` and ``fract(sin(dy) *
    4378.5453)``."""
    dx = 23.14069263277926 * px + 2.665144142690225 * py
    dy = 12.98987893203892 * px + 78.23376739376591 * py
    mx = torch.cos(dx) * 1235.6789
    my = torch.sin(dy) * 4378.5453
    return mx - torch.floor(mx), my - torch.floor(my)


def pixel_rand(resolution: int, device):
    """Each pixel's ``rx`` (R, R) and the frame's constant ``g_rx`` (R, R):
    ``rand2`` of the pixel's NDC times (3.14, 2.71), and of (3.14, 2.71)."""
    i = torch.arange(resolution, dtype=torch.float32, device=device)
    ix = i.view(1, -1).expand(resolution, resolution)
    iy = i.view(-1, 1).expand(resolution, resolution)
    ndc_x = (div_scalar(ix + 0.5, float(resolution)) - 0.5) * 2.0
    ndc_y = (div_scalar(iy + 0.5, float(resolution)) - 0.5) * -2.0
    rx, _ = rand2(ndc_x * 3.14, ndc_y * 2.71)
    g_rx, _ = rand2(torch.full_like(ndc_x, 3.14), torch.full_like(ndc_y, 2.71))
    return rx, g_rx


def lao_frame(inv_mvp, density, tf_table, light_position, extinction, lao_weight,
              shadows_weight, light_radius, light_coef, *, lao_step: float, slices: int,
              resolution: int, num_lao_samples: int = 1, num_shadow_samples: int = 10,
              lao_enabled: bool = True, shadows_enabled: bool = True,
              volume_filter: str = "linear", observe=None, stop: bool = False):
    """One LAO frame, (R, R, 3) linear RGB: the JAX function's masked scan of
    ``slices + 1`` samples. ``num_lao_samples`` identical cone integrals
    and ``num_shadow_samples`` identical shadow samples average to one, as
    in the reference. ``observe(active, points, value, gmag)``, where
    given, sees each sample's mask, the points of its volume lookups and
    its TF coordinates (chip_smoke.py counts the kernel's work with it).
    ``stop``: each ray ends at its first inactive sample, whose sums then
    stay as they are, as K25 does where ``early_stop_exact`` and
    ``cone_clear`` hold (the same bits as the masked scan there)."""
    dev = tf_table.device
    frm, to = camera_rays(resolution, inv_mvp, dev)
    tn, tf_, miss = ray_bounds(frm, to)
    entry, exit_ = _mix3(frm, to, tn), _mix3(frm, to, tf_)
    step = np.float32(1.0 / slices)
    lx, ly, lz = (float(v) for v in light_view(inv_mvp, light_position))
    rx, g_rx = pixel_rand(resolution, dev)
    h = float(H_GRAD)
    ext, lw, sw = K._f32(extinction), K._f32(lao_weight), K._f32(shadows_weight)
    lr = np.float32(light_radius)

    points = []

    def vol(px, py, pz):
        if observe is not None:
            points.append((px, py, pz))
        return interp.sample_volume(density, px, py, pz, volume_filter)

    t0 = torch.clamp(rx * float(step) * 1.5, 0.0, 1.0)
    q = 2.0 * rx - 1.0
    lao_dx = q / torch.sqrt(3.0 * (q * q) + 1e-20) * rx
    sdx = -1.0 + lx * rx
    sdy = ly + rx * lz
    sdz = -1.0 + 2.0 * g_rx
    sn = torch.sqrt(sdx * sdx + sdy * sdy + sdz * sdz)
    sdx, sdy, sdz = sdx / sn * rx, sdy / sn * rx, sdz / sn * rx
    cone = cone_table(lao_step)

    z = torch.zeros((resolution, resolution), dtype=torch.float32, device=dev)
    acc_r, acc_g, acc_b, acc_a = z, z, z, z
    live = torch.ones_like(z, dtype=torch.bool)
    for k in range(slices + 1):
        t = t0 + float(np.float32(k) * step)
        active = (t < 1.0) & (acc_a <= K._f32(0.9))
        if stop:
            live = live & active
        p0, p1, p2 = _mix3(entry, exit_, t)
        gx = vol(p0 - h, p1, p2) - vol(p0 + h, p1, p2)
        gy = vol(p0, p1 - h, p2) - vol(p0, p1 + h, p2)
        gz = vol(p0, p1, p2 - h) - vol(p0, p1, p2 + h)
        gmag = torch.sqrt(gx * gx + gy * gy + gz * gz)
        value = vol(p0, p1, p2)

        lao = torch.zeros_like(value)
        if lao_enabled:
            acc_lao = torch.zeros_like(value)
            for tt, wgt in cone:
                d = lao_dx * float(lr * tt)
                jx, jy, jz = lx + d - p0, ly + d - p1, lz + d - p2
                jn = torch.sqrt(jx * jx + jy * jy + jz * jz)
                s = vol(p0 + jx / jn * float(tt), p1 + jy / jn * float(tt),
                        p2 + jz / jn * float(tt))
                acc_lao = acc_lao + s * float(wgt)
            lao = torch.clamp(div_scalar(acc_lao, K._f32(light_coef)), 0.0, 1.0)

        shadow = torch.zeros_like(value)
        if shadows_enabled:
            s = vol(p0 + sdx * float(lr), p1 + sdy * float(lr), p2 + sdz * float(lr))
            contrib = s * (s * 0.2) * rx
            shadow = torch.clamp(contrib * 20.0, 0.0, 1.0)
            shadow = torch.clamp(div_scalar(float(SHADOW_BIAS) + shadow * 1.2, K._f32(1.3)), 0.0,
                                 1.0)

        if observe is not None:
            observe(active, points, value, gmag)
            points.clear()
        tf4 = interp.sample_tex2d(tf_table, value, gmag)
        cr, cg, cb = tf4[..., 0], tf4[..., 1], tf4[..., 2]
        wl = lao * lw
        cr = cr + (cr * 0.15 - cr) * wl
        cg = cg + (cg * 0.18 - cg) * wl
        cb = cb + (cb * 0.32 - cb) * wl
        ws = shadow * sw
        cr = cr + (cr * 0.15 - cr) * ws
        cg = cg + (cg * 0.18 - cg) * ws
        cb = cb + (cb * 0.22 - cb) * ws

        w = torch.where(active, (1.0 - acc_a) * value, 0.0)
        sums = (acc_r + w * cr, acc_g + w * cg, acc_b + w * cb,
                acc_a + torch.where(active, div_scalar((1.0 - acc_a) * value * ext, 100.0), 0.0))
        if stop:
            sums = tuple(torch.where(live, new, old)
                         for new, old in zip(sums, (acc_r, acc_g, acc_b, acc_a)))
        acc_r, acc_g, acc_b, acc_a = sums
    scale = torch.where(acc_a > 1.0, torch.reciprocal(acc_a), 1.0)
    rgb = torch.stack([acc_r * scale, acc_g * scale, acc_b * scale], dim=-1)
    return torch.where(miss[..., None], 0.0, rgb)


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------
def early_stop_exact(density, tf_table, extinction, lao_weight, shadows_weight, light_radius,
                     light_coef) -> bool:
    """Whether K25 may stop a ray at its first inactive sample and give the
    masked scan's bits, as far as the tables and parameters decide it: the
    tables and the weights finite and ``light_coef`` not 0 (an inactive
    sample then adds exactly +0: at 0 a cone integral of 0 gives 0/0 = NaN,
    and 0 * NaN is NaN), and the density and extinction >= 0 (then the
    accumulated alpha of an active sample cannot fall, so a ray that passed
    0.9 stays inactive; t only grows). ``cone_clear`` decides the rest for
    each camera."""
    vol = RK._volume_tensor(density)
    dmin = vol.min() if vol.dtype == torch.uint8 else vol.float().min()
    ok = bool(torch.isfinite(tf_table).all()) and bool(dmin >= 0)
    if vol.dtype != torch.uint8:
        ok = ok and bool(torch.isfinite(vol).all())
    vals = np.asarray([extinction, lao_weight, shadows_weight, light_radius, light_coef],
                      np.float32)
    return (ok and bool(np.isfinite(vals).all()) and float(vals[0]) >= 0.0
            and float(vals[-1]) != 0.0)


def cone_clear(inv_mvp, light_position, light_radius, lao_step: float, slices: int) -> bool:
    """Whether no cone direction of this frame can be 0/0: the light's cone
    segment ``light_view + d * (1, 1, 1)``, ``|d| <= |light_radius| *
    max(tt) / sqrt(3)`` (the jitter ``|lao_dx| < 1 / sqrt(3)``), lies off
    the box every sample point stays in (the unit cube widened by ``2 /
    slices``: t runs up to 1 + 1.5 / slices) along at least one axis, with
    a margin for rounding."""
    light = light_view(inv_mvp, light_position).astype(np.float64)
    dmax = abs(float(light_radius)) * float(cone_table(lao_step)[:, 0].max()) * 0.6 + 1e-6
    e = 2.0 / slices + 1e-3
    return bool(np.any((light - dmax > 1.0 + e) | (light + dmax < -e)))


def kernel_mode(density, tf_table, volume_filter: str):
    """K25's table mode for these tables (csrc/lao.cu LaoMode), or None
    where it has no instance: "u8" / "f32" (a packed corner table, linear),
    "u8 quasicubic" / "f32 quasicubic", each beside the packed (Hp, Wp, 16)
    TF, or "nearest" (the raw (D, H, W) grid beside the raw (H, W, 4) TF)."""
    tf_raw = tf_table.shape[-1] == 4
    if not isinstance(density, interp.PackedVolume):
        return "nearest" if volume_filter == "nearest" and tf_raw else None
    if volume_filter == "nearest" or tf_raw:
        return None
    kind = "u8" if density.table.dtype == torch.uint8 else "f32"
    return kind + (" quasicubic" if volume_filter == "quasicubic" else "")


def _params(inv_mvp, density, tf_table, light_position, extinction, lao_weight,
            shadows_weight, light_radius, light_coef, slices, resolution, n_cone, exact,
            volume_filter):
    f = np.zeros(_F_COUNT, np.float32)
    f[0:16] = np.asarray(inv_mvp, np.float32).reshape(16)
    f[16:19] = light_view(inv_mvp, light_position)
    f[19:28] = (np.float32(1.0 / resolution), np.float32(1.0 / slices), extinction, lao_weight,
                shadows_weight, light_radius, light_coef, H_GRAD, SHADOW_BIAS)
    raw = not isinstance(density, interp.PackedVolume)
    # a raw table of n texels along an axis is given as n + 1, as in K15
    dims = tuple(d + 1 for d in density.shape) if raw else density.dims
    tf_raw = tf_table.shape[-1] == 4
    i = np.array([resolution, slices + 1, int(raw),
                  int(not raw and density.table.dtype == torch.uint8), *dims,
                  int(volume_filter == "quasicubic"), int(volume_filter == "nearest"),
                  int(tf_raw), tf_table.shape[0] + tf_raw, tf_table.shape[1] + tf_raw, n_cone,
                  int(exact)], np.int32)
    assert i.shape == (_I_COUNT,)
    return f, i


def lao_pass(inv_mvp, density, tf_table, light_position, extinction, lao_weight,
             shadows_weight, light_radius, light_coef, *, lao_step: float, slices: int,
             resolution: int, num_lao_samples: int = 1, num_shadow_samples: int = 10,
             lao_enabled: bool = True, shadows_enabled: bool = True,
             volume_filter: str = "linear", cone, exact: bool):
    """One LAO frame (R, R, 3), ``lao_frame``: one launch of K25
    ``lao_frame_kernel<lao_enabled, shadows_enabled, MODE>`` on a CUDA
    device, MODE the tables' ``kernel_mode``.
    ``cone``: ``cone_table(lao_step)`` on the tables' device; ``exact``:
    ``early_stop_exact`` of these inputs (the renderer computes both once).
    The rays stop early where ``exact`` holds and, with the cone on,
    ``cone_clear`` for this camera; the plain version stops where K25
    would."""
    vol = RK._volume_tensor(density)
    exact = bool(exact) and (not lao_enabled or cone_clear(inv_mvp, light_position,
                                                           light_radius, lao_step, slices))
    if K._route(vol, tf_table) == "cpu":
        return lao_frame(inv_mvp, density, tf_table, light_position, extinction, lao_weight,
                         shadows_weight, light_radius, light_coef, lao_step=lao_step,
                         slices=slices, resolution=resolution, num_lao_samples=num_lao_samples,
                         num_shadow_samples=num_shadow_samples, lao_enabled=lao_enabled,
                         shadows_enabled=shadows_enabled, volume_filter=volume_filter,
                         stop=exact)
    RK._check_tables(density, tf_table, volume_filter)
    if kernel_mode(density, tf_table, volume_filter) is None:
        raise ValueError(f"K25 is built for a packed volume beside the packed TF or a raw grid "
                         f"under the nearest filter beside the raw TF, not a "
                         f"{type(density).__name__} under {volume_filter!r} beside a TF of "
                         f"{tf_table.shape[-1]} channels")
    rows = density.dims[1] * density.dims[2] if isinstance(density, interp.PackedVolume) \
        else density.shape[1] * density.shape[2]
    if rows >= 2**31 - 1:
        raise ValueError(f"a volume plane of {rows} rows: K25 addresses a plane in 32 bits")
    K._check(cone, "cone", torch.float32, (n_lao_steps(lao_step), 2), align=8)
    if cone.device != vol.device:
        raise ValueError(f"tensors lie on different devices: {vol.device}, {cone.device}")
    f, i = _params(inv_mvp, density, tf_table, light_position, extinction, lao_weight,
                   shadows_weight, light_radius, light_coef, slices, resolution, cone.shape[0],
                   exact, volume_filter)
    out = torch.empty((resolution, resolution, 3), dtype=torch.float32, device=vol.device)
    lib = _build.load()
    if (lib.vpt_lao_layout(0), lib.vpt_lao_layout(1)) != (_F_COUNT, _I_COUNT):
        raise RuntimeError("lao kernel library parameter layout does not match the wrapper")
    with torch.cuda.device(vol.device):
        err = lib.vpt_lao_frame(f.ctypes.data, i.ctypes.data, int(bool(lao_enabled)),
                                int(bool(shadows_enabled)), vol.data_ptr(), tf_table.data_ptr(),
                                cone.data_ptr(), out.data_ptr(), K._stream(vol.device))
    K._raise_on(err, "lao_frame")
    LAUNCHES["lao_frame"] += 1
    return out
