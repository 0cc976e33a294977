"""The directional-occlusion slice kernel: wrapper, plain version, launch counts.

One kernel of ``vpt_tpu_torch/csrc/dos.cu``:

- ``dos_pass`` (K24 ``dos_slice_kernel``): a render's run of slices of the
  DOS sweep, each slice one launch (replaces ``vpt_tpu/models/dos.py::
  dos_slice`` looped by ``DOSRenderer.render``), the last one also writing
  the display image; plain version ``dos_slice`` (one slice, with the JAX
  name and arguments) looped by ``dos_pass_plain``.

A slice composites the emission-absorption colour of the view-space plane
at one depth into the colour buffer (R, R, 4), lit by the occlusion buffer
(R, R), and advances the occlusion buffer by the mean of its own bilinear
samples at the disk offsets ``occl_samples`` scaled by the slice's
``occl_scale``, attenuated by the slice's transmittance. Pixels whose plane
point leaves the unit cube keep both. The slice's occlusion reads its
neighbours' occlusion from the previous slice, so on a CUDA device each
slice is one launch that reads one occlusion buffer and writes the other
(the wrapper's ``spare``); the colour is per pixel and is updated in place.

The host helpers are the port's copies of the JAX module's
(``generate_occlusion_samples``, ``depth_range``); the sweep's schedule
(``DOSRenderer.render``) stays on the host in float64, and each slice's
scalars (``depth_ndc``, ``occl_scale``) reach the kernel as the f32 rounding
of the double.

The wrapper runs the plain version when its tensors lie on the CPU and
launches the kernel when they lie on one CUDA device; anything else raises.
``LAUNCHES`` counts kernel launches (never plain runs): ``dos_slice`` one a
slice, ``dos_display`` one for a render past the sweep's end (no slice; the
display of the unchanged colour).
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.kernels import raymarch as RK
from vpt_tpu_torch.ops import geometry, interp
from vpt_tpu_torch.ops.sampling import div_scalar
from vpt_tpu_torch.scene import transform as T

# must match DF_COUNT / DI_COUNT in csrc/dos.cu
_F_COUNT = 18
_I_COUNT = 12

LAUNCHES = {"dos_slice": 0, "dos_display": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------
def generate_occlusion_samples(n: int, seed: int = 0) -> np.ndarray:
    """Mean-centred disk samples (n, 2) f32, deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n))
    phi = rng.uniform(size=n) * 2 * np.pi
    pts = np.stack([r * np.cos(phi), r * np.sin(phi)], axis=-1)
    return (pts - pts.mean(axis=0, keepdims=True)).astype(np.float32)


def depth_range(camera) -> tuple:
    """Min (at least 0) and max view-space depth of the unit cube's corners,
    in float64."""
    m = camera.view_matrix @ T.translate([-0.5, -0.5, -0.5])
    corners = np.array(
        [[x, y, z, 1.0] for x in (0, 1) for y in (0, 1) for z in (0, 1)]
    )
    depths = -(corners @ m.T)[:, 2]
    return max(float(depths.min()), 0.0), float(depths.max())


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def dos_slice(color, occlusion, inv_mvp, density, tf_table, occl_samples, depth_ndc,
              occl_scale, slice_distance, extinction, samples_count: int,
              volume_filter: str = "linear"):
    """Integrate one slice: the new (color (R, R, 4), occlusion (R, R))."""
    H, W = occlusion.shape
    dev = occlusion.device
    iy = torch.arange(H, dtype=torch.float32, device=dev).view(-1, 1).expand(H, W)
    ix = torch.arange(W, dtype=torch.float32, device=dev).view(1, -1).expand(H, W)
    # fullscreen-triangle interpolation: uv in [0, 1], NDC in [-1, 1]
    u2 = div_scalar(ix + 0.5, float(W))
    v2 = div_scalar(iy + 0.5, float(H))
    ndc_x = u2 * 2.0 - 1.0
    ndc_y = v2 * 2.0 - 1.0
    px, py, pz = geometry.apply_homogeneous(np.asarray(inv_mvp, np.float32), ndc_x, ndc_y,
                                            K._f32(depth_ndc))
    oob = (px > 1.0) | (px < 0.0) | (py > 1.0) | (py < 0.0) | (pz > 1.0) | (pz < 0.0)

    d = interp.sample_volume(density, px, py, pz, volume_filter)
    tf4 = interp.sample_tex2d(tf_table, d, torch.zeros_like(d))
    local_ext = tf4[..., 3] * K._f32(extinction)
    trans = torch.exp(-local_ext * K._f32(slice_distance))
    alpha = 1.0 - trans

    prev_a = color[..., 3]
    contrib = tf4[..., :3] * occlusion[..., None] * alpha[..., None]
    new_rgb = color[..., :3] + contrib * (1.0 - prev_a)[..., None]
    new_a = torch.clamp_max(prev_a + alpha, 1.0)
    new_color = torch.cat([new_rgb, new_a[..., None]], dim=-1)

    # occlusion advance: mean of bilinear self-samples at disk offsets
    samples = np.asarray(occl_samples.cpu() if torch.is_tensor(occl_samples) else occl_samples,
                         np.float32)
    sx, sy = np.float32(occl_scale[0]), np.float32(occl_scale[1])
    occ = torch.zeros((H, W), dtype=torch.float32, device=dev)
    tex = occlusion[..., None]
    for i in range(samples_count):
        su = u2 + float(samples[i, 0] * sx)
        sv = v2 + float(samples[i, 1] * sy)
        occ = occ + interp.sample_tex2d(tex, su, sv)[..., 0]
    new_occl = div_scalar(occ, float(samples_count)) * trans

    color = torch.where(oob[..., None], color, new_color)
    occlusion = torch.where(oob, occlusion, new_occl)
    return color, occlusion


def display(color):
    """The render pass: the colour blended over white by its alpha, (R, R, 3)."""
    a = color[..., 3:4]
    return torch.ones_like(color[..., :3]) * (1.0 - a) + color[..., :3] * a


def dos_pass_plain(color, occlusion, inv_mvp, density, tf_table, occl_samples, schedule,
                   slice_distance, extinction, volume_filter: str = "linear"):
    """Plain ``dos_pass``: ``dos_slice`` per row of ``schedule``; ``color``
    updated in place; returns (occlusion, display)."""
    c = color
    for depth_ndc, ox, oy in np.asarray(schedule, np.float32).reshape(-1, 3):
        c, occlusion = dos_slice(c, occlusion, inv_mvp, density, tf_table, occl_samples,
                                 depth_ndc, (ox, oy), slice_distance, extinction,
                                 len(occl_samples), volume_filter)
    if c is not color:
        color.copy_(c)
    return occlusion, display(color)


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------
def _params(inv_mvp, density, tf_table, n_samples, resolution, slice_distance, extinction,
            volume_filter):
    f = np.zeros(_F_COUNT, np.float32)
    f[0:16] = np.asarray(inv_mvp, np.float32).reshape(16)
    f[16:18] = (slice_distance, extinction)
    raw = not isinstance(density, interp.PackedVolume)
    # a raw table of n texels along an axis is given as n + 1, as in K15
    dims = tuple(d + 1 for d in density.shape) if raw else density.dims
    tf_raw = tf_table.shape[-1] == 4
    i = np.array([resolution, n_samples, int(raw),
                  int(not raw and density.table.dtype == torch.uint8), *dims,
                  int(volume_filter == "quasicubic"), int(volume_filter == "nearest"),
                  int(tf_raw), tf_table.shape[0] + tf_raw, tf_table.shape[1] + tf_raw], np.int32)
    assert i.shape == (_I_COUNT,)
    return f, i


def dos_pass(color, occlusion, spare, inv_mvp, density, tf_table, occl_samples, schedule,
             slice_distance, extinction, volume_filter: str = "linear"):
    """Advance the sweep by the slices of ``schedule`` ((n, 3) f32 rows:
    depth_ndc, occl_scale x, occl_scale y): ``color`` (R, R, 4) updated in
    place; returns (the occlusion after the last slice, the display image
    (R, R, 3)). On a CUDA device one K24 launch a slice, reading one of
    ``occlusion`` and ``spare`` (R, R) and writing the other, so the
    returned occlusion is one of the two; the last slice's launch writes
    the display too, and with no slice one display launch writes it."""
    schedule = np.ascontiguousarray(np.asarray(schedule, np.float32).reshape(-1, 3))
    vol = RK._volume_tensor(density)
    if K._route(color, occlusion, spare, vol, tf_table, occl_samples) == "cpu":
        return dos_pass_plain(color, occlusion, inv_mvp, density, tf_table, occl_samples,
                              schedule, slice_distance, extinction, volume_filter)
    RK._check_tables(density, tf_table, volume_filter)
    res = occlusion.shape[0]
    K._check(color, "color", torch.float32, (res, res, 4), align=16)
    K._check(occlusion, "occlusion", torch.float32, (res, res))
    K._check(spare, "spare", torch.float32, (res, res))
    if spare.data_ptr() == occlusion.data_ptr():
        raise ValueError("spare must be another buffer than occlusion")
    n_samples = occl_samples.shape[0]
    K._check(occl_samples, "occl_samples", torch.float32, (n_samples, 2), align=8)
    if n_samples < 1:
        raise ValueError("at least one occlusion sample")
    f, i = _params(inv_mvp, density, tf_table, n_samples, res, np.float32(slice_distance),
                   np.float32(extinction), volume_filter)
    out = torch.empty((res, res, 3), dtype=torch.float32, device=color.device)
    lib = _build.load()
    if (lib.vpt_dos_layout(0), lib.vpt_dos_layout(1)) != (_F_COUNT, _I_COUNT):
        raise RuntimeError("dos kernel library parameter layout does not match the wrapper")
    n = schedule.shape[0]
    with torch.cuda.device(color.device):
        err = lib.vpt_dos_sweep(f.ctypes.data, i.ctypes.data, n, schedule.ctypes.data,
                                vol.data_ptr(), tf_table.data_ptr(), occl_samples.data_ptr(),
                                color.data_ptr(), occlusion.data_ptr(), spare.data_ptr(),
                                out.data_ptr(), K._stream(color.device))
    K._raise_on(err, "dos_slice")
    LAUNCHES["dos_slice"] += n
    LAUNCHES["dos_display"] += int(n == 0)
    return (spare if n % 2 else occlusion), out
