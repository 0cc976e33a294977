"""The ray-march renderer kernels: wrappers, plain versions, launch counts.

Four kernels of ``vpt_tpu_torch/csrc/raymarch.cu``, each a pass of one
renderer of ``models/raymarch.py`` that updates the renderer's state in
place (the JAX functions return new arrays):

- ``eam_pass`` (K15 ``march_kernel<EAM>``): one EAM frame merged into the
  running average ``acc`` (replaces ``vpt_tpu/models/raymarch.py::
  eam_frame`` and ``EAMRenderer.render``'s merge); plain version
  ``eam_pass_plain`` (``eam_frame`` + ``eam_merge``).
- ``depth_pass`` (K15 ``march_kernel<DEPTH>``): the depth display image
  (replaces ``depth_frame`` and ``DepthRenderer.render``'s display); plain
  version ``depth_pass_plain`` (``depth_frame`` + ``depth_display``).
- ``mip_pass`` (K16 ``mip_kernel``): one MIP frame max-merged into ``acc``
  (replaces ``mip_frame`` and the max merge); plain ``mip_pass_plain``.
- ``iso_pass`` (K17 ``iso_kernel``): one ISO frame's closest hit merged into
  the state's (cx, cy, cz, ct) (replaces ``iso_frame`` and
  ``ISORenderer.render``'s merge); plain ``iso_pass_plain``.
- ``shade_pass`` (K18 ``iso_shade_kernel``): the ISO image from the merged
  hit (replaces ``iso_shade``); plain ``iso_shade``.
- ``eam_frame_pass`` (K15 ``march_kernel<EAM>`` given an output image): one
  EAM frame alone (``eam_frame``), the forward of the differentiable frame.
- ``eam_backward`` (K19 ``eam_backward_kernel<LEARN_TF>``): the reverse of
  ``eam_frame`` under ``jax.grad`` (through ``vpt_tpu/optim.py::eam_loss``):
  a cotangent of the frame into the gradients of the raw density grid and,
  with ``learn_tf``, of the raw TF; plain version ``eam_backward_plain``
  (torch autograd through the plain ``eam_frame``).

``eam_frame_diff`` (``EAMFrame``, a ``torch.autograd.Function``) is
``eam_frame`` made differentiable in the density and the TF: on a CUDA
device one K15 launch forward and one K19 launch backward, never autograd
of the plain version; on the CPU the plain ``eam_frame``, whose samplers are
differentiable gathers, under torch autograd. It takes the raw (D, H, W)
f32 grid and the raw (H, W, 4) TF (what ``optim.fit_density`` learns) and
raises on a packed table; K19 keeps at most ``EAM_BACKWARD_MAX_TRIPS``
samples a ray (slices + 1) and sums at most ``EAM_BACKWARD_MAX_TF_W`` TF
columns in shared memory, and the wrapper raises beyond either.

The frame functions keep the JAX names and signatures (``eam_frame``,
``mip_frame``, ``iso_frame``, ``iso_shade``, ``depth_frame``, with the
device of their tables) and the masked fixed-trip scans of the JAX code;
``camera_rays``, ``ray_bounds``, ``_mix3`` and ``sample_tf`` are their
building blocks, which ``models/raymarch.py`` exports as the JAX module
does. Per-step scalars (t, the MIP offset) are float32 numpy values, as
the JAX scan computes them.

A volume is a ``PackedVolume`` of kind "full" (u8 or f32; linear or
quasicubic filter) or a raw (D, H, W) f32 grid (also nearest); a TF is the
packed (257, 257, 16) corner table or the raw (256, 256, 4) texture. K15
and K16 run an instance per table pair (``march_mode``, ``MARCH_MODES``:
csrc/raymarch.cu MarchMode, written into the parameter block's last
integer): the pairs the renderers and ``optim.fit_density`` build each have
their own, every other pair the checks take runs the "generic" instance.

Each wrapper runs its plain version when its tensors lie on the CPU and
launches the kernel when they lie on a CUDA device; anything else raises.
``LAUNCHES`` counts kernel launches (never plain runs): K15 under its
mode (``march_eam``, ``march_depth``, and ``march_eam_frame`` for the frame
alone), K19 as ``eam_backward``.
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.kernels import mcm as KM
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.ops import geometry, interp

# must match RF_COUNT / RI_COUNT in csrc/raymarch.cu
_F_COUNT = 26
_I_COUNT = 13
_EAM, _DEPTH = 0, 1
_FILTERS = ("linear", "quasicubic", "nearest")
# K15's and K16's instance for a table pair: K20's (csrc/raymarch.cu
# MarchMode lists them in McmMode's order; the pairs the renderers and
# optim.fit_density build have their own, every other pair "generic")
MARCH_MODES = KM.STEP_MODES
march_mode = KM.step_mode
# K19's limits: EAM_BWD_MAX_TRIPS and EAM_BWD_MAX_TF_W in csrc/raymarch.cu
EAM_BACKWARD_MAX_TRIPS = 256
EAM_BACKWARD_MAX_TF_W = 1536

LAUNCHES = {"march_eam": 0, "march_eam_frame": 0, "march_depth": 0, "mip": 0, "iso": 0,
            "iso_shade": 0, "eam_backward": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def camera_rays(resolution: int, inv_mvp, device):
    """Per-pixel unjittered rays: the NDC near- and far-plane points of each
    pixel centre through ``inv_mvp``, ((fx, fy, fz), (tx, ty, tz))."""
    inv_res = float(np.float32(1.0 / resolution))
    i = torch.arange(resolution, dtype=torch.float32, device=device)
    ix = i.view(1, -1).expand(resolution, resolution)
    iy = i.view(-1, 1).expand(resolution, resolution)
    sx = ((ix + 0.5) * inv_res - 0.5) * 2.0
    sy = ((iy + 0.5) * inv_res - 0.5) * -2.0
    inv_mvp = np.asarray(inv_mvp, np.float32)
    return (geometry.apply_homogeneous(inv_mvp, sx, sy, -1.0),
            geometry.apply_homogeneous(inv_mvp, sx, sy, 1.0))


def ray_bounds(frm, to):
    """The ray's cube interval clamped at 0: (tnear, tfar, miss)."""
    tn, tf = geometry.intersect_cube(frm[0], frm[1], frm[2],
                                     to[0] - frm[0], to[1] - frm[1], to[2] - frm[2])
    zero = torch.zeros_like(tn)
    tn, tf = torch.maximum(tn, zero), torch.maximum(tf, zero)
    return tn, tf, tn >= tf


def _mix3(frm, to, t):
    return (frm[0] + (to[0] - frm[0]) * t,
            frm[1] + (to[1] - frm[1]) * t,
            frm[2] + (to[2] - frm[2]) * t)


def sample_tf(density, tf_table, px, py, pz, volume_filter: str = "linear"):
    """Volume density at the points, then the classic 2D TF's RGBA at
    (density, 0): a scalar volume's second channel reads 0."""
    d = interp.sample_volume(density, px, py, pz, volume_filter)
    return interp.sample_tex2d(tf_table, d, torch.zeros_like(d))


def _march_setup(inv_mvp, resolution, device, n):
    """The rays clamped to the cube, their entry and exit points, and the
    ray's length inside the cube over ``n`` (ray_step_len)."""
    frm, to = camera_rays(resolution, inv_mvp, device)
    tn, tf, miss = ray_bounds(frm, to)
    entry, exit_ = _mix3(frm, to, tn), _mix3(frm, to, tf)
    ex, ey, ez = (exit_[i] - entry[i] for i in range(3))
    step = np.float32(1.0 / n)
    return tn, tf, miss, entry, exit_, torch.sqrt(ex * ex + ey * ey + ez * ez) * float(step), step


def eam_frame(inv_mvp, density, tf_table, extinction, offset, slices: int,
              resolution: int = 512, volume_filter: str = "linear"):
    """One front-to-back compositing pass; (R, R, 3) linear RGB."""
    _, _, miss, entry, exit_, rsl, step = _march_setup(inv_mvp, resolution, tf_table.device,
                                                       slices)
    ext = float(np.float32(extinction))
    z = torch.zeros((resolution, resolution), dtype=torch.float32, device=tf_table.device)
    r, g, b, a = z, z, z, z
    for k in range(slices + 1):
        t = float(step * np.float32(offset) + np.float32(k) * step)
        active = (t < 1.0) & (a < 0.99)
        c = sample_tf(density, tf_table, *_mix3(entry, exit_, t), volume_filter)
        w = torch.where(active, (1.0 - a) * (c[..., 3] * rsl * ext), 0.0)
        r, g, b, a = r + w * c[..., 0], g + w * c[..., 1], b + w * c[..., 2], a + w
    # over-saturation renormalization
    scale = torch.where(a > 1.0, torch.reciprocal(torch.clamp_min(a, 1.0)), 1.0)
    rgb = torch.stack([r * scale, g * scale, b * scale], dim=-1)
    return torch.where(miss[..., None], 0.0, rgb)


def eam_merge(acc, frame, img):
    """The running average in place: acc += (img - acc) / frame, ``frame``
    the advanced count (a 0-d int32 tensor)."""
    return acc.copy_(acc + (img - acc) * torch.reciprocal(frame.to(torch.float32)))


def depth_frame(inv_mvp, density, tf_table, extinction, threshold, offset, slices: int,
                resolution: int, volume_filter: str = "linear"):
    """March until the accumulated opacity crosses ``threshold``; (R, R),
    the t of the crossing in [tnear, tfar] or -1."""
    tn, tf, miss, entry, exit_, rsl, step = _march_setup(inv_mvp, resolution,
                                                         tf_table.device, slices)
    ext, thr = float(np.float32(extinction)), float(np.float32(threshold))
    acc = torch.zeros((resolution, resolution), dtype=torch.float32, device=tf_table.device)
    t_stop = torch.full_like(acc, -1.0)
    for k in range(slices + 1):
        t = step * np.float32(offset) + np.float32(k) * step
        active = (float(t) < 1.0) & (acc < thr)
        c = sample_tf(density, tf_table, *_mix3(entry, exit_, float(t)), volume_filter)
        acc2 = acc + torch.where(active, (1.0 - acc) * c[..., 3] * rsl * ext, 0.0)
        t_stop = torch.where(active & (acc2 >= thr), float(t + step), t_stop)
        acc = acc2
    depth = torch.where(acc >= thr, tn + (tf - tn) * t_stop, -1.0)
    return torch.where(miss, -1.0, depth)


def depth_display(depth):
    """Normalized depth as grey, misses white; (R, R, 3)."""
    vis = torch.where(depth < 0, 1.0, torch.clamp(depth, 0.0, 1.0))
    return vis[..., None].repeat(1, 1, 3)


def mip_frame(inv_mvp, density, tf_table, offset, steps: int, resolution: int,
              volume_filter: str = "linear"):
    """One maximum-intensity pass over the offset-wrapped march; (R, R)."""
    _, _, miss, entry, exit_, _, step = _march_setup(inv_mvp, resolution, tf_table.device,
                                                     steps)
    val = torch.zeros((resolution, resolution), dtype=torch.float32, device=tf_table.device)
    for k in range(steps):
        o = float(np.remainder(np.float32(offset) + np.float32(k) * step, np.float32(1.0)))
        c = sample_tf(density, tf_table, *_mix3(entry, exit_, o), volume_filter)
        val = torch.maximum(val, c[..., 3])
    return torch.where(miss, 0.0, val)


def iso_frame(inv_mvp, density, tf_table, isovalue, offset, steps: int, resolution: int,
              volume_filter: str = "linear"):
    """Closest-hit search scanning far -> near; (cx, cy, cz, ct), ct = -1
    where nothing was hit."""
    _, _, miss, entry, exit_, _, step = _march_setup(inv_mvp, resolution, tf_table.device,
                                                     steps)
    iso = float(np.float32(isovalue))
    neg = torch.full((resolution, resolution), -1.0, dtype=torch.float32,
                     device=tf_table.device)
    cx, cy, cz, ct = neg, neg, neg, neg
    t_far = np.float32(1.0) - np.float32(offset) * step
    for k in range(steps):
        t = float(t_far - np.float32(k) * step)
        pos = _mix3(entry, exit_, t)
        c = sample_tf(density, tf_table, *pos, volume_filter)
        hit = (c[..., 3] >= iso) & (t >= 0.0)
        cx, cy, cz = (torch.where(hit, p, q) for p, q in zip(pos, (cx, cy, cz)))
        ct = torch.where(hit, t, ct)
    return cx, cy, cz, torch.where(miss, -1.0, ct)


def iso_merge(closest, new):
    """The closest merge in place: keep the smaller positive t."""
    ct0, ct = closest[3], new[3]
    both = (ct > 0) & (ct0 > 0)
    take = (both & (ct < ct0)) | (~both & (ct > 0))
    for old, n in zip(closest, new):
        old.copy_(torch.where(take, n, old))
    return closest


def iso_shade(closest, density, tf_table, light_model, gradient_step,
              volume_filter: str = "linear"):
    """Lambert shading at the merged closest hit from a central difference
    of the TF alpha, white where nothing was hit; (R, R, 3)."""
    cx, cy, cz, ct = closest
    h = float(np.float32(gradient_step))
    lx, ly, lz = (float(v) for v in np.asarray(light_model, np.float32))

    def alpha_at(px, py, pz):
        return sample_tf(density, tf_table, px, py, pz, volume_filter)[..., 3]

    gx = alpha_at(cx + h, cy, cz) - alpha_at(cx - h, cy, cz)
    gy = alpha_at(cx, cy + h, cz) - alpha_at(cx, cy - h, cz)
    gz = alpha_at(cx, cy, cz + h) - alpha_at(cx, cy, cz - h)
    norm = torch.sqrt(gx * gx + gy * gy + gz * gz)
    inv = torch.reciprocal(torch.clamp_min(norm, 1e-20))
    lambert = torch.clamp_min((gx * lx + gy * ly + gz * lz) * inv, 0.0)
    material = sample_tf(density, tf_table, cx, cy, cz, volume_filter)[..., :3]
    return torch.where((ct > 0.0)[..., None], material * lambert[..., None], 1.0)


def eam_pass_plain(acc, frame, inv_mvp, density, tf_table, extinction, offset, slices: int,
                   volume_filter: str = "linear"):
    """Plain ``eam_pass``."""
    img = eam_frame(inv_mvp, density, tf_table, extinction, offset, slices, acc.shape[0],
                    volume_filter)
    return eam_merge(acc, frame, img)


def eam_backward_plain(g_img, inv_mvp, density, tf_table, extinction, offset, slices: int,
                       volume_filter: str = "linear", learn_tf: bool = False):
    """Plain ``eam_backward``: torch autograd through the plain ``eam_frame``."""
    d = density.detach().requires_grad_(True)
    t = tf_table.detach().requires_grad_(learn_tf)
    with torch.enable_grad():
        img = eam_frame(inv_mvp, d, t, extinction, offset, slices, g_img.shape[0], volume_filter)
        grads = torch.autograd.grad(img, [d, t] if learn_tf else [d], g_img)
    return grads[0], (grads[1] if learn_tf else None)


def depth_pass_plain(inv_mvp, density, tf_table, extinction, threshold, offset, slices: int,
                     resolution: int, volume_filter: str = "linear"):
    """Plain ``depth_pass``."""
    return depth_display(depth_frame(inv_mvp, density, tf_table, extinction, threshold, offset,
                                     slices, resolution, volume_filter))


def mip_pass_plain(acc, inv_mvp, density, tf_table, offset, steps: int,
                   volume_filter: str = "linear"):
    """Plain ``mip_pass``."""
    val = mip_frame(inv_mvp, density, tf_table, offset, steps, acc.shape[0], volume_filter)
    return acc.copy_(torch.maximum(acc, val))


def iso_pass_plain(closest, inv_mvp, density, tf_table, isovalue, offset, steps: int,
                   volume_filter: str = "linear"):
    """Plain ``iso_pass``."""
    new = iso_frame(inv_mvp, density, tf_table, isovalue, offset, steps, closest[0].shape[0],
                    volume_filter)
    return iso_merge(closest, new)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def _check_tables(density, tf_table, volume_filter):
    if volume_filter not in _FILTERS:
        raise ValueError(f"unknown volume filter {volume_filter!r}")
    if isinstance(density, interp.PackedVolume):
        if density.kind != "full":
            raise ValueError(f"the ray marches read a full packed table, not {density.kind!r}")
        if volume_filter == "nearest":
            raise ValueError("the nearest filter needs a raw grid")
        K._check(density.table, "density table", density.table.dtype,
                 (int(np.prod(density.dims)), 8), align=16)
    else:
        if density.ndim != 3:
            raise ValueError(f"a raw density must be a (D, H, W) grid, got {tuple(density.shape)}")
        K._check(density, "density grid", torch.float32)
    if tf_table.ndim != 3 or tf_table.shape[-1] not in (4, 16):
        raise ValueError(f"tf_table must be a packed (Hp, Wp, 16) or raw (H, W, 4) table, got "
                         f"{tuple(tf_table.shape)}")
    K._check(tf_table, "tf_table", torch.float32, align=16)


def _params(inv_mvp, density, tf_table, volume_filter, resolution, trips, step, offset,
            extinction=0.0, threshold=0.0, isovalue=0.0, light=(0.0, 0.0, 0.0), h=0.0):
    f = np.zeros(_F_COUNT, np.float32)
    f[0:16] = np.asarray(inv_mvp, np.float32).reshape(16)
    f[16:26] = (np.float32(1.0 / resolution), step, offset, extinction, threshold, isovalue,
                *light, h)
    raw = not isinstance(density, interp.PackedVolume)
    # a raw table of n texels along an axis is given as n + 1 (csrc/raymarch.cu)
    dims = tuple(d + 1 for d in density.shape) if raw else density.dims
    tf_raw = tf_table.shape[-1] == 4
    i = np.array([resolution, trips, int(raw),
                  int(not raw and density.table.dtype == torch.uint8), *dims,
                  int(volume_filter == "quasicubic"), int(volume_filter == "nearest"),
                  int(tf_raw), tf_table.shape[0] + tf_raw, tf_table.shape[1] + tf_raw,
                  MARCH_MODES.index(march_mode(density, tf_table, volume_filter))], np.int32)
    assert i.shape == (_I_COUNT,)
    return f, i


def _lib():
    lib = _build.load()
    if (tuple(lib.vpt_march_layout(k) for k in range(4))
            != (_F_COUNT, _I_COUNT, EAM_BACKWARD_MAX_TRIPS, EAM_BACKWARD_MAX_TF_W)):
        raise RuntimeError("ray-march kernel library parameter layout does not match the wrapper")
    return lib


def _volume_tensor(density):
    return density.table if isinstance(density, interp.PackedVolume) else density


def _check_image(t, name, resolution, channels=None):
    shape = (resolution, resolution) + ((channels,) if channels else ())
    K._check(t, name, torch.float32, shape)


def eam_pass(acc, frame, inv_mvp, density, tf_table, extinction, offset, slices: int,
             volume_filter: str = "linear"):
    """One EAM frame merged into the running average ``acc`` (R, R, 3) in
    place; ``frame``: 0-d int32 tensor, the count after this frame. One
    launch of K15 ``march_kernel<EAM>`` on a CUDA device."""
    vol = _volume_tensor(density)
    if K._route(acc, frame, vol, tf_table) == "cpu":
        return eam_pass_plain(acc, frame, inv_mvp, density, tf_table, extinction, offset,
                              slices, volume_filter)
    _check_tables(density, tf_table, volume_filter)
    res = acc.shape[0]
    _check_image(acc, "acc", res, 3)
    K._check(frame, "frame", torch.int32, ())
    f, i = _params(inv_mvp, density, tf_table, volume_filter, res, slices + 1,
                   np.float32(1.0 / slices), np.float32(offset), extinction=np.float32(extinction))
    lib = _lib()
    with torch.cuda.device(acc.device):
        err = lib.vpt_march(f.ctypes.data, i.ctypes.data, _EAM, vol.data_ptr(),
                            tf_table.data_ptr(), acc.data_ptr(), frame.data_ptr(), None,
                            K._stream(acc.device))
    K._raise_on(err, "march<EAM>")
    LAUNCHES["march_eam"] += 1
    return acc


def eam_frame_pass(inv_mvp, density, tf_table, extinction, offset, slices: int,
                   resolution: int = 512, volume_filter: str = "linear"):
    """One EAM frame (R, R, 3), ``eam_frame``; one launch of K15
    ``march_kernel<EAM>`` into a new image on a CUDA device."""
    vol = _volume_tensor(density)
    if K._route(vol, tf_table) == "cpu":
        return eam_frame(inv_mvp, density, tf_table, extinction, offset, slices, resolution,
                         volume_filter)
    _check_tables(density, tf_table, volume_filter)
    f, i = _params(inv_mvp, density, tf_table, volume_filter, resolution, slices + 1,
                   np.float32(1.0 / slices), np.float32(offset), extinction=np.float32(extinction))
    out = torch.empty((resolution, resolution, 3), dtype=torch.float32, device=vol.device)
    lib = _lib()
    with torch.cuda.device(vol.device):
        err = lib.vpt_march(f.ctypes.data, i.ctypes.data, _EAM, vol.data_ptr(),
                            tf_table.data_ptr(), None, None, out.data_ptr(),
                            K._stream(vol.device))
    K._raise_on(err, "march<EAM> (frame)")
    LAUNCHES["march_eam_frame"] += 1
    return out


def _check_raw_tables(density, tf_table, slices: int):
    """What K19 takes: a raw (D, H, W) grid, a raw (H, W, 4) TF, at most
    EAM_BACKWARD_MAX_TRIPS samples a ray and EAM_BACKWARD_MAX_TF_W TF
    columns."""
    if isinstance(density, interp.PackedVolume) or tf_table.ndim != 3 or tf_table.shape[-1] != 4:
        raise ValueError("the EAM backward (K19) takes a raw (D, H, W) density grid and a raw "
                         "(H, W, 4) TF, not packed tables")
    if slices + 1 > EAM_BACKWARD_MAX_TRIPS:
        raise ValueError(f"the EAM backward (K19) keeps at most {EAM_BACKWARD_MAX_TRIPS} samples "
                         f"a ray: slices <= {EAM_BACKWARD_MAX_TRIPS - 1}, got {slices}")
    if tf_table.shape[1] > EAM_BACKWARD_MAX_TF_W:
        raise ValueError(f"the EAM backward (K19) sums at most {EAM_BACKWARD_MAX_TF_W} TF columns, "
                         f"got {tf_table.shape[1]}")


def eam_backward(g_img, inv_mvp, density, tf_table, extinction, offset, slices: int,
                 volume_filter: str = "linear", learn_tf: bool = False):
    """The gradients of ``<g_img, eam_frame(...)>`` with respect to the raw
    density grid and, with ``learn_tf``, the raw TF (else None): the
    cotangent ``g_img`` (R, R, 3) of one EAM frame carried back as
    ``jax.grad`` carries it. One launch of K19 ``eam_backward_kernel`` on a
    CUDA device (the gradients summed by atomics, so in no fixed order)."""
    _check_raw_tables(density, tf_table, slices)
    if K._route(g_img, density, tf_table) == "cpu":
        return eam_backward_plain(g_img, inv_mvp, density, tf_table, extinction, offset, slices,
                                  volume_filter, learn_tf)
    _check_tables(density, tf_table, volume_filter)
    res = g_img.shape[0]
    _check_image(g_img, "g_img", res, 3)
    f, i = _params(inv_mvp, density, tf_table, volume_filter, res, slices + 1,
                   np.float32(1.0 / slices), np.float32(offset), extinction=np.float32(extinction))
    g_density = torch.zeros_like(density)
    # the TF's row 0, the only row a classic lookup reads, summed in double
    g_row = (torch.zeros((tf_table.shape[1], 4), dtype=torch.float64, device=g_img.device)
             if learn_tf else None)
    lib = _lib()
    with torch.cuda.device(g_img.device):
        err = lib.vpt_eam_backward(f.ctypes.data, i.ctypes.data, density.data_ptr(),
                                   tf_table.data_ptr(), g_img.data_ptr(), g_density.data_ptr(),
                                   None if g_row is None else g_row.data_ptr(),
                                   K._stream(g_img.device))
    K._raise_on(err, "eam_backward")
    LAUNCHES["eam_backward"] += 1
    if not learn_tf:
        return g_density, None
    g_tf = torch.zeros_like(tf_table)
    g_tf[0] = g_row
    return g_density, g_tf


class EAMFrame(torch.autograd.Function):
    """``eam_frame`` on a CUDA device with its reverse: K15 forward, K19
    backward."""

    @staticmethod
    def forward(ctx, density, tf_table, inv_mvp, extinction, offset, slices, resolution,
                volume_filter):
        ctx.save_for_backward(density, tf_table)
        ctx.args = (inv_mvp, extinction, offset, slices, volume_filter)
        return eam_frame_pass(inv_mvp, density, tf_table, extinction, offset, slices, resolution,
                              volume_filter)

    @staticmethod
    def backward(ctx, g_img):
        density, tf_table = ctx.saved_tensors
        inv_mvp, extinction, offset, slices, volume_filter = ctx.args
        g_density, g_tf = eam_backward(g_img.contiguous(), inv_mvp, density, tf_table, extinction,
                                       offset, slices, volume_filter,
                                       learn_tf=ctx.needs_input_grad[1])
        return (g_density if ctx.needs_input_grad[0] else None, g_tf,
                None, None, None, None, None, None)


def eam_frame_diff(inv_mvp, density, tf_table, extinction, offset, slices: int,
                   resolution: int = 512, volume_filter: str = "linear"):
    """``eam_frame``, differentiable in ``density`` (a raw (D, H, W) grid)
    and ``tf_table`` (a raw (H, W, 4) TF): ``EAMFrame`` on a CUDA device
    (K15 forward, K19 backward), the plain ``eam_frame`` under torch
    autograd on the CPU."""
    _check_raw_tables(density, tf_table, slices)
    if K._route(density, tf_table) == "cpu":
        return eam_frame(inv_mvp, density, tf_table, extinction, offset, slices, resolution,
                         volume_filter)
    return EAMFrame.apply(density, tf_table, inv_mvp, extinction, offset, slices, resolution,
                          volume_filter)


def depth_pass(inv_mvp, density, tf_table, extinction, threshold, offset, slices: int,
               resolution: int, volume_filter: str = "linear"):
    """The depth display image (R, R, 3): the t where the accumulated
    opacity crosses ``threshold``, clipped to [0, 1], white on a miss. One
    launch of K15 ``march_kernel<DEPTH>`` on a CUDA device."""
    vol = _volume_tensor(density)
    if K._route(vol, tf_table) == "cpu":
        return depth_pass_plain(inv_mvp, density, tf_table, extinction, threshold, offset,
                                slices, resolution, volume_filter)
    _check_tables(density, tf_table, volume_filter)
    f, i = _params(inv_mvp, density, tf_table, volume_filter, resolution, slices + 1,
                   np.float32(1.0 / slices), np.float32(offset), extinction=np.float32(extinction),
                   threshold=np.float32(threshold))
    out = torch.empty((resolution, resolution, 3), dtype=torch.float32, device=vol.device)
    lib = _lib()
    with torch.cuda.device(vol.device):
        err = lib.vpt_march(f.ctypes.data, i.ctypes.data, _DEPTH, vol.data_ptr(),
                            tf_table.data_ptr(), None, None, out.data_ptr(),
                            K._stream(vol.device))
    K._raise_on(err, "march<DEPTH>")
    LAUNCHES["march_depth"] += 1
    return out


def mip_pass(acc, inv_mvp, density, tf_table, offset, steps: int,
             volume_filter: str = "linear"):
    """One MIP frame max-merged into ``acc`` (R, R) in place. One launch of
    K16 ``mip_kernel`` on a CUDA device."""
    vol = _volume_tensor(density)
    if K._route(acc, vol, tf_table) == "cpu":
        return mip_pass_plain(acc, inv_mvp, density, tf_table, offset, steps, volume_filter)
    _check_tables(density, tf_table, volume_filter)
    res = acc.shape[0]
    _check_image(acc, "acc", res)
    f, i = _params(inv_mvp, density, tf_table, volume_filter, res, steps, np.float32(1.0 / steps),
                   np.float32(offset))
    lib = _lib()
    with torch.cuda.device(acc.device):
        err = lib.vpt_mip(f.ctypes.data, i.ctypes.data, vol.data_ptr(), tf_table.data_ptr(),
                          acc.data_ptr(), K._stream(acc.device))
    K._raise_on(err, "mip")
    LAUNCHES["mip"] += 1
    return acc


def iso_pass(closest, inv_mvp, density, tf_table, isovalue, offset, steps: int,
             volume_filter: str = "linear"):
    """One ISO frame's closest hit merged into ``closest`` = (cx, cy, cz,
    ct), each (R, R), in place. One launch of K17 ``iso_kernel`` on a CUDA
    device."""
    vol = _volume_tensor(density)
    if K._route(*closest, vol, tf_table) == "cpu":
        return iso_pass_plain(closest, inv_mvp, density, tf_table, isovalue, offset, steps,
                              volume_filter)
    _check_tables(density, tf_table, volume_filter)
    res = closest[0].shape[0]
    for t, name in zip(closest, ("cx", "cy", "cz", "ct")):
        _check_image(t, name, res)
    f, i = _params(inv_mvp, density, tf_table, volume_filter, res, steps, np.float32(1.0 / steps),
                   np.float32(offset), isovalue=np.float32(isovalue))
    lib = _lib()
    with torch.cuda.device(vol.device):
        err = lib.vpt_iso(f.ctypes.data, i.ctypes.data, vol.data_ptr(), tf_table.data_ptr(),
                          *(t.data_ptr() for t in closest), K._stream(vol.device))
    K._raise_on(err, "iso")
    LAUNCHES["iso"] += 1
    return closest


def shade_pass(closest, density, tf_table, light_model, gradient_step,
               volume_filter: str = "linear"):
    """The ISO image (R, R, 3) from the merged closest hit; one launch of
    K18 ``iso_shade_kernel`` on a CUDA device."""
    vol = _volume_tensor(density)
    if K._route(*closest, vol, tf_table) == "cpu":
        return iso_shade(closest, density, tf_table, light_model, gradient_step, volume_filter)
    _check_tables(density, tf_table, volume_filter)
    res = closest[0].shape[0]
    for t, name in zip(closest, ("cx", "cy", "cz", "ct")):
        _check_image(t, name, res)
    f, i = _params(np.eye(4, dtype=np.float32), density, tf_table, volume_filter, res, 0,
                   np.float32(0.0), np.float32(0.0), light=np.asarray(light_model, np.float32),
                   h=np.float32(gradient_step))
    out = torch.empty((res, res, 3), dtype=torch.float32, device=vol.device)
    lib = _lib()
    with torch.cuda.device(vol.device):
        err = lib.vpt_iso_shade(f.ctypes.data, i.ctypes.data, vol.data_ptr(),
                                tf_table.data_ptr(), *(t.data_ptr() for t in closest),
                                out.data_ptr(), K._stream(vol.device))
    K._raise_on(err, "iso_shade")
    LAUNCHES["iso_shade"] += 1
    return out
