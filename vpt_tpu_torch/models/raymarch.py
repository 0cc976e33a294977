"""Deterministic ray-march renderer family: EAM, MIP, ISO, Depth.

Counterpart of ``vpt_tpu/models/raymarch.py``:
  - EAM  : front-to-back emission-absorption compositing, running average
  - MIP  : maximum-intensity projection over an offset-wrapped march
  - ISO  : closest iso-surface hit, Lambert shading from a central
           difference of the TF alpha
  - Depth: the first crossing of an opacity-accumulation threshold

Each renderer's ``render`` is one pass of a hand-written kernel
(``kernels/raymarch.py``: K15 for EAM and Depth, K16 for MIP, K17 then
K18 for ISO) that merges the frame into the state in place; on CPU tensors
the plain PyTorch versions run. States are dicts of tensors with the JAX
renderers' keys (checkpoints store them in sorted key order, as
``jax.tree.flatten`` does). ``camera_rays``, ``ray_bounds``, ``_mix3`` and
``sample_tf`` are the shared helpers the JAX module exports, defined
beside the plain versions that use them. ``eam_frame`` is the plain frame
and ``eam_frame_diff`` the frame that ``optim.fit_density`` differentiates
(K15 forward and K19 backward on a CUDA device), exported here as the JAX
optimizer imports ``eam_frame`` from this module.
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.kernels import raymarch as K
from vpt_tpu_torch.kernels.raymarch import (_mix3, camera_rays, eam_frame,  # noqa: F401
                                             eam_frame_diff, ray_bounds, sample_tf)
from vpt_tpu_torch.models.base import register_renderer
from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.scene import transform as T
from vpt_tpu_torch.scene.tf import TransferFunction2D
from vpt_tpu_torch.utils.config import EAMConfig


def _seed_to_offset(seed: int) -> float:
    """Deterministic per-frame march offset in [0, 1): a Weyl/Knuth
    multiplicative hash of the seed, in Python integers."""
    return (int(seed) * 2654435761 % 2**32) / 2**32


def _pack_if_linear(volume, tf2d, device):
    """The device tables (density, tf_table): for the linear and quasicubic
    filters a ``pack_volume_auto`` "full" table (u8 for a u8-quantized
    source) and the (257, 257, 16) TF corner table; for nearest the raw
    (D, H, W) f32 grid and the raw (256, 256, 4) TF."""
    tf_table = np.asarray(tf2d.rasterize(), np.float32)
    if volume.filter in ("linear", "quasicubic"):
        return (interp.pack_volume_auto(volume.density, device, "full"),
                torch.as_tensor(interp.pack_tex2d_corners(tf_table), device=device))
    return (torch.as_tensor(np.asarray(volume.density, np.float32), device=device),
            torch.as_tensor(tf_table, device=device))


class _RayMarchRenderer:
    """Tables on ``device`` (given explicitly) and the volume's filter."""

    def __init__(self, volume, tf2d, resolution: int, device):
        if volume.filter not in ("linear", "quasicubic", "nearest"):
            raise ValueError(f"unknown volume filter {volume.filter!r}")
        self.volume = volume
        self.tf2d = tf2d or TransferFunction2D.grayscale_ramp()
        self.resolution = int(resolution)
        self.device = torch.device(device)
        self._density, self._tf_table = _pack_if_linear(volume, self.tf2d, self.device)

    def _image(self, fill, *extra):
        return torch.full((self.resolution, self.resolution, *extra), fill, dtype=torch.float32,
                          device=self.device)


@register_renderer("eam")
class EAMRenderer(_RayMarchRenderer):
    """Progressive EAM: a stochastic offset per frame and a running average."""

    def __init__(self, volume, tf2d=None, config: EAMConfig | None = None,
                 resolution: int = 512, *, device):
        super().__init__(volume, tf2d, resolution, device)
        self.config = config or EAMConfig()

    def reset(self, camera, seed: int = 0):
        return dict(acc=self._image(0.0, 3),
                    frame=torch.zeros((), dtype=torch.int32, device=self.device))

    def render(self, state, camera, seed: int):
        offset = _seed_to_offset(seed) if self.config.random_offset else 0.0
        state["frame"].add_(1)
        K.eam_pass(state["acc"], state["frame"], camera.inverse_mvp(), self._density,
                   self._tf_table, self.config.extinction, offset, self.config.slices,
                   self.volume.filter)
        return state, state["acc"]


@register_renderer("mip")
class MIPRenderer(_RayMarchRenderer):
    def __init__(self, volume, tf2d=None, steps: int = 64, resolution: int = 512, *, device):
        super().__init__(volume, tf2d, resolution, device)
        self.steps = steps

    def reset(self, camera, seed: int = 0):
        return dict(acc=self._image(0.0))

    def render(self, state, camera, seed: int):
        acc = K.mip_pass(state["acc"], camera.inverse_mvp(), self._density, self._tf_table,
                         _seed_to_offset(seed), self.steps, self.volume.filter)
        return state, acc[..., None].repeat(1, 1, 3)


@register_renderer("iso")
class ISORenderer(_RayMarchRenderer):
    def __init__(self, volume, tf2d=None, steps: int = 50, isovalue: float = 0.5,
                 light=(2.0, -3.0, -5.0), resolution: int = 512, *, device):
        super().__init__(volume, tf2d, resolution, device)
        self.steps = steps
        self.isovalue = isovalue
        self.light = np.asarray(light, np.float64)

    def reset(self, camera, seed: int = 0):
        return {k: self._image(-1.0) for k in ("cx", "cy", "cz", "ct")}

    def _light_model_space(self, camera):
        """The view-space light through inv(V @ M) with w = 1, then
        normalized: the reference's point-transform quirk, in float64."""
        m = camera.view_matrix @ T.translate([-0.5, -0.5, -0.5])
        v = np.linalg.inv(m) @ np.array([*self.light, 1.0])
        v = v[:3] / v[3]
        return (v / np.linalg.norm(v)).astype(np.float32)

    def render(self, state, camera, seed: int):
        closest = tuple(state[k] for k in ("cx", "cy", "cz", "ct"))
        K.iso_pass(closest, camera.inverse_mvp(), self._density, self._tf_table, self.isovalue,
                   _seed_to_offset(seed), self.steps, self.volume.filter)
        img = K.shade_pass(closest, self._density, self._tf_table,
                           self._light_model_space(camera), 0.005, self.volume.filter)
        return state, img


@register_renderer("depth")
class DepthRenderer(_RayMarchRenderer):
    def __init__(self, volume, tf2d=None, extinction: float = 100.0, slices: int = 64,
                 threshold: float = 0.1, random_offset: bool = False, resolution: int = 512,
                 *, device):
        super().__init__(volume, tf2d, resolution, device)
        self.extinction = extinction
        self.slices = slices
        self.threshold = threshold
        self.random_offset = random_offset

    def reset(self, camera, seed: int = 0):
        return dict(frame=torch.zeros((), dtype=torch.int32, device=self.device))

    def render(self, state, camera, seed: int):
        offset = _seed_to_offset(seed) if self.random_offset else 0.0
        img = K.depth_pass(camera.inverse_mvp(), self._density, self._tf_table, self.extinction,
                           self.threshold, offset, self.slices, self.resolution,
                           self.volume.filter)
        return state, img
