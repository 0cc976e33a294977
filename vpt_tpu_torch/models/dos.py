"""Directional occlusion shading (DOS) renderer.

Counterpart of ``vpt_tpu/models/dos.py``: a front-to-back sweep of
view-space slices between the unit cube's nearest and farthest depth, each
compositing emission-absorption colour modulated by an occlusion buffer
that is advanced by cone-sampling itself at disk offsets scaled by the
slice distance and the aperture.

The state is JAX's: the colour (R, R, 4) and occlusion (R, R) buffers and
the sweep's position, three Python floats (``depth``, ``min_depth``,
``max_depth``; checkpoints keep them as host scalars). Each ``render``
advances ``steps`` slices; the schedule (the slice distance, the
``depth > max_depth`` test, each slice's NDC depth and occlusion scale,
``depth += slice_distance``) runs on the host in float64 exactly as the
reference runs it, so both packages sweep the same slices. On a CUDA device
the render's slices are one K24 launch each (``kernels/dos.py::dos_pass``),
enqueued by one call; on the CPU the plain ``dos_slice`` runs. The display
blends the colour over white by its alpha.
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.kernels import dos as K
from vpt_tpu_torch.kernels.dos import (depth_range, dos_slice,  # noqa: F401
                                       generate_occlusion_samples)
from vpt_tpu_torch.models.base import register_renderer
from vpt_tpu_torch.models.raymarch import _RayMarchRenderer


def slice_schedule(state, camera, steps: int, slices: int, aperture: float):
    """The host schedule of one render from ``state``: (rows (n, 3) f32 of
    depth_ndc and the occlusion scale per slice, the slice distance, the
    depth after the last slice), in float64 as the reference computes them."""
    proj = camera.projection_matrix
    slice_distance = (state["max_depth"] - state["min_depth"]) / slices
    depth = state["depth"]
    occl_extent = slice_distance * np.tan(np.deg2rad(aperture))
    rows = []
    for _ in range(steps):
        if depth > state["max_depth"]:
            break
        # correction = P @ [1, 1, -depth, 1] with perspective divide
        c = proj @ np.array([1.0, 1.0, -depth, 1.0])
        c = c / c[3]
        rows.append((np.float32(float(c[2])), np.float32(c[0] * occl_extent),
                     np.float32(c[1] * occl_extent)))
        depth += slice_distance
    return np.asarray(rows, np.float32).reshape(-1, 3), slice_distance, depth


@register_renderer("dos")
class DOSRenderer(_RayMarchRenderer):
    def __init__(self, volume, tf2d=None, steps: int = 50, slices: int = 200,
                 extinction: float = 100.0, aperture: float = 30.0,
                 samples: int = 8, resolution: int = 512, sample_seed: int = 0, *, device):
        super().__init__(volume, tf2d, resolution, device)
        self.steps = steps
        self.slices = slices
        self.extinction = extinction
        self.aperture = aperture
        self.samples = samples
        self._occl_samples = torch.as_tensor(generate_occlusion_samples(samples, sample_seed),
                                             device=self.device)

    def reset(self, camera, seed: int = 0):
        lo, hi = depth_range(camera)
        return dict(color=self._image(0.0, 4), occlusion=self._image(1.0), depth=lo,
                    min_depth=lo, max_depth=hi)

    def render(self, state, camera, seed: int):
        schedule, slice_distance, depth = slice_schedule(state, camera, self.steps,
                                                         self.slices, self.aperture)
        occlusion, img = K.dos_pass(
            state["color"], state["occlusion"], torch.empty_like(state["occlusion"]),
            camera.inverse_mvp(), self._density, self._tf_table, self._occl_samples, schedule,
            slice_distance, self.extinction, self.volume.filter)
        return dict(state, occlusion=occlusion, depth=depth), img
