"""Local ambient occlusion + soft shadows renderer (LAO).

Counterpart of ``vpt_tpu/models/lao.py``: an emission-absorption march
where every sample darkens the 2D TF's colour at (value, |gradient|) by a
light-cone ambient-occlusion integral and a soft-shadow term, tinted with
the reference shader's blue-grey constants, until the accumulated alpha
passes 0.9 (its quirks, kept: a per-pixel constant "random" value, the
light through inv(MVP) without the divide, a gradient step of 1/32, no
temporal accumulation).

``render`` is one launch of K25 ``lao_frame_kernel`` on a CUDA device
(``kernels/lao.py::lao_pass``), the plain ``lao_frame`` on the CPU. The
state is JAX's ``{frame}``.
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.kernels import lao as K
from vpt_tpu_torch.kernels.lao import lao_frame, rand2  # noqa: F401
from vpt_tpu_torch.models.base import register_renderer
from vpt_tpu_torch.models.raymarch import _RayMarchRenderer


@register_renderer("lao")
class LAORenderer(_RayMarchRenderer):
    def __init__(self, volume, tf2d=None, extinction: float = 100.0,
                 lao_enabled: bool = True, lao_weight: float = 0.69,
                 num_lao_samples: int = 1, lao_step: float = 0.05,
                 shadows_enabled: bool = True, shadows_weight: float = 0.54,
                 num_shadow_samples: int = 10, light_radius: float = 0.19,
                 light_position=(2.0, -3.0, -5.0), light_coef: float = 1.0,
                 slices: int = 64, resolution: int = 512, *, device):
        super().__init__(volume, tf2d, resolution, device)
        self.params = dict(
            extinction=extinction, lao_weight=lao_weight, lao_step=lao_step,
            shadows_weight=shadows_weight, light_radius=light_radius,
            light_coef=light_coef,
        )
        self.flags = dict(
            lao_enabled=lao_enabled, shadows_enabled=shadows_enabled,
            num_lao_samples=num_lao_samples, num_shadow_samples=num_shadow_samples,
        )
        self.light_position = np.asarray(light_position, np.float32)
        self.slices = slices
        p = self.params
        self._cone = torch.as_tensor(K.cone_table(lao_step), device=self.device)
        # whether K25's early stop gives the masked scan's bits (checked once)
        self.exact_stop = K.early_stop_exact(self._density, self._tf_table, p["extinction"],
                                             p["lao_weight"], p["shadows_weight"],
                                             p["light_radius"], p["light_coef"])

    def reset(self, camera, seed: int = 0):
        return dict(frame=torch.zeros((), dtype=torch.int32, device=self.device))

    def render(self, state, camera, seed: int):
        p = self.params
        img = K.lao_pass(
            camera.inverse_mvp(), self._density, self._tf_table, self.light_position,
            p["extinction"], p["lao_weight"], p["shadows_weight"], p["light_radius"],
            p["light_coef"], lao_step=p["lao_step"], slices=self.slices,
            resolution=self.resolution, volume_filter=self.volume.filter, cone=self._cone,
            exact=self.exact_stop, **self.flags,
        )
        return dict(frame=state["frame"] + 1), img
