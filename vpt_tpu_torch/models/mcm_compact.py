"""Hit-lane compaction for the RGB MCM renderer (opt-in mode).

Counterpart of ``vpt_tpu/models/mcm_compact.py``, over the spectral
compaction's host machinery (``models/mcm_spectral_compact.py``: the hit
test, the lane packing, the subpixel-averaged environment) with one
stream. Lanes march only the pixels whose ray bundle can hit the cube; a
camera ray that misses keeps transmittance (1, 1, 1) and deposits env(dir)
every sample, so a miss pixel converges to E_jitter[env(dir)]
(``mean_env_image``), which it takes in closed form. Each lane seeds its
chain from its pixel's (ix, iy), so a hit pixel equals the full render's
for the same seeds.

On a CUDA device ``compact_reset`` is one K21 launch, ``render_compact_many``
one K20 launch over the lane table (``kernels/mcm.py``) and
``compact_image`` one K8 launch with the three channels as its bins
(``kernels/mcm_spectral.py::compact_radiance``).

Restriction (``ValueError`` in the renderer): blur == 0.
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.kernels import mcm as K
from vpt_tpu_torch.kernels import mcm_spectral as KS
from vpt_tpu_torch.models import mcm_spectral_compact as C
from vpt_tpu_torch.models.mcm import MCMState


def device_tables(inv_mvp, resolution: int, env_raw, device) -> dict:
    """One pose's compaction tables on ``device``: the hit mask, the
    closed-form miss image as (3, res, res) f32, int32 (M, res) lane
    tables, each lane's flat pixel (``lane_pixel``, the dump row res * res
    for a padding lane), each pixel's hit index (``pixel_hit``) and
    ``n_hit``."""
    hit = C.hit_pixel_mask(inv_mvp, resolution)
    t = C.build_lane_tables(hit, resolution, streams=1)
    miss = np.asarray(C.mean_env_image(inv_mvp, resolution, env_raw), np.float32)

    def dev(a, dtype=None):
        a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
        return torch.as_tensor(a, device=device)

    return dict(hit=dev(hit), miss=dev(miss.transpose(2, 0, 1)),
                lane_ix=dev(t["lane_ix"], np.int32), lane_iy=dev(t["lane_iy"], np.int32),
                lane_pixel=dev(t["lane_pixel"]), pixel_hit=dev(C.hit_pixel_index(hit)),
                n_hit=int(t["n_hit"]))


def compact_reset(ctx, lane_ix, lane_iy, resolution: int) -> MCMState:
    """``full_reset`` over an explicit (M, resolution) int32 lane table."""
    return MCMState(**K.reset(ctx, resolution, lane_ix.device, lanes=(lane_ix, lane_iy)))


def render_compact_many(state: MCMState, ctx, seeds, lane_ix, lane_iy, steps: int,
                        resolution: int) -> MCMState:
    """K dispatches over the compact lane set, in place (one K20 launch on
    a CUDA device); the lane math is the full render's."""
    if state.px.shape[-1] != resolution:
        raise ValueError(f"lane rows of {state.px.shape[-1]} != resolution {resolution}")
    K.step(state, ctx, seeds, steps, lanes=(lane_ix, lane_iy))
    return state


def compact_image(state: MCMState, pixel_hit, n_hit: int, miss, resolution: int):
    """(res, res, 3): each hit pixel's lane radiance, the closed-form
    ``miss`` ((3, res, res)) elsewhere; ``pixel_hit`` is the hit index of
    each pixel (-1 for a miss). The JAX version scatters the lanes through
    their flat pixels (padding lanes into a dump row) and selects by the
    hit mask; with one stream K8 gives the same bits."""
    rad = torch.stack([state.rr, state.rg, state.rb])
    img = KS.compact_radiance(rad, pixel_hit, miss, n_hit, 1)
    if img.shape[1:] != (resolution, resolution):
        raise ValueError(f"image {tuple(img.shape[1:])} != ({resolution}, {resolution})")
    return img.permute(1, 2, 0)
