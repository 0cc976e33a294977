"""RGB multiple-scattering delta-tracking path tracer (MCMCompute).

Counterpart of ``vpt_tpu/models/mcm.py``: the spectral renderer's lane
layout with RGB transmittance and radiance instead of bins, no wavelength;
the material is the classic 2D TF at (density, 0) (rgb = colour, a = the
true-extinction ratio, P_scatter = a * max(rgb)); a scatter multiplies the
transmittance by the TF's rgb and samples HG with the global anisotropy;
an escape deposits the transmittance times the equirect environment map.

One ``render_many`` call is one launch of K20 ``mcm_step`` on a CUDA
device and ``reset`` one of K21 ``mcm_reset`` (``kernels/mcm.py``); on CPU
tensors the plain PyTorch versions run. ``render`` and ``render_many``
update the state in place where the JAX functions donate it. Hit-lane
compaction (``compaction=True``) is ``models/mcm_compact.py``.

Known reference quirks preserved: radiance starts at 1.0; y-flipped screen
coordinates; the environment's y quirk; a white 1x1 environment when none
is given.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from vpt_tpu_torch.kernels import mcm as K
from vpt_tpu_torch.models.base import register_renderer
from vpt_tpu_torch.models.mcm_spectral import _seed_bits
from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.scene.tf import TransferFunction2D
from vpt_tpu_torch.utils.config import MCMConfig


@dataclass
class MCMState:
    """Per-lane photon state, (H, W) lane tensors (or (M, res) over a lane
    table). Field order is the JAX ``PhotonState``'s leaf order, which
    checkpoints keep."""

    px: torch.Tensor  # f32 position
    py: torch.Tensor
    pz: torch.Tensor
    dx: torch.Tensor  # f32 direction
    dy: torch.Tensor
    dz: torch.Tensor
    bounces: torch.Tensor  # i32
    samples: torch.Tensor  # i32
    tr: torch.Tensor  # f32 transmittance
    tg: torch.Tensor
    tb: torch.Tensor
    rr: torch.Tensor  # f32 radiance (running mean)
    rg: torch.Tensor
    rb: torch.Tensor

    @staticmethod
    def field_names():
        return tuple(f.name for f in dataclasses.fields(MCMState))

    def tensors(self):
        return [getattr(self, k) for k in self.field_names()]


@dataclass
class MCMCtx:
    """Render resources for one dispatch: host scalars and device tables."""

    inv_mvp: np.ndarray  # (4, 4) f32
    seed_bits: int  # uint32 frame seed bit pattern
    extinction: np.float32
    blur: np.float32
    anisotropy: np.float32
    max_bounces: int
    density: interp.PackedVolume | torch.Tensor  # full (rows, 8) u8|f32 table or raw (D, H, W)
    tf_table: torch.Tensor  # packed (257, 257, 16) or raw (256, 256, 4)
    environment: torch.Tensor  # raw (He, We, 3) equirect radiance map
    volume_filter: str = "linear"  # "linear" | "quasicubic" | "nearest" (raw grid)


def full_reset(ctx: MCMCtx, resolution: int, *, device) -> MCMState:
    """Fresh photons for every pixel, radiance = 1 (the reset dispatch)."""
    return MCMState(**K.reset(ctx, resolution, device))


def render(state: MCMState, ctx: MCMCtx, steps: int):
    """One render dispatch (``steps`` iterations with ``ctx.seed_bits``);
    returns (state, (H, W, 3) image)."""
    return render_many(state, ctx, [ctx.seed_bits], steps)


def render_many(state: MCMState, ctx: MCMCtx, seeds, steps: int):
    """K render dispatches, one per frame seed, in one K20 launch; the
    same as K ``render`` calls. Returns (state, final (H, W, 3) image)."""
    K.step(state, ctx, seeds, steps)
    return state, torch.stack([state.rr, state.rg, state.rb], dim=-1)


@register_renderer("mcm")
class MCMRenderer(nn.Module):
    """Progressive RGB MCM renderer bound to scene resources.

    The scene tables are registered buffers on ``device``: ``vol_table``
    (a full packed corner table, or the raw (D, H, W) f32 grid when
    ``vol_kind`` is "raw"), ``tf_table`` and ``environment`` (raw, a white
    texel when none is given). As in the reference, ``pack_tables`` packs
    the volume and the TF when the filter is linear or quasicubic, and
    keeps both raw otherwise."""

    # bound on _compact_tables' per-pose cache (an orbit renders many poses)
    COMPACT_CACHE_POSES = 8

    def __init__(self, volume, tf2d=None, environment=None, config: MCMConfig | None = None,
                 resolution: int = 512, pack_tables: bool = True, compaction: bool = False,
                 *, device):
        super().__init__()
        if volume.filter not in ("linear", "quasicubic", "nearest"):
            raise ValueError(f"unknown volume filter {volume.filter!r}")
        self.volume = volume
        self.tf2d = tf2d or TransferFunction2D.grayscale_ramp()
        self.config = config or MCMConfig()
        self.resolution = int(resolution)
        self.device = torch.device(device)
        if environment is None:
            environment = np.ones((1, 1, 3), np.float32)  # white fallback env
        # hit-lane compaction (models/mcm_compact.py): lanes for the pixels
        # whose ray bundle can hit the cube; miss pixels take the closed form
        # E_jitter[env(dir)] (transmittance stays 1 on a miss ray)
        self.compaction = bool(compaction)
        if self.compaction:
            if self.config.blur != 0.0:
                raise ValueError("compaction requires blur=0")
            self._env_raw = np.asarray(environment, np.float32)
            self._compact_cache = {}
        tf_table = np.asarray(self.tf2d.rasterize(), np.float32)
        if pack_tables and volume.filter in ("linear", "quasicubic"):
            vol = interp.pack_volume_auto(volume.density, self.device, "full")
            self.vol_kind, self.vol_dims = "full", vol.dims
            self.register_buffer("vol_table", vol.table)
            tf_table = interp.pack_tex2d_corners(tf_table)
        else:
            self.vol_kind, self.vol_dims = "raw", tuple(np.shape(volume.density))
            self.register_buffer("vol_table", torch.as_tensor(
                np.asarray(volume.density, np.float32), device=self.device))
        self.register_buffer("tf_table", torch.as_tensor(tf_table, device=self.device))
        self.register_buffer("environment", torch.as_tensor(
            np.ascontiguousarray(environment, np.float32), device=self.device))

    def ctx(self, camera, seed) -> MCMCtx:
        """The resources of one dispatch; ``seed`` is the frame seed."""
        cfg = self.config
        return MCMCtx(
            inv_mvp=np.asarray(camera.inverse_mvp(), np.float32),
            seed_bits=_seed_bits(seed),
            extinction=np.float32(cfg.extinction),
            blur=np.float32(cfg.blur),
            anisotropy=np.float32(cfg.anisotropy),
            max_bounces=int(cfg.bounces),
            density=(self.vol_table if self.vol_kind == "raw"
                     else interp.PackedVolume(self.vol_table, self.vol_dims, "full")),
            tf_table=self.tf_table,
            environment=self.environment,
            volume_filter=self.volume.filter,
        )

    def _compact_tables(self, camera):
        """Per-pose lane tables and closed-form miss image on the device
        (``mcm_compact.device_tables``), LRU-cached over the last
        COMPACT_CACHE_POSES poses."""
        from vpt_tpu_torch.models import mcm_compact as C

        inv_mvp = camera.inverse_mvp()
        key = inv_mvp.tobytes()
        if key not in self._compact_cache:
            while len(self._compact_cache) >= self.COMPACT_CACHE_POSES:
                self._compact_cache.pop(next(iter(self._compact_cache)))
            self._compact_cache[key] = C.device_tables(inv_mvp, self.resolution, self._env_raw,
                                                       self.device)
        else:
            self._compact_cache[key] = self._compact_cache.pop(key)
        return self._compact_cache[key]

    def reset(self, camera, seed: int = 0) -> MCMState:
        if self.compaction:
            from vpt_tpu_torch.models import mcm_compact as C

            t = self._compact_tables(camera)
            return C.compact_reset(self.ctx(camera, seed), t["lane_ix"], t["lane_iy"],
                                   self.resolution)
        return full_reset(self.ctx(camera, seed), self.resolution, device=self.device)

    def render(self, state: MCMState, camera, seed: int):
        if self.compaction:
            return self.render_many(state, camera, [seed])
        return render(state, self.ctx(camera, seed), self.config.steps)

    def render_many(self, state: MCMState, camera, seeds):
        """K dispatches in one kernel launch (amortized host overhead); the
        ctx's seed is ``seeds[0]``."""
        seeds = np.asarray(seeds, np.uint32).reshape(-1)
        ctx = self.ctx(camera, int(seeds[0]))
        if self.compaction:
            from vpt_tpu_torch.models import mcm_compact as C

            t = self._compact_tables(camera)
            C.render_compact_many(state, ctx, seeds, t["lane_ix"], t["lane_iy"],
                                  self.config.steps, self.resolution)
            return state, C.compact_image(state, t["pixel_hit"], t["n_hit"], t["miss"],
                                          self.resolution)
        return render_many(state, ctx, seeds, self.config.steps)
