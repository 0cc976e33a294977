"""Spectral multiple-scattering delta-tracking path tracer, forward path.

Counterpart of ``vpt_tpu/models/mcm_spectral.py`` for the default
configuration: packed tables (flat corner table, u8 when the source volume
is u8-quantized, plus the fused (257, 257, 18) TF+light table), linear
filter, the exact global majorant and a directional (or isotropic) light.

Photon state is a dataclass of lane tensors of shape (H, W), or (S, H, W)
with S sample streams per pixel; radiance and transmittance carry a
leading bin axis. ``render`` and ``render_many`` update the state in place
where the JAX functions donate it. One ``render_many`` call is one launch
of the step kernel on a CUDA device (``vpt_tpu_torch/kernels``).

Known reference quirks preserved: radiance starts at 1.0; y-flipped screen
coordinates; light gain 5.0; the volume is sampled (clamped) before the
out-of-bounds test.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.models.base import register_renderer
from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.ops.spectral import bin_coefficients, xyz_to_rgb_linear


@dataclass
class SpectralState:
    """Per-lane photon state. Field order is the JAX ``SpectralState``'s
    leaf order, which checkpoints keep."""

    px: torch.Tensor  # (H, W) | (S, H, W) f32 position
    py: torch.Tensor
    pz: torch.Tensor
    dx: torch.Tensor  # f32 direction
    dy: torch.Tensor
    dz: torch.Tensor
    bounces: torch.Tensor  # i32
    samples: torch.Tensor  # i32
    bin: torch.Tensor  # i32
    wavelength: torch.Tensor  # f32
    radiance: torch.Tensor  # (B, ...) f32
    transmittance: torch.Tensor  # (B, ...) f32, never changes after reset

    @staticmethod
    def field_names():
        return tuple(f.name for f in dataclasses.fields(SpectralState))

    def tensors(self):
        return [getattr(self, k) for k in self.field_names()]


@dataclass
class SpectralCtx:
    """Render resources for one dispatch: host scalars and device tables."""

    inv_mvp: np.ndarray  # (4, 4) f32
    seed_bits: int  # uint32 frame seed bit pattern
    extinction: np.float32
    blur: np.float32
    max_bounces: int
    light_direction: np.ndarray  # (3,) f32, unnormalized
    density: interp.PackedVolume  # flat (rows, 8) u8|f32 corner table
    material_tf: torch.Tensor  # (257, 257, 18) fused TF + light table
    light_spectrum: torch.Tensor  # (257, 2) packed light pairs
    boundaries: np.ndarray  # (B+1,) f32 bin boundaries
    bin_xyz: torch.Tensor  # (3, B) f32 per-bin CIE coefficients


def full_reset(ctx: SpectralCtx, resolution: int, n_bins: int, streams: int = 1,
               *, device) -> SpectralState:
    """Fresh photons for every lane, radiance = 1 (the reset dispatch)."""
    return SpectralState(**K.reset(ctx, resolution, n_bins, streams, device))


def radiance_to_rgb(radiance: torch.Tensor, bin_xyz: torch.Tensor) -> torch.Tensor:
    """Binned radiance (B, H, W) or (B, S, H, W) -> (H, W, 3) linear sRGB;
    streams average equally (the XYZ map is linear)."""
    if radiance.ndim == 4:
        radiance = radiance.mean(dim=1)
    return xyz_to_rgb_linear(torch.einsum("bhw,cb->hwc", radiance, bin_xyz))


def render(state: SpectralState, ctx: SpectralCtx, steps: int, n_bins: int):
    """One render dispatch (``steps`` Woodcock iterations with
    ``ctx.seed_bits``) + display conversion. Updates ``state`` in place;
    returns (state, (H, W, 3) linear-RGB image)."""
    return render_many(state, ctx, [ctx.seed_bits], steps, n_bins)


def render_many(state: SpectralState, ctx: SpectralCtx, seeds, steps: int, n_bins: int):
    """K render dispatches, one per frame seed, in one step-kernel launch.
    Identical to K ``render`` calls with those seeds. Updates ``state`` in
    place; returns (state, final HDR image)."""
    K.step(state, ctx, seeds, steps, n_bins)
    return state, radiance_to_rgb(state.radiance, ctx.bin_xyz)


def _seed_bits(seed) -> int:
    if isinstance(seed, (int, np.integer)):
        return int(np.uint32(seed))
    return int(np.float32(seed).view(np.uint32))


@register_renderer("mcm-spectral")
class MCMSpectralRenderer(nn.Module):
    """Progressive spectral MCM renderer bound to scene resources.

    The scene tables are registered buffers on ``device``; options outside
    the ported forward path raise ``NotImplementedError``."""

    def __init__(
        self,
        volume,
        material_tf: MaterialTF | None = None,
        light: LightConfig | None = None,
        spectrum: SpectrumConfig | None = None,
        config: MCMSpectralConfig | None = None,
        resolution: int = 512,
        pack_tables=True,
        streams: int = 1,
        environment=None,
        majorant_blocks: int | None = None,
        mesh=None,
        compaction: bool = False,
        *,
        device,
    ):
        super().__init__()
        unsupported = {
            "environment": environment is not None,
            "majorant_blocks": majorant_blocks is not None,
            "mesh": mesh is not None,
            "compaction=True": bool(compaction),
            f"pack_tables={pack_tables!r} (raw tables, streams={streams})": pack_tables is not True,
            f"volume filter {volume.filter!r}": volume.filter != "linear",
        }
        for what, bad in unsupported.items():
            if bad:
                raise NotImplementedError(
                    f"mcm-spectral option not ported to the torch package yet: {what}")
        self.volume = volume
        self.material_tf = material_tf or MaterialTF.constant(0.5, 0.5)
        self.light = light or LightConfig()
        self.spectrum = spectrum or SpectrumConfig()
        self.config = config or MCMSpectralConfig()
        self.resolution = int(resolution)
        self.streams = int(streams)
        self.device = torch.device(device)
        if self.spectrum.n_bins > K.MAX_BINS:
            raise ValueError(f"{self.spectrum.n_bins} bins > the kernel's {K.MAX_BINS}")

        bx, by, bz = bin_coefficients(np.array(self.spectrum.boundaries))
        light_spectrum = self.light.spectrum_array()
        vol = interp.pack_volume_auto(volume.density, self.device)
        self.vol_dims = vol.dims
        self.register_buffer("vol_table", vol.table)
        self.register_buffer("tf_table", torch.as_tensor(
            interp.pack_tex2d_with_tex1d(self.material_tf.table, light_spectrum), device=self.device))
        self.register_buffer("light_table", torch.as_tensor(
            interp.pack_tex1d_corners(light_spectrum), device=self.device))
        self.register_buffer("bin_xyz", torch.as_tensor(
            np.stack([bx, by, bz]).astype(np.float32), device=self.device))
        self._boundaries = np.asarray(self.spectrum.boundaries, np.float32)

    def ctx(self, camera, seed) -> SpectralCtx:
        """The resources of one dispatch; ``seed`` is the frame seed."""
        cfg = self.config
        return SpectralCtx(
            inv_mvp=np.asarray(camera.inverse_mvp(), np.float32),
            seed_bits=_seed_bits(seed),
            extinction=np.float32(cfg.extinction),
            blur=np.float32(cfg.blur),
            max_bounces=int(cfg.bounces),
            light_direction=np.asarray(self.light.direction, np.float32),
            density=interp.PackedVolume(self.vol_table, self.vol_dims),
            material_tf=self.tf_table,
            light_spectrum=self.light_table,
            boundaries=self._boundaries,
            bin_xyz=self.bin_xyz,
        )

    def reset(self, camera, seed: int = 0) -> SpectralState:
        return full_reset(self.ctx(camera, seed), self.resolution, self.spectrum.n_bins,
                          self.streams, device=self.vol_table.device)

    def render(self, state: SpectralState, camera, seed: int):
        return render(state, self.ctx(camera, seed), self.config.steps, self.spectrum.n_bins)

    def render_many(self, state: SpectralState, camera, seeds):
        """K dispatches in one kernel launch (amortized host overhead)."""
        seeds = np.asarray(seeds, np.uint32).reshape(-1)
        return render_many(state, self.ctx(camera, int(seeds[0])), seeds,
                           self.config.steps, self.spectrum.n_bins)
