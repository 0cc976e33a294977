"""Single-scattering Monte-Carlo renderer (MCS): the reference-exact frames
and the persistent lanes.

Counterpart of ``vpt_tpu/models/mcs.py``. With ``persistent=False`` (the
default), per frame, each pixel's ray Woodcock-samples one collision, then ratio-tracks
the transmittance toward the frame's scattering direction; the pixel's
value is diffuse x light x transmittance (the light one environment sample
at that direction), or the environment on a miss or an escape; frames
average with 1/frame. The host draws each frame's scattering direction by
rejection-sampling the unit ball along a hash chain
(``_host_scatter_direction``).

One ``render_many`` call of K frames is one launch of K22 ``mcs_frames``
(``kernels/mcs.py``) and the frame count's ``add_`` on a CUDA device; on CPU
tensors the plain PyTorch versions run. ``render`` is ``render_many`` of one
seed. The state is the JAX dict, ``acc`` (H, W, 4) f32 and ``frame`` a 0-d
int32, updated in place where the JAX functions donate it.

``majorant_blocks`` builds the super-voxel majorant grid (``ops/majorant``)
against the TF's alpha curve along row 0, remapped onto build_majorant_grid's
density-rows convention as the reference does: statistically exact, with
other per-seed frames than the exact path.

``persistent=True`` runs the persistent-lane state machine instead
(``MCSPersistentState``, one lane per pixel and stream): every iteration
each lane takes one free-flight step, and a lane that finishes a sample
deposits it into its incremental mean and starts the next at once, its
light direction drawn per sample. ``steps`` iterations make one dispatch;
``streams`` S > 1 gives each pixel S chains (lane shape (S, R, R)), and the
image is their sample-weighted mean. One ``render_many`` call of K seeds is
one launch of K23 ``mcs_persistent`` on a CUDA device (the plain version on
CPU tensors); the same converged image as the frames, other per-seed
images.

Known reference quirks preserved: the per-pixel chain seeded from the bits
of the pixel's screen uv; a white 1x1 environment when none is given.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from vpt_tpu_torch.kernels import mcs as K
from vpt_tpu_torch.kernels.mcs import mcs_frame, mcs_frames  # noqa: F401
from vpt_tpu_torch.models.base import register_renderer
from vpt_tpu_torch.models.mcm_spectral import _seed_bits
from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.ops.majorant import build_majorant_grid
from vpt_tpu_torch.scene.tf import TransferFunction2D


@dataclass
class MCSCtx:
    """Render resources of one frame: host scalars and device tables, the
    JAX ``MCSCtx``'s fields."""

    inv_mvp: np.ndarray  # (4, 4) f32
    seed_bits: int  # uint32 frame seed bit pattern
    extinction: np.float32
    scatter_dir: np.ndarray  # (3,) f32
    density: interp.PackedVolume | torch.Tensor  # full (rows, 8) u8|f32 table or raw (D, H, W)
    tf_table: torch.Tensor  # packed (257, 257, 16) or raw (256, 256, 4)
    environment: torch.Tensor  # raw (He, We, 3) equirect map
    majorant: torch.Tensor | None = None  # (Gz, Gy, Gx, 2) f32


@dataclass
class MCSPersistentState:
    """Per-lane single-scatter state, (R, R) or (S, R, R) lane tensors; the
    JAX ``MCSPersistentState``'s fields in its leaf order, which checkpoints
    keep."""

    phase: torch.Tensor  # bool: False distance sampling, True shadow ray
    dist: torch.Tensor  # f32 distance travelled along the current segment
    trans: torch.Tensor  # f32 running transmittance (shadow phase)
    sdx: torch.Tensor  # f32 the sample's scatter (light) direction
    sdy: torch.Tensor
    sdz: torch.Tensor
    smax: torch.Tensor  # f32 shadow segment length
    scx: torch.Tensor  # f32 scatter point
    scy: torch.Tensor
    scz: torch.Tensor
    dr: torch.Tensor  # f32 diffuse RGBA at the scatter point
    dg: torch.Tensor
    db: torch.Tensor
    da: torch.Tensor
    acc: torch.Tensor  # (..., 4) f32 incremental-mean RGBA
    samples: torch.Tensor  # i32 completed samples

    @staticmethod
    def field_names():
        return tuple(f.name for f in dataclasses.fields(MCSPersistentState))

    def tensors(self):
        return [getattr(self, k) for k in self.field_names()]


def _pcg_hash(x: np.uint32) -> np.uint32:
    with np.errstate(over="ignore"):
        x = np.uint32(x * np.uint32(747796405) + np.uint32(2891336453))
        x = np.uint32(((x >> np.uint32((x >> np.uint32(28)) + np.uint32(4))) ^ x)
                      * np.uint32(277803737))
        return np.uint32((x >> np.uint32(22)) ^ x)


def _host_scatter_direction(seed: int) -> np.ndarray:
    """The frame's scattering direction: a unit-ball point rejection-sampled
    along a pcg hash chain from ``seed ^ 0x9E3779B9`` (MCSRenderer.js:106-116
    with the chain for Math.random), normalized. The uniforms, the map to
    [-1, 1] and the norm are Python doubles; only the result is float32."""
    state = np.uint32(int(seed) ^ 0x9E3779B9)

    def nxt(s):
        s = _pcg_hash(s)
        return s, float(s) / float(0xFFFFFFFF)

    while True:
        state, x = nxt(state)
        state, y = nxt(state)
        state, z = nxt(state)
        x, y, z = x * 2 - 1, y * 2 - 1, z * 2 - 1
        n = (x * x + y * y + z * z) ** 0.5
        if n <= 1 and n > 1e-6:
            return np.array([x / n, y / n, z / n], np.float32)


def _alpha_curve_majorant(density, tf_table, extinction, block):
    """The majorant grid of the TF's alpha along row 0 (where MCS reads it,
    tf[0, density, 3]), remapped onto build_majorant_grid's (W, 1, 4) density-rows
    table with the curve in channel 1."""
    curve = np.asarray(tf_table, np.float32)[0, :, 3]
    tf_equiv = np.zeros((curve.shape[0], 1, 4), np.float32)
    tf_equiv[:, 0, 1] = curve
    return build_majorant_grid(np.asarray(density), tf_equiv, extinction, block=block)


@register_renderer("mcs")
class MCSRenderer(nn.Module):
    """Progressive single-scattering renderer bound to scene resources.

    The scene tables are registered buffers on ``device``: ``vol_table`` (a
    full packed corner table for the linear and quasicubic filters, else
    the raw (D, H, W) f32 grid), ``tf_table`` (packed with the volume, else
    raw), ``environment`` (raw, a white texel when none is given) and
    ``majorant`` (None without ``majorant_blocks``)."""

    def __init__(self, volume, tf2d=None, environment=None, extinction: float = 1.0,
                 max_collisions: int = 1024, resolution: int = 512,
                 majorant_blocks: int | None = None, persistent: bool = False, steps: int = 32,
                 streams: int = 1, *, device):
        super().__init__()
        if volume.filter not in ("linear", "quasicubic", "nearest"):
            raise ValueError(f"unknown volume filter {volume.filter!r}")
        self.persistent, self.steps, self.streams = persistent, steps, streams
        self.volume = volume
        self.tf2d = tf2d or TransferFunction2D.grayscale_ramp()
        self.extinction = extinction
        self.max_collisions = int(max_collisions)
        self.resolution = int(resolution)
        self.device = torch.device(device)
        if environment is None:
            environment = np.ones((1, 1, 3), np.float32)
        tf_table = np.asarray(self.tf2d.rasterize(), np.float32)
        maj = None
        if majorant_blocks is not None:
            maj = torch.as_tensor(_alpha_curve_majorant(volume.density, tf_table, extinction,
                                                        majorant_blocks), device=self.device)
        self.register_buffer("majorant", maj)
        if volume.filter in ("linear", "quasicubic"):
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

    def ctx(self, camera, seed: int, scatter_dir: np.ndarray | None = None) -> MCSCtx:
        """The resources of one frame; ``seed`` is the frame seed, and
        ``scatter_dir`` its scattering direction when the caller has drawn
        it already."""
        if scatter_dir is None:
            scatter_dir = _host_scatter_direction(seed)
        return MCSCtx(
            inv_mvp=np.asarray(camera.inverse_mvp(), np.float32),
            seed_bits=_seed_bits(seed),
            extinction=np.float32(self.extinction),
            scatter_dir=scatter_dir,
            density=(self.vol_table if self.vol_kind == "raw"
                     else interp.PackedVolume(self.vol_table, self.vol_dims, "full")),
            tf_table=self.tf_table,
            environment=self.environment,
            majorant=self.majorant,
        )

    def reset(self, camera, seed: int = 0):
        n = self.resolution
        if self.persistent:
            shape = K._lane_shape(n, self.streams)
            # distinct buffers per field: the kernel updates each in place
            z = lambda: torch.zeros(shape, dtype=torch.float32, device=self.device)  # noqa: E731
            o = lambda: torch.ones(shape, dtype=torch.float32, device=self.device)  # noqa: E731
            return MCSPersistentState(
                phase=torch.zeros(shape, dtype=torch.bool, device=self.device), dist=z(),
                trans=o(), sdx=z(), sdy=z(), sdz=o(), smax=z(), scx=z(), scy=z(), scz=z(),
                dr=z(), dg=z(), db=z(), da=z(),
                acc=torch.zeros(shape + (4,), dtype=torch.float32, device=self.device),
                samples=torch.zeros(shape, dtype=torch.int32, device=self.device))
        return dict(acc=torch.zeros((n, n, 4), dtype=torch.float32, device=self.device),
                    frame=torch.zeros((), dtype=torch.int32, device=self.device))

    def _persistent_image(self, state):
        """The sample-weighted mean over streams (streams hold unequal
        sample counts at any finite step)."""
        if self.streams == 1:
            return state.acc[..., :3]
        w = state.samples.to(torch.float32)[..., None]
        total = torch.clamp_min(w.sum(dim=0), 1.0)
        return (state.acc[..., :3] * w).sum(dim=0) / total

    def render(self, state, camera, seed: int):
        return self.render_many(state, camera, [seed])

    def render_many(self, state, camera, seeds):
        """K frames (persistent: K dispatches) in one kernel launch; the
        ctx's seed is ``seeds[0]``, the frames' scattering directions are
        drawn on the host. Returns (state, (H, W, 3) image)."""
        seeds = np.asarray(seeds, np.uint32).reshape(-1)
        if self.persistent:
            K.persistent(state, self.ctx(camera, int(seeds[0])), seeds, self.steps,
                         self.volume.filter, self.streams)
            return state, self._persistent_image(state)
        dirs = np.stack([_host_scatter_direction(int(s)) for s in seeds])
        K.frames(state["acc"], state["frame"], self.ctx(camera, int(seeds[0]), dirs[0]), seeds,
                 dirs, self.max_collisions, self.volume.filter)
        return state, state["acc"][..., :3]
