"""Spectral multiple-scattering delta-tracking path tracer, forward path.

Counterpart of ``vpt_tpu/models/mcm_spectral.py`` on packed tables (flat
corner table, full or xy half-packed, u8 when the source volume is
u8-quantized, plus the fused (257, 257, 18) TF+light table), on raw
tables (the (D, H, W) f32 grid, the (256, 256, 4) TF, the (256,) light)
and on every mix of the two that ``pack_tables`` names, with its modes:
linear, quasicubic or (raw grid) nearest filter; the exact global majorant or the super-voxel majorant grid
(``majorant_blocks``, built by ``ops/majorant.py`` from the raw
density and TF); a directional (or isotropic) light or an equirect
environment map; and hit-lane compaction (``compaction=True``,
``models/mcm_spectral_compact.py``).

Photon state is a dataclass of lane tensors of shape (H, W), or (S, H, W)
with S sample streams per pixel; radiance and transmittance carry a
leading bin axis. ``render`` and ``render_many`` update the state in place
where the JAX functions donate it. One ``render_many`` call is one launch
of the step kernel on a CUDA device (``vpt_tpu_torch/kernels``).

``render_diff`` / ``render_sequence_diff`` are the differentiable
dispatches of the autodiff surrogate: one ``torch.autograd.Function`` per
window of dispatches (``_RenderWindow``), whose forward tapes the window in
one launch of K4's surrogate mode and whose backward walks the tapes back in
one K12 launch (``kernels/surrogate.py``), over a full packed volume with
the linear or quasicubic filter and the light or the environment map. The
surrogate over an xy half-packed volume or raw tables raises
``NotImplementedError``.

Known reference quirks preserved: radiance starts at 1.0; y-flipped screen
coordinates; light gain 5.0; the volume is sampled (clamped) before the
out-of-bounds test.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.kernels import spectral_backward as TB
from vpt_tpu_torch.kernels import surrogate as S
from vpt_tpu_torch.models.base import register_renderer
from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.ops.majorant import build_majorant_grid
from vpt_tpu_torch.ops.spectral import bin_coefficients, xyz_to_rgb_linear
from vpt_tpu_torch.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig


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
    # flat (rows, 8) full or (rows, 4) xy u8|f32 table, or a raw (D, H, W) f32 grid
    density: interp.PackedVolume | torch.Tensor
    # (257, 257, 18) fused TF + light table, (257, 257, 16) packed TF or raw (256, 256, 4)
    material_tf: torch.Tensor
    light_spectrum: torch.Tensor  # (257, 2) packed light pairs or raw (256,)
    boundaries: np.ndarray  # (B+1,) f32 bin boundaries
    bin_xyz: torch.Tensor  # (3, B) f32 per-bin CIE coefficients
    # packed (He+1, We+1, 12) or raw (He, We, 3) equirect map; None = the
    # light (directional or isotropic) is the escape radiance
    environment: torch.Tensor | None = None
    # (Gz, Gy, Gx, 2) f32 super-voxel (majorant, flight cap) table; None =
    # the reference-exact global majorant
    majorant: torch.Tensor | None = None
    volume_filter: str = "linear"  # "linear" | "quasicubic" | "nearest" (raw grid)


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


_DIFF_FIELDS = ("px", "py", "pz", "dx", "dy", "dz", "radiance")
_PLAIN_FIELDS = ("bounces", "samples", "bin", "wavelength")


class _RenderWindow(torch.autograd.Function):
    """K differentiable dispatches, one per frame seed, over (the start
    state's float fields, the score, the packed volume table, the fused TF
    table, the extinction, the packed environment map or None), in one of
    two schedules that compute the same values (``window_storage`` resolved
    as the PRB window's):

    - "tape": the forward is one launch of K4's surrogate mode over the K
      dispatches, whose tapes are kept; the backward is one K12 launch over
      them, from the adjoints at the window's end to those at its start,
      into one packed adjoint per learned table.
    - "forward": K1 per dispatch, each dispatch's start state kept (the
      memory policy of the reference's ``jax.checkpoint``); the backward
      re-tapes each dispatch from its start state and walks it back,
      dispatch K-1 first, into the same packed adjoints.

    The state's copy, the extinction's read to the host and the adjoints'
    zeroing happen once per window."""

    @staticmethod
    def forward(fctx, meta, px, py, pz, dx, dy, dz, radiance, score, vol, tf, extinction, env):
        sctx, state, seeds, steps, n_bins, storage = meta
        kctx = dataclasses.replace(
            sctx, density=dataclasses.replace(sctx.density, table=vol.detach()),
            material_tf=tf.detach(), extinction=np.float32(float(extinction.detach())),
            environment=None if env is None else env.detach())
        start = SpectralState(px=px, py=py, pz=pz, dx=dx, dy=dy, dz=dz, bounces=state.bounces,
                              samples=state.samples, bin=state.bin, wavelength=state.wavelength,
                              radiance=radiance, transmittance=state.transmittance)
        with torch.no_grad():
            if storage == "tape":
                out, tapes = S.tape_forward(start, kctx, seeds, steps, n_bins)
                fctx.starts = None
                fctx.save_for_backward(tapes, out.samples)
            else:
                out, fctx.starts = S.clone_steppable(start), []
                for s in seeds:
                    fctx.starts.append(S.clone_steppable(out))
                    K.step(out, kctx, [s], steps, n_bins)
                fctx.save_for_backward(out.samples)
        fctx.meta = (kctx, seeds, steps, n_bins)
        fctx.mark_non_differentiable(*(getattr(out, k) for k in _PLAIN_FIELDS))
        return (*(getattr(out, k) for k in _DIFF_FIELDS), torch.ones_like(score),
                *(getattr(out, k) for k in _PLAIN_FIELDS))

    @staticmethod
    def backward(fctx, *grads):
        kctx, seeds, steps, n_bins = fctx.meta
        samples = fctx.saved_tensors[-1]
        lane = tuple(samples.shape)
        n = samples.numel()
        dev = samples.device

        def flat(g, shape):
            if g is None:
                return torch.zeros(int(np.prod(shape)), dtype=torch.float32, device=dev)
            return g.detach().reshape(-1).clone()

        carry = dict(gp=[flat(grads[a], lane) for a in range(3)],
                     gd=[flat(grads[3 + a], lane) for a in range(3)],
                     grad=flat(grads[6], (n_bins,) + lane).reshape(n_bins, n),
                     c=flat(grads[7], lane))
        need = fctx.needs_input_grad
        adj = {}
        if need[9]:
            adj["g_vol"] = torch.zeros(kctx.density.table.shape, dtype=torch.float32, device=dev)
        if need[10]:
            adj["g_tf"] = torch.zeros((kctx.material_tf.shape[0] * kctx.material_tf.shape[1], 18),
                                      dtype=torch.float32, device=dev)
        if need[11]:
            adj["g_ext"] = torch.zeros(1, dtype=torch.float32, device=dev)
        if need[12]:
            HpE, WpE, _ = kctx.environment.shape
            adj["g_env"] = torch.zeros((HpE * WpE, 12), dtype=torch.float32, device=dev)
        flds = S.fields(kctx.majorant is not None)
        with torch.no_grad():
            if fctx.starts is None:
                S.reverse(fctx.saved_tensors[0], flds, samples, carry, adj, kctx, n_bins)
            else:
                for k in range(len(seeds) - 1, -1, -1):
                    end, tape = S.tape_forward(fctx.starts[k], kctx, seeds[k:k + 1], steps, n_bins)
                    S.reverse(tape, flds, end.samples, carry, adj, kctx, n_bins)
                    del end, tape
        g_state = [t.reshape(lane) for t in (*carry["gp"], *carry["gd"])]
        return (None, *g_state, carry["grad"].reshape((n_bins,) + lane), carry["c"].reshape(lane),
                adj.get("g_vol"),
                adj["g_tf"].reshape(kctx.material_tf.shape) if "g_tf" in adj else None,
                adj["g_ext"].reshape(()) if "g_ext" in adj else None,
                adj["g_env"].reshape(kctx.environment.shape) if "g_env" in adj else None)


def _render_window(state: SpectralState, score: torch.Tensor, ctx: SpectralCtx, seeds,
                   steps: int, n_bins: int, volume_filter: str, window_storage: str):
    """The differentiable window from ``state`` (untouched): (state, score).
    ``volume_filter`` is the filter rendered, whatever ``ctx.volume_filter``
    says (the static argument of the JAX functions, whose ctx holds none)."""
    if ctx.volume_filter != volume_filter:
        ctx = dataclasses.replace(ctx, volume_filter=volume_filter)
    S.check_ctx(ctx)
    seeds = [int(s) for s in np.asarray(seeds, np.uint32).reshape(-1)]
    if not seeds:
        raise ValueError("a differentiable window needs at least one frame seed")
    tape_bytes = state.px.numel() * steps * len(seeds) * len(S.fields(ctx.majorant is not None)) * 4
    storage = TB.resolve_storage(window_storage, tape_bytes)
    ext = ctx.extinction
    if not torch.is_tensor(ext):
        ext = torch.tensor(np.float32(ext))
    outs = _RenderWindow.apply((ctx, state, seeds, steps, n_bins, storage),
                               *(getattr(state, k) for k in _DIFF_FIELDS), score,
                               ctx.density.table, ctx.material_tf, ext, ctx.environment)
    fields = dict(zip(_DIFF_FIELDS, outs[:7]))
    fields.update(zip(_PLAIN_FIELDS, outs[8:]))
    return SpectralState(**fields, transmittance=state.transmittance), outs[7]


def render_diff(state: SpectralState, score: torch.Tensor, ctx: SpectralCtx, steps: int,
                n_bins: int, volume_filter: str = "linear"):
    """Differentiable render dispatch: (state, score, image), the forward
    bit for bit ``render``'s with the ``volume_filter`` argument's filter
    (it decides, as the JAX static argument does); the window of one
    dispatch. Gradients of the outputs flow to the packed tables
    ``ctx.density.table`` (f32), ``ctx.material_tf`` and
    ``ctx.environment``, to ``ctx.extinction`` (a 0-d tensor), and to the
    state's position, direction and radiance and the score, by the
    autodiff surrogate's hand-derived backward (``kernels/surrogate.py``).
    ``score``: the carried score weights, ones after a reset; a product of
    factors P / stop_grad(P), so its value is always 1 (anything else
    raises). The wavelength and the integer fields get no gradient: they
    depend on no parameter."""
    if not bool((score == 1).all()):
        raise ValueError("the surrogate's carried score must be all ones (its factors are "
                         "P / stop_grad(P))")
    new, score = _render_window(state, score, ctx, [ctx.seed_bits], steps, n_bins, volume_filter,
                                "auto")
    return new, score, radiance_to_rgb(new.radiance, ctx.bin_xyz)


def render_sequence_diff(seeds, init_state: SpectralState, ctx: SpectralCtx, steps: int,
                         n_bins: int, volume_filter: str = "linear", *,
                         window_storage: str = "auto"):
    """Differentiable accumulation over per-dispatch frame ``seeds`` from
    ``init_state`` (which stays untouched) with a score of ones: the same
    values as ``render_diff`` chained, as one window (``_RenderWindow``).
    Returns the final HDR image. ``window_storage``: "tape" (keep the
    window's surrogate tapes between the passes: one K4 launch forward, one
    K12 launch backward), "forward" (keep each dispatch's start state and
    re-tape it in the backward), or "auto" ("tape" while the tapes fit in
    6 GiB)."""
    new, _ = _render_window(init_state, torch.ones_like(init_state.px), ctx, seeds, steps, n_bins,
                            volume_filter, window_storage)
    return radiance_to_rgb(new.radiance, ctx.bin_xyz)


def table_layout(pack_tables, volume_filter: str = "linear"):
    """What the reference keeps for a ``pack_tables`` option (True, False or
    a subset of {"density", "density_xy", "material_tf", "light_spectrum"})
    and a volume filter: (volume, tf, light, env_packed) with volume "full",
    "xy" or "raw", tf "fused" (the (257, 257, 18) TF+light table), "packed"
    (the 16-wide TF) or "raw", light "pair" or "raw". The environment map
    packs when "material_tf" does. A ``nearest`` volume is never packed, and
    nothing else is then but the environment map
    (``vpt_tpu/models/mcm_spectral.py:609-647``)."""
    keys = {"density", "material_tf", "light_spectrum"} if pack_tables is True else set(
        pack_tables or ())
    env_packed = "material_tf" in keys
    if volume_filter not in ("linear", "quasicubic"):
        return "raw", "raw", "raw", env_packed
    volume = "full" if "density" in keys else "xy" if "density_xy" in keys else "raw"
    if {"material_tf", "light_spectrum"} <= keys:
        return volume, "fused", "pair", env_packed
    if "material_tf" in keys:
        return volume, "packed", "raw", env_packed
    return volume, "raw", "pair" if "light_spectrum" in keys else "raw", env_packed


def _seed_bits(seed) -> int:
    if isinstance(seed, (int, np.integer)):
        return int(np.uint32(seed))
    return int(np.float32(seed).view(np.uint32))


@register_renderer("mcm-spectral")
class MCMSpectralRenderer(nn.Module):
    """Progressive spectral MCM renderer bound to scene resources.

    The scene tables are registered buffers on ``device``: ``vol_table``
    (the packed volume table, or the raw (D, H, W) f32 grid when
    ``vol_kind`` is "raw"), ``tf_table``, ``light_table`` and
    ``environment``. ``pack_tables`` follows the reference
    (``table_layout``): True packs everything (the full 8-wide corner
    table and the fused TF+light table); a subset of {"density",
    "density_xy", "material_tf", "light_spectrum"} packs those tables and
    keeps the others raw ({"density_xy", "material_tf", "light_spectrum"}
    is the xy half-packed volume at 4x the raw grid's memory,
    {"material_tf", "light_spectrum"} the raw grid with the fused TF);
    False keeps every table raw. A ``nearest`` volume renders over raw
    tables whatever ``pack_tables`` says. A mesh raises
    ``NotImplementedError``."""

    # bound on _compact_tables' per-pose cache (an orbit renders many poses)
    COMPACT_CACHE_POSES = 8

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
        if compaction and mesh is not None:
            raise ValueError("compaction is a single-device mode")
        if mesh is not None:
            raise NotImplementedError(
                "mcm-spectral option not ported to the torch package yet: mesh")
        if volume.filter not in ("linear", "quasicubic", "nearest"):
            raise ValueError(f"unknown volume filter {volume.filter!r}")
        vol_kind, tf_kind, light_kind, env_packed = table_layout(pack_tables, volume.filter)
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
        # host seconds of the table builds (a 512^3 volume takes seconds)
        self.build_seconds = {}
        t0 = time.perf_counter()
        if vol_kind == "raw":
            self.vol_kind, self.vol_dims = "raw", tuple(np.shape(volume.density))
            self.register_buffer("vol_table", torch.as_tensor(
                np.asarray(volume.density, np.float32), device=self.device))
        else:
            vol = interp.pack_volume_auto(volume.density, self.device, vol_kind)
            self.vol_dims, self.vol_kind = vol.dims, vol.kind
            self.register_buffer("vol_table", vol.table)
        self.build_seconds["pack_volume"] = time.perf_counter() - t0
        mtf = np.array(self.material_tf.table, np.float32)
        light_spectrum = np.array(light_spectrum, np.float32)
        tf = {"fused": lambda: interp.pack_tex2d_with_tex1d(mtf, light_spectrum),
              "packed": lambda: interp.pack_tex2d_corners(mtf), "raw": lambda: mtf}[tf_kind]()
        self.register_buffer("tf_table", torch.as_tensor(tf, device=self.device))
        self.register_buffer("light_table", torch.as_tensor(
            interp.pack_tex1d_corners(light_spectrum) if light_kind == "pair" else light_spectrum,
            device=self.device))
        self.register_buffer("bin_xyz", torch.as_tensor(
            np.stack([bx, by, bz]).astype(np.float32), device=self.device))
        self._boundaries = np.asarray(self.spectrum.boundaries, np.float32)
        # the majorant grid is built from the RAW density and TF
        t0 = time.perf_counter()
        self.register_buffer("majorant", None if majorant_blocks is None else torch.as_tensor(
            build_majorant_grid(volume.density, self.material_tf.table, self.config.extinction,
                                block=majorant_blocks), device=self.device))
        self.build_seconds["majorant_grid"] = time.perf_counter() - t0
        env = None if environment is None else np.asarray(environment, np.float32)
        if env is not None and env_packed:
            env = interp.pack_tex2d_corners(env)
        self.register_buffer("environment", None if env is None else torch.as_tensor(
            env, device=self.device))

        self.compaction = bool(compaction)
        if self.compaction:
            if self.config.blur != 0.0:
                raise ValueError(
                    "compaction requires blur=0 (depth of field widens the "
                    "ray bundle beyond the per-pixel pyramid test)")
            # raw light spectrum and env image for the closed-form miss values
            self._light_raw = np.asarray(light_spectrum, np.float32)
            self._env_raw = None if environment is None else np.asarray(environment, np.float32)
            self._compact_cache = {}

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
            density=(self.vol_table if self.vol_kind == "raw"
                     else interp.PackedVolume(self.vol_table, self.vol_dims, self.vol_kind)),
            material_tf=self.tf_table,
            light_spectrum=self.light_table,
            boundaries=self._boundaries,
            bin_xyz=self.bin_xyz,
            environment=self.environment,
            majorant=self.majorant,
            volume_filter=self.volume.filter,
        )

    def _compact_tables(self, camera):
        """Per-camera-pose lane tables + closed-form miss radiance, on the
        device; LRU-cached over the last COMPACT_CACHE_POSES poses."""
        from vpt_tpu_torch.models import mcm_spectral_compact as C

        inv_mvp = camera.inverse_mvp()
        key = inv_mvp.tobytes()
        if key not in self._compact_cache:
            while len(self._compact_cache) >= self.COMPACT_CACHE_POSES:
                self._compact_cache.pop(next(iter(self._compact_cache)))
            self._compact_cache[key] = C.device_tables(
                inv_mvp, self.resolution, self.streams, self.spectrum, self._light_raw,
                self.light.direction, self._env_raw, self.device)
        else:
            self._compact_cache[key] = self._compact_cache.pop(key)
        return self._compact_cache[key]

    def reset(self, camera, seed: int = 0) -> SpectralState:
        if self.compaction:
            from vpt_tpu_torch.models import mcm_spectral_compact as C

            t = self._compact_tables(camera)
            return C.compact_reset(self.ctx(camera, seed), t["lane_ix"], t["lane_iy"],
                                   t["lane_seed_iy"], self.spectrum.n_bins, self.resolution)
        return full_reset(self.ctx(camera, seed), self.resolution, self.spectrum.n_bins,
                          self.streams, device=self.vol_table.device)

    def render(self, state: SpectralState, camera, seed: int):
        if self.compaction:
            return self.render_many(state, camera, [seed])
        return render(state, self.ctx(camera, seed), self.config.steps, self.spectrum.n_bins)

    def render_many(self, state: SpectralState, camera, seeds):
        """K dispatches in one kernel launch (amortized host overhead)."""
        seeds = np.asarray(seeds, np.uint32).reshape(-1)
        ctx = self.ctx(camera, int(seeds[0]))
        if self.compaction:
            from vpt_tpu_torch.models import mcm_spectral_compact as C

            t = self._compact_tables(camera)
            C.render_compact_many(state, ctx, seeds, t["lane_ix"], t["lane_iy"],
                                  t["lane_seed_iy"], self.config.steps, self.spectrum.n_bins,
                                  self.resolution)
            return state, C.compact_image(state, t["pixel_hit"], t["n_hit"], t["miss"],
                                          ctx.bin_xyz, self.streams)
        return render_many(state, ctx, seeds, self.config.steps, self.spectrum.n_bins)
