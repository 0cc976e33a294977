"""Carry photon state and render resources between this package and
``vpt_tpu``, through numpy arrays.

With these the two packages run the same dispatch from the same inputs:
``state_from_numpy({k: np.asarray(getattr(jax_state, k)) ...}, device)``
and ``ctx_from_numpy`` on the JAX ``SpectralCtx``'s arrays; the backward's
packed adjoints and raw-table gradients cross with ``adjoints_from_numpy``
and ``grads_to_numpy``.

The scene and config objects cross the same way: ``camera_from``,
``volume_from``, ``light_from``, ``material_from``, ``spectrum_from`` and
``mcm_spectral_config_from`` build the port's own types
(``vpt_tpu_torch.scene``, ``vpt_tpu_torch.utils.config``) from any object
with the JAX package's fields, reading only plain values and numpy arrays;
``scene_from`` picks the function by the object's type name. The port's
types keep the JAX package's fields, so that package reads them as well.
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.models.mcm_spectral import SpectralCtx, SpectralState
from vpt_tpu_torch.ops.interp import PackedVolume
from vpt_tpu_torch.scene.camera import Camera
from vpt_tpu_torch.scene.volume import Volume
from vpt_tpu_torch.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig


def state_from_numpy(fields: dict, device) -> SpectralState:
    """``SpectralState`` from numpy arrays keyed by the state's field names."""
    names = SpectralState.field_names()
    missing = set(names) - set(fields)
    if missing:
        raise KeyError(f"missing state fields: {sorted(missing)}")
    return SpectralState(**{
        k: torch.as_tensor(np.array(fields[k]), device=device) for k in names})


def state_to_numpy(state: SpectralState) -> dict:
    """The state's tensors as numpy arrays keyed by field name."""
    return {k: t.cpu().numpy() for k, t in zip(state.field_names(), state.tensors())}


def ctx_from_numpy(*, inv_mvp, seed_bits, extinction, blur, max_bounces,
                   light_direction, density_table, density_dims=None, material_tf,
                   light_spectrum, boundaries, bin_xyz, environment=None, majorant=None,
                   volume_filter="linear", device) -> SpectralCtx:
    """The port's ``SpectralCtx`` from the arrays of a JAX ``SpectralCtx``.

    The packed volume comes as a flat ``PackedVolume`` table (u8 or f32,
    ``density_table`` (rows, 8) or (rows, 4) + ``density_dims``) or as the
    natural 4-D (D+1, H+1, W+1, 8) or (D, H+1, W+1, 4) array the JAX
    package keeps for small f32 volumes (``density_dims`` None); both
    become a flat table, of kind "xy" when 4 wide. A 3-D ``density_table``
    (``density_dims`` None) is a raw (D, H, W) grid and stays one (f32).
    ``environment`` is the packed (He+1, We+1, 12) or raw (He, We, 3) map
    and ``majorant`` the (Gz, Gy, Gx, 2) grid, as the JAX ctx holds them;
    ``volume_filter`` is the JAX render functions' static argument.
    ``material_tf`` is the fused (Hp, Wp, 18) table, the packed (Hp, Wp,
    16) TF or the raw (H, W, 4) one, ``light_spectrum`` the (N+1, 2) pair
    table or the raw (N,) one, as the reference's ``pack_tables`` left
    them. A fused table's light pair (channels 16:18) repeats in every
    density row, as ``interp.pack_tex2d_with_tex1d`` packs it: the forward
    kernel reads an escaping lane's light from row 0, so a table whose rows
    differ there is refused."""

    def dev(a):
        return torch.as_tensor(np.array(a), device=device)

    density_table = np.asarray(density_table)
    if density_table.ndim == 3 and density_dims is None:
        density = dev(np.asarray(density_table, np.float32))
    else:
        if density_table.ndim == 4:
            if density_dims is not None and tuple(density_dims) != density_table.shape[:3]:
                raise ValueError(f"density_dims {density_dims} != table dims "
                                 f"{density_table.shape[:3]}")
            density_dims = density_table.shape[:3]
            density_table = density_table.reshape(-1, density_table.shape[-1])
        elif density_dims is None:
            raise ValueError("a flat density table needs density_dims")
        density = PackedVolume(dev(density_table), tuple(density_dims),
                               "xy" if density_table.shape[-1] == 4 else "full")
    material_tf = np.asarray(material_tf, np.float32)
    if material_tf.ndim == 3 and material_tf.shape[-1] == 18 and not np.array_equal(
            material_tf[..., 16:18], np.broadcast_to(material_tf[:1, :, 16:18],
                                                     material_tf[..., 16:18].shape)):
        raise ValueError("material_tf's light pair (channels 16:18) differs between density rows")

    return SpectralCtx(
        inv_mvp=np.asarray(inv_mvp, np.float32),
        seed_bits=int(np.asarray(seed_bits).astype(np.uint32)),
        extinction=np.float32(extinction),
        blur=np.float32(blur),
        max_bounces=int(max_bounces),
        light_direction=np.asarray(light_direction, np.float32),
        density=density,
        material_tf=dev(material_tf),
        light_spectrum=dev(np.asarray(light_spectrum, np.float32)),
        boundaries=np.asarray(boundaries, np.float32),
        bin_xyz=dev(np.asarray(bin_xyz, np.float32)),
        environment=None if environment is None else dev(np.asarray(environment, np.float32)),
        majorant=None if majorant is None else dev(np.asarray(majorant, np.float32)),
        volume_filter=str(volume_filter),
    )


def adjoints_from_numpy(acc: dict, device) -> dict:
    """Packed adjoints of the JAX backward (``raw_adjoints=True``: g_ext
    scalar, g_tf (Hp*Wp, 18), g_vol (rows, 8)) as the port's tensors
    (g_ext of shape (1,))."""
    out = {}
    for k, v in acc.items():
        a = np.array(v, np.float32)
        out[k] = torch.as_tensor(a.reshape(1) if k == "g_ext" else a, device=device)
    return out


def grads_to_numpy(grads: dict) -> dict:
    """Gradients (or adjoints) of the port as numpy arrays, by key."""
    return {k: v.detach().cpu().numpy() for k, v in grads.items()}


def camera_from(camera) -> Camera:
    """The port's ``Camera`` with the fields of ``camera``."""
    return Camera(fovy=float(camera.fovy), aspect=float(camera.aspect), near=float(camera.near),
                  far=float(camera.far), rotation=np.array(camera.rotation, np.float64),
                  translation=np.array(camera.translation, np.float64))


def volume_from(volume) -> Volume:
    """The port's ``Volume`` over the same density array and filter."""
    return Volume(density=np.asarray(volume.density), filter=str(volume.filter))


def light_from(light) -> LightConfig:
    return LightConfig(direction=tuple(float(v) for v in light.direction),
                       spectrum=tuple(float(v) for v in light.spectrum))


def material_from(material) -> MaterialTF:
    return MaterialTF(np.array(material.table, np.float32))


def spectrum_from(spectrum) -> SpectrumConfig:
    return SpectrumConfig(tuple(float(b) for b in spectrum.boundaries))


def mcm_spectral_config_from(config) -> MCMSpectralConfig:
    return MCMSpectralConfig(extinction=float(config.extinction),
                             anisotropy=float(config.anisotropy), bounces=int(config.bounces),
                             steps=int(config.steps), blur=float(config.blur))


_BY_TYPE = {"Camera": camera_from, "Volume": volume_from, "LightConfig": light_from,
            "MaterialTF": material_from, "SpectrumConfig": spectrum_from,
            "MCMSpectralConfig": mcm_spectral_config_from}


def scene_from(*objects):
    """The port's counterpart of each scene or config object, by its type
    name (Camera, Volume, LightConfig, MaterialTF, SpectrumConfig,
    MCMSpectralConfig); one object gives one result, several a tuple."""
    out = []
    for obj in objects:
        name = type(obj).__name__
        if name not in _BY_TYPE:
            raise TypeError(f"no port counterpart for {name}")
        out.append(_BY_TYPE[name](obj))
    return out[0] if len(out) == 1 else tuple(out)
