"""Carry photon state and render resources between this package and
``vpt_tpu``, through numpy arrays.

With these the two packages run the same dispatch from the same inputs:
``state_from_numpy({k: np.asarray(getattr(jax_state, k)) ...}, device)``
and ``ctx_from_numpy`` on the JAX ``SpectralCtx``'s arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.models.mcm_spectral import SpectralCtx, SpectralState
from vpt_tpu_torch.ops.interp import PackedVolume


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
                   light_direction, density_table, density_dims, material_tf,
                   light_spectrum, boundaries, bin_xyz, device) -> SpectralCtx:
    """The port's ``SpectralCtx`` from the arrays of a JAX ``SpectralCtx``
    (its ``PackedVolume`` given as ``density_table`` + ``density_dims``)."""

    def dev(a):
        return torch.as_tensor(np.array(a), device=device)

    return SpectralCtx(
        inv_mvp=np.asarray(inv_mvp, np.float32),
        seed_bits=int(np.asarray(seed_bits).astype(np.uint32)),
        extinction=np.float32(extinction),
        blur=np.float32(blur),
        max_bounces=int(max_bounces),
        light_direction=np.asarray(light_direction, np.float32),
        density=PackedVolume(dev(density_table), tuple(density_dims)),
        material_tf=dev(np.asarray(material_tf, np.float32)),
        light_spectrum=dev(np.asarray(light_spectrum, np.float32)),
        boundaries=np.asarray(boundaries, np.float32),
        bin_xyz=dev(np.asarray(bin_xyz, np.float32)),
    )
