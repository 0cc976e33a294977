"""Color science on torch tensors.

The CIE tables, the per-bin coefficients and the XYZ->sRGB matrices are
numpy and come from ``vpt_tpu.ops.spectral``, which loads no jax; this
module adds the two functions that run on image tensors.
"""

from __future__ import annotations

import torch

from vpt_tpu.ops.spectral import (  # noqa: F401  (re-exported)
    XYZ_TO_SRGB_HOST,
    XYZ_TO_SRGB_KERNEL,
    bin_coefficients,
)


def xyz_to_rgb_linear(xyz: torch.Tensor, matrix=XYZ_TO_SRGB_KERNEL) -> torch.Tensor:
    """XYZ -> linear sRGB. ``xyz``: (..., 3) tensor."""
    m = torch.as_tensor(matrix, dtype=xyz.dtype, device=xyz.device)
    return xyz @ m.T


def srgb_gamma(rgb_linear: torch.Tensor) -> torch.Tensor:
    """sRGB opto-electronic transfer (gamma) curve, elementwise."""
    return torch.where(
        rgb_linear <= 0.0031308,
        12.92 * rgb_linear,
        1.055 * torch.abs(rgb_linear) ** (1 / 2.4) - 0.055,
    )
