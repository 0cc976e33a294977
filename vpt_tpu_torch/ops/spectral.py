"""Color science: the CIE 1931 tables, the per-bin coefficients, the
XYZ->sRGB matrices (numpy), and the two functions that run on image tensors.

The numpy half is the port's copy of ``vpt_tpu/ops/spectral.py``, reading
the port's own copy of the CIE 1931 color-matching functions
(``vpt_tpu_torch/data/cie1931.npz``, 360-830 nm at 1 nm, public measurement
data as vendored by pbrt-v3).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

_DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data", "cie1931.npz")


@functools.lru_cache(maxsize=1)
def cie_1931():
    """Return (wavelengths, X, Y, Z) arrays: 1nm steps from 360 to 830 nm."""
    d = np.load(_DATA)
    first = int(d["first_wavelength"])
    step = int(d["step"])
    n = d["X"].shape[0]
    lams = first + step * np.arange(n)
    return lams, d["X"], d["Y"], d["Z"]


# Linear-sRGB (D65) matrix of the reference's in-kernel display conversion
# (MCMSpectralComputeRenderer.wgsl:319-326); Spectrum.js:21-26 uses a
# slightly higher-precision variant, kept for the host path.
XYZ_TO_SRGB_KERNEL = np.array(
    [
        [3.240479, -1.537150, -0.498536],
        [-0.969255, 1.875990, 0.041556],
        [0.055647, -0.204041, 1.057311],
    ],
    dtype=np.float32,
)

XYZ_TO_SRGB_HOST = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    dtype=np.float64,
)


def bin_coefficients(boundaries):
    """Per-bin mean CIE XYZ coefficients for the binned spectral estimator.

    ``boundaries``: (n_bins+1,) wavelengths. For each bin, averages the 1nm
    CIE samples with wavelength in [b_i, b_{i+1}) as the reference's
    compute_spectral_coefficients (WebGPUMCMSpectralComputeRenderer.js
    :379-412) does, edge behavior included (samples below b_0 skipped; the
    running-bin scan bumps the bin index at each boundary crossing).

    Returns (x, y, z): three (n_bins,) float64 arrays.
    """
    boundaries = np.asarray(boundaries, np.float64)
    n_bins = len(boundaries) - 1
    lams, X, Y, Z = cie_1931()
    coeff = np.zeros((3, n_bins))
    weight = np.zeros(n_bins)
    b = 0
    for i, lam in enumerate(lams):
        if lam < boundaries[0]:
            continue
        if lam >= boundaries[b + 1]:
            b += 1
        if b >= n_bins:
            break
        weight[b] += 1
        coeff[0, b] += X[i]
        coeff[1, b] += Y[i]
        coeff[2, b] += Z[i]
    coeff /= weight
    return coeff[0], coeff[1], coeff[2]


def spectrum_representation_buffer(boundaries, max_len=64):
    """The flat f32 spectrum representation of the reference's kernels:
    [n_bins, boundaries[n+1], x[n], y[n], z[n]] zero-padded to ``max_len``
    (WebGPUMCMSpectralComputeRenderer.js:311-312)."""
    boundaries = np.asarray(boundaries, np.float64)
    n = len(boundaries) - 1
    x, y, z = bin_coefficients(boundaries)
    flat = np.concatenate([[n], boundaries, x, y, z]).astype(np.float32)
    assert len(flat) <= max_len, "spectrum representation exceeds buffer size"
    out = np.zeros(max_len, np.float32)
    out[: len(flat)] = flat
    return out


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
