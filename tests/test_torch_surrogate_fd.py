"""Finite differences of the port's own forward against the port's
surrogate gradients, in exact and majorant mode: the statistical protocol
of tests/test_grad_fd.py:250-272 and tests/test_majorant_grad.py:129-145,
on the port's plain versions.

Seeds are sample streams: a renderer with S streams per pixel runs S
independent chains per pixel in one batch (stream s seeds as pixel row
y + s * res), so one render of S streams stands for S single-stream renders
of different seeds. Per-stream image sums give the common-random-numbers
central differences and their standard error; the gradient of the
stream-mean image's sum is the mean of the per-stream gradients. Scene,
sizes, steps, seed counts (768 for the differences, 192 for the gradients)
and thresholds (4 standard errors + 15% of the larger magnitude) are
those of the JAX tests; the majorant grid keeps their 30% headroom.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vpt_tpu_torch import (Camera, LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig,
                           Volume)
from vpt_tpu_torch.kernels import corners as C
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.ops.majorant import build_majorant_grid
from vpt_tpu_torch.ops.spectral import XYZ_TO_SRGB_KERNEL

torch.set_num_threads(1)

RES, STEPS, NBINS = 8, 64, 12
N_FD_SEEDS, N_AD_SEEDS = 768, 192
SEED = 2654435761


def _table():
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.7
    table[..., 1] = 0.1 + 0.8 * dens
    table[..., 2] = 0.6
    return table


def _scene(streams, majorant):
    vol = Volume.sphere_in_cube(8)
    cfg = MCMSpectralConfig(extinction=4.0, bounces=3, steps=STEPS)
    r = TM.MCMSpectralRenderer(vol, MaterialTF(_table()), LightConfig(direction=(0.0, 0.0, 0.0)),
                               SpectrumConfig(), cfg, resolution=RES, streams=streams,
                               device="cpu")
    ctx = r.ctx(Camera(), SEED)
    if majorant:
        ctx = dataclasses.replace(ctx, majorant=torch.as_tensor(build_majorant_grid(
            vol.density, _table(), cfg.extinction, block=4, safety=0.3)))
    raw = dict(density=torch.as_tensor(np.asarray(vol.density, np.float32)),
               material_tf=torch.as_tensor(_table()),
               light_spectrum=torch.as_tensor(np.asarray(r.light.spectrum_array(), np.float32)),
               extinction=torch.tensor(np.float32(cfg.extinction)))
    return r, ctx, raw


def _packed(ctx, p):
    return dataclasses.replace(
        ctx, density=interp.PackedVolume(C.pack_volume_diff(p["density"]), ctx.density.dims),
        material_tf=C.pack_tf_diff(p["material_tf"], p["light_spectrum"]),
        extinction=p["extinction"])


def _stream_sums(r, ctx, p):
    """Per-stream sums of the image after one STEPS-step dispatch."""
    with torch.no_grad():
        c = _packed(ctx, p)
        state = r.reset(Camera(), SEED)
        K.step(state, dataclasses.replace(c, extinction=np.float32(float(p["extinction"]))),
               [SEED], STEPS, NBINS)
        w = (torch.as_tensor(XYZ_TO_SRGB_KERNEL, dtype=torch.float32) @ ctx.bin_xyz).sum(0)
        return torch.einsum("bshw,b->s", state.radiance, w).numpy().astype(np.float64)


@pytest.fixture(scope="module", params=["exact", "majorant"])
def case(request):
    majorant = request.param == "majorant"
    r_ad, ctx_ad, raw = _scene(N_AD_SEEDS, majorant)
    p = {k: v.clone().requires_grad_(True) for k, v in raw.items()}
    img = TM.render_sequence_diff([SEED], r_ad.reset(Camera(), SEED), _packed(ctx_ad, p), STEPS,
                                  NBINS)
    # the stream-mean image's sum: its gradient is the per-stream mean
    grads = dict(zip(p, torch.autograd.grad(img.sum(), list(p.values()))))
    r_fd, ctx_fd, _ = _scene(N_FD_SEEDS, majorant)
    return dict(mode=request.param, ad=grads, r=r_fd, ctx=ctx_fd, raw=raw)


def _fd(case, field, direction, eps):
    plus = dict(case["raw"], **{field: case["raw"][field] + eps * direction})
    minus = dict(case["raw"], **{field: case["raw"][field] - eps * direction})
    diffs = (_stream_sums(case["r"], case["ctx"], plus)
             - _stream_sums(case["r"], case["ctx"], minus)) / (2 * eps)
    return float(diffs.mean()), float(diffs.std() / np.sqrt(len(diffs)))


def _assert_close(name, fd, se, val):
    tol = 4 * se + 0.15 * max(abs(fd), abs(val))
    assert abs(fd - val) < tol, f"{name}: FD {fd:.4f}±{se:.4f} vs AD {val:.4f} (tol {tol:.4f})"


def test_fd_extinction(case):
    fd, se = _fd(case, "extinction", torch.tensor(1.0), 0.25)
    assert se < 0.5 * abs(fd) + 0.2
    _assert_close(f"{case['mode']} extinction", fd, se, float(case["ad"]["extinction"]))


def test_fd_density_voxels(case):
    fd, se = _fd(case, "density", torch.ones_like(case["raw"]["density"]), 0.03)
    _assert_close(f"{case['mode']} density", fd, se, float(case["ad"]["density"].sum()))


def test_fd_tf_alpha_texels(case):
    d = torch.zeros_like(case["raw"]["material_tf"])
    d[..., 1] = 1.0
    fd, se = _fd(case, "material_tf", d, 0.03)
    _assert_close(f"{case['mode']} tf_alpha", fd, se,
                  float(case["ad"]["material_tf"][..., 1].sum()))
