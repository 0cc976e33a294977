"""The port's autodiff surrogate over raw tables against finite differences
of its own forward, and ``fit_spectral`` on raw renderers against
``vpt_tpu.optim.fit_spectral``.

The finite differences mirror tests/test_grad_fd.py:250-290 (exact mode)
and tests/test_majorant_grad.py:129-147 (majorant mode), which run on the
reference's raw tables (``pack_tables=False``): the port's renderer keeps
the same raw tables, so its surrogate runs in its RAW mode and the
perturbations go into those tables directly. Seeds are sample streams, as
in ``tests/test_torch_surrogate_fd.py``: a renderer with S streams per
pixel runs S independent chains per pixel in one batch, so per-stream image
sums give the common-random-numbers central differences and their standard
error, and the gradient of the stream-mean image's sum is the mean of the
per-stream gradients. Scene, sizes, steps, seed counts (768 for the
differences, 192 for the gradients) and thresholds (4 standard errors + 15%
of the larger magnitude) are those of the JAX tests; the majorant grid
keeps their 30% headroom.

The fits: 3 iterations of ``fit_spectral`` with method=None on raw
renderers in both packages (losses rtol 1e-4, params rtol 5e-4 / atol 5e-6,
as ``tests/test_torch_optim.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vpt_tpu import optim as JO
from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume as JVolume
from vpt_tpu.utils.config import LightConfig as JLight
from vpt_tpu.utils.config import MaterialTF as JMaterialTF
from vpt_tpu.utils.config import MCMSpectralConfig as JConfig
from vpt_tpu.utils.config import SpectrumConfig as JSpectrum
from vpt_tpu_torch import (Camera as TCamera, LightConfig, MaterialTF, MCMSpectralConfig,
                           SpectrumConfig, Volume, convert)
from vpt_tpu_torch import optim as TO
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.ops import interp as TI
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
    """The reference tests' scene over raw tables, and its raw tables."""
    vol = Volume.sphere_in_cube(8)
    cfg = MCMSpectralConfig(extinction=4.0, bounces=3, steps=STEPS)
    r = TM.MCMSpectralRenderer(vol, MaterialTF(_table()), LightConfig(direction=(0.0, 0.0, 0.0)),
                               SpectrumConfig(), cfg, resolution=RES, streams=streams,
                               pack_tables=False, device="cpu")
    ctx = r.ctx(TCamera(), SEED)
    assert r.vol_kind == "raw" and K.is_raw(ctx)
    if majorant:
        ctx = dataclasses.replace(ctx, majorant=torch.as_tensor(build_majorant_grid(
            vol.density, _table(), cfg.extinction, block=4, safety=0.3)))
    raw = dict(density=ctx.density, material_tf=ctx.material_tf,
               extinction=torch.tensor(np.float32(cfg.extinction)))
    return r, ctx, raw


def _stream_sums(r, ctx, p):
    """Per-stream sums of the image after one STEPS-step dispatch over the
    raw tables ``p``."""
    with torch.no_grad():
        c = dataclasses.replace(ctx, density=p["density"], material_tf=p["material_tf"],
                                extinction=np.float32(float(p["extinction"])))
        state = r.reset(TCamera(), SEED)
        K.step(state, c, [SEED], STEPS, NBINS)
        w = (torch.as_tensor(XYZ_TO_SRGB_KERNEL, dtype=torch.float32) @ ctx.bin_xyz).sum(0)
        return torch.einsum("bshw,b->s", state.radiance, w).numpy().astype(np.float64)


@pytest.fixture(scope="module", params=["exact", "majorant"])
def case(request):
    majorant = request.param == "majorant"
    r_ad, ctx_ad, raw = _scene(N_AD_SEEDS, majorant)
    p = {k: v.clone().requires_grad_(True) for k, v in raw.items()}
    img = TM.render_sequence_diff([SEED], r_ad.reset(TCamera(), SEED),
                                  dataclasses.replace(ctx_ad, **p), STEPS, NBINS)
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


def test_fd_extinction_over_raw_tables(case):
    fd, se = _fd(case, "extinction", torch.tensor(1.0), 0.25)
    assert se < 0.5 * abs(fd) + 0.2
    _assert_close(f"{case['mode']} extinction", fd, se, float(case["ad"]["extinction"]))


def test_fd_raw_density_voxels(case):
    fd, se = _fd(case, "density", torch.ones_like(case["raw"]["density"]), 0.03)
    _assert_close(f"{case['mode']} density", fd, se, float(case["ad"]["density"].sum()))


def test_fd_raw_tf_alpha_texels(case):
    d = torch.zeros_like(case["raw"]["material_tf"])
    d[..., 1] = 1.0
    fd, se = _fd(case, "material_tf", d, 0.03)
    _assert_close(f"{case['mode']} tf_alpha", fd, se,
                  float(case["ad"]["material_tf"][..., 1].sum()))


# ---------------------------------------------------------------------------
# fit_spectral on raw renderers against JAX's
# ---------------------------------------------------------------------------
def _ramp_table():
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    return table


@pytest.mark.parametrize("pack,learn", [
    (False, "density"), ({"material_tf", "light_spectrum"}, "material_tf")])
def test_raw_fit_routes_to_autodiff_and_follows_jax(pack, learn):
    """fit_spectral with method=None on a raw renderer (the reference's
    routing: the surrogate), 3 iterations in both packages: a learned
    density packs into the full corner table, a learned TF into the 16-wide
    table beside the base's light pair, in both."""
    scene = (JVolume.sphere_in_cube(8), JMaterialTF(_ramp_table()),
             JLight(direction=(1.0, 0.2, 0.5)), JSpectrum(), JConfig(extinction=20.0, bounces=4,
                                                                     steps=8))
    jr = JM.MCMSpectralRenderer(*scene, resolution=8, pack_tables=pack)
    tr = TM.MCMSpectralRenderer(*convert.scene_from(*scene), resolution=8, pack_tables=pack,
                                device="cpu")
    assert K.is_raw(tr.ctx(TCamera(), 0))
    target = np.full((8, 8, 3), 0.1, np.float32)
    init = ({"density": np.full((8, 8, 8), 0.6, np.float32)} if learn == "density" else
            {"material_tf": np.clip(_ramp_table() * 0.8 + 0.1, 0, 1).astype(np.float32),
             "extinction": np.float32(16.0)})
    fit_kw = dict(dispatches_per_step=2, iterations=3, learning_rate=0.05, seed=3)
    params_j, losses_j = JO.fit_spectral(target, jr, Camera(), init, **fit_kw)
    params_t, losses_t, info = TO.fit_spectral(target, tr, TCamera(), init, return_info=True,
                                               **fit_kw)
    assert info["method"] == "autodiff"
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    for k in init:
        got, want = params_t[k].numpy(), np.asarray(params_j[k])
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-6, err_msg=k)
        assert np.abs(got - init[k]).max() > 0, k
    # the loss's ctx: the layout JAX's pack_params=True gives
    ctx = TO.pack_loss_ctx({k: torch.as_tensor(v) for k, v in init.items()},
                           tr.ctx(TCamera(), 0))
    if learn == "density":
        assert ctx.density.kind == "full" and ctx.density.table.shape == (729, 8)
    else:
        assert ctx.material_tf.shape == (257, 257, 16) and ctx.light_spectrum.shape == (257, 2)
        assert not isinstance(ctx.density, TI.PackedVolume)
