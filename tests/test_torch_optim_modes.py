"""The port's fit_spectral on env-lit, quasicubic and xy renderers against
vpt_tpu.optim.fit_spectral.

Trajectories at the tolerances of tests/test_torch_optim.py (losses rtol
1e-4, params rtol 5e-4 / atol 5e-6): PRB learning the environment map
(the reference's 1x1 env recovery, tests/test_spectral_inverse.py:82-118,
shortened), PRB learning an xy density, an env-lit majorant renderer
routed to the autodiff surrogate, and a quasicubic renderer, which both
packages fit with the linear filter (the reference's loss and PRB step
pass no filter). Sizes: 8-16 px, 4-16^3 volumes, 2-3 iterations.
"""

import numpy as np
import pytest
import torch

from vpt_tpu import optim as JO
from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch import optim as TO
from vpt_tpu_torch.kernels import spectral_backward as TB
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.scene.camera import Camera as TCamera

torch.set_num_threads(1)

XY = {"density_xy", "material_tf", "light_spectrum"}


def _ramp_tf():
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    return MaterialTF(table)


def _both(scene, **kw):
    return (JM.MCMSpectralRenderer(*scene, **kw),
            TM.MCMSpectralRenderer(*convert.scene_from(*scene), device="cpu", **kw))


def _follow(jr, tr, target, init, **kw):
    params_j, losses_j = JO.fit_spectral(target, jr, Camera(), init, **kw)
    params_t, losses_t = TO.fit_spectral(target, tr, TCamera(), init, **kw)
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    for k in init:
        got, want = params_t[k].numpy(), np.asarray(params_j[k])
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-6, err_msg=k)
        assert np.abs(got - np.asarray(init[k])).max() > 0, f"{k} did not move"
    return params_t, losses_t


def _env_scene(env):
    return (Volume(density=np.zeros((4, 4, 4), np.float32)),
            MaterialTF.constant(albedo=0.0, alpha=0.0), LightConfig(direction=(0.0, 0.0, 0.0)),
            SpectrumConfig(), MCMSpectralConfig(extinction=2.0, bounces=0, steps=4))


def test_prb_env_fit_follows_jax():
    """The reference's 1x1 env recovery (PRB, wrt={environment}), 3
    iterations against a target rendered by the port with the true map."""
    true_env = np.asarray([[[0.8, 0.45, 0.2]]], np.float32)
    _, rt = _both(_env_scene(true_env), resolution=8, environment=true_env)
    cam = TCamera()
    seeds = [int(np.uint32((5 + k + 1) * 2654435761 % 2**32)) for k in range(16)]
    _, target = rt.render_many(rt.reset(cam, 5), cam, seeds)
    init = np.full((1, 1, 3), 0.5, np.float32)
    jr, tr = _both(_env_scene(init), resolution=8, environment=init)
    _follow(jr, tr, target.numpy(), {"environment": init}, dispatches_per_step=4, iterations=3,
            learning_rate=0.02, seed=11, method="prb", scatter_stride=1)


def test_prb_xy_density_fit_follows_jax():
    scene = (Volume.sphere_in_cube(8), _ramp_tf(), LightConfig(direction=(1.0, 0.2, 0.5)),
             SpectrumConfig(), MCMSpectralConfig(extinction=20.0, bounces=4, steps=8))
    jr, tr = _both(scene, resolution=8, pack_tables=XY)
    assert tr.vol_kind == "xy"
    init = {"density": np.full((8, 8, 8), 0.6, np.float32), "extinction": np.float32(20.0)}
    _follow(jr, tr, np.full((8, 8, 3), 0.1, np.float32), init, dispatches_per_step=2,
            iterations=3, learning_rate=0.05, method="prb", scatter_stride=2)


def test_env_lit_majorant_fit_routes_to_autodiff_and_follows_jax():
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 1] = 0.1 + 0.8 * dens
    table[..., 2] = 0.5  # g = 0: a g of -1 makes jax.grad's HG chain NaN on every lane
    scene = (Volume.sphere_in_cube(8), MaterialTF(table), LightConfig(direction=(0.0, 0.0, 0.0)),
             SpectrumConfig(), MCMSpectralConfig(extinction=4.0, bounces=2, steps=4))
    env = np.random.default_rng(3).uniform(0.1, 1.0, (4, 8, 3)).astype(np.float32)
    jr, tr = _both(scene, resolution=8, majorant_blocks=4, environment=env)
    init = {"density": np.full((8, 8, 8), 0.4, np.float32), "environment": env * 0.8}
    _, _, info = TO.fit_spectral(np.zeros((8, 8, 3), np.float32), tr, TCamera(),
                                 {"density": init["density"]}, iterations=1,
                                 dispatches_per_step=1, return_info=True)
    assert info["method"] == "autodiff"
    _follow(jr, tr, np.full((8, 8, 3), 0.2, np.float32), init, dispatches_per_step=2,
            iterations=2, learning_rate=0.05, seed=3)


@pytest.mark.parametrize("method", ["prb", "autodiff"])
def test_quasicubic_renderer_fits_with_the_linear_filter_as_jax(method):
    """Both packages fit a quasicubic renderer with the linear filter: the
    trajectories agree, and the port's equals its fit on the same scene
    with a linear renderer bit for bit."""
    vol = Volume(density=np.asarray(Volume.sphere_in_cube(8).density), filter="quasicubic")
    scene = (vol, _ramp_tf(), LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
             MCMSpectralConfig(extinction=20.0, bounces=4, steps=8))
    jr, tr = _both(scene, resolution=8)
    assert tr.ctx(TCamera(), 0).volume_filter == "quasicubic"
    init = {"density": np.full((8, 8, 8), 0.6, np.float32)}
    target = np.full((8, 8, 3), 0.1, np.float32)
    kw = dict(dispatches_per_step=2, iterations=2, learning_rate=0.05, method=method,
              scatter_stride=2)
    params, losses = _follow(jr, tr, target, init, **kw)
    lin = TM.MCMSpectralRenderer(*convert.scene_from(Volume(density=vol.density), *scene[1:]),
                                 resolution=8, device="cpu")
    params_l, losses_l = TO.fit_spectral(target, lin, TCamera(), init, **kw)
    assert losses_l == losses and torch.equal(params_l["density"], params["density"])


def test_unported_fit_options_raise():
    """The surrogate over an xy volume runs (tests/test_torch_surrogate_xy.py
    follows JAX's trajectories); learning the environment needs an env-lit
    renderer, and an unknown key raises."""
    scene = (Volume.sphere_in_cube(8), _ramp_tf(), LightConfig(direction=(1.0, 0.2, 0.5)),
             SpectrumConfig(), MCMSpectralConfig(extinction=20.0, bounces=4, steps=4))
    _, tr = _both(scene, resolution=8, pack_tables=XY)
    args = (np.zeros((8, 8, 3), np.float32), tr, TCamera(),
            {"density": np.full((8, 8, 8), 0.6, np.float32)})
    TB.reset_launch_counts()
    params, losses, info = TO.fit_spectral(*args, iterations=1, method="autodiff",
                                           return_info=True)
    assert info["method"] == "autodiff" and np.isfinite(losses).all()
    assert params["density"].shape == (8, 8, 8)
    _, tl = _both(scene, resolution=8)
    with pytest.raises(ValueError, match="env-lit"):
        TO.fit_spectral(np.zeros((8, 8, 3), np.float32), tl, TCamera(),
                        {"environment": np.ones((2, 4, 3), np.float32)}, iterations=1,
                        method="prb", scatter_stride=1)
    with pytest.raises(NotImplementedError, match="albedo"):
        TO.fit_spectral(np.zeros((8, 8, 3), np.float32), tl, TCamera(),
                        {"albedo": np.ones(3, np.float32)}, iterations=1, method="prb",
                        scatter_stride=1)
