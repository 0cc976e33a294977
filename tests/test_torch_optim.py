"""The port's PRB inverse loop (vpt_tpu_torch.optim) against vpt_tpu.optim.

Trajectory parity at the tolerances tests/test_slab.py holds the slab loop
to (losses rtol 1e-4, params rtol 5e-4), the stride policy on the r4 study
scenes, and the end-to-end alpha recovery of
tests/test_prb_packed.py::test_fit_spectral_prb_recovers_alpha on the
port's plain versions.
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

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

RES = 16
STEPS = 8
FIELDS = JM.SpectralState._fields


def _ramp_tf():
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    return table


def _smoothed(density, factor):
    """tools/convergence_stride.py's blockwise-mean init."""
    d = np.asarray(density, np.float32)
    n = d.shape[0]
    c = d.reshape(n // factor, factor, n // factor, factor, n // factor, factor).mean(axis=(1, 3, 5))
    return np.repeat(np.repeat(np.repeat(c, factor, 0), factor, 1), factor, 2)


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    p = {"a": rng.random((5, 4)).astype(np.float32), "b": rng.random(7).astype(np.float32)}
    opt_j = optax.adam(0.02)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    sj = opt_j.init(pj)
    opt_t = TO.Adam(0.02)
    pt = {k: torch.as_tensor(v) for k, v in p.items()}
    st = opt_t.init(pt)
    for _ in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
        u, sj = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        pj = optax.apply_updates(pj, u)
        pt, st = opt_t.update({k: torch.as_tensor(v) for k, v in g.items()}, st, pt)
    # f32 ops in optax's order; pow(b, t) and the moments round alike to a
    # few ulps after five steps
    for k in p:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-5, atol=1e-6)


def test_sanitize_grads_matches_jax():
    g = np.array([np.nan, np.inf, -np.inf, 5e3, -2.0, 0.5], np.float32)
    want = JO.sanitize_grads({"d": jnp.asarray(g)}, 1e3)["d"]
    got = TO.sanitize_grads({"d": torch.as_tensor(g)}, 1e3)["d"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prb_step_trajectory_matches_jax():
    """Three Adam steps of make_spectral_prb_step from one carried state,
    ctx and init: the port's trajectory follows the JAX one."""
    jr = JM.MCMSpectralRenderer(
        Volume.sphere_in_cube(16), MaterialTF(_ramp_tf()), LightConfig(direction=(1.0, 0.2, 0.5)),
        SpectrumConfig(), MCMSpectralConfig(extinction=20.0, bounces=4, steps=STEPS),
        resolution=RES)
    cam = Camera()
    jctx, js0 = jr.ctx(cam, 2), jr.reset(cam, 2)
    tctx = convert.ctx_from_numpy(
        inv_mvp=np.asarray(jctx.inv_mvp), seed_bits=np.asarray(jctx.seed_bits),
        extinction=np.asarray(jctx.extinction), blur=np.asarray(jctx.blur),
        max_bounces=np.asarray(jctx.max_bounces), light_direction=np.asarray(jctx.light_direction),
        density_table=np.asarray(jctx.density.table), density_dims=jctx.density.dims,
        material_tf=np.asarray(jctx.material_tf), light_spectrum=np.asarray(jctx.light_spectrum),
        boundaries=np.asarray(jctx.boundaries), bin_xyz=np.asarray(jctx.bin_xyz), device="cpu")
    ts0 = convert.state_from_numpy({k: np.asarray(getattr(js0, k)) for k in FIELDS}, "cpu")
    before = TB.clone_state(ts0)
    init = np.clip(_smoothed(Volume.sphere_in_cube(16).density, 4) * 0.8 + 0.15, 0, 1)
    target = np.full((RES, RES, 3), 0.2, np.float32)
    wrt = frozenset({"density"})

    step_j = JO.make_spectral_prb_step(optax.adam(0.02), STEPS, 12, wrt=wrt)
    pj = {"density": jnp.asarray(init)}
    ij = JO.InverseState(pj, optax.adam(0.02).init(pj), jnp.zeros((), jnp.int32))
    opt_t = TO.Adam(0.02)
    pt = {"density": torch.as_tensor(init)}
    it = TO.InverseState(pt, opt_t.init(pt), 0)
    step_t = TO.make_spectral_prb_step(opt_t, STEPS, 12, wrt=wrt)
    losses_j, losses_t = [], []
    for i in range(3):
        seeds = [(3 + 2 * i + k) * 2654435761 % 2**32 for k in range(2)]
        ij, lj = step_j(ij, js0, jctx, jnp.asarray(seeds, jnp.uint32), jnp.asarray(target))
        it, lt = step_t(it, ts0, tctx, seeds, torch.as_tensor(target))
        losses_j.append(float(lj))
        losses_t.append(float(lt))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    got, want = it.params["density"].numpy(), np.asarray(ij.params["density"])
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-6)
    assert np.abs(got - init).max() > 0, "the steps did not move the params"
    for a, b in zip(ts0.tensors(), before.tensors()):
        assert torch.equal(a, b), "the step modified its input state"


def test_live_gradient_fraction_and_policy_match_jax():
    """The stride probe on the r4 study scenes (optim.py:296-298, 128^3,
    bench TF): the same fractions and the same (mode, stride)."""
    tf = _ramp_tf()
    scenes = [(Volume.sphere_in_cube(128).density, 8), (Volume.two_spheres(128).density, 16),
              (Volume.two_spheres(128).density, 8), (Volume.sparse_spheres(128).density, 8)]
    modes = []
    for dens, factor in scenes:
        init = _smoothed(dens, factor)
        assert TO.live_gradient_fraction(init, tf) == JO.live_gradient_fraction(init, tf)
        assert TO.auto_initial_policy(init, tf) == JO.auto_initial_policy(init, tf)
        assert TO.auto_initial_stride(init, tf) == JO.auto_initial_stride(init, tf)
        modes.append(TO.auto_initial_policy(init, tf)[0])
    assert modes[0] == "stride" and modes[1] == "importance"
    det_t, det_j = TO.EvalStallDetector(), JO.EvalStallDetector()
    for v in (1.0, 0.9, 0.89, 0.885, 0.5, 0.49, 0.489):
        assert det_t.update(v) == det_j.update(v)


def _alpha_renderer(alpha):
    vol = Volume(density=np.full((4, 4, 4), 0.5, np.float32))
    return TM.MCMSpectralRenderer(
        *convert.scene_from(vol, MaterialTF.constant(albedo=0.0, alpha=alpha),
                            LightConfig(direction=(0.0, 0.0, 0.0)), SpectrumConfig(),
                            MCMSpectralConfig(extinction=2.0, bounces=0, steps=8)),
        resolution=RES, device="cpu")


def test_fit_spectral_prb_recovers_alpha():
    """End-to-end config-4 shape on the port: recover a TF alpha from a
    packed-tables renderer at tests/test_prb_packed.py's size."""
    true_alpha = 0.6
    r = _alpha_renderer(true_alpha)
    cam = TCamera()
    state = r.reset(cam, 5)
    seeds = [int(np.uint32((5 + k + 1) * 2654435761 % 2**32)) for k in range(64)]
    state, target = r.render_many(state, cam, seeds)
    r2 = _alpha_renderer(0.2)
    params, losses = TO.fit_spectral(
        target.numpy(), r2, cam, {"material_tf": r2.material_tf.table.copy()},
        dispatches_per_step=6, iterations=120, learning_rate=0.05, seed=11, scatter_stride=2)
    mt = params["material_tf"].numpy()
    rec_alpha = float(mt[127:129, :, 1].mean())
    untouched = float(mt[0:100, :, 1].mean())
    assert losses[-1] < losses[0], f"loss did not drop: {losses[0]} -> {losses[-1]}"
    assert rec_alpha > 0.4, f"alpha barely moved: {rec_alpha}"
    assert abs(rec_alpha - true_alpha) < abs(0.2 - true_alpha)
    assert untouched == pytest.approx(0.2, abs=1e-5)


def test_fit_spectral_auto_policy_leaves_state0_untouched():
    """One iteration under scatter_stride="auto" (the probe picks a mode),
    learning density and extinction; the reset state it renders from every
    iteration stays bit-unchanged."""
    r = TM.MCMSpectralRenderer(
        *convert.scene_from(Volume.sphere_in_cube(8), MaterialTF(_ramp_tf()),
                            LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
                            MCMSpectralConfig(extinction=20.0, bounces=4, steps=STEPS)),
        resolution=8, device="cpu")
    seen = []
    reset = r.reset

    def recording_reset(*a, **kw):
        s = reset(*a, **kw)
        seen.append((s, TB.clone_state(s)))
        return s

    r.reset = recording_reset
    init = {"density": np.full((8, 8, 8), 0.6, np.float32), "extinction": np.float32(20.0)}
    params, losses, info = TO.fit_spectral(np.zeros((8, 8, 3), np.float32), r, TCamera(), init,
                                           dispatches_per_step=2, iterations=1,
                                           return_info=True)
    assert info["method"] == "prb" and info["live_fraction"] > 0.15
    assert info["stride_history"] == [(0, "stride:4")]
    assert np.isfinite(losses).all() and params["extinction"].shape == ()
    assert float(params["extinction"]) != 20.0
    state0, copy = seen[0]
    for a, b in zip(state0.tensors(), copy.tensors()):
        assert torch.equal(a, b)


def test_unported_options_raise():
    r = _alpha_renderer(0.2)
    args = (np.zeros((RES, RES, 3), np.float32), r, TCamera(),
            {"material_tf": r.material_tf.table.copy()})
    with pytest.raises(ValueError):
        TO.fit_spectral(*args, method="sgd", iterations=1)
    # the packed PRB refuses the majorant mode, as vpt_tpu.optim does
    rm = TM.MCMSpectralRenderer(
        *convert.scene_from(Volume.sphere_in_cube(8), MaterialTF(_ramp_tf()),
                            LightConfig(direction=(0.0, 0.0, 0.0)), SpectrumConfig(),
                            MCMSpectralConfig(extinction=4.0, bounces=2, steps=4)),
        resolution=8, majorant_blocks=4, device="cpu")
    with pytest.raises(ValueError, match="majorant"):
        TO.fit_spectral(np.zeros((8, 8, 3), np.float32), rm, TCamera(),
                        {"density": np.full((8, 8, 8), 0.4, np.float32)}, iterations=1,
                        method="prb")


def _majorant_renderers():
    """tests/test_majorant_grad.py::test_fit_spectral_majorant_routes_to_autodiff's
    scene, in both packages."""
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 1] = 0.1 + 0.8 * dens
    scene = (Volume.sphere_in_cube(8), MaterialTF(table), LightConfig(direction=(0.0, 0.0, 0.0)),
             SpectrumConfig(), MCMSpectralConfig(extinction=4.0, bounces=2, steps=4))
    jr = JM.MCMSpectralRenderer(*scene, resolution=8, pack_tables=True, majorant_blocks=4)
    tr = TM.MCMSpectralRenderer(*convert.scene_from(*scene), resolution=8, majorant_blocks=4,
                                device="cpu")
    return jr, tr


def test_fit_spectral_majorant_routes_to_autodiff():
    """method=None on a majorant renderer runs the surrogate (JAX
    test_majorant_grad.py:159); the target is the port's own render."""
    _, r = _majorant_renderers()
    cam = TCamera()
    _, target = r.render_many(r.reset(cam, 1), cam, [5, 6])
    init = np.full((8, 8, 8), 0.4, np.float32)
    params, losses, info = TO.fit_spectral(target.numpy(), r, cam, {"density": init},
                                           iterations=2, dispatches_per_step=2, return_info=True)
    assert info["method"] == "autodiff" and info["stride_history"] == [(0, "autodiff")]
    assert np.isfinite(losses).all() and len(losses) == 2
    assert np.abs(params["density"].numpy() - init).max() > 0


@pytest.mark.parametrize("method", ["prb", "autodiff"])
def test_fit_spectral_on_compacted_renderer_raises_like_jax(method):
    """ROADMAP C's open check: vpt_tpu's fit_spectral fails on a compacted
    renderer (its compacted reset state does not broadcast against the
    pixel grid: ValueError), so the port refuses it with ValueError too."""
    scene = (Volume.sphere_in_cube(8), MaterialTF(_ramp_tf()),
             LightConfig(direction=(0.6, 0.3, 0.2)), SpectrumConfig(),
             MCMSpectralConfig(extinction=4.0, bounces=3, steps=4))
    jr = JM.MCMSpectralRenderer(*scene, resolution=8, compaction=True)
    tr = TM.MCMSpectralRenderer(*convert.scene_from(*scene), resolution=8, compaction=True,
                                device="cpu")
    init = {"density": np.full((8, 8, 8), 0.4, np.float32)}
    kw = dict(iterations=1, dispatches_per_step=2, method=method, scatter_stride=1)
    with pytest.raises(ValueError):
        JO.fit_spectral(np.zeros((8, 8, 3), np.float32), jr, Camera(), init, **kw)
    with pytest.raises(ValueError, match="compacted"):
        TO.fit_spectral(np.zeros((8, 8, 3), np.float32), tr, TCamera(), init, **kw)


def _ckpt_renderer():
    return TM.MCMSpectralRenderer(
        *convert.scene_from(Volume.sphere_in_cube(8), MaterialTF(_ramp_tf()),
                            LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
                            MCMSpectralConfig(extinction=20.0, bounces=4, steps=STEPS)),
        resolution=8, device="cpu")


@pytest.mark.parametrize("method", ["prb", "autodiff"])
def test_checkpoint_resume_is_bit_identical(method, tmp_path):
    """Two iterations, a checkpoint, a resume to four: the same params bit
    for bit as four straight iterations (seeds derive from the iteration
    index; the plain versions have no atomics)."""
    r = _ckpt_renderer()
    cam = TCamera()
    init = {"density": np.full((8, 8, 8), 0.6, np.float32), "extinction": np.float32(20.0)}
    target = np.full((8, 8, 3), 0.1, np.float32)
    kw = dict(dispatches_per_step=2, method=method, scatter_stride=2, learning_rate=0.05)
    straight, losses = TO.fit_spectral(target, r, cam, init, iterations=4, **kw)
    path = str(tmp_path / "inverse.npz")
    TO.fit_spectral(target, r, cam, init, iterations=2, checkpoint=path, **kw)
    assert int(np.load(path)["leaf_7"]) == 2  # the step, the last leaf
    resumed, rest = TO.fit_spectral(target, r, cam, init, iterations=4, checkpoint=path, **kw)
    assert rest == losses[2:]
    for k in straight:
        assert torch.equal(resumed[k], straight[k]), k
    assert np.abs(straight["density"].numpy() - 0.6).max() > 0


def test_checkpoints_interchange_with_jax(tmp_path):
    """A port-written checkpoint loads in vpt_tpu.optim.load_inverse_checkpoint
    (leaf order and dtypes), and a JAX-written one resumes in the port: the
    port's continuation from JAX's state after two iterations follows JAX's
    own continuation (losses rtol 1e-4, params rtol 5e-4 / atol 5e-6, the
    trajectory tolerances above)."""
    jr = JM.MCMSpectralRenderer(
        Volume.sphere_in_cube(8), MaterialTF(_ramp_tf()), LightConfig(direction=(1.0, 0.2, 0.5)),
        SpectrumConfig(), MCMSpectralConfig(extinction=20.0, bounces=4, steps=STEPS),
        resolution=8)
    r = _ckpt_renderer()
    init = {"density": np.full((8, 8, 8), 0.6, np.float32), "extinction": np.float32(20.0)}
    target = np.full((8, 8, 3), 0.1, np.float32)
    kw = dict(dispatches_per_step=2, method="prb", scatter_stride=2, learning_rate=0.05)

    # port -> JAX
    path_t = str(tmp_path / "port.npz")
    params_t, _ = TO.fit_spectral(target, r, TCamera(), init, iterations=2, checkpoint=path_t, **kw)
    pj = {k: jnp.asarray(v) for k, v in init.items()}
    template = JO.InverseState(pj, optax.adam(0.05).init(pj), jnp.zeros((), jnp.int32))
    loaded = JO.load_inverse_checkpoint(path_t, template)
    assert int(loaded.step) == 2 and int(loaded.opt_state[0].count) == 2
    for k in init:
        np.testing.assert_array_equal(np.asarray(loaded.params[k]), params_t[k].numpy())
    assert loaded.params["extinction"].dtype == jnp.float32

    # JAX -> port
    path_j, path_p = str(tmp_path / "jax.npz"), str(tmp_path / "jax_for_port.npz")
    JO.fit_spectral(target, jr, Camera(), init, iterations=2, checkpoint=path_j, **kw)
    with open(path_j, "rb") as src, open(path_p, "wb") as dst:
        dst.write(src.read())
    params_j, losses_j = JO.fit_spectral(target, jr, Camera(), init, iterations=3,
                                         checkpoint=path_j, **kw)
    params_p, losses_p = TO.fit_spectral(target, r, TCamera(), init, iterations=3,
                                         checkpoint=path_p, **kw)
    assert len(losses_p) == len(losses_j) == 1
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-4)
    for k in init:
        np.testing.assert_allclose(params_p[k].numpy(), np.asarray(params_j[k]), rtol=5e-4,
                                   atol=5e-6, err_msg=k)


def test_autodiff_step_trajectory_matches_jax():
    """Three Adam steps of make_spectral_inverse_step (the surrogate) from
    one carried state, ctx and init, learning density and extinction: the
    port's trajectory follows the JAX one."""
    jr = JM.MCMSpectralRenderer(
        Volume.sphere_in_cube(16), MaterialTF(_ramp_tf()), LightConfig(direction=(1.0, 0.2, 0.5)),
        SpectrumConfig(), MCMSpectralConfig(extinction=20.0, bounces=4, steps=STEPS),
        resolution=RES)
    cam = Camera()
    jctx, js0 = jr.ctx(cam, 2), jr.reset(cam, 2)
    tctx = convert.ctx_from_numpy(
        inv_mvp=np.asarray(jctx.inv_mvp), seed_bits=np.asarray(jctx.seed_bits),
        extinction=np.asarray(jctx.extinction), blur=np.asarray(jctx.blur),
        max_bounces=np.asarray(jctx.max_bounces), light_direction=np.asarray(jctx.light_direction),
        density_table=np.asarray(jctx.density.table), density_dims=jctx.density.dims,
        material_tf=np.asarray(jctx.material_tf), light_spectrum=np.asarray(jctx.light_spectrum),
        boundaries=np.asarray(jctx.boundaries), bin_xyz=np.asarray(jctx.bin_xyz), device="cpu")
    ts0 = convert.state_from_numpy({k: np.asarray(getattr(js0, k)) for k in FIELDS}, "cpu")
    before = TB.clone_state(ts0)
    init = {"density": np.clip(_smoothed(Volume.sphere_in_cube(16).density, 4) * 0.8 + 0.15, 0, 1),
            "extinction": np.float32(20.0)}
    target = np.full((RES, RES, 3), 0.2, np.float32)
    step_j = JO.make_spectral_inverse_step(optax.adam(0.02), STEPS, 12)
    pj = {k: jnp.asarray(v) for k, v in init.items()}
    ij = JO.InverseState(pj, optax.adam(0.02).init(pj), jnp.zeros((), jnp.int32))
    opt_t = TO.Adam(0.02)
    pt = {k: torch.as_tensor(v) for k, v in init.items()}
    it = TO.InverseState(pt, opt_t.init(pt), 0)
    step_t = TO.make_spectral_inverse_step(opt_t, STEPS, 12)
    losses_j, losses_t = [], []
    for i in range(3):
        seeds = [(3 + 2 * i + k) * 2654435761 % 2**32 for k in range(2)]
        ij, lj = step_j(ij, js0, jctx, jnp.asarray(seeds, jnp.uint32), jnp.asarray(target))
        it, lt = step_t(it, ts0, tctx, seeds, torch.as_tensor(target))
        losses_j.append(float(lj))
        losses_t.append(float(lt))
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    for k in init:
        got, want = it.params[k].numpy(), np.asarray(ij.params[k])
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-6, err_msg=k)
    assert np.abs(it.params["density"].numpy() - init["density"]).max() > 0
    for a, b in zip(ts0.tensors(), before.tensors()):
        assert torch.equal(a, b), "the step modified its input state"
