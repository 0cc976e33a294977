"""The port's super-voxel majorant, quasicubic and environment-map modes
against vpt_tpu on the same seeds.

Small sizes (24-48 px, 16-32^3 volumes, 12 bins). Renders are held to the
oracle contract of ``tests/test_mcm_spectral_parity.py``: at least 99.5% of
pixel channels within 1e-3 relative, at least 99% of lanes with equal
sample counts. Environment-map deposits go through asin, whose derivative
is unbounded at the poles, so ulp-level direction differences between two
libms can move a near-polar deposit by up to 4.1e-3 (ROADMAP C); the env
contract allows that on the channels outside the 1e-3 band.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.kernels import spectral_backward as TB
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.optim import fit_spectral
from vpt_tpu_torch.scene.camera import Camera as TCamera

torch.set_num_threads(1)

FIELDS = JM.SpectralState._fields
EXT = 20.0
POLAR_ALLOWANCE = 4.1e-3


def _ramp_tf(g_ramp=True):
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5 + 0.3 * dens if g_ramp else 0.5
    return MaterialTF(table)


def _envmap(seed=5, shape=(8, 16, 3)):
    return np.random.default_rng(seed).uniform(0.1, 1.0, size=shape).astype(np.float32)


def _args(size=16, filt="linear"):
    return (Volume(Volume.sphere_in_cube(size).density, filter=filt), _ramp_tf(),
            LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
            MCMSpectralConfig(extinction=EXT, bounces=4, steps=6))


def _port_ctx(jctx, volume_filter="linear"):
    opt = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return convert.ctx_from_numpy(
        inv_mvp=np.asarray(jctx.inv_mvp), seed_bits=np.asarray(jctx.seed_bits),
        extinction=np.asarray(jctx.extinction), blur=np.asarray(jctx.blur),
        max_bounces=np.asarray(jctx.max_bounces),
        light_direction=np.asarray(jctx.light_direction),
        density_table=np.asarray(jctx.density.table), density_dims=jctx.density.dims,
        material_tf=np.asarray(jctx.material_tf),
        light_spectrum=np.asarray(jctx.light_spectrum),
        boundaries=np.asarray(jctx.boundaries), bin_xyz=np.asarray(jctx.bin_xyz),
        environment=opt(jctx.environment), majorant=opt(jctx.majorant),
        volume_filter=volume_filter, device="cpu")


def _contract(img, ref, samples, ref_samples, polar=0.0):
    img, ref = np.asarray(img), np.asarray(ref)
    diff = np.abs(img - ref)
    within = diff / (np.abs(ref) + 1e-3) < 1e-3
    assert within.mean() > 0.995, f"only {within.mean():.1%} of pixel channels match"
    assert np.median(diff) < 1e-5
    if polar:
        assert diff[~within].max(initial=0.0) <= polar, diff.max()
    assert np.mean(np.asarray(samples) == np.asarray(ref_samples)) > 0.99
    assert np.asarray(samples).sum() > 0, "no samples completed"


def _carried_render(kw, filt, seeds=((11, 12), (13,)), polar=0.0):
    """Both packages run the same dispatches from one JAX state and ctx."""
    args = _args(filt=filt)
    rj = JM.MCMSpectralRenderer(*args, resolution=24, streams=2, **kw)
    cam = Camera()
    sj = rj.reset(cam, 5)
    st = convert.state_from_numpy({k: np.asarray(getattr(sj, k)) for k in FIELDS}, "cpu")
    jctx = rj.ctx(cam, 5)
    tctx = _port_ctx(jctx, filt)
    for s in seeds:
        sj, img_j = JM.render_many(sj, jctx, np.asarray(s, np.uint32), steps=6, n_bins=12,
                                   volume_filter=filt)
        st, img_t = TM.render_many(st, tctx, s, steps=6, n_bins=12)
    _contract(img_t.numpy(), img_j, st.samples.numpy(), sj.samples, polar)
    return st, sj


@pytest.mark.parametrize("majorant,filt", [(True, "linear"), (False, "quasicubic"),
                                           (True, "quasicubic")])
def test_majorant_and_quasicubic_render_many_match_jax(majorant, filt):
    kw = dict(majorant_blocks=4) if majorant else {}
    st, sj = _carried_render(kw, filt)
    for k in ("bounces", "bin"):
        assert np.mean(getattr(st, k).numpy() == np.asarray(getattr(sj, k))) > 0.99, k


def test_renderer_modes_match_jax_from_reset():
    """The port's renderer builds the same majorant grid and packed env
    table as vpt_tpu's and renders the same image from its own reset."""
    env = _envmap()
    args = _args(filt="quasicubic")
    kw = dict(majorant_blocks=4, environment=env)
    rj = JM.MCMSpectralRenderer(*args, resolution=24, **kw)
    rt = TM.MCMSpectralRenderer(*convert.scene_from(*args), resolution=24, device="cpu", **kw)
    cam, tcam = Camera(), TCamera()
    jc, tc = rj.ctx(cam, 0), rt.ctx(tcam, 0)
    np.testing.assert_array_equal(tc.majorant.numpy(), np.asarray(jc.majorant))
    np.testing.assert_array_equal(tc.environment.numpy(), np.asarray(jc.environment))
    assert tc.volume_filter == "quasicubic"
    sj, st = rj.reset(cam, 3), rt.reset(tcam, 3)
    sj, ij = rj.render_many(sj, cam, [21, 22])
    st, it = rt.render_many(st, tcam, [21, 22])
    _contract(it.numpy(), ij, st.samples.numpy(), sj.samples, POLAR_ALLOWANCE)


def _converged(renderer, seed, dispatches=96):
    cam = TCamera()
    state = renderer.reset(cam, seed)
    seeds = [(seed + k + 1) * 2654435761 % 2**32 for k in range(dispatches)]
    state, img = renderer.render_many(state, cam, seeds)
    return img.numpy(), int(state.samples.sum())


def test_majorant_image_parity_and_progress():
    """Port of tests/test_majorant.py::test_majorant_image_parity_and_progress:
    the majorant image agrees with the exact one within the exact path's
    own seed-to-seed noise floor, and paths finish in fewer steps."""
    def renderer(blocks):
        return TM.MCMSpectralRenderer(
            *convert.scene_from(Volume.sphere_in_cube(32), _ramp_tf(g_ramp=False),
                                LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
                                MCMSpectralConfig(extinction=EXT, bounces=8, steps=8)),
            resolution=48, majorant_blocks=blocks, device="cpu")

    img_a, paths_a = _converged(renderer(None), seed=1)
    img_b, _ = _converged(renderer(None), seed=991)
    img_m, paths_m = _converged(renderer(4), seed=1)
    floor = np.abs(img_a - img_b).mean()
    diff = np.abs(img_a - img_m).mean()
    assert diff < 2.0 * floor + 1e-4, (diff, floor)
    assert abs(img_a.mean() - img_m.mean()) < 0.1 * img_a.mean() + 1e-5
    assert paths_m > paths_a


def test_sample_environment_matches_jax():
    rng = np.random.default_rng(11)
    env = rng.uniform(size=(8, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(4096, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs[:4] = [[0, 1, 0], [0, -1, 0], [1e-8, 1, 0], [0, 0, -1]]  # poles, seam
    lams = rng.uniform(400.0, 700.0, size=4096).astype(np.float32)
    lams[4:7] = [500.0, 600.0, 499.99997]  # the band edges
    ctx_like = type("C", (), {})()
    ctx_like.environment = jnp.asarray(_pack(env))
    want = np.asarray(JM._sample_environment(ctx_like, *(jnp.asarray(dirs[:, i]) for i in range(3)),
                                             jnp.asarray(lams)))
    got = K.sample_environment(torch.as_tensor(_pack(env)),
                               *(torch.as_tensor(dirs[:, i]) for i in range(3)),
                               torch.as_tensor(lams)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _pack(env):
    from vpt_tpu_torch.ops.interp import pack_tex2d_corners

    return pack_tex2d_corners(env)


def test_env_render_matches_jax():
    """The env-mode render over several dispatches, carried from one JAX
    state, to the contract with the near-polar allowance."""
    _carried_render(dict(environment=_envmap()), "linear", seeds=((31, 32), (33, 34)),
                    polar=POLAR_ALLOWANCE)


def test_envmap_renderer_runs_and_differs():
    """Port of tests/test_spectral_envmap.py::test_envmap_renderer_runs_and_differs."""
    vol, *args = convert.scene_from(
        Volume.sphere_in_cube(16), MaterialTF.constant(0.8, 0.6), LightConfig(),
        SpectrumConfig(), MCMSpectralConfig(extinction=20.0, steps=6))
    cam = TCamera()
    env = np.zeros((4, 8, 3), np.float32)
    env[..., 0] = 1.0  # red only: deposits land in the bins above 600 nm
    re = TM.MCMSpectralRenderer(vol, *args, resolution=16, environment=env, device="cpu")
    rl = TM.MCMSpectralRenderer(vol, *args, resolution=16, device="cpu")
    se, sl = re.reset(cam, 3), rl.reset(cam, 3)
    for f in range(4):
        se, ie = re.render(se, cam, f + 1)
        sl, il = rl.render(sl, cam, f + 1)
    assert bool(torch.isfinite(ie).all()) and not torch.equal(ie, il)
    rad = se.radiance.numpy()
    bounds = np.asarray(re.spectrum.boundaries)
    assert rad[bounds[1:] > 600.0].max() > 0.0
    assert rad[bounds[:-1] < 600.0][:, se.samples.numpy() > 0].max() == 0.0


def test_ctx_from_numpy_carries_env_and_majorant():
    env = _envmap()
    args = _args(filt="quasicubic")
    rj = JM.MCMSpectralRenderer(*args, resolution=16, environment=env, majorant_blocks=8)
    rt = TM.MCMSpectralRenderer(*convert.scene_from(*args), resolution=16, environment=env,
                                majorant_blocks=8, device="cpu")
    cam = Camera()
    carried = _port_ctx(rj.ctx(cam, 9), "quasicubic")
    own = rt.ctx(convert.camera_from(cam), 9)
    for f in dataclasses.fields(own):
        a, b = getattr(carried, f.name), getattr(own, f.name)
        if f.name == "density":
            assert a.dims == b.dims and torch.equal(a.table, b.table)
        elif torch.is_tensor(b):
            assert torch.equal(a, b), f.name
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f.name)
    assert carried.majorant.shape == (2, 2, 2, 2) and carried.environment.shape == (9, 17, 12)


@pytest.mark.parametrize("mode", ["majorant", "environment", "quasicubic"])
def test_backward_raises_for_the_new_modes(mode):
    """The packed backward refuses the majorant mode, with the reference's
    own error, before it tapes anything; the environment and quasicubic
    modes, ported since, run through every entry point: the PRB backward
    (environment gradients included), the taped forward, and fit_spectral
    by both methods."""
    args = list(_args())
    kw = {}
    if mode == "majorant":
        kw = dict(majorant_blocks=4)
    elif mode == "environment":
        kw = dict(environment=_envmap())
    else:
        args[0] = Volume(args[0].density, filter="quasicubic")
    r = TM.MCMSpectralRenderer(*convert.scene_from(*args), resolution=8, device="cpu", **kw)
    cam = TCamera()
    ctx, state = r.ctx(cam, 1), r.reset(cam, 1)
    g = torch.ones(8, 8, 3)
    fit_args = (np.zeros((8, 8, 3), np.float32), r, cam, {"density": np.asarray(args[0].density)})
    if mode == "majorant":
        with pytest.raises(NotImplementedError, match=mode):
            TB.prb_render_and_grads(state, ctx, g, 6, 12)
        with pytest.raises(NotImplementedError):
            TB.tape_forward(state, ctx, [1], 6, 12)
        with pytest.raises(NotImplementedError):  # the plain taped forward, called directly
            TB.tape_forward_plain(state, ctx, [1], 6, 12)
        # fit_spectral routes the majorant mode to the autodiff surrogate and
        # refuses a forced PRB with the reference's ValueError
        with pytest.raises(ValueError, match=mode):
            fit_spectral(*fit_args, iterations=1, scatter_stride=1, method="prb")
        return
    wrt = TB.ALL_WRT | {"environment"}
    _, img, grads = TB.prb_render_and_grads(state, ctx, g, 6, 12, ctx.volume_filter, wrt=wrt)
    assert set(grads) == (wrt if mode == "environment" else TB.ALL_WRT)
    assert bool(torch.isfinite(img).all())
    for k, v in grads.items():
        assert bool(torch.isfinite(v).all()), k
    if mode == "environment":
        assert grads["environment"].shape == (8, 16, 3)
        assert float(grads["environment"].abs().sum()) > 0
        assert float(grads["light_spectrum"].abs().sum()) == 0.0  # never sampled
    # the taped forward leaves the forward step's state and tapes the mode's
    # fields (the tape against JAX's, field by field: test_torch_prb_modes.py)
    out, tapes = TB.tape_forward(state, ctx, [1], 6, 12, wrt)
    fwd = TB.clone_state(state)
    K.step(fwd, ctx, [1], 6, 12)
    for a, b in zip(out.tensors(), fwd.tensors()):
        assert torch.equal(a, b)
    assert tapes.shape[2] == len(TB.ctx_tape_fields(ctx, wrt))
    assert ("env_row" in TB.ctx_tape_fields(ctx, wrt)) == (mode == "environment")
    for method in ("prb", "autodiff"):
        params, losses = fit_spectral(*fit_args, iterations=1, scatter_stride=1, method=method,
                                      dispatches_per_step=1)
        assert np.isfinite(losses).all() and params["density"].shape == (16, 16, 16)
    # raw and partly packed tables render in these modes, and their
    # surrogate raises (the next slice's); the packed backward refuses the
    # nearest filter as the reference's assertion does; the surrogate over
    # an xy volume raises
    for pack in (False, {"density_xy", "material_tf"}):
        r2 = TM.MCMSpectralRenderer(*convert.scene_from(*args), resolution=8, pack_tables=pack,
                                    device="cpu", **kw)
        _, img2 = r2.render(r2.reset(cam, 1), cam, 2)
        assert bool(torch.isfinite(img2).all())
        with pytest.raises(NotImplementedError, match="next slice"):
            fit_spectral(np.zeros((8, 8, 3), np.float32), r2, cam,
                         {"density": np.asarray(args[0].density)}, iterations=1,
                         method="autodiff")
    with pytest.raises(AssertionError, match="linear/quasicubic"):
        TB.prb_render_and_grads(state, ctx, g, 6, 12, "nearest")
    xy = TM.MCMSpectralRenderer(*convert.scene_from(*args), resolution=8, device="cpu",
                                pack_tables={"density_xy", "material_tf", "light_spectrum"}, **kw)
    with pytest.raises(NotImplementedError, match="xy"):
        fit_spectral(np.zeros((8, 8, 3), np.float32), xy, cam,
                     {"density": np.asarray(args[0].density)}, iterations=1, method="autodiff")
