"""The port's spectral MCM forward against vpt_tpu and the NumPy oracle.

Small sizes (16-24 px, a 16^3 volume, 12 bins). The comparison contract is
the one ``tests/test_mcm_spectral_parity.py`` holds the JAX renderer to:
at least 99.5% of image channels within 1e-3 relative, median absolute
difference below 1e-5, at least 99% of lanes with equal sample counts.
Rare ulp differences in log/sin/cos between libms may flip one lane's
event, after which that lane diverges; the allowance covers that.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.reference import oracle
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.scene.camera import Camera as TCamera

torch.set_num_threads(1)

FIELDS = JM.SpectralState._fields


def _ramp_tf():
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5 + 0.3 * dens  # g from 0 to 0.6: both HG branches
    return MaterialTF(table)


def _scene():
    return (Volume.sphere_in_cube(16), _ramp_tf(), LightConfig(direction=(1.0, 0.2, 0.5)),
            SpectrumConfig(), MCMSpectralConfig(extinction=20.0, bounces=4, steps=6))


def _pair(res=24, streams=1):
    args = _scene()
    return (JM.MCMSpectralRenderer(*args, resolution=res, streams=streams),
            TM.MCMSpectralRenderer(*convert.scene_from(*args), resolution=res, streams=streams,
                                   device="cpu"))


def _contract(img, ref, samples, ref_samples):
    img, ref = np.asarray(img), np.asarray(ref)
    diff = np.abs(img - ref)
    frac = np.mean(diff / (np.abs(ref) + 1e-3) < 1e-3)
    assert frac > 0.995, f"only {frac:.1%} of pixel channels match"
    assert np.median(diff) < 1e-5
    assert np.mean(np.asarray(samples) == np.asarray(ref_samples)) > 0.99
    assert np.asarray(samples).sum() > 0, "no samples completed"


def _jax_ctx_to_port(jctx):
    return convert.ctx_from_numpy(
        inv_mvp=np.asarray(jctx.inv_mvp), seed_bits=np.asarray(jctx.seed_bits),
        extinction=np.asarray(jctx.extinction), blur=np.asarray(jctx.blur),
        max_bounces=np.asarray(jctx.max_bounces),
        light_direction=np.asarray(jctx.light_direction),
        density_table=np.asarray(jctx.density.table), density_dims=jctx.density.dims,
        material_tf=np.asarray(jctx.material_tf),
        light_spectrum=np.asarray(jctx.light_spectrum),
        boundaries=np.asarray(jctx.boundaries), bin_xyz=np.asarray(jctx.bin_xyz),
        device="cpu")


@pytest.mark.parametrize("streams", [1, 2])
def test_full_reset_matches_jax(streams):
    # the kernels' argument order and checkpoints both follow the JAX leaf order
    assert TM.SpectralState.field_names() == K.STATE_FIELDS == tuple(FIELDS)
    rj, rt = _pair(streams=streams)
    sj, st = rj.reset(Camera(), 3), rt.reset(TCamera(), 3)
    for k in FIELDS:
        a, b = np.asarray(getattr(sj, k)), getattr(st, k).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k in ("bounces", "samples", "bin", "radiance", "transmittance"):
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("streams", [1, 2])
def test_render_many_matches_jax_from_carried_state(streams):
    """Both packages run the same dispatches from one JAX state and ctx,
    carried across by convert.py."""
    rj, _ = _pair(streams=streams)
    cam = Camera()
    sj = rj.reset(cam, 5)
    st = convert.state_from_numpy({k: np.asarray(getattr(sj, k)) for k in FIELDS}, "cpu")
    jctx = rj.ctx(cam, 5)
    tctx = _jax_ctx_to_port(jctx)
    for seeds in ([11, 12], [13]):
        sj, img_j = JM.render_many(sj, jctx, np.asarray(seeds, np.uint32), steps=6, n_bins=12)
        st, img_t = TM.render_many(st, tctx, seeds, steps=6, n_bins=12)
    _contract(img_t.numpy(), img_j, st.samples.numpy(), sj.samples)
    back = convert.state_to_numpy(st)
    assert list(back) == list(FIELDS)


def test_oracle_contract():
    """Mirror of test_mcm_spectral_parity.py::test_render_dispatch_parity."""
    res = 16
    volume = Volume.sphere_in_cube(16)
    material = MaterialTF.constant(albedo=0.8, alpha=0.7, anisotropy_g=0.3)
    light = LightConfig(direction=(1.0, 0.0, 0.0))
    spectrum = SpectrumConfig()
    config = MCMSpectralConfig(extinction=20.0, bounces=4, steps=6)
    cam = TCamera()
    r = TM.MCMSpectralRenderer(*convert.scene_from(volume, material, light, spectrum, config),
                               resolution=res, device="cpu")
    prm = oracle.OracleParams(
        inv_mvp=cam.inverse_mvp(), resolution=res, seed_bits=42, blur=config.blur,
        extinction=config.extinction, max_bounces=config.bounces, steps=config.steps,
        light_direction=np.asarray(light.direction, np.float32), density=volume.density,
        material_tf=material.table, light_spectrum=light.spectrum_array(),
        spectrum_rep=spectrum.representation_buffer(), max_n_bins=12)
    state = r.reset(cam, seed=42)
    photons = oracle.reset_dispatch(prm)
    for frame_seed in (42, 1337):
        prm.seed_bits = frame_seed
        state, image = r.render(state, cam, frame_seed)
        photons, image_o = oracle.render_dispatch(photons, prm)
    samples_o = np.array([[p.samples for p in row] for row in photons])
    _contract(image.numpy(), image_o, state.samples.numpy(), samples_o)
    assert abs(float(image.mean()) - image_o.mean()) < 2e-3


def test_streams_converge_to_same_image():
    """Mirror of test_packed_tables.py::test_streams_converge_to_same_image."""
    vol, *args = convert.scene_from(
        Volume.sphere_in_cube(16), MaterialTF.constant(0.8, 0.6), LightConfig(),
        SpectrumConfig(), MCMSpectralConfig(extinction=20.0, steps=4))
    cam = TCamera()
    r1 = TM.MCMSpectralRenderer(vol, *args, resolution=16, streams=1, device="cpu")
    r4 = TM.MCMSpectralRenderer(vol, *args, resolution=16, streams=4, device="cpu")
    s1, s4 = r1.reset(cam, 3), r4.reset(cam, 3)
    assert tuple(s4.px.shape) == (4, 16, 16)
    assert torch.equal(s4.px[0], s1.px) and torch.equal(s4.wavelength[0], s1.wavelength)
    s1, i1 = r1.render_many(s1, cam, [f + 1 for f in range(24)])
    s4, i4 = r4.render_many(s4, cam, [f + 1 for f in range(24)])
    i1, i4 = i1.numpy(), i4.numpy()
    assert i4.shape == i1.shape == (16, 16, 3)
    assert np.abs(i1.mean() - i4.mean()) < 0.15
    assert np.corrcoef(i1.ravel(), i4.ravel())[0, 1] > 0.8


def test_render_many_equals_sequential_renders():
    _, rt = _pair(res=16)
    cam = TCamera()
    a, b = rt.reset(cam, 1), rt.reset(cam, 1)
    a, img_a = rt.render_many(a, cam, [7, 8, 9])
    for s in (7, 8, 9):
        b, img_b = rt.render(b, cam, s)
    for x, y in zip(a.tensors(), b.tensors()):
        assert torch.equal(x, y)
    assert torch.equal(img_a, img_b)


def test_packed_tables_bit_equal_to_jax_static_ctx():
    rj, rt = _pair()
    jc, tc = rj.ctx(Camera(), 0), rt.ctx(TCamera(), 0)
    assert tc.density.dims == jc.density.dims
    np.testing.assert_array_equal(tc.density.table.numpy(), np.asarray(jc.density.table))
    for k in ("material_tf", "light_spectrum", "bin_xyz"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)), err_msg=k)
    np.testing.assert_array_equal(tc.boundaries, np.asarray(jc.boundaries))
    np.testing.assert_array_equal(tc.inv_mvp, np.asarray(jc.inv_mvp))
    assert tc.seed_bits == int(jc.seed_bits)
    # the tables are the module's registered buffers
    names = dict(rt.named_buffers())
    assert names["vol_table"] is tc.density.table and names["tf_table"] is tc.material_tf


@pytest.mark.parametrize("option", [
    dict(environment=np.zeros((4, 8, 3), np.float32)),
    dict(majorant_blocks=8),
    dict(mesh=object()),
    dict(compaction=True),
    dict(pack_tables=False),
    dict(pack_tables={"density"}),
    dict(pack_tables=False, streams=2),
    "quasicubic",
])
def test_options_outside_the_slice_raise(option):
    """A mesh that is not a ``parallel.mesh.RayMesh`` raises TypeError (a
    RayMesh renders, tests/test_torch_mesh.py); the environment map, the
    majorant grid, compaction, the quasicubic filter and raw or partly
    packed tables are ported and render finite images."""
    args = list(convert.scene_from(*_scene()))
    kw = {}
    if option == "quasicubic":
        args[0] = convert.volume_from(Volume(args[0].density, filter="quasicubic"))
    else:
        kw = option
    if option == "quasicubic" or set(kw) & {"environment", "majorant_blocks", "compaction",
                                            "pack_tables"}:
        r = TM.MCMSpectralRenderer(*args, resolution=16, device="cpu", **kw)
        cam = TCamera()
        _, img = r.render(r.reset(cam, 1), cam, 2)
        assert img.shape == (16, 16, 3) and bool(torch.isfinite(img).all())
        return
    with pytest.raises(TypeError):
        TM.MCMSpectralRenderer(*args, resolution=16, device="cpu", **kw)


def test_nearest_filter_raises():
    """A nearest volume renders over raw tables (tests/test_torch_raw.py);
    its surrogate, which raised until the RAW mode, runs too: render_diff
    gives the render's bits and a density gradient on the raw grid."""
    args = list(convert.scene_from(*_scene()))
    args[0] = convert.volume_from(Volume(args[0].density, filter="nearest"))
    r = TM.MCMSpectralRenderer(*args, resolution=16, device="cpu")
    cam = TCamera()
    s0 = r.reset(cam, 1)
    _, img = r.render(TM.SpectralState(*(t.clone() for t in s0.tensors())), cam, 2)
    assert r.vol_kind == "raw" and bool(torch.isfinite(img).all())
    ctx = r.ctx(cam, 2)
    d = ctx.density.clone().requires_grad_(True)
    _, _, img_d = TM.render_diff(s0, torch.ones_like(s0.px), dataclasses.replace(ctx, density=d),
                                 r.config.steps, r.spectrum.n_bins, volume_filter="nearest")
    assert torch.equal(img_d.detach(), img)
    (g,) = torch.autograd.grad(img_d.sum(), [d])
    assert g.shape == d.shape and bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0


def test_cuda_route_rejects_mixed_devices_and_counts_nothing_on_cpu():
    K.reset_launch_counts()
    _, rt = _pair(res=16)
    s = rt.reset(TCamera(), 0)
    rt.render_many(s, TCamera(), [1, 2])
    assert set(K.LAUNCHES) >= {"step", "reset", "compact_radiance", "sample_volume_packed"}
    assert not any(K.LAUNCHES.values()), K.LAUNCHES
    with pytest.raises(ValueError):
        K._route(torch.zeros(1), torch.zeros(1, device="meta"))
