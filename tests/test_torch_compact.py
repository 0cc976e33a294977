"""The port's hit-lane compaction against vpt_tpu.models.mcm_spectral_compact:
the numpy host helpers bit for bit, compact_image's plain version, and
the ports of tests/test_compact.py's renderer-level checks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.models import mcm_spectral_compact as JC
from vpt_tpu.scene.camera import Camera, OrbitController
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.models import mcm_spectral_compact as TC
from vpt_tpu_torch.scene.camera import Camera as TCamera
from vpt_tpu_torch.session import RenderSession

torch.set_num_threads(1)

RES = 24
BOUNDS = np.asarray(SpectrumConfig().boundaries, np.float32)


def _table():
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    return table


def _envmap(seed=5):
    return np.random.default_rng(seed).uniform(0.1, 1.0, size=(8, 16, 3)).astype(np.float32)


def _kw(streams=2, steps=6, **extra):
    return dict(volume=Volume.sphere_in_cube(16), material_tf=MaterialTF(_table()),
                light=LightConfig(direction=(1.0, 0.2, 0.5)), spectrum=SpectrumConfig(),
                config=MCMSpectralConfig(extinction=30.0, bounces=8, steps=steps),
                resolution=RES, streams=streams, **extra)


def _tkw(streams=2, steps=6, **extra):
    """``_kw`` with the port's own scene and config types."""
    kw = _kw(streams, steps, **extra)
    for k in ("volume", "material_tf", "light", "spectrum", "config"):
        kw[k] = convert.scene_from(kw[k])
    return kw


def _renderers(**kw):
    return (TM.MCMSpectralRenderer(**_tkw(**kw), device="cpu"),
            TM.MCMSpectralRenderer(**_tkw(**kw), compaction=True, device="cpu"))


def _orbit_cam(yaw=0.7, pitch=-0.3):
    cam = Camera()
    OrbitController(yaw=yaw, pitch=pitch).apply(cam)
    return cam


INV = Camera().inverse_mvp()
INV_ORBIT = _orbit_cam().inverse_mvp()
LIGHT = LightConfig(direction=(1.0, 0.2, 0.5)).spectrum_array()
ENV = _envmap()
UV = np.random.default_rng(3).uniform(-0.2, 1.2, size=(2, 64, 64))
HIT = JC.hit_pixel_mask(INV, RES)

HELPERS = {
    "unproject": lambda M: M._unproject_np(INV, UV[0], UV[1], 0.25),
    "hit_mask_default_pose": lambda M: M.hit_pixel_mask(INV, RES),
    "hit_mask_orbit": lambda M: M.hit_pixel_mask(INV_ORBIT, 17),
    "hit_mask_frustum_filling": lambda M: M.hit_pixel_mask(
        Camera(translation=np.array([0, 0, 1.2])).inverse_mvp(), RES),
    "light_raw": lambda M: M._light_raw_np(LIGHT, UV[0]),
    "bin_light_integrals": lambda M: M.bin_light_integrals(LIGHT, BOUNDS, 12),
    "mean_gain_image": lambda M: M.mean_gain_image(INV, RES, (1.0, 0.2, 0.5)),
    "mean_gain_isotropic": lambda M: M.mean_gain_image(INV, RES, (0.0, 0.0, 0.0)),
    "analytic_miss_radiance": lambda M: M.analytic_miss_radiance(
        INV_ORBIT, RES, LIGHT, (1.0, 0.2, 0.5), BOUNDS, 12),
    "band_bin_fractions": lambda M: M.band_bin_fractions(np.linspace(380, 720, 7), 6),
    "bilinear": lambda M: M._bilinear_np(ENV, UV[0], UV[1]),
    "mean_env_image": lambda M: M.mean_env_image(INV, RES, ENV),
    "analytic_miss_radiance_env": lambda M: M.analytic_miss_radiance_env(
        INV_ORBIT, RES, ENV, BOUNDS, 12),
    "lane_tables": lambda M: M.build_lane_tables(HIT, RES, 3),
    "lane_tables_unbucketed": lambda M: M.build_lane_tables(HIT, RES, 2, row_bucket=1),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_host_helpers_equal_jax(name):
    got, want = HELPERS[name](TC), HELPERS[name](JC)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            assert np.array_equal(got[k], want[k]), k
    else:
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_hit_pixel_index_orders_like_lane_tables():
    idx = TC.hit_pixel_index(HIT)
    t = TC.build_lane_tables(HIT, RES, 2)
    n = t["n_hit"]
    assert (idx >= 0).sum() == n and idx.dtype == np.int32
    # hit pixel k's first stream lane is lane k
    np.testing.assert_array_equal(t["lane_pixel"][:n], np.nonzero(idx >= 0)[0])
    np.testing.assert_array_equal(idx[t["lane_pixel"][:n]], np.arange(n))


@pytest.mark.parametrize("streams", [1, 2, 4])
def test_compact_image_plain_matches_jax(streams):
    t = JC.build_lane_tables(HIT, RES, streams)
    rng = np.random.default_rng(streams)
    rad = rng.uniform(0, 2, size=(12,) + t["lane_ix"].shape).astype(np.float32)
    miss = rng.uniform(0, 1, size=(12, RES, RES)).astype(np.float32)
    bx = np.asarray(TM.MCMSpectralRenderer(**_tkw(), device="cpu").bin_xyz)
    state = JM.SpectralState(**{k: jnp.zeros(1) for k in JM.SpectralState._fields
                                if k != "radiance"}, radiance=jnp.asarray(rad))
    want = np.asarray(JC.compact_image(state, jnp.asarray(t["lane_pixel"]), jnp.asarray(HIT),
                                       jnp.asarray(miss), jnp.asarray(bx), RES, streams))
    tstate = type("S", (), {"radiance": torch.as_tensor(rad)})()
    got = TC.compact_image(tstate, torch.as_tensor(TC.hit_pixel_index(HIT)), t["n_hit"],
                           torch.as_tensor(miss), torch.as_tensor(bx), streams).numpy()
    # the XYZ -> RGB products sum in another order than XLA's (as in
    # test_torch_session.py::test_display_conversion_matches_jax)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the per-pixel radiance itself: stream sums in order, then / S
    per_pixel = K.compact_radiance_plain(torch.as_tensor(rad), torch.as_tensor(
        TC.hit_pixel_index(HIT)), torch.as_tensor(miss), t["n_hit"], streams).numpy()
    lanes = rad.reshape(12, -1)[:, :streams * t["n_hit"]].reshape(12, streams, -1)
    acc = np.zeros((12, t["n_hit"]), np.float32)
    for s in range(streams):
        acc = acc + lanes[:, s]
    expect = miss.copy().reshape(12, -1)
    expect[:, HIT.reshape(-1)] = acc / np.float32(streams)
    np.testing.assert_array_equal(per_pixel, expect.reshape(12, RES, RES))


def test_hit_pixels_match_full_kernel():
    full, comp = _renderers()
    cam = TCamera()
    seeds = [(k + 1) * 2654435761 % 2**32 for k in range(10)]
    sf = full.reset(cam, seeds[0])
    sf, img_full = full.render_many(sf, cam, seeds)
    sc = comp.reset(cam, seeds[0])
    sc, img_comp = comp.render_many(sc, cam, seeds)
    hit = comp._compact_tables(cam)["hit"].numpy()
    np.testing.assert_allclose(img_comp.numpy()[hit], img_full.numpy()[hit],
                               rtol=1e-5, atol=1e-6)


def test_compact_matches_jax_compact():
    """The port's compacted renderer against vpt_tpu's, from the same JAX
    compact state: the oracle contract on the image, and equal tables."""
    jc = JM.MCMSpectralRenderer(**_kw(), compaction=True)
    tc = TM.MCMSpectralRenderer(**_tkw(), compaction=True, device="cpu")
    cam = Camera()
    tcam = convert.camera_from(cam)
    jt, tt = jc._compact_tables(cam), tc._compact_tables(tcam)
    for k in ("hit", "miss", "lane_ix", "lane_iy", "lane_seed_iy", "lane_pixel"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]), err_msg=k)
    sj = jc.reset(cam, 4)
    st = tc.reset(tcam, 4)
    for k in JM.SpectralState._fields:
        np.testing.assert_allclose(getattr(st, k).numpy(), np.asarray(getattr(sj, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    seeds = [(k + 3) * 2654435761 % 2**32 for k in range(4)]
    sj, ij = jc.render_many(sj, cam, seeds)
    st = convert.state_from_numpy({k: np.asarray(getattr(jc.reset(cam, 4), k))
                                   for k in JM.SpectralState._fields}, "cpu")
    st, it = tc.render_many(st, tcam, seeds)
    ij, it = np.asarray(ij), it.numpy()
    d = np.abs(it - ij)
    assert np.mean(d / (np.abs(ij) + 1e-3) < 1e-3) > 0.995 and np.median(d) < 1e-5
    assert np.mean(st.samples.numpy() == np.asarray(sj.samples)) > 0.99


def test_compact_deterministic_and_padded_lanes_harmless():
    _, comp = _renderers()
    cam = TCamera()
    seeds = [(k + 7) * 2654435761 % 2**32 for k in range(4)]
    s1 = comp.reset(cam, 7)
    s1, i1 = comp.render_many(s1, cam, seeds)
    s2 = comp.reset(cam, 7)
    s2, i2 = comp.render_many(s2, cam, seeds)
    assert torch.equal(i1, i2) and bool(torch.isfinite(i1).all())
    t = comp._compact_tables(cam)
    n_used = t["n_hit"] * comp.streams
    assert t["lane_pixel"].numel() >= n_used
    # the padding lanes hold radiance, and changing it changes no pixel
    assert t["lane_pixel"].numel() > n_used
    s1.radiance.reshape(12, -1)[:, n_used:] = 1e6
    i3 = TC.compact_image(s1, t["pixel_hit"], t["n_hit"], t["miss"], comp.bin_xyz, comp.streams)
    assert torch.equal(i1, i3)


def test_compact_composes_with_majorant_and_quasicubic():
    kw = _tkw(majorant_blocks=4)
    kw["volume"] = convert.volume_from(Volume(kw["volume"].density, filter="quasicubic"))
    full = TM.MCMSpectralRenderer(**kw, device="cpu")
    comp = TM.MCMSpectralRenderer(**kw, compaction=True, device="cpu")
    cam = TCamera()

    def run(r, seed0, n=120):
        s = r.reset(cam, seed0)
        s, img = r.render_many(s, cam, [(seed0 + k + 1) * 2654435761 % 2**32
                                        for k in range(n)])
        return img.numpy()

    a, b = run(full, 1), run(full, 991)
    c = run(comp, 1)
    hit = comp._compact_tables(cam)["hit"].numpy()
    floor = np.abs(a[hit] - b[hit]).mean()
    diff = np.abs(c[hit] - a[hit]).mean()
    assert np.isfinite(c).all()
    assert diff < 2.0 * floor + 1e-4, (diff, floor)


def test_compact_session_checkpoint_resume(tmp_path):
    """A compacted session's (M, res) state checkpoints and resumes bit for
    bit, as tests/test_compact.py::test_compact_session_checkpoint_resume."""
    k = _kw(steps=4)
    args = (k["volume"], k["material_tf"], k["light"], k["spectrum"], k["config"])
    kw = dict(tonemapper="artistic", resolution=RES, base_seed=3, streams=2,
              compaction=True, device="cpu")
    targs = convert.scene_from(*args)
    a = RenderSession("mcm-spectral", *targs, **kw)
    a.run(6)
    b = RenderSession("mcm-spectral", *targs, **kw)
    b.run(3)
    assert b.state.px.ndim == 2 and b.state.px.shape[-1] == RES
    ck = str(tmp_path / "compact.npz")
    b.save_checkpoint(ck)
    c = RenderSession("mcm-spectral", *targs, **kw)
    c.load_checkpoint(ck)
    c.run(3)
    np.testing.assert_array_equal(c.hdr_image(), a.hdr_image())
    # the port's compact checkpoint loads into vpt_tpu's compact session
    from vpt_tpu.session import RenderSession as JaxSession

    j = JaxSession("mcm-spectral", *args, tonemapper="artistic", resolution=RES, base_seed=3,
                   streams=2, compaction=True)
    j.load_checkpoint(ck)
    for x, y in zip(j.state, b.state.tensors()):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_compact_envmap_spectral():
    env = _envmap()
    full, comp = _renderers(environment=env)
    cam = TCamera()
    seeds = [(k + 1) * 2654435761 % 2**32 for k in range(10)]
    sf = full.reset(cam, seeds[0])
    sf, img_full = full.render_many(sf, cam, seeds)
    sc = comp.reset(cam, seeds[0])
    sc, img_comp = comp.render_many(sc, cam, seeds)
    hit = comp._compact_tables(cam)["hit"].numpy()
    np.testing.assert_allclose(img_comp.numpy()[hit], img_full.numpy()[hit],
                               rtol=1e-5, atol=1e-6)

    def converged(seed0):
        s = full.reset(cam, seed0)
        s, img = full.render_many(s, cam, [(seed0 + k + 1) * 2654435761 % 2**32
                                           for k in range(150)])
        return img.numpy()

    a, b = converged(1), converged(991)
    miss = ~hit
    assert miss.any()
    floor = np.abs(a[miss] - b[miss]).mean()
    diff = np.abs(img_comp.numpy()[miss] - a[miss]).mean()
    assert diff < 2.0 * floor + 1e-4, (diff, floor)


def test_compact_cache_bounded_and_bucketed():
    _, comp = _renderers(streams=1)
    shapes = set()
    for k in range(12):
        t = comp._compact_tables(convert.camera_from(_orbit_cam(2 * np.pi * k / 12)))
        shapes.add(tuple(t["lane_ix"].shape))
    assert len(comp._compact_cache) <= comp.COMPACT_CACHE_POSES
    assert len(shapes) <= 3, shapes


def test_compaction_config_errors(tmp_path):
    from vpt_tpu_torch import cli

    args = convert.scene_from(Volume.sphere_in_cube(16), MaterialTF(_table()), LightConfig(),
                              SpectrumConfig())
    with pytest.raises(ValueError, match="blur"):
        TM.MCMSpectralRenderer(*args, convert.scene_from(MCMSpectralConfig(extinction=30.0,
                                                                           blur=0.1)),
                               resolution=RES, compaction=True, device="cpu")
    with pytest.raises(ValueError, match="single-device"):
        TM.MCMSpectralRenderer(*args, convert.scene_from(MCMSpectralConfig(extinction=30.0)),
                               resolution=RES,
                               mesh=object(), compaction=True, device="cpu")
    out = tmp_path / "should_not_exist.npy"
    with pytest.raises(SystemExit):
        cli.main(["render", "--renderer", "eam", "--compaction", "--device", "cpu",
                  "--volume-size", "8", "--resolution", "8", "--frames", "1", "-o", str(out)])
    assert not out.exists()
