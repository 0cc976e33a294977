"""The ray-march renderers (EAM, MIP, ISO, Depth; vpt_tpu_torch/models/
raymarch.py, kernels/raymarch.py) against vpt_tpu's on the CPU, where the
wrappers run the plain versions.

Inputs come from numpy with a seed; volumes are 24^3 (the oracle's 64^3),
images 32^2 (the goldens' 16^2, the oracle's 256^2). The four table modes:
linear on the u8 packed table, an f32 packed table (a smoothed random
density), quasicubic, and nearest on the raw grid.

Tolerances, and why:
- EAM and MIP: rtol 2e-4, atol 2e-5, as tests/test_config1_eam_oracle.py.
  XLA's CPU code contracts the lerps into FMAs, so sample positions differ
  from the port's by an ulp; in nearest mode such a position can cross a
  voxel face and take another voxel, so there 99% of pixels must meet the
  tolerance (the rest differ by a voxel's worth).
- ISO and Depth: thresholds (alpha >= isovalue, the merge's t > 0, acc >=
  threshold) flip on those ulps, so the hit masks must agree on >= 99.5%
  of pixels and the values within 1e-5 where both hit; in nearest mode on
  95% of those (a sample on a voxel face can take the other voxel and
  move the hit by a step).
- ISO shading from the same closest hit: rtol 2e-4, atol 2e-5.
- The goldens: test_golden.py's rtol 1e-4, atol 1e-5.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_tools import GOLDEN_PATH
from vpt_tpu.models import raymarch as JR
from vpt_tpu.reference.eam_numpy import eam_frame_numpy
from vpt_tpu.scene.camera import Camera as JCamera
from vpt_tpu.scene.camera import OrbitController as JOrbit
from vpt_tpu.scene.tf import TransferFunction2D as JTF
from vpt_tpu.scene.volume import Volume as JVolume
from vpt_tpu.session import RenderSession as JaxSession
from vpt_tpu.utils.config import EAMConfig as JEAMConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch.cli import main as cli_main
from vpt_tpu_torch.kernels import raymarch as K
from vpt_tpu_torch.models import raymarch as TR
from vpt_tpu_torch.session import RenderSession
from vpt_tpu_torch.utils.config import EAMConfig

torch.set_num_threads(1)

RES, SIZE = 32, 24
OFFSETS = (0.0, 0.37)
MODES = ("linear_u8", "f32", "quasicubic", "nearest")
RTOL, ATOL = 2e-4, 2e-5
KEYS = ("eam", "mip", "iso", "depth")
JAX_CLASSES = {"eam": JR.EAMRenderer, "mip": JR.MIPRenderer, "iso": JR.ISORenderer,
               "depth": JR.DepthRenderer}
PORT_CLASSES = {"eam": TR.EAMRenderer, "mip": TR.MIPRenderer, "iso": TR.ISORenderer,
                "depth": TR.DepthRenderer}


def _smoothed_random(size, seed):
    d = np.random.default_rng(seed).random((size, size, size)).astype(np.float32)
    for _ in range(3):
        d = (d + np.roll(d, 1, 0) + np.roll(d, 1, 1) + np.roll(d, 1, 2)) / np.float32(4)
    return d


def _jax_volume(mode):
    if mode == "f32":
        return JVolume(density=_smoothed_random(SIZE, 5))
    vol = JVolume.sphere_in_cube(SIZE)
    vol.filter = {"linear_u8": "linear"}.get(mode, mode)
    return vol


@pytest.fixture(scope="module")
def camera():
    cam = JCamera()
    JOrbit(yaw=0.5, pitch=-0.3).apply(cam)
    return cam


@pytest.fixture(scope="module")
def tables():
    """mode -> (JAX density, JAX TF, port density, port TF, filter); the
    ramp TF at alpha scale 2, so the iso-surface takes the cube too."""
    tf = JTF.grayscale_ramp(2.0)
    out = {}
    for mode in MODES:
        vol = _jax_volume(mode)
        jd, jt = JR._pack_if_linear(vol, tf)
        td, tt = TR._pack_if_linear(convert.volume_from(vol), convert.tf2d_from(tf), "cpu")
        out[mode] = (jd, jt, td, tt, vol.filter)
    return out


def _close(a, b, mode):
    ok = np.isclose(b, a, rtol=RTOL, atol=ATOL)
    if ok.ndim == 3:
        ok = ok.all(-1)
    if mode == "nearest":
        assert ok.mean() >= 0.99, f"{ok.mean():.4f} of pixels within tolerance"
    else:
        assert ok.all(), f"{(~ok).sum()} pixels outside tolerance, max |diff| {np.abs(a - b).max()}"


def _hits_agree(ja, ta, jh, th, mode="linear_u8"):
    """ISO and Depth: masks (t > 0 / t >= 0) equal on >= 99.5% of pixels,
    values within 1e-5 where both hit (in nearest mode on 95% of those: a
    sample on a voxel face that takes the other voxel moves the hit by a
    step; 97.9% agree at this pose and offset 0, all at offset 0.37)."""
    assert np.mean(jh == th) >= 0.995, f"hit masks agree on {np.mean(jh == th):.4f}"
    both = jh & th
    assert both.any()
    ok = np.all([np.abs(b[both] - a[both]) <= 1e-5 for a, b in zip(ja, ta)], axis=0)
    share = 0.95 if mode == "nearest" else 1.0
    assert ok.mean() >= share, f"{ok.mean():.4f} of hit pixels within 1e-5"


def _inv(camera):
    return camera.inverse_mvp()


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("mode", MODES)
def test_eam_frame_matches_jax(mode, offset, tables, camera):
    jd, jt, td, tt, filt = tables[mode]
    a = np.asarray(JR.eam_frame(jnp.asarray(_inv(camera)), jd, jt, jnp.float32(100.0),
                                jnp.float32(offset), slices=32, resolution=RES,
                                volume_filter=filt))
    b = K.eam_frame(_inv(camera), td, tt, 100.0, offset, 32, RES, filt).numpy()
    assert a.shape == b.shape == (RES, RES, 3) and b.max() > 0.1
    _close(a, b, mode)


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("mode", MODES)
def test_mip_frame_matches_jax(mode, offset, tables, camera):
    jd, jt, td, tt, filt = tables[mode]
    a = np.asarray(JR.mip_frame(jnp.asarray(_inv(camera)), jd, jt, jnp.float32(offset),
                                steps=32, resolution=RES, volume_filter=filt))
    b = K.mip_frame(_inv(camera), td, tt, offset, 32, RES, filt).numpy()
    assert b.shape == (RES, RES) and b.max() > 0.1
    _close(a, b, mode)


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("mode", MODES)
def test_iso_frame_matches_jax(mode, offset, tables, camera):
    jd, jt, td, tt, filt = tables[mode]
    ja = [np.asarray(x) for x in JR.iso_frame(
        jnp.asarray(_inv(camera)), jd, jt, jnp.float32(0.5), jnp.float32(offset), steps=32,
        resolution=RES, volume_filter=filt)]
    ta = [x.numpy() for x in K.iso_frame(_inv(camera), td, tt, 0.5, offset, 32, RES, filt)]
    assert (ta[3] > 0).mean() > 0.05
    _hits_agree(ja, ta, ja[3] > 0, ta[3] > 0, mode)


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("mode", MODES)
def test_depth_frame_matches_jax(mode, offset, tables, camera):
    jd, jt, td, tt, filt = tables[mode]
    a = np.asarray(JR.depth_frame(jnp.asarray(_inv(camera)), jd, jt, jnp.float32(100.0),
                                  jnp.float32(0.1), jnp.float32(offset), slices=32,
                                  resolution=RES, volume_filter=filt))
    b = K.depth_frame(_inv(camera), td, tt, 100.0, 0.1, offset, 32, RES, filt).numpy()
    assert (b >= 0).mean() > 0.05
    _hits_agree([a], [b], a >= 0, b >= 0, mode)


@pytest.mark.parametrize("mode", MODES)
def test_iso_shade_matches_jax(mode, tables, camera):
    """Both shade JAX's closest hit: the shading alone."""
    jd, jt, td, tt, filt = tables[mode]
    closest = JR.iso_frame(jnp.asarray(_inv(camera)), jd, jt, jnp.float32(0.5),
                           jnp.float32(0.2), steps=32, resolution=RES, volume_filter=filt)
    light = TR.ISORenderer(convert.volume_from(_jax_volume(mode)), resolution=RES,
                           device="cpu")._light_model_space(convert.camera_from(camera))
    a = np.asarray(JR.iso_shade(closest, jd, jt, jnp.asarray(light), jnp.float32(0.005),
                                volume_filter=filt))
    b = K.iso_shade(tuple(torch.as_tensor(np.array(x)) for x in closest), td, tt, light, 0.005,
                    filt).numpy()
    assert (b != 1.0).any(axis=-1).mean() > 0.05
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)


def test_light_model_space_matches_jax(camera):
    vol = JVolume.sphere_in_cube(8)
    j = JR.ISORenderer(vol, resolution=8, light=(1.0, -2.0, 0.5))
    t = TR.ISORenderer(convert.volume_from(vol), resolution=8, light=(1.0, -2.0, 0.5),
                       device="cpu")
    for cam in (camera, JCamera()):
        np.testing.assert_array_equal(t._light_model_space(convert.camera_from(cam)),
                                      j._light_model_space(cam))


@pytest.mark.parametrize("seed", [0, 1, 7, 2654435761, 2**32 - 1, 123456789012])
def test_seed_to_offset_matches_jax(seed):
    assert TR._seed_to_offset(seed) == JR._seed_to_offset(seed)


@pytest.mark.parametrize("offset", OFFSETS)
def test_eam_matches_numpy_oracle_in_baseline_config1(offset):
    """BASELINE config 1: 64^3, 256^2, 64 slices, extinction 80, the raw
    grid and TF as tests/test_config1_eam_oracle.py passes them."""
    vol = JVolume.sphere_in_cube(64)
    tf = np.zeros((256, 256, 4), np.float32)
    tf[..., :3] = (0.9, 0.7, 0.4)
    tf[..., 3] = np.linspace(0, 1, 256)[None, :]
    cam = JCamera()
    JOrbit(yaw=0.5, pitch=-0.3).apply(cam)
    inv = cam.inverse_mvp()
    got = K.eam_frame(inv, torch.as_tensor(vol.density), torch.as_tensor(tf), 80.0, offset, 64,
                      256).numpy()
    want = eam_frame_numpy(inv, vol.density, tf, 80.0, offset, 64, 256)
    assert got.shape == want.shape == (256, 256, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert want.max() > 0.3 and (want.sum(-1) == 0).mean() > 0.1


# -- renderers and sessions --------------------------------------------------
def _golden_scene():
    """tests/golden_tools.py's scene for both packages."""
    volume = JVolume.sphere_in_cube(16)
    table = np.zeros((256, 256, 4), np.float32)
    table[..., :3] = (0.9, 0.7, 0.5)
    table[..., 3] = np.linspace(0, 1, 256)[None, :]
    jtf, ttf = JTF(), convert.tf2d_from(JTF())
    for tf in (jtf, ttf):
        object.__setattr__(tf, "rasterize", lambda quantize=True: table)
    cam = JCamera()
    JOrbit(yaw=0.4, pitch=-0.3).apply(cam)
    return volume, jtf, ttf, cam


GOLDEN_ARGS = {"eam": (lambda tf, cfg: (tf, cfg(extinction=150.0, slices=32)), {}),
               "mip": (lambda tf, cfg: (tf,), dict(steps=32)),
               "iso": (lambda tf, cfg: (tf,), dict(steps=32, isovalue=0.5)),
               "depth": (lambda tf, cfg: (tf,), dict(extinction=400.0, slices=32))}


def _sessions(key, res=16, base_seed=7):
    volume, jtf, ttf, cam = _golden_scene()
    args, kw = GOLDEN_ARGS[key]
    j = JaxSession(key, volume, *args(jtf, JEAMConfig), camera=cam, base_seed=base_seed,
                   resolution=res, **kw)
    t = RenderSession(key, convert.volume_from(volume), *args(ttf, EAMConfig), device="cpu",
                      camera=convert.camera_from(cam), base_seed=base_seed, resolution=res, **kw)
    return j, t


@pytest.mark.parametrize("key", KEYS)
def test_sessions_reproduce_the_goldens(key):
    if not os.path.exists(GOLDEN_PATH):
        pytest.skip("goldens not generated (python tests/golden_tools.py regen)")
    golden = np.load(GOLDEN_PATH)[key]
    _, t = _sessions(key)
    K.reset_launch_counts()
    t.run(3)
    np.testing.assert_allclose(t.hdr_image(), golden, rtol=1e-4, atol=1e-5)
    assert all(v == 0 for v in K.LAUNCHES.values())  # plain versions count nothing


def _compare_images(key, a, b):
    """Session images: EAM and MIP within the frame tolerance; ISO and
    Depth by their miss colour (white) and within 1e-5 / the shading
    tolerance where both hit."""
    if key in ("eam", "mip"):
        _close(a, b, "linear")
        return
    ja, ta = (a != 1.0).any(-1), (b != 1.0).any(-1)
    assert np.mean(ja == ta) >= 0.995
    np.testing.assert_allclose(b[ja & ta], a[ja & ta], rtol=RTOL,
                               atol=1e-5 if key == "depth" else ATOL)


def _compare_states(key, js, ts):
    ts = convert.raymarch_state_to_numpy(ts)
    assert sorted(ts) == sorted(js)
    for k in js:
        assert ts[k].dtype == np.asarray(js[k]).dtype and ts[k].shape == np.asarray(js[k]).shape
    if key == "iso":
        jc = [np.asarray(js[k]) for k in ("cx", "cy", "cz", "ct")]
        tc = [ts[k] for k in ("cx", "cy", "cz", "ct")]
        _hits_agree(jc, tc, jc[3] > 0, tc[3] > 0)
    elif key == "eam":
        _close(np.asarray(js["acc"]), ts["acc"], "linear")
        assert int(ts["frame"]) == int(js["frame"])
    elif key == "mip":
        _close(np.asarray(js["acc"]), ts["acc"], "linear")
    else:
        assert int(ts["frame"]) == int(js["frame"]) == 0


@pytest.mark.parametrize("key", KEYS)
def test_three_frame_session_matches_jax(key):
    j, t = _sessions(key, base_seed=3)
    j.run(3)
    t.run(3)
    assert t.frame == j.frame == 3
    _compare_images(key, j.hdr_image(), t.hdr_image())
    _compare_states(key, j.state, t.state)
    u8 = t.image_u8()
    assert u8.shape == (16, 16, 3) and u8.dtype == np.uint8


@pytest.mark.parametrize("key", KEYS)
def test_metrics_have_jax_keys(key):
    j, t = _sessions(key)
    j.run(2)
    t.run(2)
    assert sorted(t.metrics()) == sorted(j.metrics()) == ["frames", "seconds"]
    assert t.metrics()["frames"] == 2


@pytest.mark.parametrize("key", KEYS)
def test_jax_checkpoint_loads_into_port_and_back(key, tmp_path):
    j, t = _sessions(key)
    j.run(2)
    j.save_checkpoint(str(tmp_path / "jax.npz"))
    t.load_checkpoint(str(tmp_path / "jax.npz"))
    assert t.frame == 2
    for k, v in convert.raymarch_state_to_numpy(t.state).items():
        np.testing.assert_array_equal(v, np.asarray(j.state[k]))
    j.run(1)
    t.run(1)
    _compare_images(key, j.hdr_image(), t.hdr_image())
    # and back: the port's checkpoint loads into a JAX session
    t.save_checkpoint(str(tmp_path / "port.npz"))
    j2, _ = _sessions(key)
    j2.load_checkpoint(str(tmp_path / "port.npz"))
    assert j2.frame == 3
    for k, v in convert.raymarch_state_to_numpy(t.state).items():
        np.testing.assert_array_equal(np.asarray(j2.state[k]), v)


@pytest.mark.parametrize("key", KEYS)
def test_checkpoint_resume_is_exact(key, tmp_path):
    _, a = _sessions(key)
    _, b = _sessions(key)
    a.run(4)
    b.run(2)
    b.save_checkpoint(str(tmp_path / "half.npz"))
    _, c = _sessions(key)
    c.load_checkpoint(str(tmp_path / "half.npz")).run(2)
    np.testing.assert_array_equal(c.hdr_image(), a.hdr_image())


def _random_state(key, rng, res):
    if key == "eam":
        return dict(acc=rng.random((res, res, 3), dtype=np.float32), frame=np.int32(3))
    if key == "mip":
        return dict(acc=rng.random((res, res), dtype=np.float32) * np.float32(0.5))
    if key == "iso":
        ct = np.where(rng.random((res, res)) < 0.5, -1.0, rng.random((res, res))).astype(np.float32)
        return dict(cx=rng.random((res, res), dtype=np.float32),
                    cy=rng.random((res, res), dtype=np.float32),
                    cz=rng.random((res, res), dtype=np.float32), ct=ct)
    return dict(frame=np.int32(0))


@pytest.mark.parametrize("key", KEYS)
def test_render_merges_into_a_given_state_as_jax(key, camera):
    """One render from the same numpy state in both packages: the merges
    (running average, max, closest hit) in place."""
    vol = _jax_volume("linear_u8")
    state = _random_state(key, np.random.default_rng(17), RES)
    jr = JAX_CLASSES[key](vol, resolution=RES)
    tr = PORT_CLASSES[key](convert.volume_from(vol), resolution=RES, device="cpu")
    ts = convert.raymarch_state_from_numpy(state, "cpu")
    js, jimg = jr.render({k: jnp.asarray(v) for k, v in state.items()}, camera, 2024)
    ts2, timg = tr.render(ts, convert.camera_from(camera), 2024)
    assert ts2 is ts  # merged in place
    _compare_images(key, np.asarray(jimg), timg.numpy())
    _compare_states(key, js, ts)


@pytest.mark.parametrize("key", KEYS)
def test_renderer_defaults_match_jax(key):
    vol = JVolume.sphere_in_cube(8)
    j = JAX_CLASSES[key](vol)
    t = PORT_CLASSES[key](convert.volume_from(vol), device="cpu")
    for name in ("resolution", "steps", "isovalue", "extinction", "slices", "threshold",
                 "random_offset"):
        assert getattr(t, name, None) == getattr(j, name, None), name
    if key == "eam":
        assert convert.eam_config_from(j.config) == t.config
    if key == "iso":
        np.testing.assert_array_equal(t.light, j.light)
    assert t.tf2d.bumps == j.tf2d.bumps
    reset = t.reset(None)
    jreset = j.reset(None)
    assert sorted(reset) == sorted(jreset)
    for k in reset:
        np.testing.assert_array_equal(reset[k].numpy(), np.asarray(jreset[k]))


def test_wrappers_refuse_mixed_and_unsupported_devices():
    vol, tf = TR._pack_if_linear(convert.volume_from(JVolume.sphere_in_cube(8)),
                                 convert.tf2d_from(JTF.grayscale_ramp()), "cpu")
    acc = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError, match="different devices"):
        K.mip_pass(acc, JCamera().inverse_mvp(), vol, tf, 0.0, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        K.depth_pass(JCamera().inverse_mvp(), torch.zeros((4, 4, 4), device="meta"),
                     torch.zeros((4, 4, 4), device="meta"), 1.0, 0.1, 0.0, 4, 4)


# -- the command line on --device cpu -----------------------------------------
SMALL = ["--device", "cpu", "--volume-size", "16", "--resolution", "16", "--frames", "2"]


@pytest.mark.parametrize("key", KEYS)
def test_cli_renders_each_ray_marcher(key, tmp_path, capsys):
    out = str(tmp_path / f"{key}.npy")
    cli_main(["render", *SMALL, "--renderer", key, "--output", out])
    img = np.load(out)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert metrics["frames"] == 2 and metrics["device"] == "cpu" and "paths" not in metrics


def test_cli_lists_the_ported_renderers(capsys):
    cli_main(["renderers"])
    assert capsys.readouterr().out.split() == ["depth", "dos", "eam", "iso", "lao", "mcm",
                                               "mcm-spectral", "mcs", "mip"]


@pytest.mark.parametrize("argv,message", [
    (["render", "--renderer", "eam", "--compaction"],
     "--compaction is supported by mcm-spectral and mcm, not 'eam'"),
])
def test_cli_refuses_compaction_and_invert_on_a_ray_marcher(argv, message, tmp_path):
    with pytest.raises(SystemExit) as e:
        cli_main([*argv, "--device", "cpu", "--volume-size", "8", "--resolution", "8",
                  "--frames", "1", "-o", str(tmp_path / "x.npy")])
    assert e.value.code not in (0, None) and message in str(e.value.code)
    assert not os.path.exists(tmp_path / "x.npy")


@pytest.mark.parametrize("key", ["eam", "depth"])
def test_cli_invert_runs_fit_density_whatever_the_renderer(key, tmp_path, capsys):
    """invert without --spectral is EAM's fit_density, and like vpt_tpu's it
    ignores --renderer: JAX's JSON keys, a recovered (8, 8, 8) grid."""
    out = str(tmp_path / "rec.npy")
    cli_main(["invert", "--renderer", key, "--device", "cpu", "--volume-size", "8",
              "--resolution", "8", "--iterations", "2", "-o", out])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(metrics) == {"final_loss", "density_mae"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert np.load(out).shape == (8, 8, 8)
