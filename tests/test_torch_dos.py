"""The DOS renderer (vpt_tpu_torch/models/dos.py, kernels/dos.py) and the
session's host-scalar checkpoint leaves against vpt_tpu's on the CPU, where
the wrapper runs the plain version.

Inputs come from numpy with a seed: images 32^2 (the goldens' 16^2), the
table modes linear on the u8 packed table of ``Volume.sphere_in_cube(16)``,
an f32 packed table (a smoothed random 24^3 density), quasicubic and
nearest on the raw grid, 8 disk samples (4 on the u8 table). The sweep's
schedule runs in Python float64 in both packages, so they sweep the same
slices and the host floats of the state agree exactly.

Tolerances: rtol 2e-4, atol 2e-5 on the colour, occlusion and images (XLA's
CPU code contracts the plane point's and the offsets' products into FMAs,
an ulp of a sample position); under nearest on 99% of pixels (a sample on a
voxel face can take the other voxel). The uv divides by the resolution and
the occlusion sum by the sample count: XLA's CPU code multiplies by the
reciprocal, the port divides (IEEE), which agree at powers of two (16, 32;
4 and 8 samples). The golden: tests/golden_tools.py's rtol 1e-4, atol 1e-5.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_tools import GOLDEN_PATH
from vpt_tpu import cli as jax_cli
from vpt_tpu.models import dos as JD
from vpt_tpu.scene.camera import Camera as JCamera
from vpt_tpu.scene.camera import OrbitController as JOrbit
from vpt_tpu.scene.tf import TransferFunction2D as JTF
from vpt_tpu.scene.volume import Volume as JVolume
from vpt_tpu.session import RenderSession as JaxSession
from vpt_tpu_torch import convert
from vpt_tpu_torch.cli import main as cli_main
from vpt_tpu_torch.kernels import dos as K
from vpt_tpu_torch.models.dos import DOSRenderer, slice_schedule
from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.scene.tf import TransferFunction2D as TTF
from vpt_tpu_torch.session import RenderSession

torch.set_num_threads(1)

RES = 32
MODES = ("linear_u8", "f32", "quasicubic", "nearest")
RTOL, ATOL = 2e-4, 2e-5
FLOATS = ("depth", "min_depth", "max_depth")


def _smoothed_random(size, seed):
    d = np.random.default_rng(seed).random((size, size, size)).astype(np.float32)
    for _ in range(3):
        d = (d + np.roll(d, 1, 0) + np.roll(d, 1, 1) + np.roll(d, 1, 2)) / np.float32(4)
    return d


def _jax_volume(mode):
    if mode == "f32":
        return JVolume(density=_smoothed_random(24, 5))
    vol = JVolume.sphere_in_cube(16)
    vol.filter = {"linear_u8": "linear"}.get(mode, mode)
    return vol


def _tfs(table):
    j, t = JTF(), TTF()
    for tf in (j, t):
        object.__setattr__(tf, "rasterize", lambda quantize=True: table)
    return j, t


def _ramp_table(rgb=(1.0, 0.8, 0.6)):
    t = np.zeros((256, 256, 4), np.float32)
    t[..., 0], t[..., 1], t[..., 2] = rgb
    t[..., 3] = np.linspace(0, 1, 256)[None, :]
    return t


@pytest.fixture(scope="module")
def camera():
    cam = JCamera()
    JOrbit(yaw=0.5, pitch=-0.3).apply(cam)
    return cam


def _close(a, b, mode="linear"):
    ok = np.isclose(b, a, rtol=RTOL, atol=ATOL)
    if ok.ndim == 3:
        ok = ok.all(-1)
    if mode == "nearest":
        assert ok.mean() >= 0.99, f"{ok.mean():.4f} of pixels within tolerance"
    else:
        assert ok.all(), f"{(~ok).sum()} pixels outside tolerance, max |diff| {np.abs(a - b).max()}"


# -- host helpers --------------------------------------------------------------
@pytest.mark.parametrize("n,seed", [(4, 0), (8, 0), (16, 3), (5, 11)])
def test_occlusion_samples_bit_equal_to_jax(n, seed):
    got = K.generate_occlusion_samples(n, seed)
    assert got.dtype == np.float32 and got.shape == (n, 2)
    np.testing.assert_array_equal(got, JD.generate_occlusion_samples(n, seed))


@pytest.mark.parametrize("yaw,pitch,dist", [(0.0, 0.0, 2.0), (0.5, -0.3, 2.0), (2.1, 0.7, 1.2)])
def test_depth_range_equals_jax(yaw, pitch, dist):
    cam = JCamera()
    JOrbit(yaw=yaw, pitch=pitch, focus_distance=dist).apply(cam)
    lo, hi = K.depth_range(convert.camera_from(cam))
    assert (lo, hi) == JD.depth_range(cam) and type(lo) is float and type(hi) is float


# -- one slice -----------------------------------------------------------------
def _mid_sweep(camera, res=RES, seed=24):
    """A random mid-sweep colour and occlusion, and one slice's schedule
    from 0.45 of the depth range."""
    rng = np.random.default_rng(seed)
    color = rng.random((res, res, 4), np.float32) * np.float32(0.8)
    occ = rng.random((res, res), np.float32)
    lo, hi = K.depth_range(convert.camera_from(camera))
    state = dict(depth=lo + (hi - lo) * 0.45, min_depth=lo, max_depth=hi)
    sched, sd, _ = slice_schedule(state, convert.camera_from(camera), 3, 200, 30.0)
    return color, occ, sched, sd


@pytest.mark.parametrize("mode,samples", [(m, 8) for m in MODES] + [("linear_u8", 4)])
def test_dos_slice_matches_jax(camera, mode, samples):
    vol = _jax_volume(mode)
    jtf, ttf = _tfs(_ramp_table())
    jr = JD.DOSRenderer(vol, jtf, samples=samples, resolution=RES)
    tr = DOSRenderer(convert.volume_from(vol), ttf, samples=samples, resolution=RES, device="cpu")
    np.testing.assert_array_equal(tr._occl_samples.numpy(), np.asarray(jr._occl_samples))
    color, occ, sched, sd = _mid_sweep(camera)
    inv = camera.inverse_mvp()
    depth_ndc, sx, sy = sched[0]
    jc, jo = JD.dos_slice(jnp.asarray(color), jnp.asarray(occ), jnp.asarray(inv), jr._density,
                          jr._tf_table, jr._occl_samples, jnp.float32(depth_ndc),
                          (jnp.float32(sx), jnp.float32(sy)), jnp.float32(sd),
                          jnp.float32(100.0), samples_count=samples, volume_filter=vol.filter)
    tc, to = K.dos_slice(torch.from_numpy(color), torch.from_numpy(occ), inv, tr._density,
                         tr._tf_table, tr._occl_samples, depth_ndc, (sx, sy), sd, 100.0, samples,
                         vol.filter)
    assert not np.array_equal(tc.numpy(), color) and not np.array_equal(to.numpy(), occ)
    _close(np.asarray(jc), tc.numpy(), vol.filter)
    _close(np.asarray(jo), to.numpy(), vol.filter)


def test_dos_pass_is_dos_slice_looped(camera):
    """``dos_pass`` (plain on the CPU) over three slices: the colour in
    place, the occlusion and the display as three ``dos_slice`` calls and
    the display blend give them."""
    vol = _jax_volume("linear_u8")
    r = DOSRenderer(convert.volume_from(vol), resolution=RES, device="cpu")
    color, occ, sched, sd = _mid_sweep(camera)
    inv = camera.inverse_mvp()
    c, o = torch.from_numpy(color), torch.from_numpy(occ)
    for d, sx, sy in sched:
        c, o = K.dos_slice(c, o, inv, r._density, r._tf_table, r._occl_samples, d, (sx, sy), sd,
                           100.0, 8)
    given = torch.from_numpy(color.copy())
    occ2, img = K.dos_pass(given, torch.from_numpy(occ), torch.empty(RES, RES), inv, r._density,
                           r._tf_table, r._occl_samples, sched, sd, 100.0)
    assert torch.equal(given, c) and torch.equal(occ2, o)
    assert torch.equal(img, torch.ones(RES, RES, 3) * (1.0 - c[..., 3:]) + c[..., :3] * c[..., 3:])


# -- sessions, goldens, checkpoints ----------------------------------------------
GOLDEN_KW = dict(steps=8, slices=16, extinction=200.0, samples=4)


def _golden_scene():
    volume = JVolume.sphere_in_cube(16)
    table = np.zeros((256, 256, 4), np.float32)
    table[..., :3] = (0.9, 0.7, 0.5)
    table[..., 3] = np.linspace(0, 1, 256)[None, :]
    jtf, ttf = _tfs(table)
    cam = JCamera()
    JOrbit(yaw=0.4, pitch=-0.3).apply(cam)
    return volume, jtf, ttf, cam


def _sessions(res=16, base_seed=7, **kw):
    volume, jtf, ttf, cam = _golden_scene()
    kw = dict(GOLDEN_KW, **kw)
    j = JaxSession("dos", volume, jtf, camera=cam, base_seed=base_seed, resolution=res, **kw)
    t = RenderSession("dos", convert.volume_from(volume), ttf, device="cpu",
                      camera=convert.camera_from(cam), base_seed=base_seed, resolution=res, **kw)
    return j, t


def _compare_states(js, ts):
    assert sorted(ts) == sorted(js) == ["color", "depth", "max_depth", "min_depth", "occlusion"]
    for k in FLOATS:
        assert type(ts[k]) is float and ts[k] == js[k], k
    _close(np.asarray(js["color"]), ts["color"].numpy())
    _close(np.asarray(js["occlusion"]), ts["occlusion"].numpy())


@pytest.mark.skipif(not os.path.exists(GOLDEN_PATH), reason="goldens not generated")
def test_session_reproduces_the_golden():
    golden = np.load(GOLDEN_PATH)["dos"]
    _, t = _sessions()
    K.reset_launch_counts()
    t.run(3)
    np.testing.assert_allclose(t.hdr_image(), golden, rtol=1e-4, atol=1e-5)
    assert all(v == 0 for v in K.LAUNCHES.values())  # plain versions count nothing


def test_three_frame_session_matches_jax():
    """Three renders of 8 slices: the sweep's 17 slices, then past its end."""
    j, t = _sessions(base_seed=3)
    for frame in (1, 2, 3):
        j.run(1)
        t.run(1)
        _compare_states(j.state, t.state)
        _close(j.hdr_image(), t.hdr_image())
    assert t.frame == j.frame == 3
    assert t.state["depth"] > t.state["max_depth"]
    assert sorted(t.metrics()) == sorted(j.metrics())
    u8 = t.image_u8()
    assert u8.shape == (16, 16, 3) and u8.dtype == np.uint8


def test_sweep_progresses_and_completes():
    """tests/test_dos_lao.py's sweep on the port: progress, a dense centre
    darker than the white background, renders past the end are no-ops."""
    vol = convert.volume_from(JVolume.sphere_in_cube(16))
    _, ttf = _tfs(_ramp_table())
    r = DOSRenderer(vol, ttf, steps=8, slices=16, extinction=300.0, samples=4, resolution=24,
                    device="cpu")
    cam = convert.camera_from(JCamera())
    state = r.reset(cam)
    assert state["depth"] == state["min_depth"]
    state, _ = r.render(state, cam, 0)
    assert state["depth"] > state["min_depth"]
    state, _ = r.render(state, cam, 1)
    state, img3 = r.render(state, cam, 2)
    img = img3.numpy()
    assert np.isfinite(img).all() and img[12, 12].mean() < img[0, 0].mean()
    np.testing.assert_allclose(img[0, 0], 1.0, atol=1e-5)
    color = state["color"].clone()
    state2, img4 = r.render(dict(state), cam, 3)
    np.testing.assert_array_equal(img3.numpy(), img4.numpy())
    assert torch.equal(state2["color"], color) and state2["depth"] == state["depth"]
    occ = state2["occlusion"].numpy()
    assert occ.max() <= 1.0 + 1e-6


def test_occlusion_decays_in_the_dense_volume():
    vol = convert.volume_from(JVolume.sphere_in_cube(16))
    _, ttf = _tfs(_ramp_table())
    r = DOSRenderer(vol, ttf, steps=16, slices=16, extinction=300.0, samples=4, resolution=24,
                    device="cpu")
    cam = convert.camera_from(JCamera())
    state, _ = r.render(r.reset(cam), cam, 0)
    occ = state["occlusion"].numpy()
    assert occ.min() < 0.5 and occ.max() <= 1.0 + 1e-6


def test_renderer_defaults_match_jax():
    vol = JVolume.sphere_in_cube(8)
    j = JD.DOSRenderer(vol)
    t = DOSRenderer(convert.volume_from(vol), device="cpu")
    for name in ("steps", "slices", "extinction", "aperture", "samples", "resolution"):
        assert getattr(t, name) == getattr(j, name), name
    assert (t.steps, t.slices, t.samples, t.resolution) == (50, 200, 8, 512)
    np.testing.assert_array_equal(t._occl_samples.numpy(), np.asarray(j._occl_samples))
    np.testing.assert_array_equal(t._tf_table.numpy(), np.asarray(j._tf_table))
    assert t.tf2d.bumps == j.tf2d.bumps
    cam = JCamera()
    r, jr = t.reset(convert.camera_from(cam)), j.reset(cam)
    assert sorted(r) == sorted(jr)
    for k in FLOATS:
        assert r[k] == jr[k] and type(r[k]) is type(jr[k]) is float
    for k in ("color", "occlusion"):
        np.testing.assert_array_equal(r[k].numpy(), np.asarray(jr[k]))


def test_jax_checkpoint_mid_sweep_resumes_in_port_and_back(tmp_path):
    """A JAX checkpoint taken mid-sweep (after 8 of 17 slices) loads into the
    port's session: host floats exact, arrays bit for bit; the resumed
    sweep equals the uninterrupted one (floats exactly, images within the
    tolerance); the port's checkpoint loads into JAX's session."""
    j, t = _sessions()
    j.run(1)
    assert j.state["min_depth"] < j.state["depth"] <= j.state["max_depth"]
    j.save_checkpoint(str(tmp_path / "jax.npz"))
    t.load_checkpoint(str(tmp_path / "jax.npz"))
    assert t.frame == 1
    for k in FLOATS:
        assert type(t.state[k]) is float and t.state[k] == j.state[k]
    for k in ("color", "occlusion"):
        np.testing.assert_array_equal(t.state[k].numpy(), np.asarray(j.state[k]))
    j.run(1)
    t.run(1)
    _compare_states(j.state, t.state)
    _close(j.hdr_image(), t.hdr_image())
    _, whole = _sessions()
    whole.run(2)
    for k in FLOATS:
        assert whole.state[k] == t.state[k]
    _close(whole.hdr_image(), t.hdr_image())
    t.save_checkpoint(str(tmp_path / "port.npz"))
    j2, _ = _sessions()
    j2.load_checkpoint(str(tmp_path / "port.npz"))
    assert j2.frame == 2
    for k in FLOATS:
        assert type(j2.state[k]) is float and j2.state[k] == t.state[k]
    for k in ("color", "occlusion"):
        np.testing.assert_array_equal(np.asarray(j2.state[k]), t.state[k].numpy())
    j2.run(1)
    t.run(1)
    _compare_states(j2.state, t.state)


def test_checkpoint_resume_is_exact(tmp_path):
    _, a = _sessions()
    _, b = _sessions()
    a.run(3)
    b.run(1)
    b.save_checkpoint(str(tmp_path / "half.npz"))
    _, c = _sessions()
    c.load_checkpoint(str(tmp_path / "half.npz")).run(2)
    np.testing.assert_array_equal(c.hdr_image(), a.hdr_image())
    for k in FLOATS:
        assert c.state[k] == a.state[k]


def test_checkpoint_refuses_another_renderer(tmp_path):
    _, t = _sessions()
    t.run(1)
    t.save_checkpoint(str(tmp_path / "dos.npz"))
    lao = RenderSession("lao", convert.volume_from(JVolume.sphere_in_cube(8)), device="cpu",
                        resolution=8, slices=4)
    with pytest.raises(ValueError, match="renderer dos"):
        lao.load_checkpoint(str(tmp_path / "dos.npz"))


def test_state_crosses_through_convert():
    _, t = _sessions()
    t.run(1)
    fields = convert.raymarch_state_to_numpy(t.state)
    assert type(fields["depth"]) is float and isinstance(fields["color"], np.ndarray)
    back = convert.raymarch_state_from_numpy(fields, "cpu")
    assert back["depth"] == t.state["depth"] and torch.equal(back["color"], t.state["color"])


def test_wrapper_refuses_mixed_and_unsupported_devices():
    r = DOSRenderer(convert.volume_from(JVolume.sphere_in_cube(8)), resolution=4, device="cpu")
    st = r.reset(convert.camera_from(JCamera()))
    inv = JCamera().inverse_mvp()
    sched = np.zeros((1, 3), np.float32)
    with pytest.raises(ValueError, match="different devices"):
        K.dos_pass(st["color"], st["occlusion"], st["occlusion"].to("meta"), inv, r._density,
                   r._tf_table, r._occl_samples, sched, 0.01, 100.0)
    meta = interp.PackedVolume(r._density.table.to("meta"), r._density.dims)
    with pytest.raises(ValueError, match="unsupported device"):
        K.dos_pass(st["color"].to("meta"), st["occlusion"].to("meta"),
                   st["occlusion"].to("meta"), inv, meta, r._tf_table.to("meta"),
                   r._occl_samples.to("meta"), sched, 0.01, 100.0)


# -- the command line ------------------------------------------------------------
SMALL = ["--volume-size", "16", "--resolution", "16", "--frames", "2"]


def test_cli_render_dos_matches_jax(tmp_path, capsys):
    """render --renderer dos on --device cpu against vpt_tpu's CLI (the
    reference's defaults: 50 slices a render, 200 in the sweep)."""
    out, out_j = str(tmp_path / "dos.npy"), str(tmp_path / "dos_jax.npy")
    cli_main(["render", "--device", "cpu", *SMALL, "--renderer", "dos", "-o", out])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_cli.main(["render", *SMALL, "--renderer", "dos", "-o", out_j])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(metrics) - {"device"} == set(want) and metrics["device"] == "cpu"
    assert metrics["frames"] == want["frames"] == 2
    img, img_j = np.load(out), np.load(out_j)
    assert img.shape == img_j.shape == (16, 16, 3) and img.dtype == np.uint8 and img.any()
    np.testing.assert_array_equal(img, img_j)


def test_cli_animate_dos(tmp_path):
    out = tmp_path / "anim"
    cli_main(["animate", "--device", "cpu", "--volume-size", "8", "--resolution", "8",
              "--frames", "1", "--n-frames", "2", "--renderer", "dos", "-o", str(out)])
    assert len(os.listdir(out)) == 2
