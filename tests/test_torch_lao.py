"""The LAO renderer (vpt_tpu_torch/models/lao.py, kernels/lao.py) against
vpt_tpu's on the CPU, where the wrapper runs the plain version.

Inputs come from numpy with a seed: images 32^2 (the goldens' 16^2), the
table modes linear on the u8 packed table of ``Volume.sphere_in_cube(16)``,
an f32 packed table (a smoothed random 24^3 density), quasicubic and
nearest on the raw grid, and a TF that varies along both axes (LAO reads it
at (value, |gradient|)).

``rand2`` and XLA's CPU code. The hash ``fract(cos(dx) * 1235.6789)``
turns an ulp of ``dx`` into ~1e-2 of ``rx``. Inside a jitted function,
XLA's CPU compiler folds the constant products (``23.14... * (ndc_x *
3.14)`` becomes ``(23.14... * 3.14) * ndc_x``) and contracts ``dx`` into
an FMA, and its cosine differs from torch's in the last ulp on ~5% of
inputs; so JAX's jitted ``rx`` equals the port's (the reference's operation
order, IEEE) on 58% of the pixels at 32^2 and 84% at 16^2. Hence:
- ``rand2`` is held against JAX's operations run one by one (no fusion):
  within an ulp of the cosine (sine) times the multiplier plus an ulp of the
  product, after a wrap of the fraction, whose count is asserted;
- ``lao_frame`` is held against JAX's with ``rand2`` pinned to the port's
  values (JAX's function, its ``rand2`` replaced by a callback to the
  port's, jitted anew for this module), at rtol 2e-4, atol 2e-5 (nearest:
  99% of pixels, a sample on a voxel face can take the other voxel);
- the golden (tests/golden_tools.py, rtol 1e-4, atol 1e-5): the port's
  session with ``rx`` pinned to JAX's jitted values reproduces it, and
  unpinned every pixel outside the tolerance is one whose ``rx`` differs.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_tools import GOLDEN_PATH
from vpt_tpu import cli as jax_cli
from vpt_tpu.models import lao as JL
from vpt_tpu.ops import interp as JI
from vpt_tpu.scene.camera import Camera as JCamera
from vpt_tpu.scene.camera import OrbitController as JOrbit
from vpt_tpu.scene.tf import TransferFunction2D as JTF
from vpt_tpu.scene.volume import Volume as JVolume
from vpt_tpu.session import RenderSession as JaxSession
from vpt_tpu_torch import convert
from vpt_tpu_torch.cli import main as cli_main
from vpt_tpu_torch.kernels import lao as K
from vpt_tpu_torch.models import raymarch as TR
from vpt_tpu_torch.models.lao import LAORenderer
from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.scene.tf import TransferFunction2D as TTF
from vpt_tpu_torch.session import RenderSession

torch.set_num_threads(1)

RES, SLICES = 32, 16
MODES = ("linear_u8", "f32", "quasicubic", "nearest")
RTOL, ATOL = 2e-4, 2e-5
PARAMS = dict(extinction=100.0, lao_weight=0.69, shadows_weight=0.54, light_radius=0.19,
              light_coef=1.0)
LIGHT = np.array([2.0, -3.0, -5.0], np.float32)
# JAX's own rand2 (the jax_lao fixture pins the module's to the port's)
JAX_RAND2 = JL.rand2
STATIC = ("lao_step", "slices", "resolution", "num_lao_samples", "num_shadow_samples",
          "lao_enabled", "shadows_enabled", "volume_filter")


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


def _tf_table():
    """A TF that varies with both coordinates: colour along the density and
    the gradient magnitude, alpha a ramp."""
    y, x = np.meshgrid(np.linspace(0, 1, 256), np.linspace(0, 1, 256), indexing="ij")
    t = np.zeros((256, 256, 4), np.float32)
    t[..., 0] = 0.3 + 0.7 * x
    t[..., 1] = 0.9 - 0.6 * y
    t[..., 2] = 0.5 + 0.4 * np.sin(6 * x + 4 * y)
    t[..., 3] = x
    return t


def _tfs(table):
    j, t = JTF(), TTF()
    for tf in (j, t):
        object.__setattr__(tf, "rasterize", lambda quantize=True: table)
    return j, t


def _port_rand2_callback(px, py):
    """JAX's ``rand2`` replaced by the port's values, through a callback."""
    def f(a, b):
        out = K.rand2(torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b)))
        return tuple(o.numpy() for o in out)

    shape = jax.ShapeDtypeStruct(px.shape, jnp.float32)
    return jax.pure_callback(f, (shape, shape), px, py)


@pytest.fixture(scope="module")
def jax_lao():
    """JAX's ``lao_frame`` with ``rand2`` pinned to the port's, jitted anew
    (its own trace cache), installed in ``vpt_tpu.models.lao`` for this
    module so that JAX's renderer and CLI call it; restored afterwards."""
    body = JL.lao_frame.__wrapped__

    def pinned_body(*args, **kw):
        return body(*args, **kw)

    pinned = jax.jit(pinned_body, static_argnames=STATIC)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "rand2", _port_rand2_callback)
        mp.setattr(JL, "lao_frame", pinned)
        yield pinned


@pytest.fixture(scope="module")
def camera():
    cam = JCamera()
    JOrbit(yaw=0.5, pitch=-0.3).apply(cam)
    return cam


@pytest.fixture(scope="module")
def tables():
    """mode -> (JAX density, JAX TF, port density, port TF, filter), each
    package's tables as its LAO renderer builds them."""
    jtf, ttf = _tfs(_tf_table())
    out = {}
    for mode in MODES:
        vol = _jax_volume(mode)
        jr = JL.LAORenderer(vol, jtf, resolution=RES)
        tr = LAORenderer(convert.volume_from(vol), ttf, resolution=RES, device="cpu")
        out[mode] = (jr._density, jr._tf_table, tr._density, tr._tf_table, vol.filter)
    return out


def _close(a, b, mode):
    ok = np.isclose(b, a, rtol=RTOL, atol=ATOL).all(-1)
    if mode == "nearest":
        assert ok.mean() >= 0.99, f"{ok.mean():.4f} of pixels within tolerance"
    else:
        assert ok.all(), f"{(~ok).sum()} pixels outside tolerance, max |diff| {np.abs(a - b).max()}"


# -- rand2 ---------------------------------------------------------------------
def _ndc(res):
    iy, ix = np.meshgrid(np.arange(res, dtype=np.float32), np.arange(res, dtype=np.float32),
                         indexing="ij")
    return ((ix + 0.5) / res - 0.5) * 2.0, ((iy + 0.5) / res - 0.5) * -2.0


@pytest.mark.parametrize("res", [16, 32, 512])
def test_rand2_matches_jax_operations(res):
    """rand2 of each pixel's NDC against JAX's operations run one by one:
    within one ulp of the cosine (sine) times the multiplier plus one ulp of
    the product, once a wrap of the fraction is taken out; at most 1% of the
    pixels wrap. The NDC itself is bit-equal (division by a power of two)."""
    nx, ny = _ndc(res)
    jx = jnp.asarray(nx) * 3.14
    jy = jnp.asarray(ny) * 2.71
    jrx, jry = (np.asarray(a) for a in JAX_RAND2(jx, jy))
    tx, ty = torch.from_numpy(np.array(jx)), torch.from_numpy(np.array(jy))
    trx, try_ = (a.numpy() for a in K.rand2(tx, ty))
    # pixel_rand's NDC equals numpy's (and JAX's)
    np.testing.assert_array_equal(K.pixel_rand(res, "cpu")[0].numpy(), trx)
    for got, want, mult, ulp in ((trx, jrx, 1235.6789, 2.0 ** -13),
                                 (try_, jry, 4378.5453, 2.0 ** -11)):
        d = got.astype(np.float64) - want
        wraps = np.abs(d) > 0.5
        d = d - np.round(d)
        assert np.abs(d).max() <= mult * 2.0 ** -24 + ulp, np.abs(d).max()
        assert wraps.mean() <= 0.01, f"{int(wraps.sum())} wraps"


def test_rand2_of_the_frame_constant_matches_jax():
    """g_rx = rand2(3.14, 2.71): the same bits as JAX's."""
    j = np.asarray(JAX_RAND2(jnp.full((2, 2), 3.14, jnp.float32),
                             jnp.full((2, 2), 2.71, jnp.float32))[0])
    _, g = K.pixel_rand(2, "cpu")
    np.testing.assert_array_equal(g.numpy(), j)


def test_host_constants():
    """The cone table, the light and the folded constants: f32 roundings of
    the reference's float64 values."""
    for step in (0.05, 0.001, 0.3):
        cone = K.cone_table(step)
        n = int(np.ceil((1.0 - 0.001) / step))
        assert cone.shape == (n, 2) and cone.dtype == np.float32
        for i in (0, n // 2, n - 1):
            tt = 0.001 + i * step
            assert cone[i, 0] == np.float32(tt) and cone[i, 1] == np.float32((1.0 - tt) ** 2)
    assert K.n_lao_steps(0.05) == 20 and K.n_lao_steps(0.001) == 999
    assert K.SHADOW_BIAS == np.float32(-0.19999999999999996) and K.H_GRAD == np.float32(0.03125)
    inv = JCamera().inverse_mvp()
    want = np.asarray(jnp.asarray(inv) @ jnp.concatenate([jnp.asarray(LIGHT), jnp.ones(1)]))
    np.testing.assert_allclose(K.light_view(inv, LIGHT), want[:3], rtol=1e-6)


# -- the frame -----------------------------------------------------------------
def _frames(tables, camera, mode, lao_on=True, shadows_on=True, res=RES):
    jd, jt, td, tt, filt = tables[mode]
    kw = dict(lao_step=0.05, slices=SLICES, resolution=res, lao_enabled=lao_on,
              shadows_enabled=shadows_on, volume_filter=filt)
    j = JL.lao_frame(jnp.asarray(camera.inverse_mvp()), jd, jt, jnp.asarray(LIGHT),
                     *(jnp.float32(v) for v in PARAMS.values()), **kw)
    t = K.lao_frame(camera.inverse_mvp(), td, tt, LIGHT, *PARAMS.values(), **kw)
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("mode,lao_on,shadows_on", [
    *[(m, True, True) for m in MODES],
    ("linear_u8", True, False), ("linear_u8", False, True), ("linear_u8", False, False)])
def test_lao_frame_matches_jax(jax_lao, tables, camera, mode, lao_on, shadows_on):
    j, t = _frames(tables, camera, mode, lao_on, shadows_on)
    assert t.shape == (RES, RES, 3) and np.isfinite(t).all() and (t > 0).any()
    _close(j, t, mode)


def test_terms_darken(jax_lao, tables, camera):
    """Occlusion and shadows darken the lit volume (tests/test_dos_lao.py)."""
    _, on = _frames(tables, camera, "linear_u8")
    _, off = _frames(tables, camera, "linear_u8", False, False)
    assert on.mean() < off.mean()


def test_u8_table_samples_equal_jax_f32_table():
    """The port's u8 corner table (a u8-quantized source) dequantizes to the
    f32 values of JAX's corner table, so its samples are the f32 table's, bit
    for bit; JAX's own sampler, run op by op, gives the same bits."""
    vol = JVolume.sphere_in_cube(16)
    jt = JI.pack_volume_corners(vol.density)
    u8, _ = TR._pack_if_linear(convert.volume_from(vol), TTF.grayscale_ramp(), "cpu")
    assert u8.table.dtype == torch.uint8
    deq = interp.dequantize_rows(u8.table).numpy().reshape(jt.shape)
    np.testing.assert_array_equal(deq, np.asarray(jt))
    f32 = interp.PackedVolume(torch.as_tensor(np.asarray(jt).reshape(-1, 8)), u8.dims)
    p = np.random.default_rng(3).uniform(-0.1, 1.1, (3, 4096)).astype(np.float32)
    for mode in ("linear", "quasicubic"):
        a = interp.sample_volume(u8, *(torch.from_numpy(x) for x in p), mode)
        b = interp.sample_volume(f32, *(torch.from_numpy(x) for x in p), mode)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        j = JI.sample_volume(jnp.asarray(jt), *(jnp.asarray(x) for x in p), mode)
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))


# -- sessions, goldens, renderer -------------------------------------------------
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
    kw = dict(dict(slices=16), **kw)
    j = JaxSession("lao", volume, jtf, camera=cam, base_seed=base_seed, resolution=res, **kw)
    t = RenderSession("lao", convert.volume_from(volume), ttf, device="cpu",
                      camera=convert.camera_from(cam), base_seed=base_seed, resolution=res, **kw)
    return j, t


def _jax_jitted_rand(res):
    """JAX's rx and g_rx as its jitted code computes them (the golden's)."""
    @jax.jit
    def f():
        iy = jax.lax.broadcasted_iota(jnp.float32, (res, res), 0)
        ix = jax.lax.broadcasted_iota(jnp.float32, (res, res), 1)
        ndc_x = ((ix + 0.5) / res - 0.5) * 2.0
        ndc_y = ((iy + 0.5) / res - 0.5) * -2.0
        rx, _ = JAX_RAND2(ndc_x * 3.14, ndc_y * 2.71)
        g_rx, _ = JAX_RAND2(jnp.full_like(ndc_x, 3.14), jnp.full_like(ndc_y, 2.71))
        return rx, g_rx

    return tuple(torch.from_numpy(np.array(a)) for a in f())


@pytest.mark.skipif(not os.path.exists(GOLDEN_PATH), reason="goldens not generated")
def test_session_reproduces_the_golden(monkeypatch):
    """rtol 1e-4, atol 1e-5: with rx pinned to JAX's jitted values every
    pixel; unpinned, every pixel whose rx equals JAX's jitted rx bit for bit
    (the others are rand2's, see the module's docstring)."""
    golden = np.load(GOLDEN_PATH)["lao"]
    jrx, jg = _jax_jitted_rand(16)
    prx, pg = K.pixel_rand(16, "cpu")
    assert torch.equal(jg, pg)
    same = (jrx == prx).numpy()
    _, t = _sessions()
    K.reset_launch_counts()
    t.run(3)
    ok = np.isclose(t.hdr_image(), golden, rtol=1e-4, atol=1e-5).all(-1)
    assert ok[same].all() and same.mean() >= 0.8
    monkeypatch.setattr(K, "pixel_rand", lambda res, device: (jrx.clone(), jg.clone()))
    _, t = _sessions()
    t.run(3)
    np.testing.assert_allclose(t.hdr_image(), golden, rtol=1e-4, atol=1e-5)
    assert all(v == 0 for v in K.LAUNCHES.values())  # plain versions count nothing


def test_three_frame_session_matches_jax(jax_lao):
    j, t = _sessions(base_seed=3)
    j.run(3)
    t.run(3)
    assert t.frame == j.frame == 3 and int(t.state["frame"]) == int(j.state["frame"]) == 3
    _close(j.hdr_image(), t.hdr_image(), "linear")
    assert sorted(t.metrics()) == sorted(j.metrics())
    u8 = t.image_u8()
    assert u8.shape == (16, 16, 3) and u8.dtype == np.uint8


def test_jax_checkpoint_loads_into_port_and_back(jax_lao, tmp_path):
    j, t = _sessions()
    j.run(2)
    j.save_checkpoint(str(tmp_path / "jax.npz"))
    t.load_checkpoint(str(tmp_path / "jax.npz"))
    assert t.frame == 2 and int(t.state["frame"]) == 2
    t.run(1)
    t.save_checkpoint(str(tmp_path / "port.npz"))
    j2, _ = _sessions()
    j2.load_checkpoint(str(tmp_path / "port.npz"))
    assert j2.frame == 3 and int(j2.state["frame"]) == 3


def test_renderer_defaults_match_jax():
    vol = JVolume.sphere_in_cube(8)
    j = JL.LAORenderer(vol)
    t = LAORenderer(convert.volume_from(vol), device="cpu")
    assert t.params == j.params and t.flags == j.flags
    assert (t.slices, t.resolution) == (j.slices, j.resolution) == (64, 512)
    np.testing.assert_array_equal(t.light_position, j.light_position)
    assert t.tf2d.bumps == j.tf2d.bumps
    np.testing.assert_array_equal(t._tf_table.numpy(), np.asarray(j._tf_table))
    assert t.exact_stop
    r, jr = t.reset(None), j.reset(None)
    assert sorted(r) == sorted(jr) == ["frame"]
    np.testing.assert_array_equal(r["frame"].numpy(), np.asarray(jr["frame"]))


def test_early_stop_is_exact_only_on_nonnegative_finite_inputs():
    vol = convert.volume_from(JVolume.sphere_in_cube(8))
    t = LAORenderer(vol, device="cpu")
    assert K.early_stop_exact(t._density, t._tf_table, 100.0, 0.69, 0.54, 0.19, 1.0)
    assert not K.early_stop_exact(t._density, t._tf_table, -1.0, 0.69, 0.54, 0.19, 1.0)
    assert not K.early_stop_exact(t._density, t._tf_table, 100.0, np.inf, 0.54, 0.19, 1.0)
    neg = torch.full((4, 4, 4), -0.5)
    assert not K.early_stop_exact(neg, t._tf_table, 100.0, 0.69, 0.54, 0.19, 1.0)
    bad_tf = t._tf_table.clone()
    bad_tf[0, 0, 0] = float("nan")
    assert not K.early_stop_exact(t._density, bad_tf, 100.0, 0.69, 0.54, 0.19, 1.0)


def _half_slab_renderer(light_coef):
    """A 16^3 grid dense in its far half (z >= 0.5) lit from behind: rays
    pass 0.9 in the slab, and the samples after it read an empty cone."""
    d = np.zeros((16, 16, 16), np.float32)
    d[8:] = 1.0
    return LAORenderer(convert.volume_from(JVolume(density=d)), slices=16, resolution=16,
                       light_position=(2.0, -3.0, 5.0), light_coef=light_coef, device="cpu")


@pytest.mark.parametrize("light_coef", [0.0, 1.0])
def test_early_stop_only_where_it_keeps_the_masked_bits(light_coef):
    """At light_coef 0 an inactive sample's empty cone gives 0/0 = NaN, which
    the masked scan adds as 0 * NaN: stopping early would differ, so the
    renderer takes the masked march; at 1 it stops, with the same bits."""
    r = _half_slab_renderer(light_coef)
    cam = JCamera()
    args = (cam.inverse_mvp(), r._density, r._tf_table, r.light_position, 100.0, 0.69, 0.54,
            0.19, light_coef)
    kw = dict(lao_step=0.05, slices=16, resolution=16)
    masked = K.lao_frame(*args, **kw).numpy()
    stopped = K.lao_frame(*args, **kw, stop=True).numpy()
    _, img = r.render(r.reset(cam), cam, 0)
    assert r.exact_stop == (light_coef != 0.0)
    np.testing.assert_array_equal(img.numpy(), masked)
    if light_coef == 0.0:
        assert np.isnan(masked).any(-1).sum() == 64 and not np.isnan(stopped).any()
    else:
        assert np.isfinite(masked).all()
        np.testing.assert_array_equal(stopped, masked)


@pytest.mark.parametrize("light, clear", [((5.0, 5.0, 5.0), True), ((0.5, 0.5, 3.0), True),
                                          ((0.5, 0.5, 0.5), False), ((1.05, 0.5, 0.5), False),
                                          ((-0.2, 0.5, 0.5), False)])
def test_cone_clear_keeps_the_light_off_the_samples_box(light, clear):
    """Under an identity inv_mvp the light's view point is the light: its
    cone (|d| <= 0.19 * 0.951 / sqrt(3)) must miss the unit cube widened by
    2 / slices along some axis."""
    eye = np.eye(4, dtype=np.float32)
    assert K.cone_clear(eye, np.float32(light), 0.19, 0.05, 16) is clear


def test_wrapper_refuses_mixed_and_unsupported_devices():
    vol = convert.volume_from(JVolume.sphere_in_cube(8))
    t = LAORenderer(vol, resolution=4, device="cpu")
    inv = JCamera().inverse_mvp()
    kw = dict(lao_step=0.05, slices=4, resolution=4, cone=t._cone, exact=t.exact_stop)
    with pytest.raises(ValueError, match="different devices"):
        K.lao_pass(inv, t._density, t._tf_table.to("meta"), LIGHT, *PARAMS.values(), **kw)
    meta = interp.PackedVolume(t._density.table.to("meta"), t._density.dims)
    with pytest.raises(ValueError, match="unsupported device"):
        K.lao_pass(inv, meta, t._tf_table.to("meta"), LIGHT, *PARAMS.values(), **kw)


# -- the command line ------------------------------------------------------------
SMALL = ["--volume-size", "16", "--resolution", "16", "--frames", "2"]


def test_cli_render_lao_matches_jax(jax_lao, tmp_path, capsys):
    """render --renderer lao on --device cpu against vpt_tpu's CLI (the
    reference's defaults; rand2 pinned as above): the same metric keys and
    the same u8 image."""
    out, out_j = str(tmp_path / "lao.npy"), str(tmp_path / "lao_jax.npy")
    cli_main(["render", "--device", "cpu", *SMALL, "--renderer", "lao", "-o", out])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_cli.main(["render", *SMALL, "--renderer", "lao", "-o", out_j])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(metrics) - {"device"} == set(want) and metrics["device"] == "cpu"
    assert metrics["frames"] == want["frames"] == 2
    img, img_j = np.load(out), np.load(out_j)
    assert img.shape == img_j.shape == (16, 16, 3) and img.dtype == np.uint8 and img.any()
    np.testing.assert_array_equal(img, img_j)


def test_cli_animate_lao(tmp_path):
    out = tmp_path / "anim"
    cli_main(["animate", "--device", "cpu", "--volume-size", "8", "--resolution", "8",
              "--frames", "1", "--n-frames", "2", "--renderer", "lao", "-o", str(out)])
    assert len(os.listdir(out)) == 2
