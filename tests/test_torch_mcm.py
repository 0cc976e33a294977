"""The RGB MCM renderer (vpt_tpu_torch/models/mcm.py, mcm_compact.py,
kernels/mcm.py) against vpt_tpu's on the CPU, where the wrappers run the
plain versions.

Inputs come from numpy with a seed; volumes are 16^3 (sphere_in_cube, or a
smoothed random f32 density), images 16^2-24^2. Six modes: linear on the
u8 packed table, an f32 packed table with anisotropy 0.3, quasicubic,
raw tables (pack_tables=False), nearest on the raw grid, and a seeded
8x16 environment map with anisotropy -0.4.

Tolerances, and why:
- The RNG chains of one Woodcock iteration from the same state: bit for
  bit (every lane draws the same number of uniforms); the resets' integer
  and radiance fields bit for bit, their directions within rtol 1e-5, atol
  1e-6 (XLA's CPU code contracts the ray's arithmetic into FMAs) and their
  positions within rtol 1e-4, atol 1e-5 (the entry point of a ray that
  misses the cube lies up to ~7 units out, at a tnear that magnifies the
  direction's ulps to 2e-5 relative).
- Images and states after several dispatches: the spectral parity contract
  (tests/test_torch_mcm_spectral.py): >= 99.5% of channels within 1e-3
  relative, median |diff| < 1e-5, >= 99% of lanes with equal sample
  counts. An ulp of libm or an FMA may flip one lane's event, after which
  the lane diverges; the allowance covers that.
- The equirect lookup: within 2e-6 absolute (the libms' atan2 and asin
  differ by an ulp, moving the bilinear weights by ~1e-7 of a texel).
- The session against the ``mcm`` golden: test_golden.py's rtol 1e-4,
  atol 1e-5.
- Compacted hit pixels against the full render: bit for bit (the same plain
  arithmetic on the same lanes); the compacted image against JAX's scatter
  through ``lane_pixel`` on the same state: bit for bit.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_tools import GOLDEN_PATH
from vpt_tpu import cli as jax_cli
from vpt_tpu.models import make_renderer as jax_make_renderer
from vpt_tpu.models import mcm as JM
from vpt_tpu.models import mcm_compact as JC
from vpt_tpu.ops import interp as JI
from vpt_tpu.ops import sampling as JS
from vpt_tpu.scene.camera import Camera as JCamera
from vpt_tpu.scene.camera import OrbitController as JOrbit
from vpt_tpu.scene.tf import TransferFunction2D as JTF
from vpt_tpu.scene.volume import Volume as JVolume
from vpt_tpu.session import RenderSession as JaxSession
from vpt_tpu.utils.config import MCMConfig as JMCMConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch.cli import main as cli_main
from vpt_tpu_torch.kernels import mcm as K
from vpt_tpu_torch.kernels import mcm_spectral as KS
from vpt_tpu_torch.models import make_renderer
from vpt_tpu_torch.models import mcm as TM
from vpt_tpu_torch.models import mcm_compact as TC
from vpt_tpu_torch.session import RenderSession
from vpt_tpu_torch.utils.config import MCMConfig

torch.set_num_threads(1)

FIELDS = JM.PhotonState._fields
RES, SIZE = 24, 16
MODES = ("u8", "f32", "quasicubic", "raw", "nearest", "env")


def _smoothed_random(size, seed):
    d = np.random.default_rng(seed).random((size, size, size)).astype(np.float32)
    for _ in range(3):
        d = (d + np.roll(d, 1, 0) + np.roll(d, 1, 1) + np.roll(d, 1, 2)) / np.float32(4)
    return d


def _envmap(seed=9):
    return np.random.default_rng(seed).uniform(0.1, 1.0, size=(8, 16, 3)).astype(np.float32)


def _tf_table(albedo=(0.9, 0.7, 0.5), alpha=None):
    t = np.zeros((256, 256, 4), np.float32)
    t[..., :3] = albedo
    t[..., 3] = np.linspace(0, 1, 256)[None, :] if alpha is None else alpha
    return t


def _tfs(table):
    """The same rasterized table as a JAX and a port TransferFunction2D."""
    jtf, ttf = JTF(), convert.tf2d_from(JTF())
    for tf in (jtf, ttf):
        object.__setattr__(tf, "rasterize", lambda quantize=True: table)
    return jtf, ttf


def _mode_args(mode):
    """(JAX volume, environment, config kwargs, pack_tables) of a mode."""
    vol = JVolume.sphere_in_cube(SIZE)
    env, kw, pack = None, dict(extinction=30.0, bounces=4, steps=6), True
    if mode == "f32":
        vol = JVolume(density=_smoothed_random(SIZE, 5))
        kw["anisotropy"] = 0.3
    elif mode in ("quasicubic", "nearest"):
        vol.filter = mode
    elif mode == "raw":
        pack = False
    elif mode == "env":
        env, kw["anisotropy"] = _envmap(), -0.4
    return vol, env, kw, pack


def _pair(mode, res=RES, compaction=False, table=None):
    vol, env, kw, pack = _mode_args(mode)
    jtf, ttf = _tfs(_tf_table() if table is None else table)
    cfg = JMCMConfig(**kw)
    j = JM.MCMRenderer(vol, jtf, env, cfg, resolution=res, pack_tables=pack,
                       compaction=compaction)
    t = TM.MCMRenderer(convert.volume_from(vol), ttf, env, convert.mcm_config_from(cfg),
                       resolution=res, pack_tables=pack, compaction=compaction, device="cpu")
    return j, t


def _port_ctx(jctx, volume_filter):
    d = jctx.density
    table, dims = ((np.asarray(d.table), d.dims) if isinstance(d, JI.PackedVolume)
                   else (np.asarray(d), None))
    return convert.mcm_ctx_from_numpy(
        inv_mvp=np.asarray(jctx.inv_mvp), seed_bits=np.asarray(jctx.seed_bits),
        extinction=np.asarray(jctx.extinction), blur=np.asarray(jctx.blur),
        anisotropy=np.asarray(jctx.anisotropy), max_bounces=np.asarray(jctx.max_bounces),
        density_table=table, density_dims=dims, tf_table=np.asarray(jctx.tf_table),
        environment=np.asarray(jctx.environment), volume_filter=volume_filter, device="cpu")


def _port_state(jstate):
    return convert.mcm_state_from_numpy({k: np.asarray(getattr(jstate, k)) for k in FIELDS},
                                        "cpu")


def _contract(img, ref, samples, ref_samples):
    img, ref = np.asarray(img), np.asarray(ref)
    diff = np.abs(img - ref)
    frac = np.mean(diff / (np.abs(ref) + 1e-3) < 1e-3)
    assert frac > 0.995, f"only {frac:.1%} of channels match"
    assert np.median(diff) < 1e-5
    assert np.mean(np.asarray(samples) == np.asarray(ref_samples)) > 0.99
    assert np.asarray(samples).sum() > 0, "no samples completed"


def _camera():
    cam = JCamera()
    JOrbit(yaw=0.5, pitch=-0.3).apply(cam)
    return cam


# -- layout, config, tables -----------------------------------------------------
def test_state_fields_follow_the_jax_leaf_order():
    assert TM.MCMState.field_names() == K.STATE_FIELDS == tuple(FIELDS)


def test_config_and_renderer_defaults_match_jax():
    assert MCMConfig() == convert.mcm_config_from(JMCMConfig())
    vol = JVolume.sphere_in_cube(8)
    j, t = JM.MCMRenderer(vol), TM.MCMRenderer(convert.volume_from(vol), device="cpu")
    assert t.resolution == j.resolution and t.config == convert.mcm_config_from(j.config)
    assert t.COMPACT_CACHE_POSES == j.COMPACT_CACHE_POSES and t.compaction == j.compaction
    assert t.tf2d.bumps == j.tf2d.bumps  # the grayscale ramp
    np.testing.assert_array_equal(t.environment.numpy(), np.asarray(j._static_ctx["environment"]))
    assert isinstance(make_renderer("mcm", convert.volume_from(vol), device="cpu"),
                      TM.MCMRenderer)


@pytest.mark.parametrize("mode", MODES)
def test_renderer_tables_match_jax(mode):
    """The port packs (or keeps raw) what the JAX renderer does, bit for bit."""
    j, t = _pair(mode)
    jctx, tctx = j.ctx(_camera(), 3), t.ctx(convert.camera_from(_camera()), 3)
    want = _port_ctx(jctx, j.volume.filter)
    got_vol, want_vol = KS.density_table(tctx), KS.density_table(want)
    assert got_vol.dtype == want_vol.dtype and torch.equal(got_vol, want_vol)
    assert type(tctx.density) is type(want.density)
    for k in ("tf_table", "environment"):
        assert torch.equal(getattr(tctx, k), getattr(want, k)), k
    for k in ("inv_mvp", "seed_bits", "extinction", "blur", "anisotropy", "max_bounces",
              "volume_filter"):
        np.testing.assert_array_equal(getattr(tctx, k), getattr(want, k), err_msg=k)


@pytest.mark.parametrize("shape", [(1, 1, 3), (8, 16, 3)])
def test_sample_environment_matches_jax(shape):
    env = np.random.default_rng(3).random(shape).astype(np.float32)
    d = np.random.default_rng(4).normal(size=(3, 4000)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    # the poles and directions whose |y| rounds past 1 (clipped)
    d[:, :4] = np.array([[0, 0, 0, 0], [1, -1, 1.0000001, -1.0000001], [0, 0, 0, 0]],
                        np.float32)
    want = np.asarray(JM.sample_environment(jnp.asarray(env), *map(jnp.asarray, d)))
    got = K.sample_environment(torch.as_tensor(env), *map(torch.as_tensor, d)).numpy()
    assert got.shape == want.shape == (4000, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert K.INV_PI_HALF == float(np.float32(JM.INVPI * 0.5))


@pytest.mark.parametrize("mode", ["u8", "raw"])
def test_full_reset_matches_jax(mode):
    j, t = _pair(mode)
    sj, st = j.reset(_camera(), 3), t.reset(convert.camera_from(_camera()), 3)
    for k in FIELDS:
        a, b = np.asarray(getattr(sj, k)), getattr(st, k).numpy()
        assert a.shape == b.shape == (RES, RES) and a.dtype == b.dtype, k
        if k in ("px", "py", "pz"):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5, err_msg=k)
        elif k in ("dx", "dy", "dz"):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


# -- the Woodcock step and dispatches ---------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_render_body_matches_jax(mode):
    """One iteration from the same state and chains: the chains bit for bit,
    the state under the parity contract."""
    j, _ = _pair(mode)
    cam = _camera()
    jctx = j.ctx(cam, 7)
    sj = j.reset(cam, 7)
    st = _port_state(sj)
    tctx = _port_ctx(jctx, j.volume.filter)
    jix, jiy = JM._pixel_grid(RES)
    jsx, jsy = JM.geometry.screen_position(jix, jiy, 1.0 / RES)
    jrng = JS.seed_state(jix, jiy, jctx.seed_bits)
    ix, iy = K._pixel_grid(RES, "cpu")
    sx, sy = K._screen(ix, iy, RES)
    rng = K.sampling.seed_state(ix, iy, tctx.seed_bits)
    p = {k: getattr(st, k) for k in FIELDS}
    for _ in range(4):
        sj, jrng = JM._render_body(sj, jrng, jsx, jsy, jctx, j.volume.filter)
        p, rng = K._render_body(p, rng, sx, sy, tctx)
    np.testing.assert_array_equal(rng.numpy().astype(np.uint32), np.asarray(jrng))
    for k in ("bounces", "samples"):
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(getattr(sj, k)), err_msg=k)
    img = torch.stack([p["rr"], p["rg"], p["rb"]], -1).numpy()
    jimg = np.stack([np.asarray(sj.rr), np.asarray(sj.rg), np.asarray(sj.rb)], -1)
    _contract(img, jimg, p["samples"].numpy(), sj.samples)
    for k in ("px", "py", "pz", "tr", "tg", "tb"):
        assert np.mean(np.isclose(p[k].numpy(), np.asarray(getattr(sj, k)), rtol=1e-3,
                                  atol=1e-5)) > 0.995, k


@pytest.mark.parametrize("mode", MODES)
def test_render_many_matches_jax_from_carried_state(mode):
    """Both packages run the same dispatches from one JAX state and ctx,
    carried across by convert.py."""
    j, _ = _pair(mode)
    cam = _camera()
    sj = j.reset(cam, 5)
    st = _port_state(sj)
    jctx = j.ctx(cam, 5)
    tctx = _port_ctx(jctx, j.volume.filter)
    for seeds in ([11, 12], [13]):
        sj, img_j = JM.render_many(sj, jctx, jnp.asarray(seeds, jnp.uint32), steps=6,
                                   volume_filter=j.volume.filter)
        st, img_t = TM.render_many(st, tctx, seeds, steps=6)
    assert img_t.shape == (RES, RES, 3)
    _contract(img_t.numpy(), img_j, st.samples.numpy(), sj.samples)
    assert list(convert.mcm_state_to_numpy(st)) == list(FIELDS)


def test_render_is_render_many_of_one_seed():
    _, t = _pair("env")
    cam = convert.camera_from(_camera())
    a, b = t.reset(cam, 1), t.reset(cam, 1)
    for seed in (4, 5, 6):
        a, ia = t.render(a, cam, seed)
    b, ib = t.render_many(b, cam, [4, 5, 6])
    assert torch.equal(ia, ib) and torch.equal(a.samples, b.samples)


# -- sessions -----------------------------------------------------------------
def _golden_scene():
    """tests/golden_tools.py's scene for both packages."""
    volume = JVolume.sphere_in_cube(16)
    jtf, ttf = _tfs(_tf_table())
    cam = JCamera()
    JOrbit(yaw=0.4, pitch=-0.3).apply(cam)
    return volume, jtf, ttf, cam


def _sessions(res=16, base_seed=7, **kw):
    volume, jtf, ttf, cam = _golden_scene()
    cfg = JMCMConfig(extinction=30.0, steps=6)
    j = JaxSession("mcm", volume, jtf, None, cfg, camera=cam, base_seed=base_seed,
                   resolution=res, **kw)
    t = RenderSession("mcm", convert.volume_from(volume), ttf, None,
                      convert.mcm_config_from(cfg), device="cpu",
                      camera=convert.camera_from(cam), base_seed=base_seed, resolution=res, **kw)
    return j, t


def test_session_reproduces_the_golden():
    if not os.path.exists(GOLDEN_PATH):
        pytest.skip("goldens not generated (python tests/golden_tools.py regen)")
    golden = np.load(GOLDEN_PATH)["mcm"]
    _, t = _sessions()
    K.reset_launch_counts()
    t.run(3)
    np.testing.assert_allclose(t.hdr_image(), golden, rtol=1e-4, atol=1e-5)
    assert all(v == 0 for v in K.LAUNCHES.values())  # plain versions count nothing


@pytest.mark.parametrize("compaction", [False, True])
def test_three_frame_session_matches_jax(compaction):
    j, t = _sessions(base_seed=3, compaction=compaction)
    j.run(3)
    t.run(3)
    assert t.frame == j.frame == 3
    _contract(t.hdr_image(), j.hdr_image(), t.state.samples.numpy(), j.state.samples)
    assert sorted(t.metrics()) == sorted(j.metrics())
    assert t.metrics()["paths"] == pytest.approx(j.metrics()["paths"], rel=1e-2)
    u8 = t.image_u8()
    assert u8.shape == (16, 16, 3) and u8.dtype == np.uint8


def test_jax_checkpoint_loads_into_port_and_back(tmp_path):
    j, t = _sessions()
    j.run(2)
    j.save_checkpoint(str(tmp_path / "jax.npz"))
    t.load_checkpoint(str(tmp_path / "jax.npz"))
    assert t.frame == 2
    for k, v in convert.mcm_state_to_numpy(t.state).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(j.state, k)), err_msg=k)
    j.run(1)
    t.run(1)
    _contract(t.hdr_image(), j.hdr_image(), t.state.samples.numpy(), j.state.samples)
    t.save_checkpoint(str(tmp_path / "port.npz"))
    j2, _ = _sessions()
    j2.load_checkpoint(str(tmp_path / "port.npz"))
    assert j2.frame == 3
    for k, v in convert.mcm_state_to_numpy(t.state).items():
        np.testing.assert_array_equal(np.asarray(getattr(j2.state, k)), v, err_msg=k)


def test_checkpoint_resume_is_exact(tmp_path):
    _, a = _sessions()
    _, b = _sessions()
    a.run(4)
    b.run(2)
    b.save_checkpoint(str(tmp_path / "half.npz"))
    _, c = _sessions()
    c.load_checkpoint(str(tmp_path / "half.npz")).run(2)
    np.testing.assert_array_equal(c.hdr_image(), a.hdr_image())


# -- physics (tests/test_mcm_mcs.py on the port) ------------------------------------
def _physics(table, env, cfg):
    _, ttf = _tfs(table)
    return (make_renderer("mcm", convert.volume_from(JVolume.sphere_in_cube(16)), ttf, env, cfg,
                          resolution=RES, device="cpu"),
            convert.camera_from(JCamera()))


def test_mcm_vacuum_renders_environment():
    """Zero-alpha TF: every sample escapes with transmittance 1 and the
    render converges to the environment exactly."""
    r, cam = _physics(np.zeros((256, 256, 4), np.float32),
                      np.full((1, 1, 3), 0.75, np.float32), MCMConfig(extinction=10.0, steps=16))
    state = r.reset(cam, 0)
    for f in range(6):
        state, img = r.render(state, cam, f + 1)
    sampled = state.samples.numpy() > 0
    assert sampled.mean() > 0.9
    np.testing.assert_allclose(img.numpy()[sampled], 0.75, atol=1e-5)


def test_mcm_dense_absorber_is_black_inside():
    t = np.zeros((256, 256, 4), np.float32)
    t[..., 3] = 1.0
    r, cam = _physics(t, None, MCMConfig(extinction=200.0, steps=32))
    state = r.reset(cam, 0)
    for f in range(4):
        state, img = r.render(state, cam, f + 1)
    c = RES // 2
    assert int(state.samples[c, c]) > 0
    assert float(img[c, c].max()) < 1e-3


def test_mcm_deterministic():
    r, cam = _physics(_tf_table((0.9, 0.9, 0.9)), None, MCMConfig(steps=8))
    s1, i1 = r.render(r.reset(cam, 5), cam, 5)
    s2, i2 = r.render(r.reset(cam, 5), cam, 5)
    assert torch.equal(i1, i2)


def test_mcm_transmittance_attenuates():
    """Red albedo with a white env tints multi-bounce radiance red."""
    r, cam = _physics(_tf_table((0.9, 0.0, 0.0)), None,
                      MCMConfig(extinction=50.0, steps=64, bounces=8))
    state = r.reset(cam, 3)
    for f in range(10):
        state, img = r.render(state, cam, f * 7 + 1)
    c = RES // 2
    assert float(img[c, c, 0]) > float(img[c, c, 1]) + 0.01
    assert float(img[c, c, 0]) > float(img[c, c, 2]) + 0.01


# -- hit-lane compaction (tests/test_compact.py on the port) -------------------------
SEEDS = [(k + 1) * 2654435761 % 2**32 for k in range(10)]


def test_compact_hit_pixels_equal_the_full_render_and_misses_converge():
    _, full = _pair("env")
    _, comp = _pair("env", compaction=True)
    cam = convert.camera_from(JCamera())
    sf, img_full = full.render_many(full.reset(cam, SEEDS[0]), cam, SEEDS)
    sc, img_comp = comp.render_many(comp.reset(cam, SEEDS[0]), cam, SEEDS)
    t = comp._compact_tables(cam)
    hit = t["hit"]
    assert sc.px.shape == t["lane_ix"].shape and t["n_hit"] == int(hit.sum())
    assert torch.equal(img_comp[hit], img_full[hit])

    def converged(seed0):
        s = full.reset(cam, seed0)
        return full.render_many(s, cam, [(seed0 + k + 1) * 2654435761 % 2**32
                                         for k in range(60)])[1].numpy()

    a, b = converged(1), converged(991)
    miss = ~hit.numpy()
    assert miss.any()
    floor = np.abs(a[miss] - b[miss]).mean()
    diff = np.abs(img_comp.numpy()[miss] - a[miss]).mean()
    assert diff < 2.0 * floor + 1e-4, (diff, floor)


def test_compact_state_and_image_match_jax():
    """compact_reset and the dispatches over the lane table against JAX's
    (the same lane tables), and compact_image (K8 with the three channels as
    bins) against JAX's scatter through lane_pixel, padding lanes into the
    dump row, on the same state: bit for bit."""
    j, t = _pair("env", compaction=True)
    cam = JCamera()
    jt, tt = j._compact_tables(cam), t._compact_tables(convert.camera_from(cam))
    for k in ("hit", "lane_ix", "lane_iy", "lane_pixel"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]).astype(tt[k].numpy().dtype))
    np.testing.assert_array_equal(tt["miss"].numpy().transpose(1, 2, 0), np.asarray(jt["miss"]))
    assert tt["n_hit"] == jt["n_hit"]
    sj = j.reset(cam, SEEDS[0])
    st = t.reset(convert.camera_from(cam), SEEDS[0])
    for k in ("bounces", "samples", "tr", "rr"):
        np.testing.assert_array_equal(getattr(st, k).numpy(), np.asarray(getattr(sj, k)))
    np.testing.assert_allclose(st.px.numpy(), np.asarray(sj.px), rtol=1e-4, atol=1e-5)
    sj, img_j = j.render_many(sj, cam, SEEDS[:4])
    st, img_t = t.render_many(st, convert.camera_from(cam), SEEDS[:4])
    _contract(img_t.numpy(), img_j, st.samples.numpy(), sj.samples)
    # the image of one state (JAX's, carried across) through both
    st = _port_state(sj)
    want = np.asarray(JC.compact_image(sj, jt["lane_pixel"], jt["hit"], jt["miss"], RES))
    got = TC.compact_image(st, tt["pixel_hit"], tt["n_hit"], tt["miss"], RES).numpy()
    assert got.shape == want.shape == (RES, RES, 3)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert int(tt["lane_pixel"][-1]) == RES * RES  # a padding lane's dump row


def test_compact_cache_bounded():
    _, comp = _pair("u8", res=16, compaction=True)
    for k in range(12):
        cam = JCamera()
        JOrbit(yaw=2 * np.pi * k / 12, pitch=-0.3).apply(cam)
        comp._compact_tables(convert.camera_from(cam))
    assert len(comp._compact_cache) == comp.COMPACT_CACHE_POSES == 8


def test_compaction_requires_blur_zero():
    vol = convert.volume_from(JVolume.sphere_in_cube(8))
    with pytest.raises(ValueError, match="compaction requires blur=0"):
        TM.MCMRenderer(vol, config=MCMConfig(blur=0.1), compaction=True, device="cpu")


# -- wrappers and the command line -----------------------------------------------
def test_wrappers_refuse_mixed_and_unsupported_devices():
    _, t = _pair("u8", res=8)
    cam = convert.camera_from(JCamera())
    state = t.reset(cam, 1)
    ctx = t.ctx(cam, 1)
    meta = TM.MCMCtx(**{**ctx.__dict__, "tf_table": ctx.tf_table.to("meta")})
    with pytest.raises(ValueError, match="different devices"):
        K.step(state, meta, [1], 2)
    raw = TM.MCMCtx(**{**ctx.__dict__, "density": torch.zeros((4, 4, 4), device="meta"),
                       "tf_table": torch.zeros((4, 4, 4), device="meta"),
                       "environment": torch.zeros((1, 1, 3), device="meta")})
    with pytest.raises(ValueError, match="unsupported device"):
        K.reset(raw, 8, "meta")
    with pytest.raises(ValueError, match="scene tables lie on cpu"):
        K.reset(ctx, 8, "meta")


SMALL = ["--volume-size", "16", "--resolution", "16", "--frames", "2", "--steps", "4"]


def test_cli_render_mcm_matches_jax(tmp_path, capsys):
    """render --renderer mcm on --device cpu against vpt_tpu's CLI: the same
    metrics keys and path count, the tone-mapped u8 images within 1 on
    >= 99% of values."""
    out, out_j = str(tmp_path / "mcm.npy"), str(tmp_path / "mcm_jax.npy")
    cli_main(["render", "--device", "cpu", *SMALL, "--renderer", "mcm", "-o", out])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_cli.main(["render", *SMALL, "--renderer", "mcm", "-o", out_j])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(metrics) - {"device"} == set(want) and metrics["device"] == "cpu"
    assert metrics["frames"] == want["frames"] == 2
    assert metrics["paths"] == pytest.approx(want["paths"], rel=1e-2)
    img, img_j = np.load(out), np.load(out_j)
    assert img.shape == img_j.shape == (16, 16, 3) and img.dtype == np.uint8
    assert np.mean(np.abs(img.astype(int) - img_j.astype(int)) <= 1) >= 0.99


def test_cli_render_mcm_with_envmap_and_compaction(tmp_path, capsys):
    env = str(tmp_path / "env.npy")
    np.save(env, _envmap())
    out = str(tmp_path / "mcm_compact.npy")
    cli_main(["render", "--device", "cpu", *SMALL, "--renderer", "mcm", "--envmap", env,
              "--compaction", "-o", out])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.load(out).shape == (16, 16, 3) and metrics["paths"] > 0


def test_physics_match_jax_make_renderer():
    """The vacuum case through both factories: the same converged env."""
    t = np.zeros((256, 256, 4), np.float32)
    jtf, ttf = _tfs(t)
    env = np.full((1, 1, 3), 0.6, np.float32)
    cfg = JMCMConfig(extinction=10.0, steps=8)
    j = jax_make_renderer("mcm", JVolume.sphere_in_cube(16), jtf, env, cfg, resolution=16)
    r = make_renderer("mcm", convert.volume_from(JVolume.sphere_in_cube(16)), ttf, env,
                      convert.mcm_config_from(cfg), resolution=16, device="cpu")
    cam = JCamera()
    sj, ij = j.render(j.reset(cam, 0), cam, 1)
    st, it = r.render(r.reset(convert.camera_from(cam), 0), convert.camera_from(cam), 1)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(st.samples.numpy(), np.asarray(sj.samples))
