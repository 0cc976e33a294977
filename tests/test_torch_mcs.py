"""The single-scattering renderer MCS, its frame path (vpt_tpu_torch/models/
mcs.py, kernels/mcs.py), against vpt_tpu's on the CPU, where the wrapper runs
the plain version.

Inputs come from numpy with a seed; volumes are 16^3 (sphere_in_cube, or a
smoothed random f32 density), images 16^2 (32^2 and 24^2 for the chain
seeds: the frames compare at powers of two, see below). Five table modes: linear on
the u8 packed table, an f32 packed table, quasicubic, nearest on the raw
grid, and a seeded 8x16 environment map; and the majorant grid.

Tolerances, and why:
- The host's scattering directions, the majorant grid and the per-pixel
  chain seeds at R = 16 and 32: bit for bit (integer hashes and the same
  double and float32 arithmetic). At R = 24 XLA's CPU code divides the
  pixel's uv by R as a multiply by the reciprocal, the port by IEEE
  division: the seeds differ on exactly the rows and columns whose uv bits
  differ.
- The two Woodcock loops on the same rays and chains, and frames: the
  spectral parity contract (tests/test_torch_mcm_spectral.py): >= 99.5% of
  values within 1e-3 relative and >= 99.5% of the lanes' final chains
  equal. An ulp of libm or an FMA of XLA's CPU code can flip one lane's
  lookup, after which the lane diverges; the allowance covers that. Each
  test prints the number of lanes whose chain differs.
- The port's ``render_many`` against sequential ``render`` calls and two
  runs of one seed: bit for bit (the same plain arithmetic).
- The session against the ``mcs`` golden: test_golden.py's rtol 1e-4, atol
  1e-5. The majorant's statistical parity: test_mcm_mcs.py's (the converged
  majorant image within twice the exact path's seed-to-seed floor).
- The CLI's image at 16^2: the tone-mapped u8 image equal; the metrics'
  keys and frame count equal (their seconds differ).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_tools import GOLDEN_PATH
from vpt_tpu import cli as jax_cli
from vpt_tpu.models import make_renderer as jax_make_renderer
from vpt_tpu.models import mcs as JM
from vpt_tpu.models import raymarch as JR
from vpt_tpu.ops import interp as JI
from vpt_tpu.ops import sampling as JS
from vpt_tpu.scene.camera import Camera as JCamera
from vpt_tpu.scene.camera import OrbitController as JOrbit
from vpt_tpu.scene.tf import TransferFunction2D as JTF
from vpt_tpu.scene.volume import Volume as JVolume
from vpt_tpu.session import RenderSession as JaxSession
from vpt_tpu_torch import convert
from vpt_tpu_torch.cli import main as cli_main
from vpt_tpu_torch.kernels import mcs as K
from vpt_tpu_torch.models import make_renderer
from vpt_tpu_torch.models import mcs as TM
from vpt_tpu_torch.session import RenderSession

torch.set_num_threads(1)

RES, SIZE = 16, 16
MODES = ("u8", "f32", "quasicubic", "nearest", "env")
SEEDS = [3, 71, 9001, 44]


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
    """(JAX volume, environment) of a mode."""
    vol, env = JVolume.sphere_in_cube(SIZE), None
    if mode == "f32":
        vol = JVolume(density=_smoothed_random(SIZE, 5))
    elif mode in ("quasicubic", "nearest"):
        vol.filter = mode
    elif mode == "env":
        env = _envmap()
    return vol, env


def _pair(mode="u8", res=RES, table=None, **kw):
    vol, env = _mode_args(mode)
    jtf, ttf = _tfs(_tf_table() if table is None else table)
    kw = dict(dict(extinction=30.0), **kw)
    j = JM.MCSRenderer(vol, jtf, env, resolution=res, **kw)
    t = TM.MCSRenderer(convert.volume_from(vol), ttf, env, resolution=res, device="cpu", **kw)
    return j, t


def _camera():
    cam = JCamera()
    JOrbit(yaw=0.5, pitch=-0.3).apply(cam)
    return cam


def _port_ctx(jctx):
    d = jctx.density
    table, dims = ((np.asarray(d.table), d.dims) if isinstance(d, JI.PackedVolume)
                   else (np.asarray(d), None))
    return convert.mcs_ctx_from_numpy(
        inv_mvp=np.asarray(jctx.inv_mvp), seed_bits=np.asarray(jctx.seed_bits),
        extinction=np.asarray(jctx.extinction), scatter_dir=np.asarray(jctx.scatter_dir),
        density_table=table, density_dims=dims, tf_table=np.asarray(jctx.tf_table),
        environment=np.asarray(jctx.environment),
        majorant=None if jctx.majorant is None else np.asarray(jctx.majorant), device="cpu")


def _contract(got, want, chains=None, want_chains=None, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    frac = np.mean(np.abs(got - want) / (np.abs(want) + 1e-3) < 1e-3)
    assert frac >= 0.995, f"{what}: only {frac:.2%} of values match"
    if chains is not None:
        same = np.asarray(chains).astype(np.uint32) == np.asarray(want_chains)
        print(f"{what}: {int((~same).sum())} of {same.size} lanes' chains differ")
        assert same.mean() >= 0.995, f"{what}: {int((~same).sum())} chains differ"


# -- host directions, seeds, layout ------------------------------------------------
def test_host_scatter_direction_is_bit_equal_to_jax():
    for seed in range(1000):
        a = JM._host_scatter_direction(seed * 2654435761 % 2**32)
        b = TM._host_scatter_direction(seed * 2654435761 % 2**32)
        assert b.dtype == np.float32 and np.array_equal(a.view(np.uint32), b.view(np.uint32)), seed
        assert abs(float(np.linalg.norm(b)) - 1.0) < 1e-6


def _jax_chain_seeds(resolution, seed):
    """The chains JAX's jitted ``_mcs_frame_impl`` seeds, taken from its
    call of ``_woodcock_distance`` by a host callback."""
    j, _ = _pair(res=resolution)
    ctx = j.ctx(JCamera(), seed)
    box = {}

    def fake(rng, ctx, frm, to, max_collisions, volume_filter):
        jax.debug.callback(lambda r: box.__setitem__("rng", np.asarray(r)), rng)
        z = jnp.zeros_like(frm[0])
        return rng, z, z

    real = JM._woodcock_distance
    JM._woodcock_distance = fake
    try:
        jax.block_until_ready(jax.jit(JM._mcs_frame_impl, static_argnums=(1, 2))(
            ctx, resolution, 2))
    finally:
        JM._woodcock_distance = real
    return box["rng"]


def _jax_uv(resolution):
    f = jax.jit(lambda: ((jax.lax.broadcasted_iota(jnp.float32, (resolution,), 0) + 0.5)
                         / resolution).astype(jnp.float32))
    return np.asarray(f())


@pytest.mark.parametrize("resolution", [16, 24, 32])
def test_pixel_chain_seeds_match_jax(resolution):
    seed = 2654435761
    want = _jax_chain_seeds(resolution, seed)
    got = K.pixel_seeds(resolution, seed, "cpu").numpy().astype(np.uint32)
    ieee = (np.arange(resolution, dtype=np.float32) + np.float32(0.5)) / np.float32(resolution)
    off = _jax_uv(resolution).view(np.uint32) != ieee.view(np.uint32)
    differ = off[None, :] | off[:, None]
    if resolution in (16, 32):
        assert not off.any()
        np.testing.assert_array_equal(got, want)
    else:
        # XLA's CPU code multiplies by the reciprocal of 24: some uv bits move
        assert off.sum() > 0
        np.testing.assert_array_equal(got != want, differ)
    bits = ieee.view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(JS.hash3(
        jnp.asarray(np.broadcast_to(bits[None, :], got.shape)),
        jnp.asarray(np.broadcast_to(bits[:, None], got.shape)),
        jnp.full(got.shape, seed, jnp.uint32))))


def test_renderer_defaults_and_tables_match_jax():
    vol = JVolume.sphere_in_cube(8)
    j, t = JM.MCSRenderer(vol), TM.MCSRenderer(convert.volume_from(vol), device="cpu")
    for k in ("extinction", "max_collisions", "resolution", "persistent", "steps", "streams"):
        assert getattr(t, k) == getattr(j, k), k
    assert t.tf2d.bumps == j.tf2d.bumps and t.majorant is None
    assert isinstance(make_renderer("mcs", convert.volume_from(vol), device="cpu"),
                      TM.MCSRenderer)
    for mode in MODES:
        j, t = _pair(mode, majorant_blocks=4)
        jctx, tctx = j.ctx(_camera(), 5), t.ctx(convert.camera_from(_camera()), 5)
        want = _port_ctx(jctx)
        gv, wv = K.RK._volume_tensor(tctx.density), K.RK._volume_tensor(want.density)
        assert gv.dtype == wv.dtype and torch.equal(gv, wv), mode
        for k in ("tf_table", "environment", "majorant"):
            assert torch.equal(getattr(tctx, k), getattr(want, k)), (mode, k)
        for k in ("inv_mvp", "seed_bits", "extinction", "scatter_dir"):
            np.testing.assert_array_equal(getattr(tctx, k), getattr(want, k), err_msg=k)


@pytest.mark.parametrize("mode", ["u8", "f32"])
def test_majorant_grid_is_bit_equal_to_jax(mode):
    for blocks in (2, 4):
        j, t = _pair(mode, majorant_blocks=blocks)
        want = np.asarray(j._static_ctx["majorant"])
        assert want.shape[-1] == 2 and t.majorant.dtype == torch.float32
        np.testing.assert_array_equal(t.majorant.numpy().view(np.uint32), want.view(np.uint32))


# -- the two Woodcock loops on the same rays -------------------------------------------
def _rays(res=RES):
    """JAX's camera rays clamped to the cube (entry, exit, miss) at R."""
    frm, to = JR.camera_rays(res, jnp.asarray(_camera().inverse_mvp()))
    tn, tf, miss = JR.ray_bounds(frm, to)
    entry, exit_ = JR._mix3(frm, to, tn), JR._mix3(frm, to, tf)
    return [np.asarray(a) for a in entry], [np.asarray(a) for a in exit_], np.asarray(miss)


@pytest.mark.parametrize("majorant", [None, 4])
def test_woodcock_loops_match_jax(majorant):
    j, _ = _pair(majorant_blocks=majorant)
    jctx = j.ctx(_camera(), 11)
    tctx = _port_ctx(jctx)
    entry, exit_, miss = _rays()
    rng0 = np.random.default_rng(3).integers(0, 2**32, size=miss.shape, dtype=np.uint32)
    jd = jax.jit(JM._woodcock_distance, static_argnums=(4, 5))
    jrng, jdist, jmax = jd(jnp.asarray(rng0), jctx, tuple(map(jnp.asarray, entry)),
                           tuple(map(jnp.asarray, exit_)), 1024, "linear")
    T = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    rng, dist, max_dist = K._woodcock_distance(T(rng0).to(torch.int64), tctx,
                                               tuple(map(T, entry)), tuple(map(T, exit_)), 1024,
                                               "linear")
    _contract(dist.numpy(), jdist, rng.numpy(), jrng, f"distance, majorant {majorant}")
    _contract(max_dist.numpy(), jmax)
    # the transmittance from each collision toward a fixed direction's exit
    mask = ~miss & ~(np.asarray(jdist) > np.asarray(jmax))
    assert mask.mean() > 0.1  # lanes that collided inside the cube
    t = np.asarray(jdist) / np.maximum(np.asarray(jmax), np.float32(1e-30))
    scat = [e + (x - e) * t for e, x in zip(entry, exit_)]
    light_exit = [np.clip(s + np.float32(d * 0.7), 0, 1).astype(np.float32)
                  for s, d in zip(scat, (0.6, -0.48, 0.64))]
    jt = jax.jit(JM._woodcock_transmittance, static_argnums=(5, 6))
    jrng2, jtrans = jt(jrng, jnp.asarray(mask), jctx, tuple(map(jnp.asarray, scat)),
                       tuple(map(jnp.asarray, light_exit)), 1024, "linear")
    rng2, trans = K._woodcock_transmittance(T(np.asarray(jrng)).to(torch.int64), T(mask), tctx,
                                            tuple(map(T, scat)), tuple(map(T, light_exit)),
                                            1024, "linear")
    _contract(trans.numpy(), jtrans, rng2.numpy(), jrng2, f"transmittance, majorant {majorant}")
    assert float(trans.min()) < 0.9  # the shadow rays cross the sphere


# -- frames ------------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_mcs_frame_matches_jax(mode):
    j, _ = _pair(mode)
    jctx = j.ctx(_camera(), 2654435761)
    want = JM.mcs_frame(jctx, resolution=RES, max_collisions=1024, volume_filter=j.volume.filter)
    got = K.mcs_frame(_port_ctx(jctx), RES, 1024, j.volume.filter)
    assert got.shape == (RES, RES, 4)
    _contract(got.numpy(), want, what=mode)
    assert float(got[..., 3].min()) < 0.9  # some collisions are shaded


@pytest.mark.parametrize("mode,max_collisions", [(m, 1024) for m in MODES]
                         + [("u8", 2), ("u8", 16), ("majorant", 16)])
def test_render_many_matches_jax(mode, max_collisions):
    kw = dict(max_collisions=max_collisions)
    if mode == "majorant":
        mode, kw["majorant_blocks"] = "u8", 4
    j, t = _pair(mode, **kw)
    cam = _camera()
    sj, st = j.reset(cam), t.reset(convert.camera_from(cam))
    for seeds in (SEEDS[:3], SEEDS[3:]):
        sj, img_j = j.render_many(sj, cam, seeds)
        st, img_t = t.render_many(st, convert.camera_from(cam), seeds)
    assert int(st["frame"]) == int(sj["frame"]) == 4 and st["frame"].dtype == torch.int32
    _contract(st["acc"].numpy(), sj["acc"], what=f"{mode} at {max_collisions}")
    np.testing.assert_array_equal(img_t.numpy(), st["acc"][..., :3].numpy())
    assert list(convert.mcs_state_to_numpy(st)) == ["acc", "frame"]


def test_render_many_is_sequential_renders_bit_for_bit():
    _, t = _pair("env", majorant_blocks=4)
    cam = convert.camera_from(_camera())
    a, b = t.reset(cam), t.reset(cam)
    for seed in SEEDS[:3]:
        a, ia = t.render(a, cam, seed)
    b, ib = t.render_many(b, cam, SEEDS[:3])
    assert torch.equal(ia, ib) and torch.equal(a["acc"], b["acc"]) and int(b["frame"]) == 3
    c, ic = t.render_many(t.reset(cam), cam, SEEDS[:3])
    assert torch.equal(ic, ib)


def test_frames_carry_a_state_across_from_jax():
    """K frames from a JAX state and ctx carried across by convert.py, the
    JAX ``mcs_frames`` on the same inputs; its arguments are left as they
    were, and ``frames`` updates them in place."""
    j, _ = _pair("f32")
    cam = _camera()
    sj = j.reset(cam)
    sj, _ = j.render_many(sj, cam, SEEDS[:2])
    st = convert.mcs_state_from_numpy({k: np.asarray(v) for k, v in sj.items()}, "cpu")
    dirs = np.stack([JM._host_scatter_direction(s) for s in SEEDS[2:]])
    jctx = j.ctx(cam, SEEDS[2])
    acc_j, frame_j = JM.mcs_frames(jctx, jnp.asarray(SEEDS[2:], jnp.uint32), jnp.asarray(dirs),
                                   sj["acc"], sj["frame"], resolution=RES)
    before = st["acc"].clone()
    acc, frame = K.mcs_frames(_port_ctx(jctx), SEEDS[2:], dirs, st["acc"], st["frame"], RES)
    assert torch.equal(st["acc"], before) and int(st["frame"]) == 2
    _contract(acc.numpy(), acc_j, what="mcs_frames")
    assert int(frame) == int(frame_j) == 4
    K.frames(st["acc"], st["frame"], _port_ctx(jctx), SEEDS[2:], dirs)
    assert torch.equal(st["acc"], acc) and int(st["frame"]) == 4


@pytest.mark.parametrize("seed", [1, 77])
def test_majorant_frames_match_jax_per_seed(seed):
    """Majorant mode draws as JAX's does: per seed, the same frames."""
    j, t = _pair(majorant_blocks=4, extinction=20.0)
    cam = _camera()
    seeds = [(seed + k) * 2654435761 % 2**32 for k in range(3)]
    sj, ij = j.render_many(j.reset(cam), cam, seeds)
    st, it = t.render_many(t.reset(convert.camera_from(cam)), convert.camera_from(cam), seeds)
    _contract(st["acc"].numpy(), sj["acc"], what=f"majorant seed {seed}")


# -- physics (tests/test_mcm_mcs.py on the port) ---------------------------------------
def _physics(table, env=None, **kw):
    _, ttf = _tfs(table)
    return (make_renderer("mcs", convert.volume_from(JVolume.sphere_in_cube(16)), ttf, env,
                          resolution=RES, device="cpu", **kw),
            convert.camera_from(JCamera()))


def test_mcs_vacuum_is_environment():
    r, cam = _physics(np.zeros((256, 256, 4), np.float32), np.full((1, 1, 3), 0.6, np.float32),
                      extinction=5.0)
    state, img = r.render(r.reset(cam), cam, 1)
    np.testing.assert_allclose(img.numpy(), 0.6, atol=1e-5)


def test_mcs_shades_collisions():
    r, cam = _physics(_tf_table((0.9, 0.9, 0.9)), extinction=50.0, max_collisions=32)
    state = r.reset(cam)
    for f in range(12):
        state, img = r.render(state, cam, f + 1)
    img = img.numpy()
    c = RES // 2
    assert np.isfinite(img).all() and img[c, c].mean() < img[0, 0].mean()


def test_mcs_frame_average():
    r, cam = _physics(_tf_table((0.9, 0.9, 0.9)), extinction=20.0)
    state, _ = r.render(r.reset(cam), cam, 1)
    assert int(state["frame"]) == 1
    state, _ = r.render(state, cam, 2)
    assert int(state["frame"]) == 2


def test_mcs_majorant_statistical_parity():
    """test_mcm_mcs.py:152 on the port: the majorant path converges to the
    exact path's image within twice its seed-to-seed floor."""
    def converged(maj, seed):
        r, cam = _physics(_tf_table((0.9, 0.9, 0.9)), extinction=20.0, majorant_blocks=maj)
        seeds = [(seed + k + 1) * 2654435761 % 2**32 for k in range(160)]
        return r.render_many(r.reset(cam), cam, seeds)[1].numpy()

    a, b, m = converged(None, 1), converged(None, 991), converged(4, 1)
    floor, diff = np.abs(a - b).mean(), np.abs(a - m).mean()
    assert np.isfinite(m).all() and diff < 2.0 * floor + 1e-4, (diff, floor)


# -- sessions -----------------------------------------------------------------------------
def _sessions(res=16, base_seed=7, **kw):
    """tests/golden_tools.py's mcs scene for both packages."""
    volume = JVolume.sphere_in_cube(16)
    jtf, ttf = _tfs(_tf_table())
    cam = JCamera()
    JOrbit(yaw=0.4, pitch=-0.3).apply(cam)
    kw = dict(dict(extinction=30.0, max_collisions=16), **kw)
    j = JaxSession("mcs", volume, jtf, None, camera=cam, base_seed=base_seed, resolution=res,
                   **kw)
    t = RenderSession("mcs", convert.volume_from(volume), ttf, None, device="cpu",
                      camera=convert.camera_from(cam), base_seed=base_seed, resolution=res, **kw)
    return j, t


def test_session_reproduces_the_golden():
    import os

    if not os.path.exists(GOLDEN_PATH):
        pytest.skip("goldens not generated (python tests/golden_tools.py regen)")
    golden = np.load(GOLDEN_PATH)["mcs"]
    _, t = _sessions()
    K.reset_launch_counts()
    t.run(3)
    np.testing.assert_allclose(t.hdr_image(), golden, rtol=1e-4, atol=1e-5)
    assert all(v == 0 for v in K.LAUNCHES.values())  # plain versions count nothing


def test_three_frame_session_matches_jax():
    j, t = _sessions(base_seed=3, max_collisions=1024)
    j.run(3)
    t.run(3)
    assert t.frame == j.frame == 3
    _contract(t.hdr_image(), j.hdr_image(), what="session")
    assert sorted(t.metrics()) == sorted(j.metrics())
    u8 = t.image_u8()
    assert u8.shape == (16, 16, 3) and u8.dtype == np.uint8


def test_jax_checkpoint_loads_into_port_and_back(tmp_path):
    j, t = _sessions()
    j.run(2)
    j.save_checkpoint(str(tmp_path / "jax.npz"))
    t.load_checkpoint(str(tmp_path / "jax.npz"))
    assert t.frame == 2
    for k, v in convert.mcs_state_to_numpy(t.state).items():
        np.testing.assert_array_equal(v, np.asarray(j.state[k]), err_msg=k)
    j.run(1)
    t.run(1)
    _contract(t.hdr_image(), j.hdr_image(), what="resumed")
    t.save_checkpoint(str(tmp_path / "port.npz"))
    j2, _ = _sessions()
    j2.load_checkpoint(str(tmp_path / "port.npz"))
    assert j2.frame == 3
    for k, v in convert.mcs_state_to_numpy(t.state).items():
        np.testing.assert_array_equal(np.asarray(j2.state[k]), v, err_msg=k)


# -- refusals, devices, the command line -----------------------------------------------------
def test_xy_tables_raise():
    _, t = _pair(res=8)
    ctx = t.ctx(convert.camera_from(JCamera()), 1)
    xy = K.interp.pack_volume_auto(JVolume.sphere_in_cube(8).density, "cpu", "xy")
    bad = TM.MCSCtx(**{**ctx.__dict__, "density": xy})
    with pytest.raises(ValueError, match="full packed volume table, not 'xy'"):
        K._check_tables(bad, "linear")


def test_wrapper_refuses_mixed_and_unsupported_devices():
    _, t = _pair(res=8)
    cam = convert.camera_from(JCamera())
    state = t.reset(cam)
    ctx = t.ctx(cam, 1)
    meta = TM.MCSCtx(**{**ctx.__dict__, "tf_table": ctx.tf_table.to("meta")})
    with pytest.raises(ValueError, match="different devices"):
        K.frames(state["acc"], state["frame"], meta, [1], [TM._host_scatter_direction(1)])
    acc, frame = state["acc"].to("meta"), state["frame"].to("meta")
    on_meta = TM.MCSCtx(**{**ctx.__dict__, "density": ctx.density.table.to("meta")[:1],
                           "tf_table": ctx.tf_table.to("meta"),
                           "environment": ctx.environment.to("meta")})
    with pytest.raises(ValueError, match="unsupported device"):
        K.frames(acc, frame, on_meta, [1], [TM._host_scatter_direction(1)])
    with pytest.raises(ValueError, match="scatter directions"):
        K.frames(state["acc"], state["frame"], ctx, [1, 2], [TM._host_scatter_direction(1)])


SMALL = ["--volume-size", "16", "--resolution", "16", "--frames", "2"]


def test_cli_render_mcs_matches_jax(tmp_path, capsys):
    """render --renderer mcs on --device cpu against vpt_tpu's CLI (the
    reference's defaults: extinction 1, the grayscale ramp, a white env)."""
    out, out_j = str(tmp_path / "mcs.npy"), str(tmp_path / "mcs_jax.npy")
    cli_main(["render", "--device", "cpu", *SMALL, "--renderer", "mcs", "-o", out])
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jax_cli.main(["render", *SMALL, "--renderer", "mcs", "-o", out_j])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(metrics) - {"device"} == set(want) and metrics["device"] == "cpu"
    assert metrics["frames"] == want["frames"] == 2
    img, img_j = np.load(out), np.load(out_j)
    assert img.shape == img_j.shape == (16, 16, 3) and img.dtype == np.uint8 and img.any()
    np.testing.assert_array_equal(img, img_j)


def test_cli_refuses_compaction_on_mcs(tmp_path):
    with pytest.raises(SystemExit) as e:
        cli_main(["render", "--device", "cpu", *SMALL, "--renderer", "mcs", "--compaction",
                  "-o", str(tmp_path / "x.npy")])
    assert "--compaction is supported by mcm-spectral and mcm, not 'mcs'" in str(e.value.code)


def test_make_renderer_factories_agree():
    """The vacuum case through both factories: the same env, bit for bit."""
    jtf, ttf = _tfs(np.zeros((256, 256, 4), np.float32))
    env = np.full((1, 1, 3), 0.6, np.float32)
    j = jax_make_renderer("mcs", JVolume.sphere_in_cube(16), jtf, env, extinction=5.0,
                          resolution=16)
    r = make_renderer("mcs", convert.volume_from(JVolume.sphere_in_cube(16)), ttf, env,
                      extinction=5.0, resolution=16, device="cpu")
    cam = JCamera()
    sj, ij = j.render(j.reset(cam), cam, 1)
    st, it = r.render(r.reset(convert.camera_from(cam)), convert.camera_from(cam), 1)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
