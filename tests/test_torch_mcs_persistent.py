"""The single-scattering renderer MCS, its persistent lanes (vpt_tpu_torch/
models/mcs.py with persistent=True, kernels/mcs.py), against vpt_tpu's on
the CPU, where the wrapper runs the plain version.

Inputs come from numpy with a seed; volumes are 16^3, images 16^2 (the
chain seeds also at 32^2), as in tests/test_torch_mcs.py, whose modes and
helpers this file reuses: linear on the u8 packed table, an f32 packed
table, quasicubic, nearest on the raw grid, a seeded 8x16 environment map,
and the majorant grid (2-voxel blocks, over a TF whose alpha is 0 below
density 0.5, so that the grid's cells differ), each at 1 and at 4 streams.

Tolerances, and why:
- The persistent chain seeds at R = 16 and 32, 1 and 4 streams: bit for
  bit (integer hashes of the uv bits; R a power of two, where XLA's CPU
  code divides by R exactly, see test_torch_mcs.py).
- One dispatch and a few dispatches from the same JAX state: ``samples``
  and ``phase`` equal on >= 99.5% of lanes, the float fields the spectral
  parity contract (>= 99.5% of values within 1e-3 relative). XLA's CPU code
  may contract ``b + d * dist`` into an FMA, so a lane can flip an event and
  part from JAX's; each test prints how many lanes part.
- The port against itself (``render`` against ``render_many`` of one seed,
  K renders against one ``render_many`` of K seeds, two runs of one seed)
  and a JAX checkpoint carried into the port and back: bit for bit.
- ``_persistent_image`` at 4 streams against JAX's: 1e-6 (the sums' order).
- The statistical tests of tests/test_mcm_mcs.py on the port (the converged
  image against the frame path, the majorant against the exact path): the
  same bound, twice the frame path's seed-to-seed floor plus 1e-4; the miss
  rays: the environment within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mcs import RES, _camera, _pair, _port_ctx, _tf_table, _tfs
from vpt_tpu.models import mcs as JM
from vpt_tpu.models.raymarch import camera_rays as jax_camera_rays
from vpt_tpu.ops import geometry as JG
from vpt_tpu.ops import sampling as JS
from vpt_tpu.scene.camera import Camera as JCamera
from vpt_tpu.scene.camera import OrbitController as JOrbit
from vpt_tpu.scene.volume import Volume as JVolume
from vpt_tpu.session import RenderSession as JaxSession
from vpt_tpu_torch import convert
from vpt_tpu_torch.kernels import mcs as K
from vpt_tpu_torch.models import make_renderer
from vpt_tpu_torch.models import mcs as TM
from vpt_tpu_torch.session import RenderSession, state_leaves

torch.set_num_threads(1)

STEPS = 8
MODES = ("u8", "f32", "quasicubic", "nearest", "env", "majorant")
# alpha 0 below density 0.5: the inner cube is clear, the sphere opaque
THRESHOLD_ALPHA = np.clip((np.linspace(0, 1, 256, dtype=np.float32) - 0.5) * 2, 0, 1)[None, :]


def _persistent_pair(mode, streams, res=RES):
    kw = dict(persistent=True, steps=STEPS, streams=streams)
    if mode == "majorant":
        return _pair("u8", res, _tf_table(alpha=THRESHOLD_ALPHA), majorant_blocks=2, **kw)
    return _pair(mode, res, **kw)


def _jax_copy(state):
    return jax.tree.map(jnp.copy, state)


def _from_jax(state):
    return convert.mcs_persistent_state_from_numpy(
        {k: np.asarray(getattr(state, k)) for k in state._fields}, "cpu")


def _parted(got, want, what):
    """The persistent contract: samples and phase equal on >= 99.5% of lanes,
    every float field >= 99.5% within 1e-3 relative; prints the lanes that
    part (any field off)."""
    lanes = np.asarray(want.samples).shape
    parted = np.zeros(lanes, bool)
    for k in K.PERSISTENT_FIELDS:
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind == "f":
            assert np.isfinite(a).all(), k
            close = np.abs(a - b) / (np.abs(b) + 1e-3) < 1e-3
            assert close.mean() >= 0.995, f"{what}: {k} matches on {close.mean():.2%}"
            off = ~close
        else:
            off = a != b
            assert (~off).mean() >= 0.995, f"{what}: {k} equal on {(~off).mean():.2%} of lanes"
        parted |= off.reshape(lanes + (-1,)).any(-1)
    print(f"{what}: {int(parted.sum())} of {parted.size} lanes part")
    return parted


# -- the chain seeds ----------------------------------------------------------------------
@pytest.mark.parametrize("resolution,streams", [(16, 1), (16, 4), (32, 1), (32, 4)])
def test_persistent_chain_seeds_match_jax(resolution, streams, monkeypatch):
    """The seeds JAX's dispatch hashes (taken from its hash3 call, run
    eagerly) against ``persistent_seeds`` of the lane shape (S, R, R)."""
    j, _ = _persistent_pair("u8", streams, resolution)
    seed = 2654435761
    seen = []
    real = JS.hash3
    monkeypatch.setattr(JS, "hash3", lambda *a: seen.append(real(*a)) or seen[-1])
    with jax.disable_jit():
        JM._mcs_persistent_dispatch_impl(j.reset(JCamera()), j.ctx(JCamera(), seed), resolution,
                                         0, "linear", streams)
    assert len(seen) == 1
    got = K.persistent_seeds((streams, resolution, resolution), seed, "cpu")
    want = np.asarray(seen[0]).reshape(streams, resolution, resolution)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(K.pixel_seeds(resolution, seed, "cpu").numpy(), got[0].numpy())


# -- dispatches against JAX ---------------------------------------------------------------
@pytest.mark.parametrize("streams", [1, 4])
@pytest.mark.parametrize("mode", MODES)
def test_dispatches_match_jax(mode, streams):
    """From a JAX state three dispatches into the lanes' samples: one
    dispatch (``mcs_persistent_dispatch``) and three (``mcs_persistent_many``)
    through both packages, the state carried across by convert.py."""
    j, _ = _persistent_pair(mode, streams)
    cam = _camera()
    filt = j.volume.filter
    run = lambda s, ctx, seeds: JM.mcs_persistent_many(  # noqa: E731
        s, ctx, jnp.asarray(seeds, jnp.uint32), resolution=RES, steps=STEPS,
        volume_filter=filt, streams=streams)
    sj = run(j.reset(cam), j.ctx(cam, 5), [5, 6, 7])
    assert 0 < np.asarray(sj.phase).mean() < 1  # lanes in both phases
    jctx = j.ctx(cam, 11)
    if mode == "majorant":
        m = np.asarray(jctx.majorant)[..., 0]
        assert m.min() < 0.1 and m.max() >= 1.0  # the cells differ
    one = JM.mcs_persistent_dispatch(_jax_copy(sj), jctx, resolution=RES, steps=STEPS,
                                     volume_filter=filt, streams=streams)
    few = run(_jax_copy(sj), jctx, [11, 12, 13])
    st = _from_jax(sj)
    before = [t.clone() for t in st.tensors()]
    got_one = K.mcs_persistent_dispatch(st, _port_ctx(jctx), RES, STEPS, filt, streams)
    got_few = K.mcs_persistent_many(st, _port_ctx(jctx), [11, 12, 13], RES, STEPS, filt,
                                    streams)
    assert all(torch.equal(a, b) for a, b in zip(st.tensors(), before))  # arguments kept
    _parted(got_one, one, f"{mode}, {streams} stream(s), one dispatch")
    _parted(got_few, few, f"{mode}, {streams} stream(s), three dispatches")
    assert int(got_few.samples.sum()) > int(st.samples.sum())
    # the wrapper writes the same state in place
    K.persistent(st, _port_ctx(jctx), [11, 12, 13], STEPS, filt, streams)
    assert all(torch.equal(a, b) for a, b in zip(st.tensors(), got_few.tensors()))


def test_persistent_image_matches_jax():
    """The sample-weighted mean over 4 streams of a random state."""
    j, t = _persistent_pair("u8", 4)
    rng = np.random.default_rng(17)
    sj = j.reset(JCamera())._replace(
        acc=jnp.asarray(rng.random((4, RES, RES, 4), np.float32)),
        samples=jnp.asarray(rng.integers(0, 50, (4, RES, RES)), jnp.int32))
    sj = sj._replace(samples=sj.samples.at[:, 0, :3].set(0))  # pixels with no sample yet
    got = t._persistent_image(_from_jax(sj)).numpy()
    np.testing.assert_allclose(got, np.asarray(j._persistent_image(sj)), rtol=1e-6, atol=1e-7)
    assert got.shape == (RES, RES, 3)
    _, t1 = _persistent_pair("u8", 1)
    st1 = t1.reset(None)
    assert t1._persistent_image(st1).data_ptr() == st1.acc.data_ptr()  # one stream: acc itself


# -- the port against itself --------------------------------------------------------------
def test_render_and_render_many_agree_bit_for_bit():
    _, t = _persistent_pair("env", 4)
    cam = convert.camera_from(_camera())
    a, ia = t.render(t.reset(cam), cam, 9)
    b, ib = t.render_many(t.reset(cam), cam, [9])
    assert torch.equal(ia, ib) and all(torch.equal(x, y) for x, y in zip(a.tensors(),
                                                                        b.tensors()))
    seeds = [9, 10, 11]
    c = t.reset(cam)
    for s in seeds:
        c, ic = t.render(c, cam, s)
    d, idd = t.render_many(t.reset(cam), cam, seeds)
    e, ie = t.render_many(t.reset(cam), cam, seeds)
    assert torch.equal(ic, idd) and torch.equal(idd, ie)
    assert all(torch.equal(x, y) for x, y in zip(c.tensors(), d.tensors()))
    assert int(d.samples.sum()) > 0 and ic.shape == (RES, RES, 3)


def test_reset_builds_distinct_buffers():
    for streams in (1, 4):
        _, t = _persistent_pair("u8", streams)
        s = t.reset(None)
        shape = (RES, RES) if streams == 1 else (streams, RES, RES)
        assert tuple(s.dist.shape) == shape and tuple(s.acc.shape) == shape + (4,)
        assert s.phase.dtype == torch.bool and s.samples.dtype == torch.int32
        ptrs = [x.data_ptr() for x in s.tensors()]
        assert len(set(ptrs)) == len(ptrs)
        j, _ = _persistent_pair("u8", streams)
        for k, v in convert.mcs_persistent_state_to_numpy(s).items():
            np.testing.assert_array_equal(v, np.asarray(getattr(j.reset(None), k)), err_msg=k)


# -- tests/test_mcm_mcs.py on the port ----------------------------------------------------
def _physics(env=None, volume=None, extinction=20.0, **kw):
    _, ttf = _tfs(_tf_table((0.9, 0.9, 0.9)))
    vol = JVolume.sphere_in_cube(16) if volume is None else volume
    return make_renderer("mcs", convert.volume_from(vol), ttf, env, extinction=extinction,
                         resolution=RES, device="cpu", **kw)


def _converged(seed, n, **kw):
    r = _physics(**kw)
    cam = convert.camera_from(JCamera())
    seeds = [(seed + k + 1) * 2654435761 % 2**32 for k in range(n)]
    state, img = r.render_many(r.reset(cam), cam, seeds)
    return state, img.numpy()


def test_persistent_matches_frames():
    """test_mcm_mcs.py::test_mcs_persistent_matches_frames on the port: the
    persistent image converges to the frame path's."""
    _, a = _converged(1, 160)
    _, b = _converged(991, 160)
    state, p = _converged(7, 60, persistent=True, steps=32)
    assert int(state.samples.min()) > 0 and np.isfinite(p).all()
    floor, diff = np.abs(a - b).mean(), np.abs(a - p).mean()
    assert diff < 2.0 * floor + 1e-4, (diff, floor)


def test_persistent_miss_rays_hit_environment():
    """test_mcm_mcs.py::test_mcs_persistent_miss_rays_hit_environment: a
    volume dense up to its faces, the default camera (the image's corners
    miss the cube); the miss pixels are the environment."""
    r = _physics(np.full((1, 1, 3), 0.6, np.float32), JVolume(np.ones((8, 8, 8), np.float32)),
                 extinction=50.0, persistent=True, steps=32)
    cam = convert.camera_from(JCamera())
    seeds = [(k + 1) * 2654435761 % 2**32 for k in range(20)]
    _, img = r.render_many(r.reset(cam), cam, seeds)
    frm, to = jax_camera_rays(RES, jnp.asarray(JCamera().inverse_mvp()))
    tn, tf_ = JG.intersect_cube(frm[0], frm[1], frm[2], to[0] - frm[0], to[1] - frm[1],
                                to[2] - frm[2])
    miss = np.asarray(jnp.maximum(tn, 0.0) >= jnp.maximum(tf_, 0.0))
    assert miss.any() and (~miss).any()
    np.testing.assert_allclose(img.numpy()[miss], 0.6, atol=1e-5)
    assert np.abs(img.numpy()[~miss] - 0.6).max() > 0.05  # the hit pixels are shaded


def test_persistent_deterministic_and_majorant():
    """test_mcm_mcs.py::test_mcs_persistent_deterministic_and_majorant: the
    same seeds give the same image bit for bit; the majorant converges to
    the exact path's image."""
    kw = dict(persistent=True, steps=32)
    np.testing.assert_array_equal(_converged(5, 10, **kw)[1], _converged(5, 10, **kw)[1])
    a, b = _converged(5, 80, **kw)[1], _converged(991, 80, **kw)[1]
    m = _converged(5, 80, majorant_blocks=4, **kw)[1]
    floor = np.abs(a - b).mean()
    assert np.isfinite(m).all() and np.abs(a - m).mean() < 2.0 * floor + 1e-4


# -- sessions -------------------------------------------------------------------------------
def _sessions(streams=4):
    volume = JVolume.sphere_in_cube(16)
    jtf, ttf = _tfs(_tf_table())
    cam = JCamera()
    JOrbit(yaw=0.4, pitch=-0.3).apply(cam)
    kw = dict(extinction=30.0, persistent=True, steps=STEPS, streams=streams, base_seed=7,
              resolution=RES)
    j = JaxSession("mcs", volume, jtf, None, camera=cam, **kw)
    t = RenderSession("mcs", convert.volume_from(volume), ttf, None, device="cpu",
                      camera=convert.camera_from(cam), **kw)
    return j, t


def test_session_metrics_read_samples():
    j, t = _sessions()
    j.run(3)
    t.run(3)
    got, want = t.metrics(), j.metrics()
    assert sorted(got) == sorted(want) and {"spp_mean", "paths", "paths_per_s"} <= set(got)
    assert got["frames"] == want["frames"] == 3
    assert got["paths"] == int(t.state.samples.sum()) > 0
    assert got["spp_mean"] == pytest.approx(float(t.state.samples.double().mean()))
    _parted(t.state, j.state, "session, three dispatches")
    assert t.hdr_image().shape == (RES, RES, 3) and t.image_u8().dtype == np.uint8


def test_jax_checkpoint_loads_into_port_and_back(tmp_path):
    j, t = _sessions()
    j.run(2)
    j.save_checkpoint(str(tmp_path / "jax.npz"))
    t.load_checkpoint(str(tmp_path / "jax.npz"))
    assert t.frame == 2 and isinstance(t.state, TM.MCSPersistentState)
    for k, v in convert.mcs_persistent_state_to_numpy(t.state).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(j.state, k)), err_msg=k)
    assert [x.data_ptr() for x in state_leaves(t.state)] == [
        x.data_ptr() for x in t.state.tensors()]
    t.save_checkpoint(str(tmp_path / "port.npz"))
    j2, _ = _sessions()
    j2.load_checkpoint(str(tmp_path / "port.npz"))
    assert j2.frame == 2
    for k in K.PERSISTENT_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(j2.state, k)),
                                      np.asarray(getattr(j.state, k)), err_msg=k)
    j.run(1)
    t.run(1)
    _parted(t.state, j.state, "resumed")


# -- refusals -------------------------------------------------------------------------------
def test_wrapper_refuses_mixed_and_unsupported_devices():
    _, t = _persistent_pair("u8", 1, res=8)
    cam = convert.camera_from(JCamera())
    state, ctx = t.reset(cam), t.ctx(cam, 1)
    meta = TM.MCSCtx(**{**ctx.__dict__, "tf_table": ctx.tf_table.to("meta")})
    with pytest.raises(ValueError, match="different devices"):
        K.persistent(state, meta, [1], STEPS)
    on_meta = TM.MCSPersistentState(*(x.to("meta") for x in state.tensors()))
    ctx_meta = TM.MCSCtx(**{**ctx.__dict__, "density": ctx.density.table.to("meta")[:1],
                            "tf_table": ctx.tf_table.to("meta"),
                            "environment": ctx.environment.to("meta")})
    with pytest.raises(ValueError, match="unsupported device"):
        K.persistent(on_meta, ctx_meta, [1], STEPS)
    with pytest.raises(ValueError, match="not \\(S, R, R\\)"):
        K.persistent_seeds((2, 8, 16), 1, "cpu")
