"""Raw and partly packed tables in the port's forward, against vpt_tpu.

The samplers (``vpt_tpu_torch.ops.interp``: raw (D, H, W) grids with the
linear, quasicubic and nearest filters, raw and packed 2D textures, raw
and pair 1D tables) equal ``vpt_tpu.ops.interp``'s bit for bit, and a raw
lookup equals the packed lookup of the same table. The renderer keeps what
the reference keeps for every ``pack_tables`` value, and every layout
renders the packed render's bits (the plain K1 on the CPU), as JAX's
layouts do; against JAX the renders meet the parity contract of
tests/test_mcm_spectral_parity.py:87-111 (>= 99.5% of pixel channels within
1e-3 relative, >= 99% of lanes with equal sample counts). Sizes: 8^2-16^2
pixels, 8^3-16^3 volumes, a few dispatches.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.ops import interp as JI
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.ops import interp as TI
from vpt_tpu_torch.session import RenderSession

torch.set_num_threads(1)

PACKS = [False, {"material_tf", "light_spectrum"}, {"material_tf"}, {"light_spectrum"},
         {"density"}]
ENV = np.random.default_rng(5).uniform(0.1, 1.0, (4, 8, 3)).astype(np.float32)


def _coords(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.2, 1.2, n).astype(np.float32) for _ in range(3)]


def _ramp_tf():
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.7
    return MaterialTF(table)


def _scene(filt="linear", size=8):
    density = np.random.default_rng(1).random((size, size, size)).astype(np.float32)
    return (Volume(density, filter=filt), _ramp_tf(), LightConfig(direction=(1.0, 0.2, 0.5)),
            SpectrumConfig(), MCMSpectralConfig(extinction=20.0, bounces=4, steps=4))


def _render(renderer, frames=3, seed=1):
    cam = renderer_camera(renderer)
    s = renderer.reset(cam, seed)
    for f in range(frames):
        s, img = renderer.render(s, cam, 17 + f)
    return s, img


def renderer_camera(renderer):
    if isinstance(renderer, TM.MCMSpectralRenderer):
        return convert.camera_from(Camera())
    return Camera()


# ---------------------------------------------------------------------------
# the samplers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["linear", "quasicubic", "nearest"])
def test_raw_volume_sampler_bit_equal_to_jax_and_packed(mode):
    u, v, w = _coords(4000)
    grid = np.random.default_rng(2).random((5, 6, 7)).astype(np.float32)
    want = np.asarray(JI.sample_volume(jnp.asarray(grid), jnp.asarray(u), jnp.asarray(v),
                                       jnp.asarray(w), mode))
    tu, tv, tw = (torch.as_tensor(a) for a in (u, v, w))
    got = TI.sample_volume(torch.as_tensor(grid), tu, tv, tw, mode)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(K.sample_volume_raw(torch.as_tensor(grid), tu, tv, tw, mode), got)
    if mode != "nearest":
        for kind in ("full", "xy"):
            packed = TI.pack_volume_auto(grid, "cpu", kind)
            assert torch.equal(TI.sample_volume(packed, tu, tv, tw, mode), got)


@pytest.mark.parametrize("shape", [(9, 11, 4), (9, 11, 3), "packed4", "packed3"])
def test_tex2d_sampler_bit_equal_to_jax(shape):
    """Raw (H, W, C) textures and the 4C-wide packed corner rows (the
    16-wide TF, the 12-wide environment map) give JAX's bits and each
    other's."""
    u, v, _ = _coords(4000, 3)
    rng = np.random.default_rng(4)
    raw = rng.random((9, 11, 4 if shape in ((9, 11, 4), "packed4") else 3)).astype(np.float32)
    tex = JI.pack_tex2d_corners(raw) if isinstance(shape, str) else raw
    want = np.asarray(JI.sample_tex2d(jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v)))
    tu, tv = torch.as_tensor(u), torch.as_tensor(v)
    got = TI.sample_tex2d(torch.as_tensor(np.asarray(tex)), tu, tv)
    np.testing.assert_array_equal(got.numpy(), want)
    other = torch.as_tensor(raw if isinstance(shape, str) else TI.pack_tex2d_corners(raw))
    assert torch.equal(TI.sample_tex2d(other, tu, tv), got)


@pytest.mark.parametrize("pair", [False, True])
def test_tex1d_sampler_bit_equal_to_jax(pair):
    """A raw (N,) table and the (N+1, 2) pair table (JAX's one-hot matmul,
    a row gather here) give JAX's bits and each other's."""
    u, _, _ = _coords(4000, 5)
    raw = np.random.default_rng(6).random(13).astype(np.float32)
    tex = JI.pack_tex1d_corners(raw) if pair else raw
    want = np.asarray(JI.sample_tex1d(jnp.asarray(tex), jnp.asarray(u)))
    got = TI.sample_tex1d(torch.as_tensor(np.asarray(tex)), torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), want)
    other = torch.as_tensor(raw if pair else TI.pack_tex1d_corners(raw))
    assert torch.equal(TI.sample_tex1d(other, torch.as_tensor(u)), got)


# ---------------------------------------------------------------------------
# the table policy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("filt,pack", [("linear", p) for p in PACKS + [True, {"density_xy"}]]
                         + [("nearest", True), ("nearest", {"density"})])
def test_table_layout_as_the_reference_keeps_it(filt, pack):
    """Each table the renderer keeps has the reference's ctx shape and
    values (the environment map packs with the TF; a nearest volume packs
    nothing else)."""
    args = _scene(filt)
    jc = JM.MCMSpectralRenderer(*args, resolution=8, pack_tables=pack,
                                environment=ENV).ctx(Camera(), 1)
    tr = TM.MCMSpectralRenderer(*convert.scene_from(*args), resolution=8, pack_tables=pack,
                                environment=ENV, device="cpu")
    tc = tr.ctx(convert.camera_from(Camera()), 1)
    jd = jc.density
    if not isinstance(jd, JI.PackedVolume) and jd.ndim == 4:  # a small f32 table, kept 4-D
        jd = JI.PackedVolume(jd.reshape(-1, jd.shape[-1]), jd.shape[:3],
                             "xy" if jd.shape[-1] == 4 else "full")
    if isinstance(jd, JI.PackedVolume):
        assert tr.vol_kind == jd.kind and tc.density.dims == tuple(jd.dims)
        np.testing.assert_array_equal(tc.density.table.numpy(), np.asarray(jd.table))
    else:
        assert tr.vol_kind == "raw" and torch.is_tensor(tc.density)
        np.testing.assert_array_equal(tc.density.numpy(), np.asarray(jd))
    for name in ("material_tf", "light_spectrum", "environment"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)))
    assert tc.volume_filter == filt


# ---------------------------------------------------------------------------
# renders: every layout gives the packed render's bits; parity with JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["linear", "quasicubic", "environment", "majorant"])
@pytest.mark.parametrize("pack", PACKS, ids=lambda p: "raw" if p is False else "+".join(sorted(p)))
def test_every_layout_renders_the_packed_bits(pack, mode):
    """The port's raw and partly packed renders equal its packed render bit
    for bit (state and image), as JAX's do (tests/test_packed_tables.py)."""
    args = _scene("quasicubic" if mode == "quasicubic" else "linear")
    kw = dict(resolution=8, streams=2)
    if mode == "environment":
        kw["environment"] = ENV
    if mode == "majorant":
        kw["majorant_blocks"] = 4
    targs = convert.scene_from(*args)
    packed = TM.MCMSpectralRenderer(*targs, pack_tables=True, device="cpu", **kw)
    other = TM.MCMSpectralRenderer(*targs, pack_tables=pack, device="cpu", **kw)
    assert K.is_raw(other.ctx(convert.camera_from(Camera()), 0))
    sa, ia = _render(packed)
    sb, ib = _render(other)
    assert torch.equal(ia, ib)
    for a, b in zip(sa.tensors(), sb.tensors()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("filt,pack,env", [
    ("linear", False, False), ("linear", {"material_tf", "light_spectrum"}, False),
    ("quasicubic", {"material_tf"}, True), ("linear", {"light_spectrum"}, True),
    ("nearest", True, False), ("nearest", False, True)])
def test_renders_meet_jax_parity(filt, pack, env):
    """The parity contract against JAX on the same layout, JAX's raw and
    packed renders equal bit for bit (its own equality), the nearest
    filter included (over raw tables, as the reference renders it)."""
    args = _scene(filt, 16)
    kw = dict(resolution=16, pack_tables=pack, environment=ENV if env else None)
    jr = JM.MCMSpectralRenderer(*args, **kw)
    tr = TM.MCMSpectralRenderer(*convert.scene_from(*args), device="cpu", **kw)
    js, jimg = _render(jr)
    ts, timg = _render(tr)
    img, ref = timg.numpy(), np.asarray(jimg)
    diff = np.abs(img - ref)
    assert np.mean(diff / (np.abs(ref) + 1e-3) < 1e-3) > 0.995
    assert np.median(diff) < 1e-5
    assert np.mean(ts.samples.numpy() == np.asarray(js.samples)) > 0.99
    assert ts.samples.numpy().sum() > 0
    if filt != "nearest" and pack is False:
        _, jpacked = _render(JM.MCMSpectralRenderer(*args, **dict(kw, pack_tables=True)))
        np.testing.assert_array_equal(np.asarray(jpacked), ref)


def test_compaction_and_session_over_raw_tables():
    """Hit-lane compaction over raw tables renders the packed compaction's
    bits; a ``RenderSession`` over raw tables runs."""
    targs = convert.scene_from(*_scene())
    kw = dict(resolution=8, streams=2, compaction=True, device="cpu")
    _, a = _render(TM.MCMSpectralRenderer(*targs, pack_tables=True, **kw))
    _, b = _render(TM.MCMSpectralRenderer(*targs, pack_tables=False, **kw))
    assert torch.equal(a, b)
    sess = RenderSession("mcm-spectral", *targs, device="cpu", resolution=8, pack_tables=False)
    assert sess.renderer.vol_kind == "raw"
    sess.run(2)
    assert np.isfinite(sess.image()).all()


def test_ctx_from_numpy_carries_raw_tables():
    """A JAX ctx of each raw layout (raw grid, 4-, 16- and 18-wide TF, raw
    and pair light, 3-channel env map) crosses to the port, whose dispatch
    on it equals the port renderer's bit for bit."""
    args = _scene()
    cam = Camera()
    for pack in ({"material_tf"}, {"light_spectrum"}, {"material_tf", "light_spectrum"}):
        jc = JM.MCMSpectralRenderer(*args, resolution=8, pack_tables=pack,
                                    environment=ENV).ctx(cam, 3)
        tr = TM.MCMSpectralRenderer(*convert.scene_from(*args), resolution=8, pack_tables=pack,
                                    environment=ENV, device="cpu")
        tc = convert.ctx_from_numpy(
            inv_mvp=np.asarray(jc.inv_mvp), seed_bits=np.asarray(jc.seed_bits),
            extinction=np.asarray(jc.extinction), blur=np.asarray(jc.blur),
            max_bounces=np.asarray(jc.max_bounces),
            light_direction=np.asarray(jc.light_direction), density_table=np.asarray(jc.density),
            material_tf=np.asarray(jc.material_tf),
            light_spectrum=np.asarray(jc.light_spectrum), boundaries=np.asarray(jc.boundaries),
            bin_xyz=np.asarray(jc.bin_xyz), environment=np.asarray(jc.environment),
            device="cpu")
        assert torch.is_tensor(tc.density) and tc.density.shape == (8, 8, 8)
        mine = tr.ctx(convert.camera_from(cam), 3)
        s0 = tr.reset(convert.camera_from(cam), 3)
        a, b = TM.render(TM.SpectralState(*(t.clone() for t in s0.tensors())), tc, 4, 12)
        c, d = TM.render(s0, mine, 4, 12)
        assert torch.equal(b, d)


def test_step_params_name_the_raw_kinds():
    """What K1's RAW instantiation reads from the parameter block
    (csrc/mcm_common.cuh IParam): a raw axis of n texels given as n + 1."""
    tr = TM.MCMSpectralRenderer(*convert.scene_from(*_scene("nearest")), resolution=8,
                                environment=ENV, device="cpu")
    ctx = tr.ctx(convert.camera_from(Camera()), 0)
    _, i = K._params(ctx, 8, 1, 12)
    assert list(i[8:13]) == [9, 9, 9, 257, 257]  # volume, TF
    assert list(i[18:20]) == [5, 9]  # the packed env map (He+1, We+1)
    assert list(i[21:28]) == [1, 1, 1, 1, 1, 256, 0]  # raw, grid, nearest, TF, light, N, env
    packed = TM.MCMSpectralRenderer(*convert.scene_from(*_scene()), resolution=8, device="cpu")
    _, i = K._params(packed.ctx(convert.camera_from(Camera()), 0), 8, 1, 12)
    assert not K.is_raw(packed.ctx(convert.camera_from(Camera()), 0))
    assert list(i[21:28]) == [0, 0, 0, 0, 0, 256, 0]
    with pytest.raises(ValueError, match="needs a raw grid"):
        K._check_tables(dataclasses.replace(packed.ctx(convert.camera_from(Camera()), 0),
                                            volume_filter="nearest"))
