"""The port's xy half-packed volume against vpt_tpu, on the CPU.

The xy table (``pack_tables={"density_xy", "material_tf",
"light_spectrum"}``) holds each depth plane's 4 xy corners per row; a
lookup reads the rows of its z0 and z1 planes. The two layouts hold the
same corner values and lerp them in the same order, so an xy render
equals the full-table render bit for bit, in every forward mode. Packers
equal the JAX ones bit for bit (u8 and f32); the lookup equals JAX's
``_sample_volume_packed_xy`` bit for bit; renders carried from one JAX
state meet ``tests/test_mcm_spectral_parity.py``'s contract (99.5% of
channels within 1e-3 relative, median below 1e-5, 99% of lanes with equal
sample counts). Sizes: 12-16^3 volumes, 8-24 px.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.ops import interp as JI
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch.kernels import corners as C
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.ops import interp as TI
from vpt_tpu_torch.scene.camera import Camera as TCamera

torch.set_num_threads(1)

FIELDS = JM.SpectralState._fields
XY = {"density_xy", "material_tf", "light_spectrum"}


def _ramp_tf():
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5 + 0.3 * dens
    return MaterialTF(table)


def _scene(filt="linear", f32=False):
    d = np.asarray(Volume.sphere_in_cube(16).density, np.float32)
    if f32:
        d = d * np.float32(0.9) + np.float32(0.05)
    return (Volume(density=d, filter=filt), _ramp_tf(), LightConfig(direction=(1.0, 0.2, 0.5)),
            SpectrumConfig(), MCMSpectralConfig(extinction=20.0, bounces=4, steps=6))


def _envmap():
    return np.random.default_rng(5).uniform(0.1, 1.0, (8, 16, 3)).astype(np.float32)


def _contract(img, ref, samples, ref_samples):
    img, ref = np.asarray(img), np.asarray(ref)
    diff = np.abs(img - ref)
    assert np.mean(diff / (np.abs(ref) + 1e-3) < 1e-3) > 0.995
    assert np.median(diff) < 1e-5
    assert np.mean(np.asarray(samples) == np.asarray(ref_samples)) > 0.99
    assert np.asarray(samples).sum() > 0


# ---------------------------------------------------------------------------
# the packers and the lookup
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 3, 1), (5, 6, 7)])
def test_xy_packers_bit_equal_to_jax(shape, dtype):
    rng = np.random.default_rng(3)
    raw = (rng.integers(0, 256, shape).astype(np.uint8) if dtype == np.uint8
           else rng.random(shape, dtype=np.float32))
    want = JI.pack_volume_corners_xy(raw)
    got = TI.pack_volume_corners_xy(raw)
    assert got.shape == shape[:1] + (shape[1] + 1, shape[2] + 1, 4) and got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    if dtype == np.float32:
        t = TI.pack_volume_corners_xy_t(torch.as_tensor(raw))
        np.testing.assert_array_equal(t.numpy(), np.asarray(JI.pack_volume_corners_xy_jnp(
            jnp.asarray(raw))))
        np.testing.assert_array_equal(C.pack_volume_plain(torch.as_tensor(raw), "xy").numpy(),
                                      want.reshape(-1, 4))


@pytest.mark.parametrize("scale", [1.0, 0.7134])
def test_pack_volume_auto_xy_matches_jax(scale):
    """u8-quantized sources pack to the same flat u8 xy table as JAX's
    pack_volume_auto(..., "xy"); others to the f32 xy table."""
    vol = Volume.sphere_in_cube(12).density * np.float32(scale)
    got = TI.pack_volume_auto(vol, "cpu", "xy")
    assert got.kind == "xy" and got.dims == (12, 13, 13) and got.width == 4
    assert got.raw_shape == (12, 12, 12)
    want = JI.pack_volume_auto(vol, "xy")
    want_table = np.asarray(want.table if isinstance(want, JI.PackedVolume) else want)
    assert (got.table.dtype == torch.uint8) == (scale == 1.0)
    np.testing.assert_array_equal(got.table.numpy(), want_table.reshape(-1, 4))


@pytest.mark.parametrize("mode", ["linear", "quasicubic"])
@pytest.mark.parametrize("table_dtype", ["u8", "f32"])
def test_xy_lookup_bit_equal_to_jax_and_full(table_dtype, mode):
    codes = np.arange(256, dtype=np.uint8).reshape(4, 8, 8)
    vol = codes.astype(np.float32) / np.float32(255.0)
    jv = JI.PackedVolume.pack(vol, "xy", table_dtype=table_dtype)
    jf = JI.PackedVolume.pack(vol, "full", table_dtype=table_dtype)
    rng = np.random.default_rng(2)
    u, v, w = (rng.uniform(-0.1, 1.1, 2048).astype(np.float32) for _ in range(3))
    want = np.asarray(JI._sample_volume_packed_xy(jnp.asarray(jv.table), jv.dims, jnp.asarray(u),
                                                  jnp.asarray(v), jnp.asarray(w), mode))
    tu, tv, tw = map(torch.as_tensor, (u, v, w))
    got = TI.sample_volume_packed(torch.as_tensor(np.array(jv.table)), jv.dims, tu, tv, tw, mode,
                                  "xy").numpy()
    full = TI.sample_volume_packed(torch.as_tensor(np.array(jf.table)), jf.dims, tu, tv, tw, mode,
                                   "full").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, full)
    before = dict(K.LAUNCHES)
    k = K.sample_volume_packed(torch.as_tensor(np.array(jv.table)), jv.dims, tu, tv, tw, "xy")
    if mode == "linear":
        np.testing.assert_array_equal(k.numpy(), got)
    assert K.LAUNCHES == before


def test_packed_volume_kinds_validate():
    with pytest.raises(ValueError):
        TI.PackedVolume(torch.zeros((2 * 3 * 3, 8)), (2, 3, 3), "xy")
    with pytest.raises(ValueError):
        TI.PackedVolume(torch.zeros((2 * 3 * 3, 4)), (2, 3, 3), "half")
    with pytest.raises(ValueError):
        TI.pack_volume_auto(np.zeros((2, 2, 2), np.float32), "cpu", "z")
    with pytest.raises(ValueError):
        K.sample_volume_packed(torch.zeros((4, 4)), (1, 2, 2), *(torch.zeros(3),) * 3, "z")


# ---------------------------------------------------------------------------
# the renderer: pack_tables, JAX parity, xy == full bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pack", [True, XY, {"density", "density_xy", "material_tf",
                                             "light_spectrum"}])
def test_pack_tables_kinds_as_the_reference_reads_them(pack):
    args = _scene()
    rj = JM.MCMSpectralRenderer(*args, resolution=8, pack_tables=pack)
    rt = TM.MCMSpectralRenderer(*convert.scene_from(*args), resolution=8, pack_tables=pack,
                                device="cpu")
    jd = rj.ctx(Camera(), 0).density
    kind = "full" if pack is True or "density" in pack else "xy"
    assert rt.vol_kind == kind and jd.kind == kind
    assert rt.ctx(TCamera(), 0).density.dims == jd.dims
    np.testing.assert_array_equal(rt.vol_table.numpy(), np.asarray(jd.table))


@pytest.mark.parametrize("pack", [False, {"density_xy"}, {"density_xy", "material_tf"},
                                  {"material_tf", "light_spectrum"}])
def test_raw_and_partly_packed_tables_still_raise(pack):
    """Raw and partly packed tables beside the xy options render the full
    table's bits (tests/test_torch_raw.py); what still raises over them is
    the surrogate, the next slice's."""
    targs = convert.scene_from(*_scene())
    cam = TCamera()
    imgs = []
    for p in (pack, True):
        r = TM.MCMSpectralRenderer(*targs, resolution=8, pack_tables=p, device="cpu")
        s0 = r.reset(cam, 1)
        imgs.append(r.render(s0, cam, 2)[1])
    assert torch.equal(imgs[0], imgs[1])
    r = TM.MCMSpectralRenderer(*targs, resolution=8, pack_tables=pack, device="cpu")
    s0 = r.reset(cam, 1)
    with pytest.raises(NotImplementedError, match="next slice"):
        TM.render_diff(s0, torch.ones_like(s0.px), r.ctx(cam, 2), 6, 12)


def _port_ctx(jctx, filt):
    opt = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    dens = jctx.density
    flat = isinstance(dens, JI.PackedVolume)
    return convert.ctx_from_numpy(
        inv_mvp=np.asarray(jctx.inv_mvp), seed_bits=np.asarray(jctx.seed_bits),
        extinction=np.asarray(jctx.extinction), blur=np.asarray(jctx.blur),
        max_bounces=np.asarray(jctx.max_bounces), light_direction=np.asarray(jctx.light_direction),
        density_table=np.asarray(dens.table if flat else dens),
        density_dims=dens.dims if flat else None, material_tf=np.asarray(jctx.material_tf),
        light_spectrum=np.asarray(jctx.light_spectrum), boundaries=np.asarray(jctx.boundaries),
        bin_xyz=np.asarray(jctx.bin_xyz), environment=opt(jctx.environment),
        majorant=opt(jctx.majorant), volume_filter=filt, device="cpu")


@pytest.mark.parametrize("f32", [False, True])
def test_ctx_from_numpy_carries_an_xy_volume(f32):
    """A JAX xy ctx, flat u8 or the natural 4-D f32 array of a small
    volume, becomes the port's flat xy PackedVolume."""
    rj = JM.MCMSpectralRenderer(*_scene(f32=f32), resolution=8, pack_tables=XY)
    jctx = rj.ctx(Camera(), 0)
    assert isinstance(jctx.density, JI.PackedVolume) != f32
    t = _port_ctx(jctx, "linear").density
    rt = TM.MCMSpectralRenderer(*convert.scene_from(*_scene(f32=f32)), resolution=8,
                                pack_tables=XY, device="cpu")
    assert t.kind == "xy" and t.dims == rt.vol_dims == (16, 17, 17)
    assert torch.equal(t.table, rt.vol_table)


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("filt", ["linear", "quasicubic"])
def test_xy_render_many_matches_jax(filt, streams):
    args = _scene(filt)
    rj = JM.MCMSpectralRenderer(*args, resolution=24, streams=streams, pack_tables=XY)
    cam = Camera()
    sj = rj.reset(cam, 5)
    st = convert.state_from_numpy({k: np.asarray(getattr(sj, k)) for k in FIELDS}, "cpu")
    jctx = rj.ctx(cam, 5)
    tctx = _port_ctx(jctx, filt)
    assert tctx.density.kind == "xy"
    for s in ((11, 12), (13,)):
        sj, img_j = JM.render_many(sj, jctx, np.asarray(s, np.uint32), steps=6, n_bins=12,
                                   volume_filter=filt)
        st, img_t = TM.render_many(st, tctx, s, steps=6, n_bins=12)
    _contract(img_t.numpy(), img_j, st.samples.numpy(), sj.samples)


@pytest.mark.parametrize("mode", ["default", "environment", "quasicubic", "majorant",
                                  "f32"])
def test_xy_render_equals_full_render_bit_for_bit(mode):
    args = list(convert.scene_from(*_scene("quasicubic" if mode == "quasicubic" else "linear",
                                           f32=mode == "f32")))
    kw = dict(environment=_envmap()) if mode == "environment" else {}
    if mode == "majorant":
        kw = dict(majorant_blocks=4)
    out = []
    for pack in (True, XY):
        r = TM.MCMSpectralRenderer(*args, resolution=12, streams=2, pack_tables=pack,
                                   device="cpu", **kw)
        cam = TCamera()
        s, img = r.render_many(r.reset(cam, 3), cam, [5, 6, 7])
        out.append((r.vol_kind, img, s))
    assert [o[0] for o in out] == ["full", "xy"]
    assert torch.equal(out[0][1], out[1][1])
    for a, b in zip(out[0][2].tensors(), out[1][2].tensors()):
        assert torch.equal(a, b)
    assert int(out[1][2].samples.sum()) > 0


def test_xy_repack_and_contraction_keep_the_kind():
    """fit_spectral's re-pack of a learned density into an xy base ctx
    (JAX _pack_params_into_ctx :185-236) gives an xy PackedVolume equal to
    the renderer's own f32 xy table; K9's contraction of an xy adjoint is
    jax.vjp of pack_volume_corners_xy_jnp."""
    from vpt_tpu_torch.optim import _pack_params_into_ctx

    args = _scene(f32=True)
    r = TM.MCMSpectralRenderer(*convert.scene_from(*args), resolution=8, pack_tables=XY,
                               device="cpu")
    base = r.ctx(TCamera(), 0)
    up = _pack_params_into_ctx(base, {"density": torch.as_tensor(args[0].density)})
    ctx = dataclasses.replace(base, **up)
    assert ctx.density.kind == "xy" and ctx.density.dims == base.density.dims
    assert torch.equal(ctx.density.table, base.density.table)
    g = np.random.default_rng(4).standard_normal(base.density.table.shape).astype(np.float32)
    _, vjp = jax.vjp(JI.pack_volume_corners_xy_jnp, jnp.zeros((16, 16, 16), jnp.float32))
    want = np.asarray(vjp(jnp.asarray(g.reshape(16, 17, 17, 4)))[0])
    got = C.contract_volume(torch.as_tensor(g), base.density.dims, "xy").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
