"""K23's instance by table pair (``kernels/mcs.py::persistent_mode``, which
fills the parameter block's SI_MODE; ``csrc/mcs.cu`` McsMode and its
dispatch): every pair ``MCSRenderer`` builds runs an instance of its own,
and every pair the wrapper takes maps to an instance the library builds,
so no input K23 took before it had instances raises for want of one."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from vpt_tpu_torch import Camera, Volume
from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.kernels import mcs as KS
from vpt_tpu_torch.kernels import raymarch as RK
from vpt_tpu_torch.models.mcs import MCSRenderer
from vpt_tpu_torch.ops import interp


RES = 8


def _mode_index(ctx, volume_filter):
    return int(KS._params(ctx, RES, 1, 0, volume_filter, 2, 1)[1][-1])


def test_modes_follow_the_source():
    """PERSISTENT_MODES is McsMode in order, SI_MODE is the block's last
    integer, and the dispatch instantiates every mode with and without the
    majorant."""
    text = (_build.CSRC_DIR / "mcs.cu").read_text()
    body = re.search(r"enum McsMode \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"^\s*(MM_\w+)", body, re.M)
    assert names[-1] == "MM_COUNT" and len(names) - 1 == len(KS.PERSISTENT_MODES)
    assert [n[3:].lower() for n in names[:-1]] == [
        m.replace(" quasicubic", "_qc") for m in KS.PERSISTENT_MODES]
    assert re.search(r"SI_MODE,[^\n]*\n\s*SI_COUNT,", text)
    for n in names[:-1]:
        assert f"VPT_MCSP_MODE({n})" in text
    assert "launch_persistent<true>(" in text and "launch_persistent<false>(" in text


def _volume(kind, filt):
    density = Volume.sphere_in_cube(16).density
    if kind == "f32":  # values no u8 code holds: packed as f32
        density = np.random.default_rng(5).random((16, 16, 16), np.float32)
    return Volume(density, filt)


@pytest.mark.parametrize("kind,filt,want", [
    ("u8", "linear", "u8"), ("f32", "linear", "f32"), ("u8", "quasicubic", "u8 quasicubic"),
    ("f32", "quasicubic", "f32 quasicubic"), ("u8", "nearest", "nearest"),
    ("f32", "nearest", "nearest")])
@pytest.mark.parametrize("majorant", [None, 2])
@pytest.mark.parametrize("env", [None, "map"])
def test_every_renderer_pair_has_its_instance(kind, filt, want, majorant, env):
    environment = (None if env is None
                   else np.random.default_rng(1).random((4, 8, 3)).astype(np.float32))
    r = MCSRenderer(_volume(kind, filt), None, environment, resolution=RES, persistent=True,
                    steps=2, majorant_blocks=majorant, device="cpu")
    ctx = r.ctx(Camera(), 3)
    got = KS.persistent_mode(ctx.density, ctx.tf_table, r.volume.filter)
    assert got == want and got != "generic"
    assert _mode_index(ctx, r.volume.filter) == KS.PERSISTENT_MODES.index(want)


@pytest.mark.parametrize("density", ["packed u8", "packed f32", "raw"])
@pytest.mark.parametrize("tf", ["packed", "raw"])
@pytest.mark.parametrize("filt", ["linear", "quasicubic", "nearest"])
def test_every_pair_the_wrapper_takes_has_an_instance(density, tf, filt):
    """Each (volume, TF, filter) the table checks take maps to a mode the
    library instantiates (the pairs MCSRenderer does not build to
    "generic"), and the persistent wrapper runs it; the one pair the checks
    refuse (a packed table under the nearest filter) is refused as before."""
    kind = density.split()[-1]
    base = MCSRenderer(_volume("f32" if kind == "f32" else "u8", "linear"), None, None,
                       resolution=RES, persistent=True, steps=2, device="cpu")
    ctx = base.ctx(Camera(), 3)
    raw_grid = torch.as_tensor(np.asarray(base.volume.density, np.float32))
    raw_tf = torch.as_tensor(np.asarray(base.tf2d.rasterize(), np.float32))
    ctx = dataclasses.replace(ctx, density=raw_grid if density == "raw" else ctx.density,
                              tf_table=raw_tf if tf == "raw" else ctx.tf_table)
    if density != "raw" and filt == "nearest":
        with pytest.raises(ValueError, match="nearest filter needs a raw grid"):
            KS._check_tables(ctx, filt)
        return
    KS._check_tables(ctx, filt)
    mode = KS.persistent_mode(ctx.density, ctx.tf_table, filt)
    built = density != "raw" and tf == "packed" or density == "raw" and tf == "raw" and (
        filt == "nearest")
    assert (mode != "generic") == built
    if built and density != "raw":
        assert mode == kind + ("" if filt == "linear" else " quasicubic")
    assert 0 <= _mode_index(ctx, filt) < len(KS.PERSISTENT_MODES)
    state = base.reset(None)
    before = int(state.samples.sum())
    KS.persistent(state, ctx, [7, 8], 2, filt, 1)
    assert int(state.samples.sum()) >= before and bool(torch.isfinite(state.acc).all())
    assert isinstance(ctx.density, interp.PackedVolume) == (density != "raw")
    assert RK._volume_tensor(ctx.density).device.type == "cpu"


def _directions():
    """Drawn sphere directions and finite extremes: the axes, zero, signed
    zeros, denormals and huge components."""
    rng = np.random.default_rng(11)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    special = np.array([0.0, -0.0, 1.0, -1.0, 1e-40, -1e-40, 3e38, -3e38, 0.5], np.float32)
    grid = np.stack(np.meshgrid(special, special, special, indexing="ij"), -1).reshape(-1, 3)
    return torch.as_tensor(np.concatenate([d, grid]))


@pytest.mark.parametrize("texel", [(0.3, 1.0, 2.5), (0.0, 1e-40, 3.0e38), (-0.25, 7.0, 0.0)])
def test_one_texel_light_is_its_texel_for_finite_directions(texel):
    """K23's shadow_light: the environment lookup K20, K22 and K23 make
    (sample_env_rgb, whose plain version is kernels/mcm.sample_environment)
    returns a one-texel map's texel, bit for bit, at every finite direction
    when each channel is finite and not -0 (lerp_fixed)."""
    from vpt_tpu_torch.kernels.mcm import sample_environment

    env = torch.tensor([[texel]], dtype=torch.float32)
    d = _directions()
    got = sample_environment(env, d[:, 0], d[:, 1], d[:, 2])
    want = env.reshape(1, 3).expand_as(got)
    assert torch.equal(got.view(torch.int32), want.contiguous().view(torch.int32))


@pytest.mark.parametrize("channel", [-0.0, float("inf"), float("-inf")])
def test_one_texel_light_needs_a_finite_channel_other_than_minus_zero(channel):
    """The channels lerp_fixed refuses: the lerps turn -0 into +0 and an
    infinite texel into NaN (and a NaN's payload is the hardware's), so the
    kernel looks those maps up."""
    from vpt_tpu_torch.kernels.mcm import sample_environment

    env = torch.tensor([[[channel, 1.0, 2.0]]], dtype=torch.float32)
    d = _directions()
    got = sample_environment(env, d[:, 0], d[:, 1], d[:, 2])[:, 0]
    assert not torch.equal(got.view(torch.int32),
                           torch.full_like(got, channel).view(torch.int32))


@pytest.mark.parametrize("kind,filt,want", [
    ("u8", "linear", "u8"), ("f32", "linear", "f32"), ("u8", "quasicubic", "u8 quasicubic"),
    ("f32", "quasicubic", "f32 quasicubic"), ("u8", "nearest", "nearest")])
@pytest.mark.parametrize("majorant", [None, 2])
@pytest.mark.parametrize("env", [None, "map"])
def test_every_frames_renderer_pair_has_its_instance(kind, filt, want, majorant, env):
    """K22 (mcs_frames_kernel<MODE, MAJ>) is chosen by the same SI_MODE and
    the majorant's presence: every pair the frame renderer builds runs its
    own instance, with the majorant where the renderer has one; the
    dispatch instantiates every mode with and without it."""
    environment = (None if env is None
                   else np.random.default_rng(1).random((4, 8, 3)).astype(np.float32))
    r = MCSRenderer(_volume(kind, filt), None, environment, resolution=RES,
                    majorant_blocks=majorant, device="cpu")
    ctx = r.ctx(Camera(), 3)
    assert KS.persistent_mode(ctx.density, ctx.tf_table, r.volume.filter) == want
    f, i = KS._params(ctx, RES, 2, r.max_collisions, r.volume.filter)
    assert int(i[-1]) == KS.PERSISTENT_MODES.index(want)
    assert (ctx.majorant is not None) == (majorant is not None)
    text = (_build.CSRC_DIR / "mcs.cu").read_text()
    for name in re.findall(r"^\s*(MM_\w+)", re.search(r"enum McsMode \{(.*?)\};", text,
                                                       re.S).group(1), re.M)[:-1]:
        assert f"VPT_MCS_MODE({name})" in text
    assert "launch_frames<true>(" in text and "launch_frames<false>(" in text


@pytest.mark.parametrize("res", [512, 100, 24, 7])
def test_warp_tiles_cover_each_pixel_once(res):
    """kernels/mcs.warp_tiles, the mirror of mcsp_pixel's 8 x 4 tiles that
    chip_smoke's trip statistics use: every pixel in exactly one warp's
    lanes, each warp's lanes an 8 x 4 block of the image, lane l at (l % 8,
    l // 8) in it, the tile sizes those of csrc/mcs.cu."""
    text = (_build.CSRC_DIR / "mcs.cu").read_text()
    assert "#define MCSP_TILE_W 16" in text and "#define MCSP_TILE_H 8" in text
    w = KS.warp_tiles(res)
    inside = w[w >= 0]
    assert inside.numel() == res * res
    assert torch.equal(torch.sort(inside).values, torch.arange(res * res))
    ix, iy = w % res, w // res
    lane = torch.arange(32)
    ok = w >= 0
    x0, y0 = ix[:, :1], iy[:, :1]
    assert bool(((ix == x0 + lane % 8) & (iy == y0 + lane // 8))[ok].all())
