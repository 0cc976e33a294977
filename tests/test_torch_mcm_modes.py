"""K20's instance by table pair (``kernels/mcm.py::step_mode``, which fills
the parameter block's MI_MODE; ``csrc/mcm.cu`` McmMode and its dispatch),
and the two identities K20's escape and respawn use in place of the plain
version's operations:

- every pair ``MCMRenderer`` builds runs an instance of its own, and every
  pair the wrapper takes maps to an instance the library builds, so no
  input K20 took before it had instances raises for want of one;
- the escape under a one-texel environment whose channels are lerp_fixed
  deposits the texel (``sample_environment`` returns it at every finite
  direction), bit for bit through the plain step;
- at blur +0 the near point of a respawn's camera ray is the point of
  (sx + 0, sy + 0), which K20 computes once a lane: bit for bit at every
  pixel and disk point of both signs, after the plain ``apply_homogeneous``;
  the kernel computes its own where sx or sy is -0 and the disk point's
  coordinate is negative or -0 (the sums then keep -0), which the last test
  holds against the per-respawn point too.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from vpt_tpu_torch import Camera, Volume
from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.kernels import mcm as KM
from vpt_tpu_torch.models.mcm import MCMRenderer, MCMState
from vpt_tpu_torch.ops import geometry, interp
from vpt_tpu_torch.utils.config import MCMConfig

RES = 8
F32 = np.float32


def _mode_index(ctx):
    return int(KM._params(ctx, RES, RES * RES, 2, 1)[1][-1])


def test_modes_follow_the_source():
    """STEP_MODES is McmMode in order, MI_MODE is the block's last integer,
    and the dispatch instantiates every mode."""
    text = (_build.CSRC_DIR / "mcm.cu").read_text()
    body = re.search(r"enum McmMode \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"^\s*(MC_\w+)", body, re.M)
    assert names[-1] == "MC_COUNT" and len(names) - 1 == len(KM.STEP_MODES)
    assert [n[3:].lower() for n in names[:-1]] == [
        m.replace(" quasicubic", "_qc") for m in KM.STEP_MODES]
    assert re.search(r"MI_MODE,[^\n]*\n\s*MI_COUNT,", text)
    for n in names[:-1]:
        assert f"VPT_MCM_MODE({n})" in text


def _volume(kind, filt):
    density = Volume.sphere_in_cube(16).density
    if kind == "f32":  # values no u8 code holds: packed as f32
        density = np.random.default_rng(5).random((16, 16, 16), np.float32)
    return Volume(density, filt)


@pytest.mark.parametrize("kind", ["u8", "f32"])
@pytest.mark.parametrize("filt", ["linear", "quasicubic", "nearest"])
@pytest.mark.parametrize("pack", [True, False])
@pytest.mark.parametrize("env", [None, "map"])
@pytest.mark.parametrize("compaction", [False, True])
def test_every_renderer_pair_has_its_instance(kind, filt, pack, env, compaction):
    environment = (None if env is None
                   else np.random.default_rng(1).random((4, 8, 3)).astype(np.float32))
    r = MCMRenderer(_volume(kind, filt), None, environment, resolution=RES, pack_tables=pack,
                    compaction=compaction, device="cpu")
    ctx = r.ctx(Camera(), 3)
    got = KM.step_mode(ctx.density, ctx.tf_table, ctx.volume_filter)
    packed = pack and filt != "nearest"
    want = ((kind + ("" if filt == "linear" else " quasicubic")) if packed
            else {"linear": "raw", "quasicubic": "raw quasicubic", "nearest": "nearest"}[filt])
    assert got == want and got != "generic"
    assert _mode_index(ctx) == KM.STEP_MODES.index(want)


@pytest.mark.parametrize("density", ["packed u8", "packed f32", "raw"])
@pytest.mark.parametrize("tf", ["packed", "raw"])
@pytest.mark.parametrize("filt", ["linear", "quasicubic", "nearest"])
def test_every_pair_the_wrapper_takes_has_an_instance(density, tf, filt):
    """Each (volume, TF, filter) the table checks take maps to a mode the
    library instantiates (the pairs MCMRenderer does not build to
    "generic"), and the step runs it; the pair the checks refuse (a packed
    table under the nearest filter) is refused as before."""
    kind = density.split()[-1]
    base = MCMRenderer(_volume("f32" if kind == "f32" else "u8", "linear"), None, None,
                       resolution=RES, device="cpu")
    ctx = base.ctx(Camera(), 3)
    raw_grid = torch.as_tensor(np.asarray(base.volume.density, np.float32))
    raw_tf = torch.as_tensor(np.asarray(base.tf2d.rasterize(), np.float32))
    ctx = dataclasses.replace(ctx, density=raw_grid if density == "raw" else ctx.density,
                              tf_table=raw_tf if tf == "raw" else ctx.tf_table,
                              volume_filter=filt)
    if density != "raw" and filt == "nearest":
        with pytest.raises(ValueError, match="needs a raw grid"):
            KM._check_tables(ctx)
        return
    KM._check_tables(ctx)
    mode = KM.step_mode(ctx.density, ctx.tf_table, filt)
    built = (density != "raw" and tf == "packed") or (density == "raw" and tf == "raw")
    assert (mode != "generic") == built
    assert 0 <= _mode_index(ctx) < len(KM.STEP_MODES)
    state = MCMState(**KM.reset(ctx, RES, "cpu"))
    KM.step(state, ctx, [7, 8], 2)
    assert int(state.samples.sum()) > 0 and bool(torch.isfinite(state.rr).all())
    assert isinstance(ctx.density, interp.PackedVolume) == (density != "raw")


@pytest.mark.parametrize("texel", [(1.0, 1.0, 1.0), (0.3, 1e-40, 2.5), (-0.25, 7.0, 0.0)])
def test_one_texel_escape_deposits_its_texel(texel, monkeypatch):
    """K20's escape under a one-texel map: the plain step with the texel in
    place of the equirect lookup gives the same state bit for bit over
    dispatches where most lanes escape (each escape at a finite direction,
    the respawned or scattered one)."""
    env = np.asarray(texel, np.float32).reshape(1, 1, 3)
    r = MCMRenderer(_volume("u8", "linear"), None, env, MCMConfig(extinction=8.0, steps=4),
                    resolution=16, device="cpu")
    cam = Camera()
    ctx = r.ctx(cam, 5)
    s0 = r.reset(cam, 5)
    want = KM.step_plain(MCMState(*(t.clone() for t in s0.tensors())), ctx, [3, 4], 4)
    one = torch.as_tensor(env.reshape(3))

    def texel_lookup(e, dx, dy, dz):
        assert bool(torch.isfinite(dx).all() & torch.isfinite(dy).all() & torch.isfinite(dz).all())
        return one.expand(dx.shape + (3,))

    monkeypatch.setattr(KM, "sample_environment", texel_lookup)
    got = KM.step_plain(MCMState(*(t.clone() for t in s0.tensors())), ctx, [3, 4], 4)
    assert int(got.samples.sum()) > 16 * 16
    for a, b in zip(got.tensors(), want.tensors()):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def _screen(res):
    i = torch.arange(res)
    return geometry.screen_position(i.view(1, -1).expand(res, res), i.view(-1, 1).expand(res, res),
                                    float(F32(1) / F32(res)))


# disk points of both signs, the signed zeros among them
DISK = [(a, b) for a in (0.3, -0.3, 0.0, -0.0, 1.0) for b in (0.7, -0.7, 0.0, -0.0, -1.0)]


@pytest.mark.parametrize("res", [512, 385, 100, 24])
def test_near_point_at_zero_blur_is_the_pixel_point(res):
    """At blur +0 the per-respawn near point apply_homogeneous(sx + ox *
    blur, sy + oy * blur, -1) equals apply_homogeneous(sx + 0, sy + 0, -1),
    bit for bit, at every pixel (R = 385 has a row at sy = -0) and disk
    point, for the default camera."""
    inv = np.asarray(Camera().inverse_mvp(), np.float32)
    sx, sy = _screen(res)
    blur = torch.tensor(F32(0.0))
    hoisted = geometry.apply_homogeneous(inv, sx + 0.0, sy + 0.0, -1.0)
    for ox, oy in DISK:
        near = geometry.apply_homogeneous(inv, sx + torch.tensor(F32(ox)) * blur,
                                          sy + torch.tensor(F32(oy)) * blur, -1.0)
        for a, b in zip(hoisted, near):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (ox, oy)


def _neg0(t):
    return t.view(torch.int32) == torch.iinfo(torch.int32).min


@pytest.mark.parametrize("res", [385, 21])
def test_near_point_rule_equals_the_respawn_point_for_any_camera(res):
    """The kernel's rule (mcm.cu mcm_respawn_lane): the hoisted point
    unless sx or sy is -0 and the disk point's coordinate has its sign bit,
    where the respawn computes its own. Its screen point equals the
    per-respawn sum bit for bit everywhere, so the near point does for any
    matrix; checked through a camera that puts the pixel centre's ray at x
    = 0 and w = 1 exactly, where a signed zero reaches the point."""
    sx, sy = _screen(res)
    blur = torch.tensor(F32(0.0))
    inv = np.eye(4, dtype=np.float32)
    for ox, oy in DISK:
        px, py = sx + torch.tensor(F32(ox)) * blur, sy + torch.tensor(F32(oy)) * blur
        own = (_neg0(sx) & bool(np.signbit(F32(ox)))) | (_neg0(sy) & bool(np.signbit(F32(oy))))
        rx = torch.where(own, px, sx + 0.0)
        ry = torch.where(own, py, sy + 0.0)
        assert torch.equal(rx.view(torch.int32), px.view(torch.int32))
        assert torch.equal(ry.view(torch.int32), py.view(torch.int32))
        got = geometry.apply_homogeneous(inv, rx, ry, -1.0)
        want = geometry.apply_homogeneous(inv, px, py, -1.0)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert bool(_neg0(sy).any())  # the rows whose sum keeps -0 exist at these R
