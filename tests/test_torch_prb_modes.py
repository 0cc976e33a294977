"""The port's packed PRB backward in the environment, quasicubic and xy
modes (JAX ``spectral_backward_packed``'s branches) against vpt_tpu.

Both packages run the same dispatches from one JAX state and ctx, carried
across by ``vpt_tpu_torch.convert``; on the CPU the port runs the plain
versions of K4 ``tape_forward`` and K5 ``prb_reverse``. Tolerances as
``tests/test_torch_prb.py``: raw gradients within 1e-3 relative L2 per
table, images rtol 1e-3; tapes equal on >= 99% of lane-steps per field
(int and bool fields bit for bit, floats within 1e-3 (|x| + 1)). The
environment's addressing fields hold 0 where the lane did not escape (the
JAX tape holds unused values there), so they compare on escaping
lane-steps. Sizes: 16^2 pixels, a 16^3 volume, an 8x16 env map, 8 steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpt_tpu.kernels import spectral_backward as JB
from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.ops import interp as JI
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch.kernels import spectral_backward as TB

torch.set_num_threads(1)

RES, STEPS = 16, 8
FIELDS = JM.SpectralState._fields
XY = {"density_xy", "material_tf", "light_spectrum"}
ENV = np.random.default_rng(0).random((8, 16, 3)).astype(np.float32)


def _table():
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.7
    table[..., 1] = 0.1 + 0.8 * dens
    table[..., 2] = 0.3 + 0.4 * dens
    return MaterialTF(table)


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


def _pair(seed, mode, streams=1):
    """(jax ctx, jax state, port ctx, port state, filter) of one scene."""
    filt = "quasicubic" if mode == "quasicubic" else "linear"
    r = JM.MCMSpectralRenderer(
        Volume(density=np.asarray(Volume.sphere_in_cube(16).density), filter=filt), _table(),
        LightConfig(direction=(0.6, 0.3, 0.2)), SpectrumConfig(),
        MCMSpectralConfig(extinction=6.0, bounces=4, steps=STEPS), resolution=RES,
        streams=streams, pack_tables=XY if mode == "xy" else True,
        environment=ENV if mode == "environment" else None)
    cam = Camera()
    jctx, js0 = r.ctx(cam, seed), r.reset(cam, seed)
    ts0 = convert.state_from_numpy({k: np.asarray(getattr(js0, k)) for k in FIELDS}, "cpu")
    return jctx, js0, _port_ctx(jctx, filt), ts0, filt


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


CASES = [
    ("environment", 1, frozenset({"environment", "density"})),
    ("environment", 1, TB.ALL_WRT | {"environment"}),
    ("quasicubic", 1, TB.ALL_WRT),
    ("xy", 1, TB.ALL_WRT),
    ("xy", 2, TB.ALL_WRT),
]


@pytest.mark.parametrize("stride,scatter", [(1, "stride"), (4, "stride"), (4, "importance")])
@pytest.mark.parametrize("mode,streams,wrt", CASES,
                         ids=["env-density", "env-all", "quasicubic", "xy", "xy-streams2"])
def test_prb_modes_match_jax(mode, streams, wrt, stride, scatter):
    jctx, js0, tctx, ts0, filt = _pair(5, mode, streams)
    g = np.random.default_rng(2).random((RES, RES, 3)).astype(np.float32)
    kw = dict(volume_filter=filt, wrt=wrt, scatter_stride=stride, scatter_mode=scatter)
    _, img_j, g_j = JB.prb_render_and_grads(js0, jctx, jnp.asarray(g), STEPS, 12, **kw)
    _, img_t, g_t = TB.prb_render_and_grads(ts0, tctx, torch.as_tensor(g), STEPS, 12, **kw)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-3, atol=1e-5)
    assert set(g_t) == set(g_j) == set(wrt)
    for k in g_j:
        if k == "light_spectrum" and mode == "environment":
            # never sampled under an env map: zero in both packages
            assert float(g_t[k].abs().sum()) == 0.0 == float(np.abs(np.asarray(g_j[k])).sum())
            continue
        err = _rel(g_j[k], g_t[k].numpy())
        assert err <= 1e-3, f"{mode} {scatter}{stride} {k}: relative L2 error {err:.3g}"
        assert np.abs(np.asarray(g_j[k])).sum() > 0, k


def _jax_tape(tape, fields):
    cols = []
    for f in fields:
        v = np.asarray(tape["slopes"][..., int(f[-1])] if f.startswith("slope") else tape[f])
        if f == "hg_cos":
            v = np.where(np.asarray(tape["scatter"]), v, np.float32(0.0))
        if v.dtype == bool:
            v = v.astype(np.float32)
        elif v.dtype == np.int32:
            v = v.view(np.float32)
        cols.append(v.reshape(v.shape[0], -1))
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("mode", ["environment", "quasicubic", "xy"])
def test_tape_matches_jax_field_by_field(mode):
    jctx, js0, tctx, ts0, filt = _pair(5, mode, 2)
    wrt = TB.ALL_WRT | {"environment"}
    _, jtape = JB.spectral_backward_packed(js0, jctx, None, STEPS, 12, filt, wrt=wrt,
                                           forward_only=True)
    _, ttape = TB.spectral_backward_packed(ts0, tctx, None, STEPS, 12, filt, wrt=wrt,
                                           forward_only=True)
    fields = TB.ctx_tape_fields(tctx, wrt)
    new = {"environment": ("env_row", "env_fx", "env_fy", "env_band", "env_w"),
           "quasicubic": ("vfx", "vfy", "vfz"), "xy": ("vol_row0", "vol_row1")}[mode]
    assert set(new) <= set(fields) and set(fields) <= set(TB.TAPE_FIELDS)
    assert (mode == "xy") == ("vol_row1" in fields)
    want, got = _jax_tape(jtape, fields), ttape.numpy()
    assert got.shape == want.shape
    escaped = got[:, fields.index("env_w")] > 0 if mode == "environment" else None
    for i, f in enumerate(fields):
        a, b = got[:, i], want[:, i]
        if f in TB.INT_FIELDS or f in TB.BOOL_FIELDS:
            ok = a.view(np.int32) == b.view(np.int32)
        else:
            ok = np.abs(a - b) <= 1e-3 * (np.abs(b) + 1.0)
        if f in ("env_row", "env_fx", "env_fy", "env_band"):
            ok = ok[escaped]
            assert escaped.sum() > 0
            assert np.all(a[~escaped].view(np.int32) == 0), f
        assert float(np.mean(ok)) >= 0.99, f"{mode} tape field {f}: {np.mean(ok):.4f} agree"


def test_the_filter_argument_decides():
    """As the JAX static argument does: a ctx whose volume_filter differs
    from the argument renders with the argument's filter, and its tape
    carries the argument's (warped or not) weights."""
    _, _, tctx, ts0, _ = _pair(5, "quasicubic")
    lin = dataclasses.replace(tctx, volume_filter="linear")
    g = torch.ones(RES, RES, 3)
    for ctx in (tctx, lin):
        outs = [TB.prb_render_and_grads(ts0, ctx, g, STEPS, 12, volume_filter=f)
                for f in ("linear", "quasicubic")]
        want = [TB.prb_render_and_grads(ts0, dataclasses.replace(ctx, volume_filter=f), g, STEPS,
                                        12, volume_filter=f) for f in ("linear", "quasicubic")]
        for (_, img, gr), (_, img_w, gr_w) in zip(outs, want):
            assert torch.equal(img, img_w)
            for k in gr:
                assert torch.equal(gr[k], gr_w[k]), k
        assert not torch.equal(outs[0][1], outs[1][1])


def test_environment_key_without_a_map_and_unported_options():
    """wrt="environment" on a ctx without a map adds no gradient (JAX's
    want_env is False there); raw volumes, the nearest filter and unknown
    keys raise before any launch."""
    jctx, js0, tctx, ts0, _ = _pair(3, "xy")
    g = torch.ones(RES, RES, 3)
    _, _, gr = TB.prb_render_and_grads(ts0, tctx, g, STEPS, 12,
                                       wrt=frozenset({"environment", "density"}))
    assert set(gr) == {"density"} and gr["density"].shape == (16, 16, 16)
    TB.reset_launch_counts()
    raw = dataclasses.replace(tctx, density=torch.zeros(16, 16, 16))
    with pytest.raises(NotImplementedError, match="raw"):
        TB.prb_render_and_grads(ts0, raw, g, STEPS, 12)
    with pytest.raises(NotImplementedError, match="nearest"):
        TB.prb_render_and_grads_many(ts0, tctx, [1, 2], g, STEPS, 12, volume_filter="nearest")
    with pytest.raises(ValueError, match="unknown"):
        TB.tape_fields(frozenset({"density", "albedo"}))
    with pytest.raises(ValueError):
        bad_env = dataclasses.replace(tctx, environment=torch.zeros((4, 4, 3)))
        TB.prb_render_and_grads(ts0, bad_env, g, STEPS, 12)
    assert set(TB.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("mode", ["environment", "quasicubic", "xy"])
def test_window_storage_modes_agree(mode):
    """The K = 3 window in each mode, taped once or re-taped per dispatch
    from stored start states: image bit-identical, gradients to float
    rounding; a window equals three chained single dispatches."""
    _, _, tctx, ts0, filt = _pair(4, mode, 2)
    g = torch.ones(RES, RES, 3)
    seeds = [11, 5021, 90001]
    wrt = TB.ALL_WRT | {"environment"}
    out = {}
    for storage in ("tape", "forward"):
        _, img, gr = TB.prb_render_and_grads_many(ts0, tctx, seeds, g, STEPS, 12, filt, wrt=wrt,
                                                  window_storage=storage)
        out[storage] = (img, gr)
    _, img_s, gr_s = TB.prb_render_and_grads_many(ts0, tctx, seeds, g, STEPS, 12, filt, wrt=wrt,
                                                  window=False)
    assert torch.equal(out["tape"][0], out["forward"][0])
    assert torch.equal(out["tape"][0], img_s)
    for k in out["tape"][1]:
        a, b = out["tape"][1][k].numpy(), out["forward"][1][k].numpy()
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-6, err_msg=k)
