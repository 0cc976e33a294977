"""The port's autodiff surrogate over the xy half-packed volume: K4's
surrogate tape and K12's hand derivation reading and scattering two 4-wide
plane rows per lookup, against the full table, the autograd twin, jax.grad
of vpt_tpu's surrogate and vpt_tpu.optim.fit_spectral.

On the CPU the port runs the plain versions (``surrogate.tape_forward_plain``,
``surrogate.reverse_plain``) under ``_RenderWindow``; the twin is torch
autograd through the diff ``_render_body`` (``K.render_diff_plain``), which
reads the xy table through torch ops. Tolerances: the xy tape and state equal
the full table's bit for bit (the xy lookup gives the full lookup's bits);
the hand derivation within 1e-5 relative L2 of the twin per table and per
state field; the window schedules within 1e-6 of chained dispatches, the
loss bit for bit; the contracted raw-density gradient over xy within 1e-6
relative L2 of the full table's (the same terms summed through other
rows); the port within 5e-4 x max|g_JAX| of jax.grad per seed, as
``tests/test_torch_surrogate.py``; the fits at ``tests/test_torch_optim.py``'s
(losses rtol 1e-4, params rtol 5e-4 / atol 5e-6).

JAX's ``spectral_render_loss`` packs a learned density into the full corner
table whatever the base ctx's kind; the port packs it into the renderer's
kind (ROADMAP C, "Reference behaviours that are not port faults"). The two
tables give the same forward bits, so there the packages differ only in the
rounding of the gradient sums, which the tolerances above cover. Sizes:
8^2 pixels x 2 streams, 8^3 volumes, 8 steps, 12 bins.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vpt_tpu import optim as JO
from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.ops import interp as JI
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch import optim as TO
from vpt_tpu_torch.kernels import corners as C
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.kernels import surrogate as S
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.ops import interp as TI
from vpt_tpu_torch.scene.camera import Camera as TCamera

torch.set_num_threads(1)

RES, STEPS, BINS = 8, 8, 12
SEEDS = [8, 5100, 77, 90017]
FIELDS = JM.SpectralState._fields
STATE = ("px", "py", "pz", "dx", "dy", "dz", "radiance")
XY = {"density_xy", "material_tf", "light_spectrum"}
ENV = np.random.default_rng(8).uniform(0.1, 1.0, (8, 16, 3)).astype(np.float32)


def _table():
    """Scattering with a density-dependent g, so the HG chain is live."""
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.7
    table[..., 1] = 0.1 + 0.8 * dens
    table[..., 2] = 0.3 + 0.4 * dens
    return table


def _density(f32):
    """The u8-quantized sphere_in_cube(8) (a u8 table), or the same moved
    off the u8 grid (an f32 table)."""
    d = np.asarray(Volume.sphere_in_cube(8).density, np.float32)
    return (d * 0.9 + 0.05).astype(np.float32) if f32 else d


def _scene(f32=False, filt="linear"):
    return (Volume(density=_density(f32), filter=filt), MaterialTF(_table()),
            LightConfig(direction=(0.6, 0.3, 0.2)), SpectrumConfig(),
            MCMSpectralConfig(extinction=6.0, bounces=4, steps=STEPS))


def _port(pack, blocks=None, env=False, f32=False, filt="linear"):
    return TM.MCMSpectralRenderer(*convert.scene_from(*_scene(f32, filt)), resolution=RES,
                                  streams=2, majorant_blocks=blocks, pack_tables=pack,
                                  environment=ENV if env else None, device="cpu")


def _raw_params(r, env=False):
    p = dict(density=np.asarray(r.volume.density, np.float32), material_tf=_table(),
             light_spectrum=np.asarray(r.light.spectrum_array(), np.float32),
             extinction=np.float32(6.0))
    if env:
        p["environment"] = ENV
    return p


def _ctx_of(base, p):
    """The base ctx with its tables packed from the raw parameters ``p``
    under autograd, the density into the base's kind."""
    vol = base.density
    ctx = dataclasses.replace(
        base, density=TI.PackedVolume(C.pack_volume_diff(p["density"], vol.kind), vol.dims,
                                      vol.kind),
        extinction=p["extinction"], material_tf=C.pack_tf_diff(p["material_tf"],
                                                              p["light_spectrum"]))
    if "environment" in p:
        ctx = dataclasses.replace(ctx, environment=C.pack_env_diff(p["environment"]))
    return ctx


def _grads(loss_fn, raw):
    p = {k: v.clone().requires_grad_(True) if torch.is_tensor(v)
         else torch.tensor(np.asarray(v)).requires_grad_(True) for k, v in raw.items()}
    loss = loss_fn(p)
    return float(loss.detach()), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _history(r, cam):
    """A reset state moved one dispatch on (positions and radiance off the
    reset) and the ctx."""
    base, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    K.step_plain(s0, base, [SEEDS[3]], STEPS, BINS)
    return base, s0


# ---------------------------------------------------------------------------
# K4's surrogate mode: the xy tape equals the full table's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("env", [False, True])
@pytest.mark.parametrize("filt", ["linear", "quasicubic"])
@pytest.mark.parametrize("blocks", [None, 4])
def test_xy_tape_and_state_equal_the_full_tables(blocks, filt, env, f32):
    cam = TCamera()
    out = []
    for pack in (XY, True):
        r = _port(pack, blocks, env, f32, filt)
        ctx, s0 = r.ctx(cam, 7), r.reset(cam, 7)
        assert ctx.density.kind == ("xy" if pack is XY else "full")
        assert (ctx.density.table.dtype == torch.float32) == f32
        assert ctx.volume_filter == filt and (ctx.majorant is not None) == (blocks is not None)
        st, tape = S.tape_forward(s0, ctx, SEEDS[:2], STEPS, BINS)
        out.append((st, tape))
    (sx, tx), (sf, tf) = out
    assert torch.equal(tx.view(torch.int32), tf.view(torch.int32))
    for a, b in zip(sx.tensors(), sf.tensors()):
        assert torch.equal(a, b)
    assert int(sx.samples.sum()) > 0


# ---------------------------------------------------------------------------
# the hand derivation over xy against the autograd twin
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_disp", [1, 4])
@pytest.mark.parametrize("mode", ["exact", "majorant", "quasicubic", "environment"])
def test_hand_derivation_over_xy_matches_autograd_twin(mode, n_disp):
    env = mode == "environment"
    filt = "quasicubic" if mode == "quasicubic" else "linear"
    r = _port(XY, 4 if mode == "majorant" else None, env, filt=filt)
    base, s0 = _history(r, TCamera())
    assert base.density.kind == "xy"
    raw = _raw_params(r, env)
    raw.update({k: getattr(s0, k) for k in STATE})
    target = torch.full((RES, RES, 3), 0.25)
    seeds = SEEDS[:n_disp]

    def start(p):
        return dataclasses.replace(s0, **{k: p[k] for k in STATE})

    def hand(p):
        img = TM.render_sequence_diff(seeds, start(p), _ctx_of(base, p), STEPS, BINS, filt)
        return torch.mean((img - target) ** 2)

    def twin(p):
        ctx = _ctx_of(base, p)
        st = {k: getattr(start(p), k) for k in K.STATE_FIELDS}
        score = torch.ones_like(s0.px)
        for s in seeds:
            st, score = K.render_diff_plain(st, score, dataclasses.replace(
                ctx, seed_bits=s, volume_filter=filt), [s], STEPS, BINS)
        return torch.mean((TM.radiance_to_rgb(st["radiance"], base.bin_xyz) - target) ** 2)

    lh, gh = _grads(hand, raw)
    lt, gt = _grads(twin, raw)
    assert lh == lt
    for k in raw:
        if k == "light_spectrum" and env:
            assert float(gh[k].abs().sum()) == 0.0 == float(gt[k].abs().sum())
            continue
        err = _rel(gh[k], gt[k])
        assert err <= 1e-5, f"{mode} {k}: relative L2 {err:.3g} from the twin"
        assert float(gt[k].abs().sum()) > 0 and bool(torch.isfinite(gh[k]).all()), k


# ---------------------------------------------------------------------------
# the contracted density gradient: xy against the full table
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("blocks", [None, 4])
def test_contracted_density_gradient_over_xy_equals_the_full_tables(blocks, f32):
    cam = TCamera()
    target = torch.full((RES, RES, 3), 0.25)
    out = []
    for pack in (XY, True):
        r = _port(pack, blocks, f32=f32)
        base, s0 = _history(r, cam)
        raw = {"density": r.volume.density}
        out.append(_grads(lambda p: TO.spectral_render_loss(p, s0, base, SEEDS, target, STEPS,
                                                             BINS), raw))
    (lx, gx), (lf, gf) = out
    assert lx == lf
    err = _rel(gx["density"], gf["density"])
    assert err <= 1e-6, f"xy vs full: relative L2 {err:.3g}"
    assert float(gf["density"].abs().sum()) > 0


# ---------------------------------------------------------------------------
# the window schedules over xy
# ---------------------------------------------------------------------------
def _window_grads(r, seeds, how):
    base, s0 = _history(r, TCamera())
    raw = _raw_params(r)
    target = torch.full((RES, RES, 3), 0.25)
    p = {k: torch.tensor(np.asarray(v)).requires_grad_(True) for k, v in raw.items()}
    start = {k: getattr(s0, k).clone().requires_grad_(True) for k in STATE}
    state = dataclasses.replace(s0, **start)
    ctx = _ctx_of(base, p)
    if how == "chained":
        score = torch.ones_like(s0.px)
        for s in seeds:
            state, score, img = TM.render_diff(state, score, dataclasses.replace(ctx, seed_bits=s),
                                               STEPS, BINS)
    else:
        img = TM.render_sequence_diff(seeds, state, ctx, STEPS, BINS, window_storage=how)
    loss = torch.mean((img - target) ** 2)
    leaves = {**p, **start}
    return float(loss.detach()), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("blocks", [None, 4])
def test_window_schedules_over_xy_match_chained_dispatches(blocks):
    r = _port(XY, blocks)
    lc, gc = _window_grads(r, SEEDS, "chained")
    for how in ("tape", "forward"):
        lw, gw = _window_grads(r, SEEDS, how)
        assert lw == lc, how
        for k in gc:
            if k == "extinction" and blocks is not None:
                # a scalar whose terms cancel under the majorant: held
                # absolutely, as tests/test_torch_surrogate_modes.py does
                assert abs(float(gw[k]) - float(gc[k])) <= 4e-9, (how, float(gw[k]))
                continue
            err = _rel(gw[k], gc[k])
            assert err <= 1e-6, f"{how} {k}: relative L2 {err:.3g} from the chained dispatches"
            assert bool(torch.isfinite(gw[k]).all()), (how, k)
        assert float(gc["density"].abs().sum()) > 0


# ---------------------------------------------------------------------------
# against jax.grad of the JAX surrogate, per seed
# ---------------------------------------------------------------------------
def _jax_xy_loss(vals, js0, jctx, seeds, target):
    """render_diff over an xy ctx whose density stays xy (JAX's own xy
    packer under jax.grad), the state's float fields, the TF, the light and
    the extinction learned too."""
    st = js0._replace(**{k: vals[k] for k in STATE})
    dens = JI.pack_volume_corners_xy_jnp(vals["density"])
    ctx = jctx._replace(density=JI.PackedVolume(dens.reshape(-1, 4), jctx.density.dims, "xy"),
                        material_tf=JI.pack_tex2d_with_tex1d_jnp(vals["material_tf"],
                                                                vals["light_spectrum"]),
                        extinction=vals["extinction"])
    score = jnp.ones_like(st.px)
    for k in range(seeds.shape[0]):
        st, score, img = JM.render_diff(st, score, ctx._replace(seed_bits=seeds[k]), STEPS, BINS)
    return jnp.mean((img - target) ** 2)


_jax_xy_grad = jax.jit(jax.value_and_grad(_jax_xy_loss))
_jax_loss = jax.jit(jax.value_and_grad(JO.spectral_render_loss), static_argnums=(5, 6, 7))


def _jax_renderer(blocks, f32):
    return JM.MCMSpectralRenderer(*_scene(f32), resolution=RES, streams=2, pack_tables=XY,
                                  majorant_blocks=blocks)


def _state_of(js0):
    return convert.state_from_numpy({k: np.asarray(getattr(js0, k)) for k in FIELDS}, "cpu")


def _assert_close(g_j, g_t, keys, label, nonzero=None):
    for k in keys:
        a, b = np.asarray(g_j[k]), g_t[k].numpy()
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b / scale, a / scale, atol=5e-4, err_msg=f"{label} {k}")
        if nonzero is None or k in nonzero:
            assert np.abs(a).sum() > 0, f"{label} {k}"


@pytest.mark.parametrize("seed", [2, 77])
@pytest.mark.parametrize("blocks", [None, 4])
def test_render_diff_over_xy_matches_jax_grad_per_seed(blocks, seed):
    """Two chained render_diff dispatches over an xy ctx in both packages,
    the density kept xy in both: the gradients of the start state's float
    fields, the density, the TF, the light and the extinction."""
    jr, tr = _jax_renderer(blocks, False), _port(XY, blocks)
    cam = Camera()
    jctx, js0 = jr.ctx(cam, seed), jr.reset(cam, seed)
    assert jctx.density.kind == "xy"
    seeds = (seed, seed + 1000)
    target = np.full((RES, RES, 3), 0.25, np.float32)
    raw = _raw_params(tr)
    raw.update({k: np.asarray(getattr(js0, k)) for k in STATE})
    loss_j, g_j = _jax_xy_grad({k: jnp.asarray(v) for k, v in raw.items()}, js0, jctx,
                               jnp.asarray(seeds, jnp.uint32), jnp.asarray(target))
    base, s0 = tr.ctx(convert.camera_from(cam), seed), _state_of(js0)
    assert base.density.kind == "xy"

    def port(p):
        st, score = dataclasses.replace(s0, **{k: p[k] for k in STATE}), torch.ones_like(s0.px)
        ctx = _ctx_of(base, p)
        for s in seeds:
            st, score, img = TM.render_diff(st, score, dataclasses.replace(ctx, seed_bits=s),
                                            STEPS, BINS)
        return torch.mean((img - torch.as_tensor(target)) ** 2)

    loss_t, g_t = _grads(port, raw)
    assert loss_t == pytest.approx(float(loss_j), rel=1e-5)
    # from a reset every lane's first deposit replaces its radiance (n = 1),
    # so the start radiance's adjoint is 0 in both packages
    assert np.abs(np.asarray(g_j["radiance"])).max() == 0.0
    _assert_close(g_j, g_t, raw, f"blocks {blocks} seed {seed}", nonzero=set(raw) - {"radiance"})


@pytest.mark.parametrize("blocks", [None, 4])
def test_learned_density_over_xy_matches_jax_loss(blocks):
    """spectral_render_loss learning the density (and the extinction) of an
    xy renderer: JAX packs the full corner table, the port the xy one (f32
    tables, re-packed from the learned raw grid)."""
    jr, tr = _jax_renderer(blocks, False), _port(XY, blocks)
    cam = Camera()
    target = np.full((RES, RES, 3), 0.25, np.float32)
    raw = {"density": _density(True), "extinction": np.float32(6.0)}
    loss_j, g_j = _jax_loss({k: jnp.asarray(v) for k, v in raw.items()}, jr.reset(cam, 7),
                            jr.ctx(cam, 7), jnp.asarray(SEEDS, jnp.uint32), jnp.asarray(target),
                            STEPS, BINS, True)
    base = tr.ctx(convert.camera_from(cam), 7)
    assert base.density.kind == "xy"
    s0 = _state_of(jr.reset(cam, 7))
    loss_t, g_t = _grads(lambda p: TO.spectral_render_loss(p, s0, base, SEEDS,
                                                           torch.as_tensor(target), STEPS, BINS),
                         raw)
    assert loss_t == pytest.approx(float(loss_j), rel=1e-5)
    _assert_close(g_j, g_t, raw, f"blocks {blocks}")


# ---------------------------------------------------------------------------
# fit_spectral on xy renderers against JAX's
# ---------------------------------------------------------------------------
def _ramp_scene():
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    table[..., 2] = 0.5
    return (Volume.sphere_in_cube(8), MaterialTF(table), LightConfig(direction=(1.0, 0.2, 0.5)),
            SpectrumConfig(), MCMSpectralConfig(extinction=20.0, bounces=4, steps=8))


def _follow(kw, fit_kw):
    scene = _ramp_scene()
    jr = JM.MCMSpectralRenderer(*scene, resolution=8, pack_tables=XY, **kw)
    tr = TM.MCMSpectralRenderer(*convert.scene_from(*scene), resolution=8, pack_tables=XY,
                                device="cpu", **kw)
    assert tr.vol_kind == "xy"
    target = np.full((8, 8, 3), 0.1, np.float32)
    init = {"density": np.full((8, 8, 8), 0.6, np.float32)}
    params_j, losses_j = JO.fit_spectral(target, jr, Camera(), init, **fit_kw)
    params_t, losses_t, info = TO.fit_spectral(target, tr, TCamera(), init, return_info=True,
                                               **fit_kw)
    assert info["method"] == "autodiff"
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    got, want = params_t["density"].numpy(), np.asarray(params_j["density"])
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-6)
    assert np.abs(got - init["density"]).max() > 0


@pytest.mark.parametrize("routing", ["autodiff", "default with a majorant grid"])
def test_xy_autodiff_fit_follows_jax(routing):
    """fit_spectral(method="autodiff") learning an xy renderer's density,
    and method=None on an xy renderer with a majorant grid, which both
    packages route to the surrogate; 3 iterations each."""
    fit_kw = dict(dispatches_per_step=2, iterations=3, learning_rate=0.05, seed=3)
    if routing == "autodiff":
        _follow({}, dict(fit_kw, method="autodiff"))
    else:
        _follow({"majorant_blocks": 4}, fit_kw)


@pytest.mark.parametrize("blocks", [None, 4])
def test_xy_fit_launch_structure(monkeypatch, blocks):
    """One iteration's kernels over xy: one taped sweep and one reverse
    pass per window, each over the xy table, the re-pack into xy rows
    (K10) and the contraction of the xy adjoint (K9), and no plain step
    inside the loss."""
    calls = []
    where = {"tape_forward": 1, "reverse": 5, "step": 1, "pack_volume": 1, "contract_volume": 2}
    for mod, name in ((S, "tape_forward"), (S, "reverse"), (K, "step"), (C, "pack_volume"),
                      (C, "contract_volume")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            # the ctx's volume kind, or the kind argument of K9 and K10
            arg = a[where[_name]]
            calls.append((_name, arg if isinstance(arg, str) else arg.density.kind))
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    loss_fn, inside = TO.spectral_render_loss, []

    def counted_loss(*a, **kw):
        n = len(calls)
        out = loss_fn(*a, **kw)
        inside.append(calls[n:])
        return out

    monkeypatch.setattr(TO, "spectral_render_loss", counted_loss)
    tr = TM.MCMSpectralRenderer(*convert.scene_from(*_ramp_scene()), resolution=8,
                                pack_tables=XY, majorant_blocks=blocks, device="cpu")
    iters = 2
    _, _, info = TO.fit_spectral(np.full((8, 8, 3), 0.1, np.float32), tr, TCamera(),
                                 {"density": np.full((8, 8, 8), 0.6, np.float32)},
                                 dispatches_per_step=2, iterations=iters, learning_rate=0.05,
                                 return_info=True, **({} if blocks else {"method": "autodiff"}))
    assert info["method"] == "autodiff"
    assert len(inside) == iters
    for got in inside:
        assert got == [("pack_volume", "xy"), ("tape_forward", "xy")], got
    for name in ("tape_forward", "reverse", "pack_volume", "contract_volume"):
        assert calls.count((name, "xy")) == iters, (name, calls)
    assert not [c for c in calls if c[1] != "xy"], calls


# ---------------------------------------------------------------------------
# beside the xy options: raw and partly packed tables, the nearest filter
# (the surrogate's RAW mode, tests/test_torch_surrogate_raw.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pack", [False, {"density_xy"}, {"density_xy", "material_tf"},
                                  {"material_tf", "light_spectrum"}, "nearest"])
def test_raw_partly_packed_and_nearest_still_raise(pack):
    """These layouts raised until the surrogate's RAW mode: render_diff now
    runs on them and gives the step's bits; fit_spectral(method="autodiff")
    runs, and on the CPU launches no kernel."""
    if pack == "nearest":
        r = _port(True, filt="nearest")
        filt = "nearest"
    else:
        r = _port(pack)
        filt = "linear"
    cam = TCamera()
    s0 = r.reset(cam, 1)
    ctx = r.ctx(cam, 2)
    assert K.is_raw(ctx)
    new, _, img = TM.render_diff(s0, torch.ones_like(s0.px), ctx, STEPS, BINS,
                                 volume_filter=filt)
    ref = TM.SpectralState(*(t.clone() for t in s0.tensors()))
    K.step_plain(ref, dataclasses.replace(ctx, volume_filter=filt), [ctx.seed_bits], STEPS, BINS)
    assert torch.equal(new.radiance, ref.radiance) and bool(torch.isfinite(img).all())
    S.reset_launch_counts()
    params, losses, info = TO.fit_spectral(np.zeros((8, 8, 3), np.float32), r, cam,
                                           {"density": np.asarray(r.volume.density)},
                                           iterations=1, method="autodiff", return_info=True)
    assert info["method"] == "autodiff" and np.isfinite(losses).all()
    assert params["density"].shape == (8, 8, 8) and bool(torch.isfinite(params["density"]).all())
    assert set(S.LAUNCHES.values()) == {0}
