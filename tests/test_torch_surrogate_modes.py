"""The port's autodiff surrogate in the environment and quasicubic modes,
exact and majorant, against its autograd twin and against jax.grad of
vpt_tpu's surrogate.

On the CPU the port runs the plain versions (K4's surrogate tape
``surrogate.tape_forward_plain``, K12's hand derivation
``surrogate.reverse_plain``) under ``_RenderWindow``; the twin is torch
autograd through the diff ``_render_body`` (``K.render_diff_plain``),
which reads the env map and the warped lookup through torch ops.
Tolerances as ``tests/test_torch_surrogate.py``: the forward equals the
plain forward bit for bit; the hand derivation within 1e-5 relative L2 of
the twin per table (the same float32 derivatives summed in another
order); the window schedules within 1e-6 of chained dispatches, the loss
bit for bit; the port within 5e-4 x max|g_JAX| of jax.grad per seed, in
the setting of ``tests/test_prb_packed.py:406-461`` (albedo 0, no
bounces, an isotropic light). An escape within an ulp of a pole gets an
unbounded direction adjoint from asin, as under jax.grad (ROADMAP C); the
seeded scenes here have none. Sizes: 8^2 pixels x 2 streams, 8^3 and
12^3 volumes, an 8x16 env map, 8 steps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch.kernels import corners as C
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.kernels import surrogate as S
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.ops import interp as TI

torch.set_num_threads(1)

RES, STEPS, BINS = 8, 8, 12
SEEDS = [8, 5100, 77, 90017]
FIELDS = JM.SpectralState._fields
ENV = np.random.default_rng(8).uniform(0.1, 1.0, (8, 16, 3)).astype(np.float32)
MODES = ["environment", "quasicubic"]


def _table(albedo=0.7):
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = albedo
    table[..., 1] = 0.1 + 0.8 * dens
    table[..., 2] = 0.3 + 0.4 * dens
    return table


def _filter(mode):
    return "quasicubic" if mode == "quasicubic" else "linear"


def _port_renderer(mode, blocks):
    vol = Volume(density=np.asarray(Volume.sphere_in_cube(8).density), filter=_filter(mode))
    return TM.MCMSpectralRenderer(
        *convert.scene_from(vol, MaterialTF(_table()), LightConfig(direction=(0.6, 0.3, 0.2)),
                            SpectrumConfig(), MCMSpectralConfig(extinction=6.0, bounces=4,
                                                                steps=STEPS)),
        resolution=RES, streams=2, majorant_blocks=blocks,
        environment=ENV if mode == "environment" else None, device="cpu")


def _raw_params(r, mode):
    p = dict(density=np.asarray(Volume.sphere_in_cube(8).density, np.float32),
             material_tf=_table(), light_spectrum=np.asarray(r.light.spectrum_array(), np.float32),
             extinction=np.float32(6.0))
    if mode == "environment":
        p["environment"] = ENV
    return p


def _ctx_of(base, p):
    vol = TI.PackedVolume(C.pack_volume_diff(p["density"]), base.density.dims)
    ctx = dataclasses.replace(base, density=vol, extinction=p["extinction"],
                              material_tf=C.pack_tf_diff(p["material_tf"], p["light_spectrum"]))
    if "environment" in p:
        ctx = dataclasses.replace(ctx, environment=C.pack_env_diff(p["environment"]))
    return ctx


def _grads(loss_fn, raw):
    p = {k: torch.tensor(np.asarray(v)).requires_grad_(True) for k, v in raw.items()}
    loss = loss_fn(p)
    return float(loss.detach()), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _clone(state):
    return type(state)(*(t.clone() for t in state.tensors()))


@pytest.mark.parametrize("blocks", [None, 4])
@pytest.mark.parametrize("mode", MODES)
def test_diff_forward_equals_plain_forward(mode, blocks):
    r = _port_renderer(mode, blocks)
    cam = convert.camera_from(Camera())
    ctx, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    assert ctx.volume_filter == _filter(mode)
    plain = _clone(s0)
    K.step_plain(plain, ctx, SEEDS[:2], STEPS, BINS)
    state, score = s0, torch.ones_like(s0.px)
    for s in SEEDS[:2]:
        state, score, img = TM.render_diff(state, score, dataclasses.replace(ctx, seed_bits=s),
                                           STEPS, BINS, _filter(mode))
    for k in FIELDS:
        assert torch.equal(getattr(state, k), getattr(plain, k)), k
    assert torch.equal(img, TM.radiance_to_rgb(plain.radiance, ctx.bin_xyz))
    st, tape = S.tape_forward(s0, ctx, SEEDS[:2], STEPS, BINS)
    for a, b in zip(st.tensors(), plain.tensors()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_disp", [1, 4])
@pytest.mark.parametrize("blocks", [None, 4])
@pytest.mark.parametrize("mode", MODES)
def test_hand_derivation_matches_autograd_twin(mode, blocks, n_disp):
    r = _port_renderer(mode, blocks)
    cam = convert.camera_from(Camera())
    base, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    raw = _raw_params(r, mode)
    target = torch.full((RES, RES, 3), 0.25)
    seeds = SEEDS[:n_disp]

    def hand(p):
        return torch.mean((TM.render_sequence_diff(seeds, s0, _ctx_of(base, p), STEPS, BINS,
                                                   _filter(mode)) - target) ** 2)

    def twin(p):
        ctx = _ctx_of(base, p)
        st = {k: getattr(s0, k).clone() for k in K.STATE_FIELDS}
        score = torch.ones_like(s0.px)
        for s in seeds:
            st, score = K.render_diff_plain(st, score, dataclasses.replace(ctx, seed_bits=s), [s],
                                            STEPS, BINS)
        return torch.mean((TM.radiance_to_rgb(st["radiance"], base.bin_xyz) - target) ** 2)

    lh, gh = _grads(hand, raw)
    lt, gt = _grads(twin, raw)
    assert lh == lt
    for k in raw:
        if k == "light_spectrum" and mode == "environment":
            assert float(gh[k].abs().sum()) == 0.0 == float(gt[k].abs().sum())
            continue
        err = _rel(gh[k], gt[k])
        assert err <= 1e-5, f"{mode} {k}: relative L2 {err:.3g} from the twin"
        assert float(gt[k].abs().sum()) > 0 and bool(torch.isfinite(gh[k]).all()), k


def _window_grads(r, mode, seeds, how):
    cam = convert.camera_from(Camera())
    base, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    K.step_plain(s0, base, [SEEDS[3]], STEPS, BINS)
    raw = _raw_params(r, mode)
    target = torch.full((RES, RES, 3), 0.25)
    p = {k: torch.tensor(np.asarray(v)).requires_grad_(True) for k, v in raw.items()}
    start = {k: getattr(s0, k).clone().requires_grad_(True)
             for k in ("px", "py", "pz", "dx", "dy", "dz", "radiance")}
    state = dataclasses.replace(s0, **start)
    ctx = _ctx_of(base, p)
    if how == "chained":
        score = torch.ones_like(s0.px)
        for s in seeds:
            state, score, img = TM.render_diff(state, score, dataclasses.replace(ctx, seed_bits=s),
                                               STEPS, BINS, _filter(mode))
    else:
        img = TM.render_sequence_diff(seeds, state, ctx, STEPS, BINS, _filter(mode),
                                      window_storage=how)
    loss = torch.mean((img - target) ** 2)
    leaves = {**p, **start}
    return float(loss.detach()), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("blocks", [None, 4])
@pytest.mark.parametrize("mode", MODES)
def test_window_schedules_match_chained_dispatches(mode, blocks):
    r = _port_renderer(mode, blocks)
    lc, gc = _window_grads(r, mode, SEEDS, "chained")
    for how in ("tape", "forward"):
        lw, gw = _window_grads(r, mode, SEEDS, how)
        assert lw == lc, how
        for k in gc:
            if float(gc[k].abs().sum()) == 0.0:
                assert float(gw[k].abs().sum()) == 0.0, (how, k)
                continue
            if k == "extinction":
                # a scalar whose terms cancel (to 5e-5 under the majorant
                # here): held to 1e-6 of the exact scene's -4e-3, absolutely
                assert abs(float(gw[k]) - float(gc[k])) <= 4e-9, (how, float(gw[k]), float(gc[k]))
                continue
            err = _rel(gw[k], gc[k])
            assert err <= 1e-6, f"{how} {k}: relative L2 {err:.3g} from the chained dispatches"
    if mode == "environment":
        assert float(gc["environment"].abs().sum()) > 0


# ---------------------------------------------------------------------------
# against jax.grad of the JAX surrogate, per seed
# ---------------------------------------------------------------------------
def _jax_scene(mode, blocks):
    vol = Volume(density=np.asarray(Volume.sphere_in_cube(12).density), filter=_filter(mode))
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 1] = 0.1 + 0.6 * dens
    table[..., 2] = 0.5
    scene = (vol, MaterialTF(table), LightConfig(direction=(0.0, 0.0, 0.0)), SpectrumConfig(),
             MCMSpectralConfig(extinction=6.0, bounces=0, steps=STEPS))
    kw = dict(resolution=RES, streams=2, majorant_blocks=blocks,
              environment=ENV if mode == "environment" else None)
    return (JM.MCMSpectralRenderer(*scene, pack_tables=False, **kw),
            TM.MCMSpectralRenderer(*convert.scene_from(*scene), device="cpu", **kw))


@pytest.mark.parametrize("blocks", [None, 4])
@pytest.mark.parametrize("mode", MODES)
def test_port_matches_jax_grad_per_seed(mode, blocks):
    jr, tr = _jax_scene(mode, blocks)
    cam = Camera()
    filt = _filter(mode)
    for seed in (2, 77):
        rctx, rs0 = jr.ctx(cam, seed), jr.reset(cam, seed)
        keys = ("density", "environment") if mode == "environment" else ("density",)

        def img_sum(*vals):
            ctx = rctx._replace(**dict(zip(keys, vals)))
            return jnp.sum(JM.render_sequence_diff(jnp.asarray([np.uint32(seed)], jnp.uint32),
                                                   rs0, ctx, STEPS, BINS, volume_filter=filt))

        raw = {"density": np.asarray(jr.volume.density, np.float32)}
        if mode == "environment":
            raw["environment"] = ENV
        g_j = jax.grad(img_sum, argnums=tuple(range(len(keys))))(
            *(jnp.asarray(raw[k]) for k in keys))
        s0 = convert.state_from_numpy({k: np.asarray(getattr(rs0, k)) for k in FIELDS}, "cpu")
        base = tr.ctx(convert.camera_from(cam), seed)

        def port(p):
            ctx = dataclasses.replace(base, density=TI.PackedVolume(
                C.pack_volume_diff(p["density"]), base.density.dims))
            if "environment" in p:
                ctx = dataclasses.replace(ctx, environment=C.pack_env_diff(p["environment"]))
            return TM.render_sequence_diff([seed], s0, ctx, STEPS, BINS, filt).sum()

        _, g_t = _grads(port, raw)
        for k, a in zip(keys, g_j):
            a, b = np.asarray(a), g_t[k].numpy()
            scale = max(np.abs(a).max(), 1e-6)
            np.testing.assert_allclose(b / scale, a / scale, atol=5e-4,
                                       err_msg=f"{mode} {k} seed {seed}")
            assert np.abs(a).sum() > 0, k
