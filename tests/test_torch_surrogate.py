"""The port's autodiff surrogate (render_diff / render_sequence_diff and the
hand-derived backward of kernels/surrogate.py) against its autograd twin
and against jax.grad of vpt_tpu's surrogate.

On the CPU the port runs the plain versions: K4's surrogate tape
(``surrogate.tape_forward_plain``) and K12's hand derivation
(``surrogate.reverse_plain``), under a ``torch.autograd.Function`` per
dispatch. The twin is torch autograd through the diff ``_render_body``.
Tolerances: the diff forward equals the plain forward bit for bit; the hand
derivation within 1e-5 relative L2 of the twin per table and for
extinction (the same float32 derivatives, summed in another order); the
port within 5e-4 x max|g_JAX| elementwise of JAX per seed, the PRB window
pin's tolerance (XLA's CPU log and its division of the wavelength by 300
differ from torch's by ulps, which the HG inversion's steep lanes
amplify), the loss within 1e-5 relative. Sizes as tests/test_majorant_grad.py:
8^2 pixels x 2 streams, 8^3 volumes, 8 steps.
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
from vpt_tpu_torch.kernels import corners as C
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.kernels import surrogate as S
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.ops import geometry as TG
from vpt_tpu_torch.ops import interp as TI
from vpt_tpu_torch.ops import sampling as TS

torch.set_num_threads(1)

RES, STEPS, BINS = 8, 8, 12
SEEDS = [8, 5100, 77, 90017]
FIELDS = JM.SpectralState._fields


def _table():
    """Scattering with a density-dependent g, so the HG chain is live."""
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.7
    table[..., 1] = 0.1 + 0.8 * dens
    table[..., 2] = 0.3 + 0.4 * dens
    return table


def _volume(f32):
    """u8-quantized sphere_in_cube(8), or the same moved off the u8 grid
    (an f32 table). Not a random volume: trilinear interpolation's spatial
    derivative jumps at cell faces, and the ulp-level differences between
    XLA's and torch's forward positions (carried into the next dispatch)
    put a few lanes on the other side of a face; on a random 8^3 volume
    that moves <= 10 voxels' gradients by up to ~1% of max|g| after four
    dispatches, with the hand derivation equal to the twin (ROADMAP C)."""
    vol = Volume.sphere_in_cube(8)
    if f32:
        return Volume(density=(np.asarray(vol.density) * 0.9 + 0.05).astype(np.float32))
    return vol


def _jax_renderer(vol, blocks, pack):
    return JM.MCMSpectralRenderer(
        vol, MaterialTF(_table()), LightConfig(direction=(0.6, 0.3, 0.2)), SpectrumConfig(),
        MCMSpectralConfig(extinction=6.0, bounces=4, steps=STEPS), resolution=RES, streams=2,
        pack_tables=pack, majorant_blocks=blocks)


def _port_renderer(vol, blocks):
    return TM.MCMSpectralRenderer(
        *convert.scene_from(vol, MaterialTF(_table()), LightConfig(direction=(0.6, 0.3, 0.2)),
                            SpectrumConfig(), MCMSpectralConfig(extinction=6.0, bounces=4,
                                                                steps=STEPS)),
        resolution=RES, streams=2, majorant_blocks=blocks, device="cpu")


def _raw_params(vol, light):
    return dict(density=np.asarray(vol.density, np.float32), material_tf=_table(),
                light_spectrum=np.asarray(light.spectrum_array(), np.float32),
                extinction=np.float32(6.0))


def _ctx_of(base, p):
    vol = TI.PackedVolume(C.pack_volume_diff(p["density"]), base.density.dims)
    return dataclasses.replace(base, density=vol, extinction=p["extinction"],
                               material_tf=C.pack_tf_diff(p["material_tf"], p["light_spectrum"]))


def _grads(loss_fn, raw):
    p = {k: torch.tensor(np.asarray(v)).requires_grad_(True) for k, v in raw.items()}
    loss = loss_fn(p)
    return float(loss.detach()), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))


def _clone(state):
    return type(state)(*(t.clone() for t in state.tensors()))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# the forward: bit for bit the plain step's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("blocks", [None, 4])
def test_diff_forward_equals_plain_forward(blocks):
    r = _port_renderer(Volume.sphere_in_cube(8), blocks)
    cam = convert.camera_from(Camera())
    ctx, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    plain = _clone(s0)
    K.step_plain(plain, ctx, SEEDS[:2], STEPS, BINS)
    state, score = s0, torch.ones_like(s0.px)
    for s in SEEDS[:2]:
        state, score, img = TM.render_diff(state, score, dataclasses.replace(ctx, seed_bits=s),
                                           STEPS, BINS)
    for k in FIELDS:
        assert torch.equal(getattr(state, k), getattr(plain, k)), k
    assert torch.equal(img, TM.radiance_to_rgb(plain.radiance, ctx.bin_xyz))
    assert torch.equal(score, torch.ones_like(score))
    # the twin's forward too
    p, sc = K.render_diff_plain({k: getattr(s0, k) for k in K.STATE_FIELDS},
                                torch.ones_like(s0.px), dataclasses.replace(ctx, seed_bits=SEEDS[0]),
                                SEEDS[:2], STEPS, BINS)
    for k in p:
        assert torch.equal(p[k], getattr(plain, k)), k
    if blocks is not None:
        assert int(plain.samples.sum()) > 0


# ---------------------------------------------------------------------------
# the hand derivation against the autograd twin
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("blocks", [None, 4])
@pytest.mark.parametrize("n_disp", [1, 4])
def test_hand_derivation_matches_autograd_twin(blocks, n_disp):
    vol = Volume.sphere_in_cube(8)
    r = _port_renderer(vol, blocks)
    cam = convert.camera_from(Camera())
    base, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    raw = _raw_params(vol, r.light)
    target = torch.full((RES, RES, 3), 0.25)
    seeds = SEEDS[:n_disp]

    def hand(p):
        return torch.mean((TM.render_sequence_diff(seeds, s0, _ctx_of(base, p), STEPS, BINS)
                           - target) ** 2)

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
        err = _rel(gh[k], gt[k])
        assert err <= 1e-5, f"{k}: relative L2 {err:.3g} from the twin"
        assert float(gt[k].abs().sum()) > 0 and bool(torch.isfinite(gh[k]).all()), k


def test_state_and_score_adjoints_match_twin():
    """render_diff's gradients w.r.t. its state inputs and score (the
    adjoints K12 hands to the previous dispatch) against the twin's."""
    r = _port_renderer(Volume.sphere_in_cube(8), None)
    cam = convert.camera_from(Camera())
    ctx, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    s1 = _clone(s0)
    K.step_plain(s1, ctx, [SEEDS[0]], STEPS, BINS)  # a state with history
    names = ("px", "py", "pz", "dx", "dy", "dz", "radiance")
    rng = np.random.default_rng(3)
    w = torch.as_tensor(rng.standard_normal((BINS,) + tuple(s0.px.shape)).astype(np.float32))
    wd = torch.as_tensor(rng.standard_normal(s0.px.shape).astype(np.float32))

    def run(hand):
        ins = {k: getattr(s1, k).clone().requires_grad_(True) for k in names}
        score = torch.ones_like(s1.px).requires_grad_(True)
        c = dataclasses.replace(ctx, seed_bits=SEEDS[1])
        if hand:
            st = dataclasses.replace(s1, **ins)
            out, sc, _ = TM.render_diff(st, score, c, STEPS, BINS)
            rad, dx = out.radiance, out.dx
        else:
            p = {k: getattr(s1, k) for k in K.STATE_FIELDS}
            p.update(ins)
            p, sc = K.render_diff_plain(p, score, c, [SEEDS[1]], STEPS, BINS)
            rad, dx = p["radiance"], p["dx"]
        loss = (rad * w).sum() + (dx * wd).sum() + sc.sum()
        return torch.autograd.grad(loss, [*ins.values(), score])

    for name, a, b in zip((*names, "score"), run(True), run(False)):
        assert _rel(a, b) <= 1e-5, name
    assert float(run(False)[-1].abs().sum()) > 0


# ---------------------------------------------------------------------------
# the port against jax.grad of the JAX surrogate, per seed
# ---------------------------------------------------------------------------
_jax_loss = jax.jit(jax.value_and_grad(JO.spectral_render_loss), static_argnums=(5, 6, 7))


def _port_ctx(jctx):
    dens = jctx.density
    flat = isinstance(dens, JI.PackedVolume)
    return convert.ctx_from_numpy(
        inv_mvp=np.asarray(jctx.inv_mvp), seed_bits=np.asarray(jctx.seed_bits),
        extinction=np.asarray(jctx.extinction), blur=np.asarray(jctx.blur),
        max_bounces=np.asarray(jctx.max_bounces), light_direction=np.asarray(jctx.light_direction),
        density_table=np.asarray(dens.table if flat else dens),
        density_dims=dens.dims if flat else None, material_tf=np.asarray(jctx.material_tf),
        light_spectrum=np.asarray(jctx.light_spectrum), boundaries=np.asarray(jctx.boundaries),
        bin_xyz=np.asarray(jctx.bin_xyz),
        majorant=None if jctx.majorant is None else np.asarray(jctx.majorant), device="cpu")


@pytest.mark.parametrize("blocks", [None, 4])
@pytest.mark.parametrize("f32", [False, True])
def test_port_matches_jax_grad_per_seed(blocks, f32):
    from vpt_tpu_torch import optim as TO

    vol = _volume(f32)
    raw_r, packed_r = _jax_renderer(vol, blocks, False), _jax_renderer(vol, blocks, True)
    cam = Camera()
    target = np.full((RES, RES, 3), 0.25, np.float32)
    raw = _raw_params(vol, raw_r.light)
    loss_j, g_j = _jax_loss({k: jnp.asarray(v) for k, v in raw.items()}, raw_r.reset(cam, 7),
                            raw_r.ctx(cam, 7), jnp.asarray(SEEDS, jnp.uint32), jnp.asarray(target),
                            STEPS, BINS, False)
    ctx = _port_ctx(packed_r.ctx(cam, 7))
    assert (ctx.density.table.dtype == torch.float32) == f32
    js0 = packed_r.reset(cam, 7)
    s0 = convert.state_from_numpy({k: np.asarray(getattr(js0, k)) for k in FIELDS}, "cpu")
    loss_t, g_t = _grads(lambda p: TO.spectral_render_loss(p, s0, ctx, SEEDS,
                                                           torch.as_tensor(target), STEPS, BINS),
                         raw)
    assert loss_t == pytest.approx(float(loss_j), rel=1e-5)
    for k in raw:
        a, b = np.asarray(g_j[k]), g_t[k].numpy()
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b / scale, a / scale, atol=5e-4, err_msg=k)
        assert np.abs(a).sum() > 0, k


def test_learned_tf_agrees_with_jax_packed_loss():
    """JAX's spectral_render_loss(pack_params=True) packs a learned
    material_tf into the unfused 16-wide table and reads the light from
    sample_tex1d; the port keeps the fused 18-wide table (K10). On this
    scene the two forwards agree (the loss within 1e-5) and so do the
    gradients of material_tf and light_spectrum (5e-4 x max)."""
    from vpt_tpu_torch import optim as TO

    vol = _volume(False)
    jr = _jax_renderer(vol, None, True)
    cam = Camera()
    target = np.full((RES, RES, 3), 0.25, np.float32)
    raw = {k: v for k, v in _raw_params(vol, jr.light).items()
           if k in ("material_tf", "light_spectrum")}
    loss_j, g_j = _jax_loss({k: jnp.asarray(v) for k, v in raw.items()}, jr.reset(cam, 7),
                            jr.ctx(cam, 7), jnp.asarray(SEEDS, jnp.uint32), jnp.asarray(target),
                            STEPS, BINS, True)
    js0 = jr.reset(cam, 7)
    s0 = convert.state_from_numpy({k: np.asarray(getattr(js0, k)) for k in FIELDS}, "cpu")
    loss_t, g_t = _grads(lambda p: TO.spectral_render_loss(
        p, s0, _port_ctx(jr.ctx(cam, 7)), SEEDS, torch.as_tensor(target), STEPS, BINS), raw)
    assert loss_t == pytest.approx(float(loss_j), rel=1e-5)
    for k in raw:
        a, b = np.asarray(g_j[k]), g_t[k].numpy()
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b / scale, a / scale, atol=5e-4, err_msg=k)


def test_options_outside_the_slice_raise():
    """The quasicubic filter (the argument decides, as JAX's static
    argument does), the environment map, an xy half-packed volume and a raw
    grid run; the nearest filter over a packed table raises ValueError
    before any launch, as JAX's packed lookup does."""
    r = _port_renderer(Volume.sphere_in_cube(8), None)
    cam = convert.camera_from(Camera())
    ctx, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    score = torch.ones_like(s0.px)
    qc_ctx = dataclasses.replace(ctx, volume_filter="quasicubic")
    qc_state = _clone(s0)
    K.step_plain(qc_state, qc_ctx, [ctx.seed_bits], STEPS, BINS)
    new, _, _ = TM.render_diff(s0, score, ctx, STEPS, BINS, volume_filter="quasicubic")
    assert torch.equal(new.radiance, qc_state.radiance)
    lin_state = _clone(s0)
    K.step_plain(lin_state, ctx, [ctx.seed_bits], STEPS, BINS)
    new, _, _ = TM.render_diff(s0, score, qc_ctx, STEPS, BINS)
    assert torch.equal(new.radiance, lin_state.radiance)
    env = torch.as_tensor(TI.pack_tex2d_corners(
        np.random.default_rng(1).uniform(0.1, 1.0, (4, 8, 3)).astype(np.float32)))
    env_ctx = dataclasses.replace(ctx, environment=env)
    _, _, img = TM.render_diff(s0, score, env_ctx, STEPS, BINS)
    assert bool(torch.isfinite(img).all())
    xy = TI.pack_volume_auto(np.asarray(Volume.sphere_in_cube(8).density), "cpu", "xy")
    new, _, img = TM.render_diff(s0, score, dataclasses.replace(ctx, density=xy), STEPS, BINS)
    assert torch.equal(new.radiance, lin_state.radiance) and bool(torch.isfinite(img).all())
    grid = torch.as_tensor(np.asarray(Volume.sphere_in_cube(8).density, np.float32))
    new, _, img = TM.render_diff(s0, score, dataclasses.replace(ctx, density=grid), STEPS, BINS)
    assert torch.equal(new.radiance, lin_state.radiance) and bool(torch.isfinite(img).all())
    S.reset_launch_counts()
    with pytest.raises(ValueError, match="nearest"):
        TM.render_diff(s0, score, ctx, STEPS, BINS, volume_filter="nearest")
    assert set(S.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        TM.render_diff(s0, score * 2.0, ctx, STEPS, BINS)
    S.reset_launch_counts()
    K.reset_launch_counts()
    TM.render_diff(s0, score, ctx, STEPS, BINS)
    assert set(S.LAUNCHES.values()) == {0} and K.LAUNCHES["step"] == 0


# ---------------------------------------------------------------------------
# one window: the taped and the checkpointed schedule against K chained
# single-dispatch windows
# ---------------------------------------------------------------------------
_STATE_GRADS = ("px", "py", "pz", "dx", "dy", "dz", "radiance")


def _window_grads(r, blocks, seeds, how):
    """(loss, grads of the four raw tables and of the start state's float
    fields) of an MSE loss on one window from a state with history, rendered
    ``how``: "chained" (one render_diff per seed), "tape" or "forward"."""
    vol = Volume.sphere_in_cube(8)
    cam = convert.camera_from(Camera())
    base, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    K.step_plain(s0, base, [SEEDS[3]], STEPS, BINS)  # positions and radiance off the reset
    raw = _raw_params(vol, r.light)
    target = torch.full((RES, RES, 3), 0.25)
    p = {k: torch.tensor(np.asarray(v)).requires_grad_(True) for k, v in raw.items()}
    start = {k: getattr(s0, k).clone().requires_grad_(True) for k in _STATE_GRADS}
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
@pytest.mark.parametrize("n_disp", [1, 4])
def test_window_schedules_match_chained_dispatches(blocks, n_disp):
    """The window Function under "tape" and "forward" against K chained
    render_diff windows: the loss bit for bit, every gradient within 1e-6
    relative L2 (only the order of the adjoint sums differs: one packed
    adjoint per window against one per dispatch that autograd adds)."""
    r = _port_renderer(Volume.sphere_in_cube(8), blocks)
    seeds = SEEDS[:n_disp]
    lc, gc = _window_grads(r, blocks, seeds, "chained")
    for how in ("tape", "forward"):
        lw, gw = _window_grads(r, blocks, seeds, how)
        assert lw == lc, how
        for k in gc:
            err = _rel(gw[k], gc[k])
            assert err <= 1e-6, f"{how} {k}: relative L2 {err:.3g} from the chained dispatches"
            assert bool(torch.isfinite(gw[k]).all()), (how, k)
        assert all(float(gc[k].abs().sum()) > 0 for k in ("density", "material_tf",
                                                           "light_spectrum", "extinction", "px"))


@pytest.mark.parametrize("storage", ["tape", "forward"])
def test_window_launch_structure(monkeypatch, storage):
    """Which kernels one window of 4 dispatches runs: under "tape" one taped
    sweep forward and one reverse pass backward, no step; under "forward" a
    step per dispatch forward, then per dispatch a re-tape and a reverse."""
    calls = []
    for mod, name in ((S, "tape_forward"), (S, "reverse"), (K, "step")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    r = _port_renderer(Volume.sphere_in_cube(8), None)
    cam = convert.camera_from(Camera())
    base, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    raw = _raw_params(Volume.sphere_in_cube(8), r.light)
    p = {k: torch.tensor(np.asarray(v)).requires_grad_(True) for k, v in raw.items()}
    img = TM.render_sequence_diff(SEEDS, s0, _ctx_of(base, p), STEPS, BINS, window_storage=storage)
    forward, calls[:] = list(calls), []
    torch.autograd.grad(img.sum(), list(p.values()))
    if storage == "tape":
        assert forward == ["tape_forward"] and calls == ["reverse"]
    else:
        assert forward == ["step"] * len(SEEDS)
        assert calls == ["tape_forward", "reverse"] * len(SEEDS)


def test_window_input_checks():
    r = _port_renderer(Volume.sphere_in_cube(8), None)
    cam = convert.camera_from(Camera())
    ctx, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    score = torch.ones_like(s0.px)
    # the carried score is a product of P / stop_grad(P): any lane off 1 raises
    off = score.clone()
    off.view(-1)[5] = float(np.nextafter(np.float32(1), np.float32(2)))
    with pytest.raises(ValueError, match="all ones"):
        TM.render_diff(s0, off, ctx, STEPS, BINS)
    with pytest.raises(ValueError, match="window_storage"):
        TM.render_sequence_diff(SEEDS, s0, ctx, STEPS, BINS, window_storage="disk")
    with pytest.raises(ValueError, match="frame seed"):
        TM.render_sequence_diff([], s0, ctx, STEPS, BINS)


# ---------------------------------------------------------------------------
# the surrogate tape's definition (what K4's surrogate mode writes and K12
# reads), rebuilt here from the plain step's internals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("blocks", [None, 4])
def test_plain_surrogate_tape_definition(blocks):
    assert S.SUR_FIELDS == ("flags", "dist", "dx", "dy", "dz", "rng", "px", "py", "pz", "lam",
                            "maj")
    assert (S.F_RESPAWN, S.F_OOB, S.F_NULL, S.F_SCATTER, S.F_CAPPED) == (1, 2, 4, 8, 16)
    r = _port_renderer(Volume.sphere_in_cube(8), blocks)
    cam = convert.camera_from(Camera())
    ctx, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    seeds = SEEDS[:2]
    st = _clone(s0)
    tape = S.tape_forward_plain(st, ctx, seeds, STEPS, BINS)
    flds = S.fields(blocks is not None)
    assert tape.shape == (len(seeds), STEPS, len(flds), s0.px.numel())

    ix, iy, seed_iy = K._pixel_grid(RES, 2, s0.px.device)
    sx, sy = TG.screen_position(ix, iy, K._f32(np.float32(1.0) / np.float32(RES)))
    light = K.light_terms(ctx.light_direction)
    p = {k: getattr(s0, k).clone() for k in K.STATE_FIELDS if k != "transmittance"}
    for k, seed in enumerate(seeds):
        rng = TS.seed_state(ix, seed_iy, seed)
        for i in range(STEPS):
            p, rng, it = K._render_body(p, rng, sx, sy, ctx, BINS, light, collect=True)
            bits = (it["respawn"].to(torch.int32) + 2 * it["oob"].to(torch.int32)
                    + 4 * it["null"].to(torch.int32) + 8 * it["scatter"].to(torch.int32)
                    + 256 * it["pre_bin"].to(torch.int32))
            if blocks is not None:
                bits = bits + 16 * it["capped"].to(torch.int32)
            want = dict(flags=bits.view(torch.float32), dist=it["dist"],
                        dx=it["pre_dir"][0], dy=it["pre_dir"][1], dz=it["pre_dir"][2],
                        rng=(it["rng_disk"] - (it["rng_disk"] >= 2**31) * 2**32).to(torch.int32)
                        .view(torch.float32),
                        px=it["sample_pos"][0], py=it["sample_pos"][1], pz=it["sample_pos"][2],
                        lam=it["pre_wavelength"], maj=it["maj"])
            for j, f in enumerate(flds):
                got = tape[k, i, j].view(torch.int32)
                assert torch.equal(got, want[f].reshape(-1).view(torch.int32)), (k, i, f)
    plain = _clone(s0)
    K.step_plain(plain, ctx, seeds, STEPS, BINS)
    for name in FIELDS:
        assert torch.equal(getattr(st, name), getattr(plain, name)), name
