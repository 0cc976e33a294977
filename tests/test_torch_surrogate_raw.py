"""The port's autodiff surrogate over raw and partly packed tables and the
nearest filter (the RAW mode of K4's surrogate mode and of K12), against
the port's own step, the autograd twin, jax.grad of vpt_tpu's surrogate and
vpt_tpu.optim.fit_spectral.

On the CPU the port runs the plain versions (``surrogate.tape_forward_plain``,
``surrogate.reverse_plain``) under ``_RenderWindow``; the twin is torch
autograd through the diff ``_render_body`` (``K.render_diff_plain``), which
reads every table kind through torch ops. The modes are every layout of
``chip_smoke.RAW_LAYOUTS``, the xy table beside a raw TF, the nearest filter,
a raw environment map, the quasicubic filter and raw tables with a majorant
grid. Tolerances: the taped state equal to ``K.step_plain``'s bit for bit;
the hand derivation within 2e-6 relative L2 of the twin per table and per
state field (the start position's x reads 1.1e-6 over 3 dispatches from a
state with history in every layout, the packed table's too: the two sum
the same terms in another order); the window schedules within 1e-6 of chained dispatches, the
loss bit for bit; the port within 5e-4 x max|g_JAX| of jax.grad per seed
and table, as ``tests/test_torch_surrogate.py`` (the fused TF's light pair
summed over its density rows: jax.grad adds it into the row each lookup
read, the port into row 0; ROADMAP C); the fits at
``tests/test_torch_optim.py``'s (losses rtol 1e-4, params rtol 5e-4 / atol
5e-6). Sizes: 8^2 pixels x 2 streams, 8^3 smooth ``sphere_in_cube`` volumes
moved off the u8 grid (ROADMAP C, "Trilinear kinks"), 6 steps, 12 bins.
The finite differences and the fits are in
``tests/test_torch_surrogate_raw_fd.py``.
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
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.kernels import spectral_backward as TB
from vpt_tpu_torch.kernels import surrogate as S
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.ops import interp as TI
from vpt_tpu_torch.scene.camera import Camera as TCamera

torch.set_num_threads(1)

RES, STEPS, BINS = 8, 6, 12
SEEDS = [8, 5100, 77]
FIELDS = JM.SpectralState._fields
STATE = ("px", "py", "pz", "dx", "dy", "dz", "radiance")
ENV = np.random.default_rng(8).uniform(0.1, 1.0, (8, 16, 3)).astype(np.float32)
# mode -> (pack_tables, volume filter, majorant blocks, environment map)
MODES = {
    "raw": (False, "linear", None, False),
    "raw grid + fused TF": ({"material_tf", "light_spectrum"}, "linear", None, False),
    "16-wide TF": ({"material_tf"}, "linear", None, False),
    "pair light": ({"light_spectrum"}, "linear", None, False),
    "packed volume + raw TF": ({"density"}, "linear", None, False),
    "xy + raw TF": ({"density_xy"}, "linear", None, False),
    "nearest": (True, "nearest", None, False),
    "raw quasicubic": (False, "quasicubic", None, False),
    "raw environment": (False, "linear", None, True),
    "raw majorant": (False, "linear", 4, False),
}


def _table():
    """Scattering with a density-dependent g, so the HG chain is live."""
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.7
    table[..., 1] = 0.1 + 0.8 * dens
    table[..., 2] = 0.3 + 0.4 * dens
    table[..., 3] = 0.5
    return table


def _scene(filt="linear"):
    d = np.asarray(Volume.sphere_in_cube(8).density, np.float32) * 0.9 + 0.05
    return (Volume(density=d.astype(np.float32), filter=filt), MaterialTF(_table()),
            LightConfig(direction=(0.6, 0.3, 0.2)), SpectrumConfig(),
            MCMSpectralConfig(extinction=6.0, bounces=4, steps=STEPS))


def _kw(mode):
    pack, filt, blocks, env = MODES[mode]
    return dict(resolution=RES, streams=2, pack_tables=pack, majorant_blocks=blocks,
                environment=ENV if env else None), filt


def _port(mode):
    kw, filt = _kw(mode)
    return TM.MCMSpectralRenderer(*convert.scene_from(*_scene(filt)), device="cpu", **kw), filt


def _jax(mode):
    kw, filt = _kw(mode)
    return JM.MCMSpectralRenderer(*_scene(filt), **kw), filt


def _tables(ctx) -> dict:
    """The ctx's differentiable tables by name: the volume (the raw grid or
    the packed table), the TF, the light beside a TF without it, the
    environment map, the extinction."""
    out = dict(density=K.density_table(ctx), material_tf=ctx.material_tf,
               extinction=torch.tensor(np.float32(ctx.extinction)))
    if ctx.material_tf.shape[-1] != 18:
        out["light_spectrum"] = ctx.light_spectrum
    if ctx.environment is not None:
        out["environment"] = ctx.environment
    return out


def _ctx_of(base, p):
    """``base`` with its tables replaced by ``p``'s (leaves under autograd)."""
    vol = base.density
    density = (TI.PackedVolume(p["density"], vol.dims, vol.kind)
               if isinstance(vol, TI.PackedVolume) else p["density"])
    return dataclasses.replace(base, density=density,
                               **{k: v for k, v in p.items() if k != "density"})


def _never_read(mode, k) -> bool:
    """Leaves whose gradient is 0 by construction: the position under the
    nearest filter (floor has no gradient, and only the lookups see the
    position), the light under an environment map (escapes read the map)."""
    _, filt, _, env = MODES[mode]
    return (filt == "nearest" and k in ("px", "py", "pz")) or (env and k == "light_spectrum")


def _grads(loss_fn, raw):
    """(loss, gradients); a leaf the loss does not reach gets zeros (the
    twin's start positions under the nearest filter)."""
    p = {k: v.clone().requires_grad_(True) if torch.is_tensor(v)
         else torch.tensor(np.asarray(v)).requires_grad_(True) for k, v in raw.items()}
    loss = loss_fn(p)
    g = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    return float(loss.detach()), {k: torch.zeros_like(v) if gk is None else gk
                                  for (k, v), gk in zip(p.items(), g)}


def _comparable(g):
    """A gradient as the comparisons hold it: a fused (Hp, Wp, 18) TF's
    light pair summed over its density rows (jax.grad and the twin add it
    into the row each lookup read, the port into row 0: the same light
    gradient once contracted), every other table as it is."""
    g = np.asarray(g, np.float64)
    if g.ndim == 3 and g.shape[-1] == 18:
        return np.concatenate([g[..., :16].reshape(-1), g[..., 16:].sum(0).reshape(-1)])
    return g


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _history(r, cam):
    """A reset state moved one dispatch on (positions and radiance off the
    reset) and the ctx."""
    base, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    K.step_plain(s0, base, [SEEDS[2]], STEPS, BINS)
    return base, s0


# ---------------------------------------------------------------------------
# the taped forward in RAW mode: the state equals the step's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", list(MODES))
def test_raw_tape_state_equals_the_step(mode):
    r, filt = _port(mode)
    cam = TCamera()
    ctx = dataclasses.replace(r.ctx(cam, 7), volume_filter=filt)
    assert K.is_raw(ctx) and ctx.volume_filter == filt
    s0 = r.reset(cam, 7)
    st, tape = S.tape_forward(s0, ctx, SEEDS[:2], STEPS, BINS)
    ref = TB.clone_state(s0)
    K.step_plain(ref, ctx, SEEDS[:2], STEPS, BINS)
    for k in K.STATE_FIELDS:
        assert torch.equal(getattr(st, k), getattr(ref, k)), k
    assert tape.shape == (2, STEPS, len(S.fields(ctx.majorant is not None)), s0.px.numel())
    assert int(st.samples.sum()) > 0
    # the window's forward runs the same bits
    new, _, _ = TM.render_diff(s0, torch.ones_like(s0.px), dataclasses.replace(
        ctx, seed_bits=SEEDS[0]), STEPS, BINS, filt)
    one = TB.clone_state(s0)
    K.step_plain(one, ctx, SEEDS[:1], STEPS, BINS)
    assert torch.equal(new.radiance, one.radiance)


# ---------------------------------------------------------------------------
# the hand derivation against the autograd twin
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_disp", [1, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_hand_derivation_matches_autograd_twin(mode, n_disp):
    r, filt = _port(mode)
    base, s0 = _history(r, TCamera())
    raw = _tables(base)
    raw.update({k: getattr(s0, k) for k in STATE})
    target = torch.full((RES, RES, 3), 0.25)
    seeds = SEEDS[:n_disp]

    def start(p):
        return dataclasses.replace(s0, **{k: p[k] for k in STATE})

    def tables(p):
        return _ctx_of(base, {k: v for k, v in p.items() if k not in STATE})

    def hand(p):
        img = TM.render_sequence_diff(seeds, start(p), tables(p), STEPS, BINS, filt)
        return torch.mean((img - target) ** 2)

    def twin(p):
        ctx = tables(p)
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
        if _never_read(mode, k):
            assert float(gh[k].abs().max()) == 0.0 == float(gt[k].abs().max()), k
            continue
        err = _rel(_comparable(gh[k]), _comparable(gt[k]))
        assert err <= 2e-6, f"{mode} {k}: relative L2 {err:.3g} from the twin"
        assert bool(torch.isfinite(gh[k]).all()), k
        assert k in STATE or float(gt[k].abs().sum()) > 0, k
        if k == "material_tf" and gh[k].shape[-1] in (4, 16):
            # the fourth channel of a raw or 16-wide TF takes no adjoint
            assert float(gh[k].reshape(-1, 4)[:, 3].abs().max()) == 0.0
    assert any(float(gt[k].abs().sum()) > 0 for k in ("px", "py", "pz", "dx", "dy", "dz"))


# ---------------------------------------------------------------------------
# the window schedules over raw tables
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["raw", "raw majorant", "16-wide TF"])
def test_window_schedules_over_raw_tables_match_chained_dispatches(mode):
    r, filt = _port(mode)
    base, s0 = _history(r, TCamera())
    target = torch.full((RES, RES, 3), 0.25)

    def run(how):
        p = {k: v.clone().requires_grad_(True) for k, v in _tables(base).items()}
        start = {k: getattr(s0, k).clone().requires_grad_(True) for k in STATE}
        state = dataclasses.replace(s0, **start)
        ctx = _ctx_of(base, p)
        if how == "chained":
            score = torch.ones_like(s0.px)
            for s in SEEDS:
                state, score, img = TM.render_diff(state, score,
                                                   dataclasses.replace(ctx, seed_bits=s),
                                                   STEPS, BINS)
        else:
            img = TM.render_sequence_diff(SEEDS, state, ctx, STEPS, BINS, window_storage=how)
        loss = torch.mean((img - target) ** 2)
        leaves = {**p, **start}
        return float(loss.detach()), dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))

    lc, gc = run("chained")
    for how in ("tape", "forward"):
        lw, gw = run(how)
        assert lw == lc, how
        for k in gc:
            if k in ("px", "py", "pz") and float(gc[k].abs().max()) == 0.0:
                assert float(gw[k].abs().max()) == 0.0, (how, k)
                continue
            if k == "extinction" and mode == "raw majorant":
                # a scalar whose terms cancel under the majorant: held
                # absolutely, as tests/test_torch_surrogate_modes.py does
                assert abs(float(gw[k]) - float(gc[k])) <= 4e-9, (how, float(gw[k]))
                continue
            err = _rel(gw[k], gc[k])
            assert err <= 1e-6, f"{how} {k}: relative L2 {err:.3g} from the chained dispatches"


# ---------------------------------------------------------------------------
# nearest: the density gradient on the voxels read, no position term
# ---------------------------------------------------------------------------
def test_nearest_gradient_lands_on_the_voxels_read():
    """The surrogate's nearest lookup sends its density adjoint to the one
    voxel it read, as jax.grad of a gather does; B9's raw PRB backward
    scatters the same lookups trilinearly (ROADMAP C), and keeps doing so."""
    r, _ = _port("nearest")
    cam = TCamera()
    ctx, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    assert ctx.volume_filter == "nearest" and ctx.density.ndim == 3
    seeds = SEEDS[:2]
    _, tape = S.tape_forward(s0, ctx, seeds, STEPS, BINS)
    col = {f: i for i, f in enumerate(S.fields(False))}
    flags = tape[:, :, col["flags"]].view(torch.int32)
    event = (flags & (S.F_NULL | S.F_SCATTER)) != 0
    D, H, W = ctx.density.shape
    pos = [tape[:, :, col[c]][event] for c in ("pz", "py", "px")]
    cells = [TI._nearest_coords(p, n).to(torch.int64) for p, n in zip(pos, (D, H, W))]
    read = torch.zeros(D * H * W, dtype=torch.bool)
    read[(cells[0] * H + cells[1]) * W + cells[2]] = True
    g = torch.ones(RES, RES, 3)
    d = ctx.density.clone().requires_grad_(True)
    img = TM.render_sequence_diff(seeds, s0, dataclasses.replace(ctx, density=d), STEPS, BINS,
                                  "nearest")
    (gd,) = torch.autograd.grad((img * g).sum(), [d])
    touched = gd.reshape(-1) != 0
    assert int(touched.sum()) > 0
    assert not bool((touched & ~read).any()), "a density adjoint outside the voxels read"
    _, _, grads = TB.prb_render_and_grads(s0, ctx, g, STEPS, BINS, "nearest")
    spread = grads["density"].reshape(-1) != 0
    assert bool((spread & ~read).any()), "B9 scatters a nearest lookup trilinearly"


# ---------------------------------------------------------------------------
# a raw axis's slope: scale n, a clamped edge's zero
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("filt", ["linear", "quasicubic"])
def test_raw_axis_slope_at_interior_and_clamped_edge_voxels(filt):
    """The position adjoint of one raw lookup as reverse_plain forms it
    (``_volume_corners``' corners and fractions, ``_volume_scales``) against
    jax.grad of ``vpt_tpu.ops.interp.sample_volume`` on the raw grid: the
    slope along an axis of n voxels is n times the fraction's, unclamped,
    and 0 between two clamped corners at an edge voxel."""
    d = np.asarray(Volume.sphere_in_cube(8).density, np.float32) * 0.9 + 0.05
    d = d + np.random.default_rng(3).uniform(0, 0.05, d.shape).astype(np.float32)
    # interior, and within half a voxel of each face (the clamped corners)
    u = np.array([0.37, 0.02, 0.985, 0.51, 0.03], np.float32)
    v = np.array([0.44, 0.55, 0.40, 0.01, 0.97], np.float32)
    w = np.array([0.61, 0.50, 0.33, 0.99, 0.02], np.float32)
    jg = jax.grad(lambda x, y, z: JI.sample_volume(jnp.asarray(d), x, y, z, filt).sum(),
                  argnums=(0, 1, 2))(jnp.asarray(u), jnp.asarray(v), jnp.asarray(w))
    pos = [torch.as_tensor(a) for a in (u, v, w)]
    grid = torch.as_tensor(d)
    _, _, raw, (fx, fy, fz), cc = S._volume_corners(grid, *pos, filt)
    l00, l01 = cc[0] + (cc[1] - cc[0]) * fx, cc[2] + (cc[3] - cc[2]) * fx
    l10, l11 = cc[4] + (cc[5] - cc[4]) * fx, cc[6] + (cc[7] - cc[6]) * fx
    l0, l1 = l00 + (l01 - l00) * fy, l10 + (l11 - l10) * fy
    g_f = (((1 - fz) * ((1 - fy) * (cc[1] - cc[0]) + fy * (cc[3] - cc[2]))
            + fz * ((1 - fy) * (cc[5] - cc[4]) + fy * (cc[7] - cc[6]))),
           (1 - fz) * (l01 - l00) + fz * (l11 - l10), l1 - l0)
    if filt == "quasicubic":
        g_f = tuple(g * (6.0 * f * (1.0 - f)) for g, f in zip(g_f, raw))
    scales = S._volume_scales(grid)
    assert scales == (8.0, 8.0, 8.0)
    for a in range(3):
        got = (g_f[a] * scales[a]).numpy()
        np.testing.assert_allclose(got, np.asarray(jg[a]), rtol=1e-5, atol=1e-6, err_msg=str(a))
    # the clamped edges: x at lane 1 (u < 0.5/8) and 2, y at 3 and 4, z at 3 and 4
    for a, lanes in ((0, (1, 2)), (1, (3, 4)), (2, (3, 4))):
        assert all(float(np.asarray(jg[a])[i]) == 0.0 for i in lanes), a
        assert float(np.asarray(jg[a])[0]) != 0.0


# ---------------------------------------------------------------------------
# against jax.grad of the JAX surrogate, per seed
# ---------------------------------------------------------------------------
def _jax_loss(vals, js0, jctx, seeds, target, filt):
    """render_sequence_diff over the JAX renderer's own ctx, its tables (as
    the layout keeps them) and the state's float fields learned."""
    st = js0._replace(**{k: vals[k] for k in STATE})
    ctx = jctx._replace(**{k: v for k, v in vals.items() if k not in STATE})
    img = JM.render_sequence_diff(seeds, st, ctx, STEPS, BINS, filt)
    return jnp.mean((img - target) ** 2)


# one compile per layout (the ctx's shapes and the filter)
_JAX_GRAD = {}


def _jax_grad(filt):
    if filt not in _JAX_GRAD:
        _JAX_GRAD[filt] = jax.jit(jax.value_and_grad(_jax_loss), static_argnums=(5,))
    return _JAX_GRAD[filt]


def _state_of(js0):
    return convert.state_from_numpy({k: np.asarray(getattr(js0, k)) for k in FIELDS}, "cpu")


@pytest.mark.parametrize("seed", [2, 77])
@pytest.mark.parametrize("mode", list(MODES))
def test_render_diff_over_raw_tables_matches_jax_grad_per_seed(mode, seed):
    """render_sequence_diff over two dispatches in both packages and the
    same layout: the gradients of the start state's float fields and of
    every table the ctx holds, in its own kind."""
    jr, filt = _jax(mode)
    tr, _ = _port(mode)
    cam = Camera()
    jctx, js0 = jr.ctx(cam, seed), jr.reset(cam, seed)
    base = tr.ctx(convert.camera_from(cam), seed)
    assert K.is_raw(base)
    seeds = (seed, seed + 1000)
    target = np.full((RES, RES, 3), 0.25, np.float32)
    tables = _tables(base)
    names = {"density": "density", "material_tf": "material_tf",
             "light_spectrum": "light_spectrum", "environment": "environment",
             "extinction": "extinction"}
    jvals = {k: jnp.asarray(getattr(jctx, names[k])) for k in tables if k != "extinction"}
    jvals["extinction"] = jnp.float32(6.0)
    jvals.update({k: jnp.asarray(getattr(js0, k)) for k in STATE})
    loss_j, g_j = _jax_grad(filt)(jvals, js0, jctx, jnp.asarray(seeds, jnp.uint32),
                                  jnp.asarray(target), filt)
    s0 = _state_of(js0)
    raw = dict(tables)
    raw.update({k: getattr(s0, k) for k in STATE})

    def port(p):
        st = dataclasses.replace(s0, **{k: p[k] for k in STATE})
        ctx = _ctx_of(base, {k: v for k, v in p.items() if k not in STATE})
        img = TM.render_sequence_diff(seeds, st, ctx, STEPS, BINS, filt)
        return torch.mean((img - torch.as_tensor(target)) ** 2)

    loss_t, g_t = _grads(port, raw)
    assert loss_t == pytest.approx(float(loss_j), rel=1e-5)
    # from a reset every lane's first deposit replaces its radiance (n = 1)
    assert np.abs(np.asarray(g_j["radiance"])).max() == 0.0
    for k in raw:
        a = np.asarray(g_j[k], np.float64)
        a, b = _comparable(a), _comparable(g_t[k].numpy().reshape(a.shape))
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b / scale, a / scale, atol=5e-4, err_msg=f"{mode} {k}")
        if _never_read(mode, k):
            assert np.abs(a).max() == 0.0 == np.abs(b).max(), f"{mode} {k}"
        elif k != "radiance":
            assert np.abs(a).sum() > 0, f"{mode} {k}"
