"""The port's packed-adjoint PRB backward against vpt_tpu's.

Both packages run the same dispatches from one JAX state and ctx, carried
across by ``vpt_tpu_torch.convert``; on the CPU the port runs the plain
versions of its kernels (K4 ``tape_forward``, K5 ``prb_reverse``).
Tolerances: tapes agree on >= 99% of lane-steps per field, int and bool
fields bit for bit, float fields within 1e-3 (|x| + 1). XLA on the CPU
computes ``(lambda - 400) / 300`` as a multiply by the reciprocal and its
``log`` differs from torch's by an ulp on ~14% of inputs, while the port
divides IEEE-exactly like its kernels; the TF lookup scales those ulps by
its 256 texels per unit (fractions differ by up to ~3e-4), and an ulp
flip can fork a lane, as tests/test_mcm_spectral_parity.py allows. Packed
adjoints and raw gradients within 1e-3 relative L2 (sum order differs);
importance picks equal on >= 99% of lanes. Sizes: 16^2 pixels, a 16^3
volume, 8 steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vpt_tpu.kernels import spectral_backward as JB
from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.ops import interp as JI
from vpt_tpu.ops import sampling as JS
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch.kernels import spectral_backward as TB
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.ops import interp as TI
from vpt_tpu_torch.scene.camera import Camera as TCamera

torch.set_num_threads(1)

RES = 16
STEPS = 8
FIELDS = JM.SpectralState._fields


def _table(g_density_dependent=True):
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.7
    table[..., 1] = 0.1 + 0.8 * dens
    table[..., 2] = 0.3 + 0.4 * dens if g_density_dependent else 0.5
    return MaterialTF(table)


def _jax_renderer(volume=None, streams=1, table=None, pack_tables=True):
    return JM.MCMSpectralRenderer(
        volume if volume is not None else Volume.sphere_in_cube(16),
        table or _table(), LightConfig(direction=(0.6, 0.3, 0.2)), SpectrumConfig(),
        MCMSpectralConfig(extinction=6.0, bounces=4, steps=STEPS), resolution=RES,
        streams=streams, pack_tables=pack_tables)


def _port_ctx(jctx, seed_bits=None):
    dens = jctx.density
    flat = isinstance(dens, JI.PackedVolume)
    return convert.ctx_from_numpy(
        inv_mvp=np.asarray(jctx.inv_mvp),
        seed_bits=np.asarray(jctx.seed_bits if seed_bits is None else seed_bits),
        extinction=np.asarray(jctx.extinction), blur=np.asarray(jctx.blur),
        max_bounces=np.asarray(jctx.max_bounces),
        light_direction=np.asarray(jctx.light_direction),
        density_table=np.asarray(dens.table if flat else dens),
        density_dims=dens.dims if flat else None,
        material_tf=np.asarray(jctx.material_tf), light_spectrum=np.asarray(jctx.light_spectrum),
        boundaries=np.asarray(jctx.boundaries), bin_xyz=np.asarray(jctx.bin_xyz), device="cpu")


def _port_state(jstate):
    return convert.state_from_numpy({k: np.asarray(getattr(jstate, k)) for k in FIELDS}, "cpu")


def _pair(seed, **kw):
    """(jax ctx, jax state, port ctx, port state) of one scene."""
    r = _jax_renderer(**kw)
    cam = Camera()
    jctx, js0 = r.ctx(cam, seed), r.reset(cam, seed)
    return jctx, js0, _port_ctx(jctx), _port_state(js0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _jax_tape(tape, fields):
    """A JAX forward_only tape dict -> the port's (steps, F, lanes) layout."""
    cols = []
    for f in fields:
        v = np.asarray(tape["slopes"][..., int(f[-1])] if f.startswith("slope") else tape[f])
        if f == "hg_cos":  # the port stores 0 where the step did not scatter
            v = np.where(np.asarray(tape["scatter"]), v, np.float32(0.0))
        if v.dtype == bool:
            v = v.astype(np.float32)
        elif v.dtype == np.int32:
            v = v.view(np.float32)
        cols.append(v.reshape(v.shape[0], -1))
    return np.stack(cols, axis=1)


# ---------------------------------------------------------------------------
# the torch packers: bit-equal values, VJP equal to jax.vjp (the contraction)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,shapes", [
    ("volume", [(5, 6, 7)]),
    ("tex2d", [(6, 5, 4)]),
    ("tex1d", [(9,)]),
    ("tex2d_with_tex1d", [(6, 5, 4), (5,)]),
])
def test_torch_packers_bit_equal_and_vjp_matches_jax(name, shapes):
    jfn = {"volume": JI.pack_volume_corners_jnp, "tex2d": JI.pack_tex2d_corners_jnp,
           "tex1d": JI.pack_tex1d_corners_jnp,
           "tex2d_with_tex1d": JI.pack_tex2d_with_tex1d_jnp}[name]
    tfn = {"volume": TI.pack_volume_corners_t, "tex2d": TI.pack_tex2d_corners_t,
           "tex1d": TI.pack_tex1d_corners_t, "tex2d_with_tex1d": TI.pack_tex2d_with_tex1d_t}[name]
    nfn = {"volume": TI.pack_volume_corners, "tex2d": TI.pack_tex2d_corners,
           "tex1d": TI.pack_tex1d_corners, "tex2d_with_tex1d": TI.pack_tex2d_with_tex1d}[name]
    rng = np.random.default_rng(3)
    xs = [rng.random(s, dtype=np.float32) for s in shapes]
    want, vjp = jax.vjp(jfn, *[jnp.asarray(x) for x in xs])
    ts = [torch.tensor(x, requires_grad=True) for x in xs]
    got = tfn(*ts)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.detach().numpy(), nfn(*xs))
    cot = rng.standard_normal(got.shape).astype(np.float32)
    g_j = vjp(jnp.asarray(cot))
    g_t = torch.autograd.grad(got, ts, torch.as_tensor(cot))
    for a, b in zip(g_j, g_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the tape (K4's plain version) against the JAX forward_only tape
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("streams,f32_volume", [(1, False), (2, True)])
def test_tape_matches_jax(streams, f32_volume):
    vol = (Volume(density=np.random.default_rng(1).random((12, 12, 12)).astype(np.float32))
           if f32_volume else None)
    jctx, js0, tctx, ts0 = _pair(5, volume=vol, streams=streams)
    assert (tctx.density.table.dtype == torch.float32) == f32_volume
    js, jtape = JB.spectral_backward_packed(js0, jctx, None, STEPS, 12, forward_only=True)
    ts, ttape = TB.spectral_backward_packed(ts0, tctx, None, STEPS, 12, forward_only=True)
    fields = TB.tape_fields(TB.ALL_WRT)
    want = _jax_tape(jtape, fields)
    got = ttape.numpy()
    assert got.shape == want.shape == (STEPS, len(fields), RES * RES * streams)
    worst = 1.0
    for i, f in enumerate(fields):
        a, b = got[:, i], want[:, i]
        if f in TB.INT_FIELDS or f in TB.BOOL_FIELDS:
            ok = a.view(np.int32) == b.view(np.int32)
        else:
            ok = np.abs(a - b) <= 1e-3 * (np.abs(b) + 1.0)
        eq = float(np.mean(ok))
        worst = min(worst, eq)
        assert eq >= 0.99, f"tape field {f}: only {eq:.4f} of lane-steps agree"
    assert np.mean(ts.samples.numpy() == np.asarray(js.samples)) >= 0.99
    # the input state is untouched (the forward runs on a copy)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ts0, k).numpy(), np.asarray(getattr(js0, k)))
    print(f"tape parity: worst field {worst:.5f} of lane-steps agree")


# ---------------------------------------------------------------------------
# prb_render_and_grads against JAX: stride 1 / 4, importance 4, wrt subsets
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("stride,mode", [(1, "stride"), (4, "stride"), (4, "importance")])
def test_prb_render_and_grads_matches_jax(stride, mode, streams):
    jctx, js0, tctx, ts0 = _pair(5, streams=streams)
    g = np.random.default_rng(2).random((RES, RES, 3)).astype(np.float32)
    _, img_j, g_j = JB.prb_render_and_grads(js0, jctx, jnp.asarray(g), STEPS, 12,
                                            scatter_stride=stride, scatter_mode=mode)
    _, img_t, g_t = TB.prb_render_and_grads(ts0, tctx, torch.as_tensor(g), STEPS, 12,
                                            scatter_stride=stride, scatter_mode=mode)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-3, atol=1e-5)
    assert set(g_t) == set(g_j) == TB.ALL_WRT
    for k in g_j:
        err = _rel(g_j[k], g_t[k].numpy())
        assert err <= 1e-3, f"{mode}{stride} {k}: relative L2 error {err:.3g}"
        assert np.abs(np.asarray(g_j[k])).sum() > 0, k


@pytest.mark.parametrize("wrt", [{"density"}, {"material_tf", "light_spectrum"}, {"extinction"}])
def test_wrt_subsets_match_jax(wrt):
    jctx, js0, tctx, ts0 = _pair(7)
    g = np.ones((RES, RES, 3), np.float32)
    wrt = frozenset(wrt)
    _, _, g_j = JB.prb_render_and_grads(js0, jctx, jnp.asarray(g), STEPS, 12, wrt=wrt)
    _, _, g_t = TB.prb_render_and_grads(ts0, tctx, torch.as_tensor(g), STEPS, 12, wrt=wrt)
    assert set(g_t) == set(wrt)
    for k in wrt:
        err = _rel(g_j[k], g_t[k].numpy())
        assert err <= 1e-3, f"{sorted(wrt)} {k}: relative L2 error {err:.3g}"


def test_packed_adjoints_and_carry_match_jax():
    """raw_adjoints / m_final / adj_in / cot_in / return_cot plumbing,
    compared on the packed adjoints themselves (f32 table)."""
    vol = Volume(density=np.random.default_rng(4).random((10, 10, 10)).astype(np.float32))
    jctx, js0, tctx, ts0 = _pair(9, volume=vol, streams=2)
    lane = js0.px.shape
    rng = np.random.default_rng(5)
    g = rng.random((RES, RES, 3)).astype(np.float32)
    m = rng.integers(1, 5, lane).astype(np.float32)
    c_in, cb_in = (rng.random(lane).astype(np.float32) for _ in range(2))
    adj0 = JB._packed_adj_init(jctx, JB.ALL_WRT)
    adj0 = {k: jnp.full_like(v, 0.25) for k, v in adj0.items()}
    kw = dict(raw_adjoints=True, return_cot=True)
    _, _, a_j, cot_j = JB.spectral_backward_packed(
        js0, jctx, jnp.asarray(g), STEPS, 12, m_final=jnp.asarray(m), adj_in=adj0,
        cot_in=dict(c=jnp.asarray(c_in), cb=jnp.asarray(cb_in)), **kw)
    _, _, a_t, cot_t = TB.spectral_backward_packed(
        ts0, tctx, torch.as_tensor(g), STEPS, 12, m_final=torch.as_tensor(m),
        adj_in=convert.adjoints_from_numpy(adj0, "cpu"),
        cot_in=dict(c=torch.as_tensor(c_in), cb=torch.as_tensor(cb_in)), **kw)
    got = convert.grads_to_numpy(a_t)
    for k in ("g_ext", "g_tf", "g_vol"):
        err = _rel(np.asarray(a_j[k]).reshape(-1), got[k].reshape(-1))
        assert err <= 1e-3, f"{k}: relative L2 error {err:.3g}"
    for k in ("c", "cb"):
        a, b = cot_t[k].numpy(), np.asarray(cot_j[k])
        eq = np.mean(np.abs(a - b) <= 1e-3 * (np.abs(b) + 1.0))
        assert eq >= 0.99, f"carry {k}: {eq:.4f} agree"


def test_importance_picks_match_jax():
    """The picks themselves: the JAX selection code (_importance_metric,
    jnp.sum, jnp.cumsum, the pcg pick chain) and the port's on one tape
    and carry, equal on >= 99% of lanes per pick."""
    jctx, js0, tctx, ts0 = _pair(3, streams=2)
    wrt = frozenset({"density", "material_tf", "light_spectrum"})
    fields = TB.tape_fields(wrt)
    _, tape = TB.spectral_backward_packed(ts0, tctx, None, STEPS, 12, wrt=wrt,
                                          forward_only=True)
    rng = np.random.default_rng(6)
    c_all = rng.random((STEPS, tape.shape[-1])).astype(np.float32)
    cb_all = (rng.random((STEPS, tape.shape[-1])) * (rng.random((STEPS, tape.shape[-1])) < 0.7)
              ).astype(np.float32)
    col = {f: i for i, f in enumerate(fields)}
    picks, stride = STEPS // 4, 4
    sel_t, _ = TB._importance_picks(tape, col, list(torch.as_tensor(c_all)),
                                    list(torch.as_tensor(cb_all)), int(tctx.seed_bits), stride,
                                    RES, 2, None, True, True)

    t = tape.numpy()
    jt = {f: t[:, i] for i, f in enumerate(fields)}
    for f in ("null", "scatter"):
        jt[f] = jt[f] > 0.5
    jt["slopes"] = np.stack([jt.pop(f"slope{c}") for c in range(3)], axis=-1)
    jt = {k: jnp.asarray(v) for k, v in jt.items()}
    absq = JB._importance_metric(jt, jnp.asarray(c_all), jnp.asarray(cb_all), True, True, False)
    S = jnp.sum(absq, axis=0)
    cdf = jnp.cumsum(absq / jnp.maximum(S, 1e-30)[None], axis=0)
    ix, _, seed_iy = JM._pixel_grid(RES, 2)
    state0 = JS.seed_state(ix.reshape(-1), seed_iy.reshape(-1),
                           jctx.seed_bits ^ jnp.uint32(0x7F4A7C15))
    worst = 1.0
    for j in range(picks):
        u = JS.uniform_from_state(JS.pcg_hash(state0 ^ (jnp.uint32(0x9E3779B9) * jnp.uint32(j + 1))))
        sel = np.clip(np.asarray(jnp.sum((cdf < u[None]).astype(jnp.int32), axis=0)), 0, STEPS - 1)
        eq = float(np.mean(sel == sel_t[j].numpy()))
        worst = min(worst, eq)
        assert eq >= 0.99, f"pick {j}: only {eq:.4f} of lanes pick the same step"
    print(f"importance picks: worst pick {worst:.5f} of lanes equal")


# ---------------------------------------------------------------------------
# tests/test_prb_packed.py, ported against the port
# ---------------------------------------------------------------------------
def _port_renderer(volume=None, streams=1):
    return TM.MCMSpectralRenderer(
        *convert.scene_from(volume if volume is not None else Volume.sphere_in_cube(16),
                            _table(), LightConfig(direction=(0.6, 0.3, 0.2)), SpectrumConfig(),
                            MCMSpectralConfig(extinction=6.0, bounces=4, steps=STEPS)),
        resolution=RES, streams=streams, device="cpu")


def test_scatter_stride_partition_identity():
    """stride-k thinning at a FIXED seed: the k phase gradients partition
    the steps, so their average equals the exact gradient identically."""
    r = _port_renderer()
    cam = TCamera()
    g_img = torch.ones(RES, RES, 3)
    ctx = r.ctx(cam, 7)
    s0 = r.reset(cam, 7)
    wrt = frozenset({"density"})
    _, tape = TB.spectral_backward_packed(s0, ctx, None, STEPS, 12, wrt=wrt, forward_only=True)
    _, _, g_e = TB.prb_render_and_grads(s0, ctx, g_img, STEPS, 12, wrt=wrt)
    exact = g_e["density"].numpy()
    k = 4
    acc = np.zeros_like(exact)
    state_out = TB.tape_forward(s0, ctx, [ctx.seed_bits], STEPS, 12, wrt)[0]
    for phase in range(k):
        _, _, g_s = TB.spectral_backward_packed(
            s0, ctx, g_img, STEPS, 12, wrt=wrt, scatter_stride=k, scatter_phase=phase,
            tape_in=tape, state_out_in=state_out)
        acc += g_s["density"].numpy() / k
    scale = max(np.abs(exact).max(), 1e-6)
    np.testing.assert_allclose(acc / scale, exact / scale, atol=1e-5)
    assert np.abs(exact).sum() > 0


def test_many_matches_sequential_dispatches():
    """prb_render_and_grads_many(window=False) == K sequential
    prb_render_and_grads calls with summed grads."""
    r = _port_renderer(streams=2)
    g_img = torch.ones(RES, RES, 3)
    cam = TCamera()
    seeds = [11, 5021, 90001]
    wrt = frozenset({"density", "extinction"})
    state = r.reset(cam, 3)
    want = None
    for s in seeds:
        state, _, g = TB.prb_render_and_grads(state, r.ctx(cam, s), g_img, STEPS, 12, wrt=wrt)
        want = g if want is None else {k: want[k] + g[k] for k in want}
    img_seq = TM.radiance_to_rgb(state.radiance, r.ctx(cam, 0).bin_xyz)
    s0 = r.reset(cam, 3)
    _, img_m, got = TB.prb_render_and_grads_many(s0, r.ctx(cam, 0), seeds, g_img, STEPS, 12,
                                                 wrt=wrt, window=False)
    assert torch.equal(img_m, img_seq)
    for k in wrt:
        a, b = want[k].numpy(), got[k].numpy()
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-5, err_msg=k)


def test_window_matches_autodiff_multi_dispatch():
    """The window-correctness pin: the port's prb_loss_and_grads over a
    K = 4 dispatch window equals jax.grad of the JAX autodiff surrogate loss
    (optim.spectral_render_loss) PER SEED, and so does the port's own
    surrogate (vpt_tpu_torch.optim.spectral_render_loss): port PRB ~ port
    autodiff ~ JAX autodiff. With g = 0 (isotropic scattering) no position
    or direction depends on a table, so the surrogate's pathwise chains
    reach none and the two estimators agree seed by seed. Truncating the
    (c, cb) carry at dispatch boundaries fails this."""
    from vpt_tpu import optim as JO
    from vpt_tpu_torch import optim as TO

    table = _table(g_density_dependent=False)
    vol = Volume.sphere_in_cube(16)
    raw = _jax_renderer(vol, streams=2, table=table, pack_tables=False)
    packed = _jax_renderer(vol, streams=2, table=table, pack_tables=True)
    cam = Camera()
    seeds = [8, 5100, 77, 90017]
    target = np.full((RES, RES, 3), 0.25, np.float32)
    params = {"density": jnp.asarray(np.asarray(vol.density))}
    loss_a, g_a = jax.value_and_grad(JO.spectral_render_loss)(
        params, raw.reset(cam, 7), raw.ctx(cam, 7), jnp.asarray(seeds, jnp.uint32),
        jnp.asarray(target), STEPS, 12, False)
    ctx = _port_ctx(packed.ctx(cam, 7))
    s0 = _port_state(packed.reset(cam, 7))
    _, _, loss_p, g_p = TB.prb_loss_and_grads(s0, ctx, seeds, torch.as_tensor(target), STEPS,
                                              12, wrt=frozenset({"density"}))
    assert float(loss_p) == pytest.approx(float(loss_a), rel=1e-5)
    a, b = np.asarray(g_a["density"]), g_p["density"].numpy()
    scale = max(np.abs(a).max(), 1e-6)
    np.testing.assert_allclose(b / scale, a / scale, atol=5e-4)
    assert np.abs(a).sum() > 0
    # the port's surrogate, the third party
    dens = torch.tensor(np.asarray(vol.density, np.float32), requires_grad=True)
    loss_s = TO.spectral_render_loss({"density": dens}, s0, ctx, seeds, torch.as_tensor(target),
                                     STEPS, 12)
    c = torch.autograd.grad(loss_s, [dens])[0].numpy()
    assert float(loss_s.detach()) == pytest.approx(float(loss_a), rel=1e-5)
    np.testing.assert_allclose(c / scale, a / scale, atol=5e-4)
    np.testing.assert_allclose(c / scale, b / scale, atol=5e-4)


def test_window_storage_modes_agree():
    """window_storage="tape" and "forward" are one estimator computed two
    ways: image bit-identical, grads equal to float rounding; neither
    touches the input state."""
    r = _port_renderer(streams=2)
    cam = TCamera()
    seeds = [11, 5021, 90001, 7]
    g_img = torch.ones(RES, RES, 3)
    wrt = frozenset({"density", "extinction"})
    s0 = r.reset(cam, 3)
    before = TB.clone_state(s0)
    out = {}
    for storage in ("tape", "forward"):
        _, img, g = TB.prb_render_and_grads_many(s0, r.ctx(cam, 0), seeds, g_img, STEPS, 12,
                                                 wrt=wrt, window_storage=storage)
        out[storage] = (img, g)
    assert torch.equal(out["tape"][0], out["forward"][0])
    for k in wrt:
        a, b = out["tape"][1][k].numpy(), out["forward"][1][k].numpy()
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-6, err_msg=k)
    for a, b in zip(s0.tensors(), before.tensors()):
        assert torch.equal(a, b)
    _, _, loss, _ = TB.prb_loss_and_grads(s0, r.ctx(cam, 0), seeds, torch.zeros(RES, RES, 3),
                                          STEPS, 12)
    assert np.isfinite(float(loss))
    for a, b in zip(s0.tensors(), before.tensors()):
        assert torch.equal(a, b)


def test_importance_thinning_unbiased_and_deterministic():
    """Per pick seed the importance estimator is random, but its mean over
    pick seeds equals the exact (stride 1) gradient; identical pick_bits
    give identical results. The light-spectrum term, which a |q| metric
    would bias, is pinned too. The reverse runs on one stored tape."""
    r = _port_renderer(volume=Volume.sphere_in_cube(8))
    cam = TCamera()
    seed = 3
    ctx = r.ctx(cam, seed)
    g_img = torch.ones(RES, RES, 3)
    s0 = r.reset(cam, seed)

    def run(wrt, key, n, first):
        state_out, tape = TB.spectral_backward_packed(s0, ctx, None, STEPS, 12, wrt=wrt,
                                                      forward_only=True)
        _, _, exact = TB.spectral_backward_packed(s0, ctx, g_img, STEPS, 12, wrt=wrt,
                                                  tape_in=tape, state_out_in=state_out)

        def imp(pick_seed):
            _, _, g = TB.spectral_backward_packed(
                s0, ctx, g_img, STEPS, 12, wrt=wrt, scatter_stride=4,
                scatter_mode="importance", pick_bits=pick_seed, tape_in=tape,
                state_out_in=state_out)
            return g[key].numpy()

        np.testing.assert_array_equal(imp(12345), imp(12345))
        sums, acc = [], 0.0
        for k in range(n):
            g = imp((k + first) * 2654435761 % 2**32)
            acc = acc + g
            sums.append(g.sum())
        return exact[key].numpy(), acc / n, np.std(sums) / np.sqrt(n)

    exact_d, mean, se = run(frozenset({"density"}), "density", 200, 1)
    assert abs(mean.sum() - exact_d.sum()) < 4 * se + 1e-6, (mean.sum(), exact_d.sum(), se)
    cos = float((mean * exact_d).sum() / max(np.linalg.norm(mean) * np.linalg.norm(exact_d), 1e-30))
    assert cos > 0.95
    exact_ls, mean_ls, se2 = run(frozenset({"material_tf", "light_spectrum"}), "light_spectrum",
                                 150, 11)
    assert abs(mean_ls.sum() - exact_ls.sum()) < 4 * se2 + 1e-7, (mean_ls.sum(), exact_ls.sum())


def test_options_outside_the_slice_raise():
    """The modes ported since run (the quasicubic filter, the environment
    key on a ctx without a map: no env gradient, as JAX gives none); what
    the reference refuses raises before any launch: a raw volume beside
    the fused TF (``ValueError``: neither the packed nor the fully raw
    ctx), the nearest filter on the packed ctx (its assertion)."""
    jctx, js0, tctx, ts0 = _pair(1)
    g = torch.ones(RES, RES, 3)
    _, img, grads = TB.prb_render_and_grads(ts0, tctx, g, STEPS, 12, volume_filter="quasicubic")
    assert set(grads) == TB.ALL_WRT and bool(torch.isfinite(img).all())
    _, _, grads = TB.prb_render_and_grads(ts0, tctx, g, STEPS, 12,
                                          wrt=frozenset({"environment", "density"}))
    assert set(grads) == {"density"} and float(grads["density"].abs().sum()) > 0
    raw_ctx = type(tctx)(**{**tctx.__dict__, "density": torch.zeros(4, 4, 4)})
    with pytest.raises(ValueError, match="packed"):
        TB.prb_render_and_grads(ts0, raw_ctx, g, STEPS, 12)
    with pytest.raises(AssertionError, match="linear/quasicubic"):
        TB.prb_render_and_grads(ts0, tctx, g, STEPS, 12, volume_filter="nearest")
    with pytest.raises(ValueError):
        TB.prb_render_and_grads(ts0, tctx, g, STEPS, 12, wrt=frozenset({"albedo"}))
    with pytest.raises(ValueError):
        TB.prb_render_and_grads(ts0, tctx, g, STEPS, 12, scatter_stride=3)
    TB.reset_launch_counts()
    TB.prb_render_and_grads(ts0, tctx, g, STEPS, 12, wrt=frozenset({"density"}))
    assert set(TB.LAUNCHES.values()) == {0}
