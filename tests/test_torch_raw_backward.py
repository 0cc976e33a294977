"""The port's raw-table replay backward (B9) against vpt_tpu's.

``prb_render_and_grads`` on a fully raw ctx (``pack_tables=False``, or any
``nearest`` volume) runs ``spectral_backward``: the taped dispatch (K13
``raw_tape``), the reverse scan of each lane's tape, the replay and its
analytic scatters into the raw tables (K14 ``raw_replay``). On the CPU the
port runs their plain versions. Both packages run the same dispatch from
one JAX state and ctx, carried across by ``vpt_tpu_torch.convert``.

Tolerances: state and image bit for bit against the port's own ``render``;
the four gradients within 1e-3 relative L2 of JAX's per seed, as the
packed backward is held (tests/test_torch_prb.py): XLA on the CPU computes
``(lambda - 400) / 300`` as a multiply by the reciprocal, the port divides
IEEE-exactly, and sums run in another order. Sizes: 16^2 pixels, a 16^3
volume, 8 steps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vpt_tpu import optim as JO
from vpt_tpu.kernels import spectral_backward as JB
from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch import optim as TO
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.kernels import spectral_backward as TB
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.scene.camera import Camera as TCamera

torch.set_num_threads(1)

RES = 16
STEPS = 8
FIELDS = JM.SpectralState._fields


def _table():
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.7
    table[..., 1] = 0.1 + 0.8 * dens
    table[..., 2] = 0.3 + 0.4 * dens
    return MaterialTF(table)


def _scene(filt="linear", light=(0.6, 0.3, 0.2)):
    density = np.asarray(Volume.sphere_in_cube(16).density, np.float32)
    return (Volume(density, filter=filt), _table(), LightConfig(direction=light),
            SpectrumConfig(), MCMSpectralConfig(extinction=6.0, bounces=4, steps=STEPS))


def _port_ctx(jctx, filt="linear"):
    dens = jctx.density
    flat = hasattr(dens, "table")
    env = None if jctx.environment is None else np.asarray(jctx.environment)
    return convert.ctx_from_numpy(
        inv_mvp=np.asarray(jctx.inv_mvp), seed_bits=np.asarray(jctx.seed_bits),
        extinction=np.asarray(jctx.extinction), blur=np.asarray(jctx.blur),
        max_bounces=np.asarray(jctx.max_bounces),
        light_direction=np.asarray(jctx.light_direction),
        density_table=np.asarray(dens.table if flat else dens),
        density_dims=dens.dims if flat else None,
        material_tf=np.asarray(jctx.material_tf), light_spectrum=np.asarray(jctx.light_spectrum),
        boundaries=np.asarray(jctx.boundaries), bin_xyz=np.asarray(jctx.bin_xyz),
        environment=env, volume_filter=filt, device="cpu")


def _port_state(jstate):
    return convert.state_from_numpy({k: np.asarray(getattr(jstate, k)) for k in FIELDS}, "cpu")


def _pair(seed, filt="linear", pack=False, streams=1, res=RES, **kw):
    """(jax ctx, jax state, port ctx, port state) of one raw-table scene."""
    r = JM.MCMSpectralRenderer(*_scene(filt), resolution=res, streams=streams,
                               pack_tables=pack, **kw)
    cam = Camera()
    jctx, js0 = r.ctx(cam, seed), r.reset(cam, seed)
    return jctx, js0, _port_ctx(jctx, filt), _port_state(js0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


@pytest.mark.parametrize("filt,seed,streams", [
    ("linear", 3, 1), ("linear", 11, 2), ("quasicubic", 5, 1), ("nearest", 7, 1)])
def test_raw_backward_matches_jax(filt, seed, streams):
    """State and image equal the port's ``render`` bit for bit; the four
    gradients are within 1e-3 relative L2 of JAX's ``spectral_backward``."""
    jctx, js0, tctx, ts0 = _pair(seed, filt, streams=streams)
    g = np.random.default_rng(seed).uniform(0.5, 1.5, (RES, RES, 3)).astype(np.float32)
    _, img_j, g_j = JB.prb_render_and_grads(js0, jctx, jnp.asarray(g), STEPS, 12, filt)
    TB.reset_launch_counts()
    s_t, img_t, g_t = TB.prb_render_and_grads(ts0, tctx, torch.as_tensor(g), STEPS, 12, filt)
    assert TB.LAUNCHES["raw_tape"] == TB.LAUNCHES["raw_replay"] == 0  # plain versions
    fwd = TB.clone_state(ts0)
    _, img_r = TM.render(fwd, tctx, STEPS, 12)
    for a, b in zip(s_t.tensors(), fwd.tensors()):
        assert torch.equal(a, b)
    assert torch.equal(img_t, img_r)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=1e-3, atol=1e-5)
    assert set(g_t) == set(g_j) == TB.ALL_WRT
    for k in g_j:
        assert g_t[k].shape == np.shape(g_j[k]), k
        err = _rel(g_j[k], g_t[k].numpy())
        assert err <= 1e-3, f"{filt} {k}: relative L2 error {err:.3g}"
        assert np.abs(np.asarray(g_j[k])).sum() > 0, k


def test_tape_and_carry_match_jax():
    """K13's tape (the deposit, respawn and pre-step bin of each lane-step)
    against the JAX tape pass's internals, and the reverse scan's (c, cb)
    against JAX's ``rev_body``: flags bit for bit on >= 99% of lane-steps,
    deposits within 1e-3 (|x| + 1)."""
    res = 8
    jctx, js0, tctx, ts0 = _pair(9, res=res)
    rng = JM.sampling.seed_state(*JM._pixel_grid(res)[::2], jctx.seed_bits)
    sx, sy = JM.geometry.screen_position(*JM._pixel_grid(res)[:2], 1.0 / res)
    body = jax.jit(lambda p, rng: JM._render_body(p, rng, None, sx, sy, jctx, 12, "linear",
                                                  diff=False, collect=True))
    p, em, rs, pb = js0, [], [], []
    for _ in range(STEPS):
        p, rng, _, it = body(p, rng)
        em.append(np.asarray(it["emitted"]).reshape(-1))
        rs.append(np.asarray(it["respawn"]).reshape(-1))
        pb.append(np.asarray(it["pre_bin"]).reshape(-1))
    out, tape = TB.raw_tape(ts0, tctx, STEPS, 12)
    flags = tape[:, 1].view(torch.int32).numpy()
    assert np.mean((flags & 1).astype(bool) == np.stack(rs)) >= 0.99
    assert np.mean((flags >> 8) == np.stack(pb)) >= 0.99
    assert np.mean(np.abs(tape[:, 0].numpy() - np.stack(em)) <= 1e-3 * (np.abs(em) + 1)) >= 0.99
    # the state is the forward step's, bit for bit
    fwd = TB.clone_state(ts0)
    K.step(fwd, tctx, [tctx.seed_bits], STEPS, 12)
    for a, b in zip(out.tensors(), fwd.tensors()):
        assert torch.equal(a, b)
    # the reverse scan: the next respawn's deposit and cotangent (here the
    # bin's index + 1), zero after the last respawn
    g_rs = torch.arange(1, 13, dtype=torch.float32)[:, None].expand(12, res * res).contiguous()
    carry = TB._raw_carry(tape, g_rs)
    dep = (flags & 1).astype(bool)
    c_next, cb_next = np.zeros(res * res, np.float32), np.zeros(res * res, np.float32)
    for it in range(STEPS - 1, -1, -1):
        c_next = np.where(dep[it], tape[it, 0].numpy(), c_next)
        cb_next = np.where(dep[it], (flags[it] >> 8) + 1.0, cb_next).astype(np.float32)
        assert np.array_equal(carry[it][0].numpy(), c_next)
        assert np.array_equal(carry[it][1].numpy(), cb_next)


def test_nearest_scatters_trilinear_as_the_reference():
    """The reference's ``_trilinear_corners`` has no nearest branch: a
    nearest lookup's density gradient goes to the 8 trilinear corners with
    the linear weights (ROADMAP C). The port mirrors it."""
    rng = np.random.default_rng(2)
    u, v, w = (rng.uniform(-0.1, 1.1, 500).astype(np.float32) for _ in range(3))
    idx_j, wts_j = JB._trilinear_corners(jnp.asarray(u), jnp.asarray(v), jnp.asarray(w), 5, 6, 7,
                                         "nearest")
    tu, tv, tw = (torch.as_tensor(a) for a in (u, v, w))
    idx_n, wts_n = TB._trilinear_corners(tu, tv, tw, 5, 6, 7, "nearest")
    idx_l, wts_l = TB._trilinear_corners(tu, tv, tw, 5, 6, 7, "linear")
    for a, b, c, d in zip(idx_j, wts_j, idx_n, wts_n):
        assert np.array_equal(np.asarray(a), c.numpy())
        np.testing.assert_array_equal(np.asarray(b), d.numpy())
    for a, b in zip(wts_n, wts_l):
        assert torch.equal(a, b)
    # not the one-hot weight a nearest lookup's own derivative would have
    assert sum(float((wt > 0).sum()) for wt in wts_n) > 2 * len(u)


def test_raw_backward_ignores_wrt_and_thinning():
    """The raw path returns all four gradients whatever ``wrt`` and the
    thinning arguments say, as the reference's does (ROADMAP C)."""
    jctx, js0, tctx, ts0 = _pair(4)
    g = torch.ones(RES, RES, 3)
    _, _, full = TB.prb_render_and_grads(ts0, tctx, g, STEPS, 12)
    _, _, some = TB.prb_render_and_grads(ts0, tctx, g, STEPS, 12, wrt=frozenset({"density"}),
                                         scatter_stride=2, scatter_mode="importance")
    _, _, g_j = JB.prb_render_and_grads(js0, jctx, jnp.ones((RES, RES, 3)), STEPS, 12,
                                        wrt=frozenset({"density"}), scatter_stride=2)
    assert set(some) == set(full) == set(g_j) == TB.ALL_WRT
    for k in full:
        assert torch.equal(some[k], full[k]), k


def test_refusals_as_the_reference():
    """A half-packed ctx raises ``ValueError`` naming the packed ctx; a raw
    ctx with an environment map fails the reference's assertion; a raw ctx
    with a pair light fails its unpacking (``ValueError``); the packed
    backward's entry points fail its assertions on a raw ctx."""
    g = np.ones((RES, RES, 3), np.float32)
    for pack in ({"material_tf", "light_spectrum"}, {"density"}, {"material_tf"}):
        jctx, js0, tctx, ts0 = _pair(1, pack=pack)
        with pytest.raises(ValueError, match="packed"):
            JB.prb_render_and_grads(js0, jctx, jnp.asarray(g), STEPS, 12)
        with pytest.raises(ValueError, match="packed"):
            TB.prb_render_and_grads(ts0, tctx, torch.as_tensor(g), STEPS, 12)
    env = np.random.default_rng(0).uniform(0.1, 1.0, (4, 8, 3)).astype(np.float32)
    jctx, js0, tctx, ts0 = _pair(1, environment=env)
    assert tctx.environment.shape == (4, 8, 3)
    with pytest.raises(AssertionError, match="environment"):
        JB.prb_render_and_grads(js0, jctx, jnp.asarray(g), STEPS, 12)
    with pytest.raises(AssertionError, match="environment"):
        TB.prb_render_and_grads(ts0, tctx, torch.as_tensor(g), STEPS, 12)
    jctx, js0, tctx, ts0 = _pair(1, pack={"light_spectrum"})
    assert tctx.light_spectrum.shape == (257, 2)
    with pytest.raises(ValueError):
        JB.prb_render_and_grads(js0, jctx, jnp.asarray(g), STEPS, 12)
    with pytest.raises(ValueError):
        TB.prb_render_and_grads(ts0, tctx, torch.as_tensor(g), STEPS, 12)
    jctx, js0, tctx, ts0 = _pair(1)
    with pytest.raises(AssertionError, match="fused TF"):
        TB.prb_render_and_grads_many(ts0, tctx, [1, 2], torch.as_tensor(g), STEPS, 12)


@pytest.mark.parametrize("pack", [False, {"material_tf", "light_spectrum"}, {"density"}])
def test_fit_spectral_routing_on_raw_renderers(pack):
    """The reference routes a raw or partly packed renderer to the
    surrogate by default, which the port raises for as the next slice's;
    ``method="prb"`` fails the same assertion in both packages."""
    scene = _scene()
    jr = JM.MCMSpectralRenderer(*scene, resolution=8, pack_tables=pack)
    tr = TM.MCMSpectralRenderer(*convert.scene_from(*scene), resolution=8, pack_tables=pack,
                                device="cpu")
    target = np.zeros((8, 8, 3), np.float32)
    params = {"density": np.asarray(scene[0].density)}
    ctx = jr.ctx(Camera(), 0)
    packed = ctx.material_tf.shape[-1] == 18 and hasattr(ctx.density, "table")
    assert not packed  # the reference's own test for its default method
    with pytest.raises(NotImplementedError, match="next slice"):
        TO.fit_spectral(target, tr, TCamera(), params, dispatches_per_step=1, iterations=1)
    with pytest.raises(AssertionError) as ej:
        JO.fit_spectral(target, jr, Camera(), params, dispatches_per_step=1, iterations=1,
                        method="prb", scatter_stride=1)
    with pytest.raises(AssertionError) as et:
        TO.fit_spectral(target, tr, TCamera(), params, dispatches_per_step=1, iterations=1,
                        method="prb", scatter_stride=1)
    assert str(et.value) == str(ej.value)
