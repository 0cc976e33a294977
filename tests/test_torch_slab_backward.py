"""The slab-sharded PRB backward and optimizer (``vpt_tpu_torch/parallel/slab.py``:
K28's TAPE mode, K5's ROUTED mode, K29 ``slab_scatter``, K30 ``slab_contract``,
K31 ``slab_pack``, each wrapper's plain version on CPU tensors) across gloo
processes, against the port's replicated backward and the JAX package's slab
(``vpt_tpu/parallel/slab.py``, ``tests/test_slab.py``).

The ranks run in spawned processes (``vpt_tpu_torch/tools/mesh_dryrun.py``)
that import neither jax nor ``vpt_tpu``, at world sizes 1, 2 and 4, and at 8
for the pad and fold cases (VOL 16: Dp = 17 pads to 24, ranks 6-7 own pure
pad, rank 5 folds the overflow). Their scene is the JAX renderer's ctx and
reset, handed over as numpy arrays, so the JAX side runs from the same
inputs on the 8-device virtual CPU mesh of ``tests/conftest.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.ops import interp as JI
from vpt_tpu.parallel import slab as JS
from vpt_tpu.parallel.mesh import ray_mesh as jax_ray_mesh
from vpt_tpu.parallel.mesh import replicated, shard_spectral_state
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import optim as TO
from vpt_tpu_torch.kernels import corners
from vpt_tpu_torch.kernels import slab as KS
from vpt_tpu_torch.kernels import spectral_backward as SB
from vpt_tpu_torch.parallel import mesh as TM
from vpt_tpu_torch.parallel import slab as TS
from vpt_tpu_torch.scene.camera import Camera as TCamera
from vpt_tpu_torch.tools import mesh_dryrun as D

torch.set_num_threads(1)

WORLDS = (1, 2, 4)
VOL, RES, BINS = D.VOL, D.RES, D.BINS
DIMS = (VOL, VOL, VOL)
STEPS = 6
# prb_grads_slab's (stride, streams) at every world; JAX's cases (world,
# stride, streams) of tests/test_slab.py among them
PRB_CASES = ((1, 1), (2, 1), (1, 2))
JAX_PRB_CASES = ((2, 1, 1), (4, 1, 1), (4, 2, 1), (4, 1, 2))
# the window's (stride, mode, steps)
WINDOW_CASES = ((1, "stride", 6), (2, "stride", 6), (4, "importance", 8))
SEEDS = [11, 12, 13, 14]


def _jax_renderer(streams=1, pack_tables=True):
    return JM.MCMSpectralRenderer(
        Volume.sphere_in_cube(VOL), MaterialTF(D.ramp_table()),
        LightConfig(direction=(1.0, 0.2, 0.3)), SpectrumConfig(),
        MCMSpectralConfig(extinction=20.0, steps=STEPS), resolution=RES,
        pack_tables=pack_tables, streams=streams)


def _packed4(jctx):
    """The JAX ctx's packed table as its (D+1, H+1, W+1, 8) array."""
    dens = jctx.density
    if isinstance(dens, JI.PackedVolume):
        return np.asarray(dens.table).reshape(tuple(dens.dims) + (8,))
    return np.asarray(dens)


def _scene(streams):
    """The JAX renderer's ctx and reset (seed 5) as the numpy arrays a
    dryrun job takes, and the JAX objects."""
    r = _jax_renderer(streams)
    cam = Camera()
    jctx, js0 = r.ctx(cam, 5), r.reset(cam, 5)
    packed = _packed4(jctx)
    ctx = dict(inv_mvp=np.asarray(jctx.inv_mvp), seed_bits=np.asarray(jctx.seed_bits),
               extinction=np.asarray(jctx.extinction), blur=np.asarray(jctx.blur),
               max_bounces=np.asarray(jctx.max_bounces),
               light_direction=np.asarray(jctx.light_direction),
               density_table=packed.reshape(-1, 8), density_dims=packed.shape[:3],
               material_tf=np.asarray(jctx.material_tf),
               light_spectrum=np.asarray(jctx.light_spectrum),
               boundaries=np.asarray(jctx.boundaries), bin_xyz=np.asarray(jctx.bin_xyz))
    state = {k: np.asarray(getattr(js0, k)) for k in JM.SpectralState._fields}
    return dict(ctx=ctx, state=state), (r, jctx, js0)


def _g_image():
    return np.random.default_rng(3).standard_normal((RES, RES, 3)).astype(np.float32)


def _fit_target():
    """The slab fit's target: the port's fully packed renderer over 16
    dispatches from seed 99 (tests/test_slab.py's)."""
    r = D.fit_renderer()
    cam = TCamera()
    st = r.reset(cam, 99)
    st, target = r.render_many(st, cam, [(99 + k + 1) * 2654435761 % 2**32 for k in range(16)])
    return target.numpy()


@pytest.fixture(scope="module")
def scenes():
    return {s: _scene(s) for s in (1, 2)}


@pytest.fixture(scope="module")
def target():
    return _fit_target()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, scenes, target):
    g = _g_image()
    pads = [("scatter", "bwd_scatter", {}), ("pack", "bwd_pack", {}),
            ("contract0", "bwd_contract", dict(pad_random=False)),
            ("contract_r", "bwd_contract", dict(pad_random=True))]
    jobs = pads + [(f"tape{s}", "bwd_tape", dict(scene=scenes[s][0])) for s in (1, 2)]
    jobs += [(f"prb{st}_{s}", "bwd_prb", dict(scene=scenes[s][0], g_image=g, stride=st))
             for st, s in PRB_CASES]
    jobs += [(f"window{m}{st}", "bwd_window",
              dict(scene=scenes[1][0], g_image=g, seeds=SEEDS, stride=st, mode=m, steps=n))
             for st, m, n in WINDOW_CASES]
    out = {}
    for w in WORLDS:
        fit = [("fit", "bwd_fit", dict(target=target))] if w in (1, 4) else []
        out[w] = D.run(w, tmp_path_factory.mktemp(f"bwd{w}"), jobs + fit)
    out[8] = D.run(8, tmp_path_factory.mktemp("bwd8"), pads)
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                 check_vma=False))


# ---------------------------------------------------------------------------
# K29, K30, K31 and their collectives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS + (8,))
def test_distributed_scatter_add_matches_index_add_and_jax(runs, world):
    """Every rank's pairs gathered and added by their owners (K29's plain
    version): the slabs together equal one local index_add_ over the
    padded table and JAX's _distributed_scatter_add on the same pairs."""
    rows = D.padded_rows(world)
    idx, upd = D.scatter_inputs(world, rows)
    got = runs[world][0]["scatter"]["adj"]
    want = torch.zeros((rows, 8)).index_add_(0, torch.as_tensor(idx[idx >= 0]).long(),
                                             torch.as_tensor(upd[idx >= 0])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    mesh = jax_ray_mesh(world)
    per = rows // world
    fn = _shard_map(lambda a, i, u: JS._distributed_scatter_add(a, i, u, per), mesh,
                    (P(JS.AXIS, None), P(JS.AXIS), P(JS.AXIS, None)), P(JS.AXIS, None))
    # a -1 row lies in no slab, in JAX's test as in K29's
    jax_adj = np.asarray(fn(jax.device_put(jnp.zeros((rows, 8), jnp.float32),
                                           NamedSharding(mesh, P(JS.AXIS, None))),
                            jax.device_put(jnp.asarray(idx), NamedSharding(mesh, P(JS.AXIS))),
                            jax.device_put(jnp.asarray(upd),
                                           NamedSharding(mesh, P(JS.AXIS, None)))))
    np.testing.assert_allclose(got, jax_adj, rtol=1e-6, atol=1e-6)


def test_distributed_scatter_add_reads_each_list_to_its_count(monkeypatch):
    """A pair list whose count is below its capacity, garbage past the
    count (rows inside the slab, NaN values): distributed_scatter_add keeps
    the -1 rows out of the list, in slot order, and K29's plain version
    adds only the first count pairs, equal to index_add_ of the owned
    pairs (world size 1, in this process)."""
    rows = D.padded_rows(1)
    idx, upd = D.scatter_inputs(1, rows)
    made, pair_buffer = [], SB.pair_buffer

    def garbage_buffer(n, device):
        buf = pair_buffer(n, device)
        count, slots, rws, vals = SB.pair_views(buf)
        slots.copy_(torch.arange(slots.numel(), dtype=torch.int32))
        rws.copy_(torch.arange(rws.numel(), dtype=torch.int32) % rows)
        vals.fill_(float("nan"))
        made.append(buf)
        return buf

    monkeypatch.setattr(SB, "pair_buffer", garbage_buffer)
    # a world of one: the gather is a copy (the gloo ranks run it in the tests above)
    monkeypatch.setattr(TS.Mesh, "all_gather", lambda t, mesh: t.clone())
    mesh = TM.RayMesh(group=None, rank=0, size=1, device=torch.device("cpu"), backend="gloo")
    got = TS.distributed_scatter_add(torch.zeros((rows, 8)), torch.as_tensor(idx),
                                     torch.as_tensor(upd), mesh)
    count, slots, rws, _ = SB.pair_views(made[0])
    own = idx >= 0
    assert int(count[0]) == int(own.sum()) < SB.pair_capacity(made[0])
    np.testing.assert_array_equal(slots[:int(count[0])].numpy(), np.flatnonzero(own))
    np.testing.assert_array_equal(rws[:int(count[0])].numpy(), idx[own])
    want = torch.zeros((rows, 8)).index_add_(0, torch.as_tensor(idx[own]).long(),
                                             torch.as_tensor(upd[own]))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stride,mode", [(1, "stride"), (2, "stride"), (4, "importance")])
def test_routed_plain_list_is_in_slot_order_and_sums_to_k5(stride, mode):
    """K5 ROUTED's plain version over a 2-dispatch tape of the port's packed
    renderer: its list holds one pair for every nonzero row, in slot order,
    each slot id naming its scatter slot and lane; K29's plain version of
    the list equals the plain K5's own adjoint and the carry is K5's, bit
    for bit."""
    r = D.fit_renderer()
    cam = TCamera()
    ctx, state = r.ctx(cam, 5), r.reset(cam, 5)
    seeds, steps = [2654435761 * k % 2**32 for k in (3, 4)], 8
    fields = SB.ctx_tape_fields(ctx, TS.WRT)
    sk, tape = SB.tape_forward(state, ctx, seeds, steps, BINS, TS.WRT)
    lane, res, streams, n = SB._lanes(state)
    g_rs = SB._deposit_cotangents(torch.as_tensor(_g_image()), ctx, lane, BINS, SB._m_final(sk))
    phases = [SB._dispatch_phase(k, s, len(seeds), stride) for k, s in enumerate(seeds)]
    kw = dict(scatter_stride=stride, scatter_mode=mode, inv_mu=SB._inv_mu(ctx), resolution=res,
              streams=streams)
    slots = len(seeds) * (steps // stride)
    rows = ctx.density.table.shape[0]
    adj = {"g_vol": torch.zeros((rows, 8))}
    cot = dict(c=torch.zeros(n), cb=torch.zeros(n))
    SB.prb_reverse(tape, fields, g_rs, cot, adj, phases, seeds, **kw)
    pairs = SB.pair_buffer(slots * n, "cpu")
    cot_r = dict(c=torch.zeros(n), cb=torch.zeros(n))
    SB.prb_reverse(tape, fields, g_rs, cot_r, {}, phases, seeds, pairs=pairs, **kw)
    count, ids, rws, vals = SB.pair_views(pairs)
    c = int(count[0])
    assert 0 < c < slots * n
    ids, rws, vals = ids[:c], rws[:c], vals[:c]
    assert bool((ids[1:] > ids[:-1]).all()) and int(ids[0]) >= 0 and int(ids[-1]) < slots * n
    assert bool((rws >= 0).all()) and bool((rws < rows).all())
    assert bool((vals != 0).any(dim=1).all())
    assert all(torch.equal(cot[k], cot_r[k]) for k in ("c", "cb"))
    assert [t.tolist() for t in SB.pair_list(pairs)[:2]] == [ids.tolist(), rws.tolist()]
    got = KS.slab_scatter(torch.zeros((rows, 8)), 0, pairs, 1)
    assert float(adj["g_vol"].abs().max()) > 0
    torch.testing.assert_close(got, adj["g_vol"], rtol=1e-5, atol=1e-7)
    # the same number of pairs as the plain K5 added nonzero rows
    touched = (adj["g_vol"] != 0).any(dim=1)
    assert int(torch.unique(rws.long()).numel()) == int(touched.sum())


@pytest.mark.parametrize("world", WORLDS + (8,))
@pytest.mark.parametrize("pad_random", [False, True])
def test_contract_slab_adjoint_matches_k9_and_jax(runs, world, pad_random):
    """K30's plain version, the halo from the next rank and the gradient's
    gather: the raw gradient equals JAX's _contract_slab_adjoint over the
    same padded adjoint (its pad planes random too, which the folds must
    carry as JAX's do), and, with zero pad planes, the plain K9
    contract_volume over the unpadded table. One halo and one gather."""
    adj = D.contract_input(world, pad_random)
    got = runs[world][0]["contract" + ("_r" if pad_random else "0")]
    assert got["counts"] == {"all_gather": 0, "reduce_scatter": 0, "gather_rows": 1, "halo": 1,
                             "all_reduce": 0}
    for rank in range(1, world):
        np.testing.assert_array_equal(runs[world][rank]["contract" + ("_r" if pad_random
                                                                      else "0")]["grad"],
                                      got["grad"])
    mesh = jax_ray_mesh(world)
    slab_z = adj.shape[0] // world
    fn = _shard_map(lambda a: JS._contract_slab_adjoint(a, VOL, VOL, VOL, slab_z), mesh,
                    P(JS.AXIS, None), P(JS.AXIS, None, None))
    want = np.asarray(fn(jax.device_put(jnp.asarray(adj.reshape(-1, 8)),
                                        NamedSharding(mesh, P(JS.AXIS, None)))))[:VOL]
    assert got["grad"].shape == DIMS
    np.testing.assert_allclose(got["grad"], want, rtol=1e-6, atol=1e-5)
    if not pad_random:
        k9 = corners.contract_volume_plain(torch.as_tensor(adj[:VOL + 1].reshape(-1, 8)),
                                           (VOL + 1,) * 3)
        np.testing.assert_allclose(got["grad"], k9.numpy(), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS + (8,))
def test_pack_slab_rows_matches_the_padded_table_and_jax(runs, world):
    """K31's plain version: each rank's slab equals its slice of
    pad_packed_for_slabs(pack_volume_corners(raw)) and JAX's
    _pack_slab_rows at the rank's lo, bit for bit (the pad planes zero)."""
    raw = D.pack_input()
    padded = JS.pad_packed_for_slabs(JI.pack_volume_corners(raw), world)
    slab_z = padded.shape[0] // world
    for rank in range(world):
        got = runs[world][rank]["pack"]
        assert got["dims"] == (slab_z, VOL + 1, VOL + 1)
        want = padded[rank * slab_z:(rank + 1) * slab_z].reshape(-1, 8)
        np.testing.assert_array_equal(_bits(got["table"]), _bits(want))
        jax_rows = np.asarray(JS._pack_slab_rows(jnp.asarray(raw), rank * slab_z, slab_z, VOL))
        np.testing.assert_array_equal(_bits(got["table"]), _bits(jax_rows.reshape(-1, 8)))


@pytest.mark.parametrize("lo", [0, 5, 16, 17, 20])
def test_slab_contract_and_pack_planes(lo):
    """The plain K30 at single owners around the fold planes: its (slab_z +
    1) planes sum, with each owner's halo plane on the owner before, to K9
    over the unpadded table; K31's planes past D are zero."""
    slab_z = 6
    g = torch.as_tensor(np.random.default_rng(lo).standard_normal(
        (slab_z, VOL + 1, VOL + 1, 8)).astype(np.float32))
    if lo + slab_z > VOL + 1:
        g[max(VOL + 1 - lo, 0):] = 0.0
    part = KS.slab_contract_plain(g.reshape(-1, 8), lo, slab_z, DIMS)
    full = torch.zeros((24, VOL + 1, VOL + 1, 8))
    full[lo:lo + slab_z] = g[:24 - lo]
    want = torch.zeros((32, VOL, VOL))
    want[:VOL] = corners.contract_volume_plain(full[:VOL + 1].reshape(-1, 8), (VOL + 1,) * 3)
    got = torch.zeros((32, VOL, VOL))
    got[lo:lo + slab_z] += part[1:]
    if lo > 0:
        got[lo - 1] += part[0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
    packed = KS.slab_pack_plain(torch.as_tensor(D.pack_input()), lo, slab_z)
    zs = lo + np.arange(slab_z)
    assert not packed.reshape(slab_z, -1)[zs > VOL].any()


# ---------------------------------------------------------------------------
# the taped dispatch (K27 every lane, K28 TAPE)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("streams", [1, 2])
def test_taped_slab_dispatch_equals_k4(runs, world, streams):
    """The taped slab dispatch writes K4's tape (plain versions) at the
    rank's lanes bit for bit, every field (vol_row0 the global row), and
    leaves K4's state."""
    for rank in range(world):
        got = runs[world][rank][f"tape{streams}"]
        assert tuple(got["fields"]) == SB.tape_fields({"density"})
        assert got["tape"].shape == got["k4_tape"].shape
        np.testing.assert_array_equal(_bits(got["tape"]), _bits(got["k4_tape"]))
        for k in got["k4_state"]:
            np.testing.assert_array_equal(_bits(got["state"][k]), _bits(got["k4_state"][k]),
                                          err_msg=k)


# ---------------------------------------------------------------------------
# prb_grads_slab
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("stride,streams", PRB_CASES)
def test_prb_grads_slab_matches_the_replicated_backward(runs, world, stride, streams):
    """prb_grads_slab (taped slab dispatch, K5 ROUTED, the pairs' gather,
    K29, K30) against the port's replicated prb_render_and_grads: image and
    samples bit-equal, density rtol 2e-5 / atol 1e-7 (tests/test_slab.py),
    the same on every rank; the rank's state untouched."""
    ref = None
    for rank in range(world):
        got = runs[world][rank][f"prb{stride}_{streams}"]
        np.testing.assert_array_equal(_bits(got["image"]), _bits(got["ref_image"]))
        np.testing.assert_array_equal(got["samples"], got["ref_samples"])
        assert np.abs(got["ref_density"]).max() > 0
        np.testing.assert_allclose(got["density"], got["ref_density"], rtol=2e-5, atol=1e-7)
        assert got["untouched"]
        if ref is not None:
            np.testing.assert_array_equal(got["density"], ref)
        ref = got["density"]


@pytest.mark.parametrize("world,stride,streams", JAX_PRB_CASES)
def test_prb_grads_slab_matches_jax(runs, scenes, world, stride, streams):
    """The port's slab gradient against JAX's prb_grads_slab on a mesh of
    the same size from the same ctx and reset: relative L2 <= 1e-3 (the
    port-vs-JAX tolerance of tests/test_torch_prb.py: XLA's CPU log and
    reciprocal division make the tapes differ by ulps); the image within
    the image tolerance of that test."""
    _, (r, jctx, js0) = scenes[streams]
    mesh = jax_ray_mesh(world)
    padded = JS.pad_packed_for_slabs(_packed4(jctx), world)
    ctx = jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)), jctx)
    ctx = ctx._replace(density=JS.shard_packed_volume(padded, mesh))
    _, img, grads = JS.prb_grads_slab(shard_spectral_state(js0, mesh), ctx, mesh, DIMS,
                                      jnp.asarray(_g_image()), STEPS, BINS,
                                      scatter_stride=stride)
    got = runs[world][0][f"prb{stride}_{streams}"]
    np.testing.assert_allclose(got["image"], np.asarray(img), rtol=1e-3, atol=1e-5)
    want = np.asarray(grads["density"])
    assert np.abs(want).max() > 0
    assert _rel(want, got["density"]) <= 1e-3


@pytest.mark.parametrize("world", WORLDS)
def test_prb_grads_slab_collectives_and_calls(runs, world):
    """One slab dispatch of STEPS steps and its backward: one all-gather
    and one reduce-scatter a forward step, one pair all-gather, one K5
    (ROUTED) and one K29 a dispatch, one K30, one halo and the gradient's
    gather (beside the image's) a backward; K4 is not called."""
    for stride, streams in PRB_CASES:
        got = runs[world][0][f"prb{stride}_{streams}"]
        assert got["counts"] == {"all_gather": STEPS + 1, "reduce_scatter": STEPS,
                                 "gather_rows": 2, "halo": 1, "all_reduce": 0}
        assert got["calls"] == {"slab_advance": STEPS, "slab_rows": STEPS, "slab_finish": STEPS,
                                "slab_scatter": 1, "slab_contract": 1, "slab_pack": 0,
                                "prb_reverse": 1, "tape_forward": 0}


# ---------------------------------------------------------------------------
# prb_window_grads_slab
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("stride,mode,steps", WINDOW_CASES)
def test_prb_window_grads_slab_matches_the_replicated_window(runs, world, stride, mode, steps):
    """The window (untaped slab dispatches, then per dispatch in reverse a
    taped re-simulation, K5 ROUTED with the carry threaded, the pairs'
    gather and K29; one contraction) against the replicated
    prb_render_and_grads_many(window=True, window_storage="forward"): the
    image bit-equal, density rtol 2e-5 / atol 1e-7; its collectives and
    calls. The importance picks (the rows every pair names, over the global
    lanes) equal world 1's at world 2 and 4."""
    key = f"window{mode}{stride}"
    K = len(SEEDS)
    for rank in range(world):
        got = runs[world][rank][key]
        np.testing.assert_array_equal(_bits(got["image"]), _bits(got["ref_image"]))
        assert np.abs(got["ref_density"]).max() > 0
        np.testing.assert_allclose(got["density"], got["ref_density"], rtol=2e-5, atol=1e-7)
    got = runs[world][0][key]
    assert got["counts"] == {"all_gather": 2 * K * steps + K, "reduce_scatter": 2 * K * steps,
                             "gather_rows": 2, "halo": 1, "all_reduce": 0}
    assert got["calls"] == {"slab_advance": 2 * K * steps, "slab_rows": 2 * K * steps,
                            "slab_finish": 2 * K * steps, "slab_scatter": K, "slab_contract": 1,
                            "slab_pack": 0}
    assert got["pair_rows"].shape == (K, steps // stride, 1, RES, RES)
    np.testing.assert_array_equal(got["pair_rows"], runs[1][0][key]["pair_rows"])
    assert (got["pair_rows"] >= 0).any()


# ---------------------------------------------------------------------------
# fit_spectral_slab
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fit_refs(target):
    """The port's replicated fit_spectral(method="prb", scatter_stride=1)
    and JAX's fit_spectral_slab on a 4-device mesh, from the same target."""
    kw = dict(D.FIT)
    init = np.full(DIMS, 0.5, np.float32)
    params, losses = TO.fit_spectral(target, D.fit_renderer(), TCamera(), {"density": init},
                                     method="prb", **kw)
    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    mesh = jax_ray_mesh(4)
    jr = JM.MCMSpectralRenderer(
        Volume.sphere_in_cube(VOL), MaterialTF(table), LightConfig(direction=(1.0, 0.2, 0.5)),
        SpectrumConfig(), MCMSpectralConfig(extinction=20.0, steps=8), resolution=RES,
        pack_tables={"material_tf", "light_spectrum"}, mesh=mesh)
    jp, jl = JS.fit_spectral_slab(target, jr, Camera(), init, mesh, **kw)
    return dict(port=(params["density"].numpy(), losses),
                jax=(np.asarray(jp["density"]), jl))


@pytest.mark.parametrize("world", [1, 4])
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_fit_spectral_slab_follows_the_replicated_and_jax_trajectories(runs, fit_refs, world,
                                                                       ref):
    """Three iterations of fit_spectral_slab (K31 each step, the window,
    Adam on the replicated density) follow the port's replicated
    fit_spectral(method="prb") and JAX's fit_spectral_slab: losses rtol
    1e-4, params rtol 5e-4 / atol 5e-6 (tests/test_torch_optim.py); the
    same on every rank, and the params moved."""
    want_d, want_l = fit_refs[ref]
    got = runs[world][0]["fit"]
    np.testing.assert_allclose(got["losses"], want_l, rtol=1e-4)
    np.testing.assert_allclose(got["density"], want_d, rtol=5e-4, atol=5e-6)
    assert np.abs(got["density"] - 0.5).max() > 1e-3
    assert np.isfinite(got["losses"]).all()
    for rank in range(1, world):
        np.testing.assert_array_equal(runs[world][rank]["fit"]["density"], got["density"])


@pytest.mark.parametrize("world", [1, 4])
def test_fit_spectral_slab_collectives_and_calls(runs, world):
    """Per iteration: K31 once, each window dispatch's two step loops and
    its pair gather and K29, one K30, one halo, one gradient gather and the
    loss's all-reduce; the image is not gathered."""
    n, K, steps = D.FIT["iterations"], D.FIT["dispatches_per_step"], 8
    got = runs[world][0]["fit"]
    assert got["counts"] == {"all_gather": n * (2 * K * steps + K),
                             "reduce_scatter": n * 2 * K * steps, "gather_rows": n,
                             "halo": n, "all_reduce": n}
    assert got["calls"] == {"slab_advance": n * 2 * K * steps, "slab_rows": n * 2 * K * steps,
                            "slab_finish": n * 2 * K * steps, "slab_scatter": n * K,
                            "slab_contract": n, "slab_pack": n}


def test_fit_spectral_slab_refuses_an_unfused_tf_as_jax_does():
    """A renderer whose TF is not fused fails JAX's assertion, with its
    message, before any collective."""
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu_torch import convert

    jr = _jax_renderer(pack_tables={"density"})
    mesh = TM.RayMesh(group=None, rank=0, size=1, device=torch.device("cpu"), backend="gloo")
    init = np.full(DIMS, 0.5, np.float32)
    with pytest.raises(AssertionError) as jerr:
        JS.fit_spectral_slab(np.zeros((RES, RES, 3), np.float32), jr, Camera(), init,
                             jax_ray_mesh(1), iterations=1)
    args = convert.scene_from(Volume.sphere_in_cube(VOL), MaterialTF(D.ramp_table()),
                              LightConfig(direction=(1.0, 0.2, 0.3)), SpectrumConfig(),
                              MCMSpectralConfig(extinction=20.0, steps=STEPS))
    r = MCMSpectralRenderer(*args, resolution=RES, pack_tables={"density"}, device="cpu")
    TM.reset_collective_counts()
    with pytest.raises(AssertionError) as terr:
        TS.fit_spectral_slab(np.zeros((RES, RES, 3), np.float32), r, TCamera(), init, mesh,
                             iterations=1)
    assert str(terr.value) == str(jerr.value)
    assert not any(TM.COLLECTIVES.values())


def test_routed_reverse_and_tape_refuse_what_they_cannot_do():
    """K5's ROUTED mode takes no g_vol beside its pairs and needs room for
    every slot; the taped slab step refuses the majorant mode as the packed
    backward does."""
    fields = SB.tape_fields({"density"})
    tapes = torch.zeros((1, 4, len(fields), 8))
    cot = dict(c=torch.zeros(8), cb=torch.zeros(8))
    kw = dict(scatter_stride=1, scatter_mode="stride", inv_mu=0.1, resolution=2, streams=2)
    with pytest.raises(ValueError):
        SB.prb_reverse(tapes, fields, torch.zeros((BINS, 8)), cot, {"g_vol": torch.zeros((4, 8))},
                       [0], [1], pairs=SB.pair_buffer(32, "cpu"), **kw)
    with pytest.raises(ValueError):
        SB.prb_reverse(tapes, fields, torch.zeros((BINS, 8)), cot, {}, [0], [1],
                       pairs=SB.pair_buffer(28, "cpu"), **kw)
    state = dataclasses.make_dataclass("S", ["px"])(torch.zeros((2, 2)))
    ctx = dataclasses.make_dataclass("C", ["majorant"])(torch.zeros((1, 1, 1, 2)))
    with pytest.raises(NotImplementedError):
        KS.slab_advance(state, ctx, None, 1, True, None, DIMS, BINS, tape=True)
