"""The ray mesh, the slab render and the slab backward across CPU processes
under gloo.

    python -m vpt_tpu_torch.tools.mesh_dryrun --world 4 --out DIR [--job NAME ...]

``run(world, out_dir, jobs)`` starts ``world`` processes with
``torch.multiprocessing`` ("spawn"), joined by a ``FileStore`` under
``out_dir`` (so concurrent runs never share a port), one thread each. Every
rank runs the named jobs on the "rays" mesh (``parallel/mesh.ray_mesh``)
and saves what it found, numpy arrays in a dict a job, to
``out_dir/rank<r>.pt``; ``run`` returns the ranks' dicts in rank order. The
tests (``tests/test_torch_mesh.py``, ``tests/test_torch_slab.py``) compare
them with the JAX package, which no process here imports.

The scene is the JAX mesh tests' (``tests/test_slab.py``: ``sphere_in_cube(16)``
at 16^2, a constant TF (0.8, 0.6, 0.2), light (1, 0.2, 0.3), extinction 20, 6
steps, 12 bins); ``SLAB_MODES`` names the slab render's modes. The backward's
jobs (``bwd_*``, ``tests/test_torch_slab_backward.py``) take their scene as
numpy arrays (``scene``: the keywords of ``convert.ctx_from_numpy`` and a
state's fields), so the test can hand them the JAX renderer's ctx and reset.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path

import numpy as np
import torch

RES, VOL, STEPS, BINS = 16, 16, 6, 12
ENV_SEED = 2024
# the slab render's modes: renderer keywords and the packed table's type
SLAB_MODES = {
    "default": dict(),
    "f32": dict(f32=True),
    "quasicubic": dict(filter="quasicubic"),
    "majorant": dict(majorant_blocks=4),
    "environment": dict(environment=True),
}


def seeded_envmap():
    return np.random.default_rng(ENV_SEED).random((8, 16, 3)).astype(np.float32)


def renderer(streams=1, mesh=None, filter="linear", majorant_blocks=None, environment=False,
             f32=False):
    """The port's renderer of the scene on the CPU (``f32`` is read by
    ``packed_table``)."""
    from vpt_tpu_torch import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig, Volume
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    vol = Volume.sphere_in_cube(VOL)
    if filter != "linear":
        vol = Volume(vol.density, filter=filter)
    return MCMSpectralRenderer(
        vol, MaterialTF.constant(0.8, 0.6, 0.2), LightConfig(direction=(1.0, 0.2, 0.3)),
        SpectrumConfig(), MCMSpectralConfig(extinction=20.0, steps=STEPS), resolution=RES,
        streams=streams, mesh=mesh, majorant_blocks=majorant_blocks,
        environment=seeded_envmap() if environment else None, device="cpu")


def packed_table(f32=False, **_):
    """The scene's (D+1, H+1, W+1, 8) corner table: u8 codes as the
    renderer packs them, or the f32 densities."""
    from vpt_tpu_torch import Volume
    from vpt_tpu_torch.ops import interp

    d = np.asarray(Volume.sphere_in_cube(VOL).density, np.float32)
    return interp.pack_volume_corners(d if f32 else np.round(d * 255.0).astype(np.uint8))


def random_state(streams, seed):
    """A global ``SpectralState`` of RES^2 lanes (x streams) from a numpy
    seed, every leaf distinct, as numpy arrays by field."""
    from vpt_tpu_torch.models.mcm_spectral import SpectralState

    g = np.random.default_rng(seed)
    lane = (RES, RES) if streams == 1 else (streams, RES, RES)
    out = {}
    for k in SpectralState.field_names():
        shape = (BINS,) + lane if k in ("radiance", "transmittance") else lane
        out[k] = (g.integers(0, 1000, shape).astype(np.int32) if k in ("bounces", "samples", "bin")
                  else g.random(shape).astype(np.float32))
    return out


def _numpy_state(state):
    return {k: getattr(state, k).numpy().copy() for k in state.field_names()}


def _clone(state):
    return type(state)(*(t.clone() for t in state.tensors()))


def job_shard_state(mesh, streams, seed=5):
    """This rank's rows of a random global state, and the global state
    gathered back from every rank."""
    from vpt_tpu_torch.models.mcm_spectral import SpectralState
    from vpt_tpu_torch.parallel import mesh as M

    full = SpectralState(**{k: torch.as_tensor(v) for k, v in random_state(streams, seed).items()})
    mine = M.shard_spectral_state(full, mesh)
    return dict(shard=_numpy_state(mine),
                gathered=_numpy_state(M.gather_spectral_state(mine, mesh)))


def job_mesh_render(mesh, streams):
    """The mesh renderer: reset, render_many of two seeds, render of one;
    the gathered state and image after each, the collectives the renders
    made; at world 1 also the renderer without a mesh."""
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.parallel import mesh as M

    cam = Camera()
    r = renderer(streams, mesh)
    state = r.reset(cam, 3)
    out = dict(reset=_numpy_state(M.gather_spectral_state(state, mesh)),
               lane_shape=tuple(state.px.shape))
    M.reset_collective_counts()
    state, img = r.render_many(state, cam, [5, 6])
    out["counts_many"] = dict(M.COLLECTIVES)
    out["image_many"] = img.numpy()
    state, img = r.render(state, cam, 9)
    out["image"] = img.numpy()
    out["state"] = _numpy_state(M.gather_spectral_state(state, mesh))
    if mesh.size == 1:
        plain = renderer(streams)
        s = plain.reset(cam, 3)
        s, img_many = plain.render_many(s, cam, [5, 6])
        out["plain_image_many"] = img_many.numpy()
        s, img = plain.render(s, cam, 9)
        out["plain_image"], out["plain_state"] = img.numpy(), _numpy_state(s)
    return out


def job_rows(mesh, f32, seed=0):
    """``distributed_rows`` over the padded table at random requests (13 a
    rank, from a numpy seed, a few -1), every rank's rows gathered."""
    from vpt_tpu_torch.parallel import mesh as M
    from vpt_tpu_torch.parallel import slab

    padded = slab.pad_packed_for_slabs(packed_table(f32), mesh.size)
    sv = slab.shard_packed_volume(padded, mesh)
    req = request_indices(mesh.size, seed)
    mine = torch.as_tensor(req.reshape(mesh.size, -1)[mesh.rank])
    rows = slab.distributed_rows(sv.table, mine, mesh)
    return dict(rows=M.all_gather(rows, mesh).numpy(), slab_dims=sv.dims)


def request_indices(n, seed=0):
    """n x 13 int32 flat row requests into the packed table, a few -1."""
    from vpt_tpu_torch import Volume

    D, H, W = Volume.sphere_in_cube(VOL).density.shape
    g = np.random.default_rng(seed)
    req = g.integers(0, (D + 1) * (H + 1) * (W + 1), size=(n * 13,)).astype(np.int32)
    req[::7] = -1
    return req


def job_slab_render(mesh, mode, streams=1, seed=5):
    """The replicated render (every rank, the whole state) and the slab
    render (``render_slab``: K27, all-gather, K26, reduce-scatter, K28 a
    step, their plain versions here; this rank's rows, gathered) from the
    same reset state; the collectives and wrapper calls the slab render
    made."""
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import slab as KS
    from vpt_tpu_torch.models import mcm_spectral as TM
    from vpt_tpu_torch.ops import interp
    from vpt_tpu_torch.parallel import mesh as M
    from vpt_tpu_torch.parallel import slab

    kw = SLAB_MODES[mode]
    r = renderer(streams, **{k: v for k, v in kw.items() if k != "f32"})
    cam = Camera()
    packed = packed_table(**kw)
    # the replicated table: the renderer's own (u8), or the f32 densities'
    ctx = M.shard_ctx(dataclasses.replace(r.ctx(cam, seed), density=interp.PackedVolume(
        torch.as_tensor(packed.reshape(-1, 8)), packed.shape[:3])), mesh)
    full = r.reset(cam, 3)
    ref_state, ref_img = TM.render(_clone(full), ctx, STEPS, BINS)
    padded = slab.pad_packed_for_slabs(packed, mesh.size)
    sctx = dataclasses.replace(ctx, density=slab.shard_packed_volume(padded, mesh))
    # each wrapper counted
    calls = {"slab_advance": 0, "slab_rows": 0, "slab_finish": 0}
    saved = {k: getattr(KS, k) for k in calls}

    def counted(name):
        def f(*a, **k):
            calls[name] += 1
            return saved[name](*a, **k)
        return f

    for k in calls:
        setattr(KS, k, counted(k))
    try:
        M.reset_collective_counts()
        st, img = slab.render_slab(M.shard_spectral_state(full, mesh), sctx, mesh,
                                   r.volume.density.shape, STEPS, BINS, r.volume.filter)
        counts = dict(M.COLLECTIVES)
    finally:
        for k, f in saved.items():
            setattr(KS, k, f)
    return dict(ref_state=_numpy_state(ref_state), ref_image=ref_img.numpy(),
                state=_numpy_state(M.gather_spectral_state(st, mesh)), image=img.numpy(),
                counts=counts, calls=calls)


# ---------------------------------------------------------------------------
# the slab backward (parallel/slab.py): K5 ROUTED, K28 TAPE, K29, K30, K31
# ---------------------------------------------------------------------------
def scatter_inputs(n, rows, seed=7, per_rank=29):
    """Every rank's (row, 8 values) pairs into a table of ``rows`` rows,
    from a numpy seed: (n * per_rank,) int32 rows (every 5th -1) and (n *
    per_rank, 8) f32 values, rank r's the r-th block."""
    g = np.random.default_rng(seed + n)
    idx = g.integers(0, rows, size=n * per_rank).astype(np.int32)
    idx[::5] = -1
    return idx, g.standard_normal((n * per_rank, 8)).astype(np.float32)


def padded_rows(n):
    """Rows of the scene's corner table padded for ``n`` ranks."""
    return -(-(VOL + 1) // n) * n * (VOL + 1) ** 2


def job_bwd_scatter(mesh, seed=7):
    """``distributed_scatter_add`` of every rank's pairs into zero adjoint
    slabs; every rank's slab gathered (the padded table's adjoint)."""
    from vpt_tpu_torch.parallel import mesh as M
    from vpt_tpu_torch.parallel import slab

    idx, upd = scatter_inputs(mesh.size, padded_rows(mesh.size), seed)
    mine = slice(mesh.rank * len(idx) // mesh.size, (mesh.rank + 1) * len(idx) // mesh.size)
    adj = torch.zeros((padded_rows(mesh.size) // mesh.size, 8))
    slab.distributed_scatter_add(adj, torch.as_tensor(idx[mine]), torch.as_tensor(upd[mine]),
                                 mesh)
    return dict(adj=M.all_gather(adj, mesh).numpy())


def contract_input(n, pad_random, seed=11):
    """A packed density adjoint (padded for ``n`` ranks, (Dp', H+1, W+1, 8)
    f32) from a numpy seed; the pad planes zero unless ``pad_random``."""
    g = np.random.default_rng(seed)
    adj = g.standard_normal((padded_rows(n) // (VOL + 1) ** 2, VOL + 1, VOL + 1, 8))
    if not pad_random:
        adj[VOL + 1:] = 0.0
    return adj.astype(np.float32)


def job_bwd_contract(mesh, pad_random):
    """``contract_slab_adjoint`` of each rank's slab of ``contract_input``:
    the raw gradient (on every rank) and the collectives it made."""
    from vpt_tpu_torch.parallel import mesh as M
    from vpt_tpu_torch.parallel import slab

    adj = contract_input(mesh.size, pad_random).reshape(mesh.size, -1, 8)[mesh.rank]
    M.reset_collective_counts()
    g = slab.contract_slab_adjoint(torch.as_tensor(adj.copy()), (VOL, VOL, VOL), mesh)
    return dict(grad=g.numpy(), counts=dict(M.COLLECTIVES))


def pack_input():
    """A raw (VOL, VOL, VOL) f32 density, the scene's sphere plus noise."""
    from vpt_tpu_torch import Volume

    d = np.asarray(Volume.sphere_in_cube(VOL).density, np.float32)
    return (d + 0.1 * np.random.default_rng(13).random(d.shape)).astype(np.float32)


def job_bwd_pack(mesh):
    """``pack_slab_rows`` of ``pack_input``: this rank's slab, its dims."""
    from vpt_tpu_torch.parallel import slab

    sv = slab.pack_slab_rows(torch.as_tensor(pack_input()), mesh)
    return dict(table=sv.table.numpy(), dims=sv.dims)


def ramp_table():
    """The density ramp TF of ``tests/test_slab.py``'s backward tests."""
    table = np.zeros((256, 256, 4), np.float32)
    table[..., 0] = 0.8
    table[..., 1] = np.linspace(0, 1, 256)[:, None]
    table[..., 2] = 0.5
    return table


def _scene(scene, mesh):
    """(replicated ctx, global state, this rank's slab ctx, this rank's
    state) of a scene given as numpy arrays."""
    from vpt_tpu_torch import convert
    from vpt_tpu_torch.parallel import mesh as M
    from vpt_tpu_torch.parallel import slab

    ctx = convert.ctx_from_numpy(**scene["ctx"], device="cpu")
    state = convert.state_from_numpy(scene["state"], "cpu")
    packed = ctx.density.table.view(*ctx.density.dims, 8).numpy()
    sctx = dataclasses.replace(ctx, density=slab.shard_packed_volume(
        slab.pad_packed_for_slabs(packed, mesh.size), mesh))
    return ctx, state, sctx, M.shard_spectral_state(state, mesh)


def _lane_rows(t, mesh, streams):
    """This rank's lanes of a (..., lanes) tensor over the global (S, R, R)
    lane grid, in the rank's (S, rows, R) order."""
    R = int(round((t.shape[-1] // streams) ** 0.5))
    lo, hi = mesh.rank * R // mesh.size, (mesh.rank + 1) * R // mesh.size
    return t.reshape(t.shape[:-1] + (streams, R, R))[..., lo:hi, :].reshape(t.shape[:-1] + (-1,))


def job_bwd_tape(mesh, scene, steps=STEPS):
    """The taped slab dispatch's tape and state, and K4's tape (plain,
    the replicated table, every lane) at this rank's lanes, and K4's state
    gathered."""
    from vpt_tpu_torch.kernels import spectral_backward as SB
    from vpt_tpu_torch.parallel import mesh as M
    from vpt_tpu_torch.parallel import slab

    ctx, state, sctx, mine = _scene(scene, mesh)
    streams = state.px.shape[0] if state.px.ndim == 3 else 1
    fields = SB.ctx_tape_fields(ctx, slab.WRT)
    k4_state, k4_tape = SB.tape_forward(state, ctx, [ctx.seed_bits], steps, BINS, slab.WRT)
    st, tape = slab.tape_slab_dispatch(mine, sctx, mesh, (VOL, VOL, VOL), steps, BINS,
                                       ctx.seed_bits, fields)
    return dict(tape=tape.numpy(), k4_tape=_lane_rows(k4_tape, mesh, streams).numpy(),
                state=_numpy_state(M.gather_spectral_state(st, mesh)),
                k4_state=_numpy_state(k4_state), fields=fields)


def _counted(module, names):
    """Wrap ``module``'s functions ``names`` to count their calls; returns
    (calls, restore)."""
    calls = {k: 0 for k in names}
    saved = {k: getattr(module, k) for k in names}

    def counted(name):
        def f(*a, **k):
            calls[name] += 1
            return saved[name](*a, **k)
        return f

    for k in names:
        setattr(module, k, counted(k))

    def restore():
        for k, f in saved.items():
            setattr(module, k, f)
    return calls, restore


BWD_WRAPPERS = ("slab_advance", "slab_rows", "slab_finish", "slab_scatter", "slab_contract",
                "slab_pack")


def job_bwd_prb(mesh, scene, g_image, stride=1, steps=STEPS):
    """``prb_grads_slab`` (this rank's rows; image, samples and the
    gradient gathered) and the replicated ``prb_render_and_grads`` over the
    whole table, from the same scene; the collectives and wrapper calls of
    the slab run (K5's ROUTED calls by ``prb_reverse``)."""
    from vpt_tpu_torch.kernels import slab as KS
    from vpt_tpu_torch.kernels import spectral_backward as SB
    from vpt_tpu_torch.parallel import mesh as M
    from vpt_tpu_torch.parallel import slab

    ctx, state, sctx, mine = _scene(scene, mesh)
    g = torch.as_tensor(g_image)
    ref_state, ref_img, ref = SB.prb_render_and_grads(state, ctx, g, steps, BINS, wrt=slab.WRT,
                                                      scatter_stride=stride)
    calls, restore = _counted(KS, BWD_WRAPPERS)
    rev_calls, rev_restore = _counted(SB, ("prb_reverse", "tape_forward"))
    try:
        M.reset_collective_counts()
        st, img, grads = slab.prb_grads_slab(mine, sctx, mesh, (VOL, VOL, VOL), g, steps, BINS,
                                             scatter_stride=stride)
        counts = dict(M.COLLECTIVES)
    finally:
        restore()
        rev_restore()
    return dict(image=img.numpy(), samples=M.gather_rows(st.samples, mesh, st.samples.ndim - 2)
                .numpy(), density=grads["density"].numpy(), ref_image=ref_img.numpy(),
                ref_samples=ref_state.samples.numpy(), ref_density=ref["density"].numpy(),
                counts=counts, calls={**calls, **rev_calls},
                untouched=all(torch.equal(a, b) for a, b in zip(
                    mine.tensors(), M.shard_spectral_state(state, mesh).tensors())))


def job_bwd_window(mesh, scene, g_image, seeds, stride=1, mode="stride", steps=STEPS):
    """``prb_window_grads_slab`` and the replicated
    ``prb_render_and_grads_many(window=True, window_storage="forward")``;
    the slab run's collectives and wrapper calls, and the rows its K5
    ROUTED pairs name ((K, slots, S, R, R) int32 over the global lanes, -1
    where a slot holds no pair, dispatch K-1 first; rebuilt from each
    list's slot ids), which the importance picks decide."""
    from vpt_tpu_torch.kernels import slab as KS
    from vpt_tpu_torch.kernels import spectral_backward as SB
    from vpt_tpu_torch.parallel import mesh as M
    from vpt_tpu_torch.parallel import slab

    ctx, state, sctx, mine = _scene(scene, mesh)
    g = torch.as_tensor(g_image)
    _, ref_img, ref = SB.prb_render_and_grads_many(
        state, ctx, seeds, g, steps, BINS, wrt=slab.WRT, scatter_stride=stride,
        scatter_mode=mode, window=True, window_storage="forward")
    pairs, scatter = [], slab.scatter_pairs

    def recording(adj, buf, m):
        count, slot_ids, rows, _ = SB.pair_views(buf)
        n = int(count[0])
        per_slot = torch.full_like(slot_ids, -1)
        per_slot[slot_ids[:n].to(torch.int64)] = rows[:n]
        pairs.append(per_slot)
        return scatter(adj, buf, m)

    calls, restore = _counted(KS, BWD_WRAPPERS)
    slab.scatter_pairs = recording
    try:
        M.reset_collective_counts()
        st, img, grads = slab.prb_window_grads_slab(mine, sctx, mesh, (VOL, VOL, VOL), seeds, g,
                                                    steps, BINS, scatter_stride=stride,
                                                    scatter_mode=mode)
        counts = dict(M.COLLECTIVES)
    finally:
        slab.scatter_pairs = scatter
        restore()
    lane = mine.px.shape if mine.px.ndim == 3 else (1,) + tuple(mine.px.shape)
    slots = steps // stride
    rows = torch.stack([p[:slots * mine.px.numel()].reshape((slots,) + tuple(lane))
                        for p in pairs])
    return dict(image=img.numpy(), density=grads["density"].numpy(), ref_image=ref_img.numpy(),
                ref_density=ref["density"].numpy(), counts=counts, calls=calls,
                pair_rows=M.gather_rows(rows, mesh, rows.ndim - 2).numpy())


def fit_renderer(mesh=None, pack=True):
    """The port's renderer of ``tests/test_slab.py``'s slab fit: the
    sphere, albedo 0.9, alpha ramping from density 0.3, light (1, 0.2,
    0.5), extinction 20, 8 steps; ``pack`` True packs every table, else
    only the TF and light (fused), as the slab fit takes them."""
    from vpt_tpu_torch import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig, Volume
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    table = np.zeros((256, 256, 4), np.float32)
    dens = np.linspace(0, 1, 256)[:, None]
    table[..., 0] = 0.9
    table[..., 1] = np.where(dens > 0.3, (dens - 0.3) / 0.7, 0.0)
    return MCMSpectralRenderer(
        Volume.sphere_in_cube(VOL), MaterialTF(table), LightConfig(direction=(1.0, 0.2, 0.5)),
        SpectrumConfig(), MCMSpectralConfig(extinction=20.0, steps=8), resolution=RES,
        pack_tables=True if pack else {"material_tf", "light_spectrum"}, mesh=mesh, device="cpu")


FIT = dict(dispatches_per_step=4, iterations=3, learning_rate=0.05, seed=3, scatter_stride=1)


def job_bwd_fit(mesh, target):
    """``fit_spectral_slab`` of ``FIT`` from a constant 0.5 density: its
    params and losses, and the collectives and wrapper calls it made."""
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import slab as KS
    from vpt_tpu_torch.parallel import mesh as M
    from vpt_tpu_torch.parallel import slab

    init = np.full((VOL, VOL, VOL), 0.5, np.float32)
    calls, restore = _counted(KS, BWD_WRAPPERS)
    try:
        M.reset_collective_counts()
        params, losses = slab.fit_spectral_slab(target, fit_renderer(mesh, pack=False), Camera(),
                                                init, mesh, **FIT)
        counts = dict(M.COLLECTIVES)
    finally:
        restore()
    return dict(density=params["density"].numpy(), losses=losses, counts=counts, calls=calls)


def job_fit_mesh(mesh):
    """``optim.fit_spectral`` of ``FIT`` on ``fit_renderer(mesh)`` from a
    constant 0.5 density towards a black image, by each method: the
    exception's type and message where it raised, else its losses."""
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch import optim

    target = np.zeros((RES, RES, 3), np.float32)
    init = {"density": np.full((VOL, VOL, VOL), 0.5, np.float32)}
    out = {}
    for method in ("prb", "autodiff"):
        try:
            _, losses = optim.fit_spectral(target, fit_renderer(mesh), Camera(), init,
                                           method=method, **FIT)
        except NotImplementedError as e:
            out[method] = dict(raised=type(e).__name__, message=str(e))
        else:
            out[method] = dict(losses=np.asarray(losses))
    return out


JOBS = {"shard_state": job_shard_state, "mesh_render": job_mesh_render, "rows": job_rows,
        "slab_render": job_slab_render, "bwd_scatter": job_bwd_scatter,
        "bwd_contract": job_bwd_contract, "bwd_pack": job_bwd_pack, "bwd_tape": job_bwd_tape,
        "bwd_prb": job_bwd_prb, "bwd_window": job_bwd_window, "bwd_fit": job_bwd_fit,
        "fit_mesh": job_fit_mesh}


def _worker(rank, world, store, out_dir, jobs):
    import torch.distributed as dist

    from vpt_tpu_torch.parallel.mesh import ray_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = ray_mesh(world, device="cpu")
        out = {key: JOBS[name](mesh, **kw) for key, name, kw in jobs}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run(world: int, out_dir, jobs):
    """Run ``jobs``, a list of (key, job name, keyword dict), on ``world``
    gloo ranks; returns each rank's {key: result} in rank order."""
    import torch.multiprocessing as mp

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    store = str(out_dir / "store")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    mp.start_processes(_worker, args=(world, store, str(out_dir), list(jobs)), nprocs=world,
                       join=True, start_method="spawn")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--out", required=True)
    ap.add_argument("--job", action="append", choices=sorted(JOBS))
    args = ap.parse_args(argv)
    defaults = {"shard_state": dict(streams=2), "mesh_render": dict(streams=2),
                "rows": dict(f32=False), "slab_render": dict(mode="default")}
    names = args.job or sorted(JOBS)
    res = run(args.world, args.out, [(n, n, defaults[n]) for n in names])
    print(f"{args.world} ranks ran {names}: rank 0 saved {sorted(res[0])}")


if __name__ == "__main__":
    main()
