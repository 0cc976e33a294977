"""The ray mesh and the slab render across CPU processes under gloo.

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
steps, 12 bins); ``SLAB_MODES`` names the slab render's modes.
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


JOBS = {"shard_state": job_shard_state, "mesh_render": job_mesh_render, "rows": job_rows,
        "slab_render": job_slab_render}


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
