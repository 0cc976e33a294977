"""The ray mesh on ``torch.distributed``: counterpart of
``vpt_tpu/parallel/mesh.py`` (and of ``scaling.initialize_distributed``).

One axis, "rays": the framebuffer's rows (and with them the photon-state
lanes) split across the ranks of a process group, one contiguous block of
``resolution / size`` rows a rank; the scene tables are replicated, each
rank holding its own copy on its own device. Every per-lane operation is
elementwise, so a row-split render dispatch needs no communication: the
only collective of a mesh render is the gather of the image's rows at its
end (``gather_rows``).

Reproducibility: a lane's random seed is a function of its *global* pixel
coordinates (``lane_tables``: ix, the global row iy, and iy + s * H for
stream s), so a render is bit-identical across world sizes, 1 included.

The backend follows the device: NCCL for CUDA, gloo for the CPU. A
collective on a tensor the group's backend cannot take raises (gloo is
never handed a CUDA tensor to stage through the host). ``COLLECTIVES``
counts the collectives this module runs, by kind.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from vpt_tpu_torch.ops.interp import PackedVolume

# collectives run, by kind: "all_gather" and "reduce_scatter" of flat
# tensors (the slab's routed gather and the backward's gather of the
# adjoint pairs, parallel/slab.py), "gather_rows" (an image, a state leaf or
# the slab backward's z-sharded gradient gathered along its row axis),
# "halo" (a plane handed to the rank before, halo_from_next), "all_reduce"
# (a sum over the ranks, the slab fit's loss)
COLLECTIVES = {"all_gather": 0, "reduce_scatter": 0, "gather_rows": 0, "halo": 0,
               "all_reduce": 0}


def reset_collective_counts():
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclass(frozen=True)
class RayMesh:
    """A 1-D "rays" mesh: a process group, this process's rank in it, the
    world size and the device this rank renders on. ``group`` None is the
    default group."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_distributed(device) -> bool:
    """Initialize the default process group for ``device`` (NCCL for CUDA,
    gloo for the CPU) unless one exists. Under torchrun (``RANK`` and
    ``WORLD_SIZE`` set, with ``MASTER_ADDR``/``MASTER_PORT``) it joins that
    world by the environment; otherwise it builds a world of one process
    on an in-process store, so the same collectives run at world size 1.
    Returns True when it initialized the group."""
    if dist.is_initialized():
        return False
    device = torch.device(device)
    backend = _backend_for(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return True


def ray_mesh(n_devices: int | None = None, *, device) -> RayMesh:
    """The "rays" mesh over the default process group (initialized for
    ``device`` if need be). ``n_devices``, when given, must equal the
    world size: each rank renders on one device."""
    device = torch.device(device)
    initialize_distributed(device)
    size = dist.get_world_size()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"a ray mesh of {n_devices} devices needs a world of {n_devices} "
                         f"ranks, this one has {size}")
    backend = dist.get_backend()
    if backend != _backend_for(device):
        raise ValueError(f"a {device.type} mesh needs the {_backend_for(device)} backend, "
                         f"the process group runs {backend}")
    return RayMesh(group=None, rank=dist.get_rank(), size=size, device=device, backend=backend)


def row_range(mesh: RayMesh, resolution: int):
    """This rank's rows [lo, hi) of a ``resolution``-row framebuffer."""
    if resolution % mesh.size:
        raise ValueError(f"{resolution} rows do not split over {mesh.size} ranks")
    rows = resolution // mesh.size
    return mesh.rank * rows, (mesh.rank + 1) * rows


def lane_tables(mesh: RayMesh, resolution: int, streams: int):
    """This rank's lanes as an int32 lane table (ix, iy, seed_iy), each
    (streams * rows, resolution): stream s's rows follow stream s-1's, iy
    is the global row and seed_iy = iy + s * resolution, as the pixel grid
    of one device seeds them."""
    lo, hi = row_range(mesh, resolution)
    shape = (streams, hi - lo, resolution)
    dev = mesh.device
    s = torch.arange(streams, dtype=torch.int32, device=dev).view(-1, 1, 1).expand(shape)
    iy = torch.arange(lo, hi, dtype=torch.int32, device=dev).view(1, -1, 1).expand(shape)
    ix = torch.arange(resolution, dtype=torch.int32, device=dev).view(1, 1, -1).expand(shape)
    flat = (streams * (hi - lo), resolution)
    return (ix.reshape(flat).contiguous(), iy.reshape(flat).contiguous(),
            (iy + s * resolution).reshape(flat).contiguous())


def _check_tensor(mesh: RayMesh, t: torch.Tensor):
    if t.device.type != mesh.device.type:
        raise ValueError(f"a {mesh.backend} mesh on {mesh.device} got a tensor on {t.device}")
    if t.is_cuda and mesh.backend != "nccl":
        raise ValueError(f"the {mesh.backend} backend takes no CUDA tensors")


def all_gather(t: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in rank order."""
    _check_tensor(mesh, t)
    out = torch.empty((mesh.size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=mesh.group)
    COLLECTIVES["all_gather"] += 1
    return out


def reduce_scatter(t: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """The sum over ranks of ``t``, whose dim 0 holds ``size`` equal
    segments; rank r receives segment r."""
    _check_tensor(mesh, t)
    if t.shape[0] % mesh.size:
        raise ValueError(f"{t.shape[0]} rows do not split over {mesh.size} ranks")
    out = torch.empty((t.shape[0] // mesh.size,) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, t.contiguous(), group=mesh.group)
    COLLECTIVES["reduce_scatter"] += 1
    return out


def halo_from_next(plane: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """Rank r + 1's ``plane`` on rank r, zeros on the last rank: JAX's
    ``ppermute`` over the pairs (i, i - 1), as one all-gather of the plane
    (the simplest form both gloo and NCCL run)."""
    _check_tensor(mesh, plane)
    out = torch.empty((mesh.size,) + tuple(plane.shape), dtype=plane.dtype, device=plane.device)
    dist.all_gather_into_tensor(out, plane.reshape((1,) + tuple(plane.shape)).contiguous(),
                                group=mesh.group)
    COLLECTIVES["halo"] += 1
    return out[mesh.rank + 1] if mesh.rank + 1 < mesh.size else torch.zeros_like(plane)


def all_reduce(t: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """The sum over ranks of ``t`` (JAX ``psum``), a new tensor on every
    rank."""
    _check_tensor(mesh, t)
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    COLLECTIVES["all_reduce"] += 1
    return out


def gather_rows(t: torch.Tensor, mesh: RayMesh, axis: int = 0) -> torch.Tensor:
    """Every rank's rows of ``t`` along ``axis`` concatenated in rank
    order: the global array that JAX's row-sharded array reads as (axis 0
    for an (H, W, 3) image, ``ndim - 2`` for a lane leaf)."""
    _check_tensor(mesh, t)
    moved = t.movedim(axis, 0).contiguous()
    out = torch.empty((mesh.size * moved.shape[0],) + tuple(moved.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, moved, group=mesh.group)
    COLLECTIVES["gather_rows"] += 1
    return out.movedim(0, axis).contiguous()


def _row_axis(t: torch.Tensor):
    """A lane leaf's framebuffer row axis (``ndim - 2``: (H, W), (S, H, W),
    (B, H, W) and (B, S, H, W) alike), or None for a leaf under 2-D."""
    return t.ndim - 2 if t.ndim >= 2 else None


def shard_spectral_state(state, mesh: RayMesh):
    """This rank's rows of every lane leaf of a (global) ``SpectralState``,
    new tensors on the mesh's device (the renders update a state in place);
    leaves under 2-D are kept whole (replicated)."""
    fields = {}
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        axis = _row_axis(t)
        if axis is not None:
            lo, hi = row_range(mesh, t.shape[axis])
            t = t.narrow(axis, lo, hi - lo)
        fields[f.name] = t.to(mesh.device).clone(memory_format=torch.contiguous_format)
    return type(state)(**fields)


def gather_spectral_state(state, mesh: RayMesh):
    """The global ``SpectralState`` from every rank's rows
    (``shard_spectral_state``'s inverse), on every rank."""
    fields = {}
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        axis = _row_axis(t)
        fields[f.name] = t.clone() if axis is None else gather_rows(t, mesh, axis)
    return type(state)(**fields)


def shard_ctx(ctx, mesh: RayMesh):
    """The scene is replicated: every tensor of ``ctx`` on this rank's
    device (host scalars as they are)."""
    out = {}
    for f in dataclasses.fields(ctx):
        v = getattr(ctx, f.name)
        if torch.is_tensor(v):
            v = v.to(mesh.device)
        elif isinstance(v, PackedVolume):
            v = dataclasses.replace(v, table=v.table.to(mesh.device))
        out[f.name] = v
    return type(ctx)(**out)
