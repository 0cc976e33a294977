"""Slab-sharded volumes, the forward: counterpart of
``vpt_tpu/parallel/slab.py``'s ``pad_packed_for_slabs``,
``shard_packed_volume``, ``_distributed_rows`` and ``render_slab``.

The full packed corner table (D+1, H+1, W+1, 8) splits along z into equal
slabs, one a rank of the ray mesh (``parallel/mesh.py``), so no rank holds
the whole table. A Woodcock step's volume lookup becomes a routed gather:

    1. all-gather every rank's flat row requests       (n * N int32)
    2. each owner takes the requested rows of its slab, dequantized, and
       zeroes the rest                                  (K26 ``slab_rows``)
    3. reduce-scatter sums over the owners and hands each rank back the
       rows of its own lanes                            (N x 8 f32)

Each row has exactly one owner, so the sum is exact and a slab render is
bit-identical to the replicated render. Everything else in the step is per
lane; the majorant grid and the environment map stay replicated.

A step runs as K27 ``slab_advance``, the all-gather, K26, the
reduce-scatter and K28 ``slab_finish`` (``kernels/slab.py``; on CPU tensors
each wrapper runs its plain version), so it makes exactly one all-gather and
one reduce-scatter (``mesh.COLLECTIVES``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vpt_tpu_torch.kernels import slab as KS
from vpt_tpu_torch.models.mcm_spectral import radiance_to_rgb
from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.parallel import mesh as Mesh


def pad_packed_for_slabs(packed: np.ndarray, n_devices: int) -> np.ndarray:
    """Zero-pad the packed corner table's z dim to a multiple of n_devices
    (pad rows are never addressed: base indices stay within the original)."""
    Dp = packed.shape[0]
    pad = (-Dp) % n_devices
    if pad:
        packed = np.concatenate(
            [packed, np.zeros((pad,) + packed.shape[1:], packed.dtype)], axis=0
        )
    return packed


def shard_packed_volume(packed, mesh: Mesh.RayMesh) -> interp.PackedVolume:
    """This rank's z-slab of the (padded) packed table (Dp', Hp, Wp, 8), a
    numpy array or a tensor, u8 or f32 as given, as a full-kind
    ``PackedVolume`` of dims (Dp' / n, Hp, Wp) on the mesh's device (a
    tensor already there, at world size 1, is used as it is)."""
    if not torch.is_tensor(packed):
        packed = np.asarray(packed)
    if packed.ndim != 4 or packed.shape[-1] != 8:
        raise ValueError(f"a packed corner table is (Dp, Hp, Wp, 8), got {tuple(packed.shape)}")
    if packed.shape[0] % mesh.size:
        raise ValueError(f"{packed.shape[0]} z rows do not split over {mesh.size} ranks "
                         "(pad_packed_for_slabs)")
    slab_z = packed.shape[0] // mesh.size
    part = packed[mesh.rank * slab_z:(mesh.rank + 1) * slab_z].reshape(-1, 8)
    table = torch.as_tensor(part, device=mesh.device).contiguous()
    return interp.PackedVolume(table, (slab_z,) + tuple(packed.shape[1:3]), "full")


def distributed_rows(slab: torch.Tensor, flat_idx: torch.Tensor, mesh: Mesh.RayMesh):
    """The routed gather: (N, 8) f32 rows of the global table at this
    rank's (N,) int32 flat row requests (-1: none, a zero row), from every
    rank's (rows, 8) slab. All-gather, K26, reduce-scatter."""
    lo = mesh.rank * slab.shape[0]
    all_idx = Mesh.all_gather(flat_idx, mesh)
    return Mesh.reduce_scatter(KS.slab_rows(slab, lo, all_idx), mesh)


def _check(state, ctx, mesh, volume_dims):
    KS.check_layout(ctx)
    D, H, W = (int(d) for d in volume_dims)
    slab_z, Hp, Wp = ctx.density.dims
    if (Hp, Wp) != (H + 1, W + 1) or slab_z * mesh.size < D + 1:
        raise ValueError(f"a slab of dims {ctx.density.dims} over {mesh.size} ranks is no z-slab "
                         f"of the ({D + 1}, {H + 1}, {W + 1}) corner table")
    if state.px.ndim not in (2, 3):
        raise ValueError(f"lane shape must be (rows, W) or (S, rows, W), got {tuple(state.px.shape)}")


def render_slab(state, ctx, mesh: Mesh.RayMesh, volume_dims, steps: int, n_bins: int,
                volume_filter: str = "linear"):
    """One spectral render dispatch with the volume slab-sharded.

    ``ctx.density`` is this rank's slab (``shard_packed_volume``),
    ``volume_dims`` the original (D, H, W); ``state`` this rank's rows
    (``mesh.shard_spectral_state``), updated in place; the frame seed is
    ``ctx.seed_bits``. Returns (state, the global (H, W, 3) image on every
    rank), bit-identical to ``render`` over the replicated volume."""
    if ctx.volume_filter != volume_filter:
        ctx = dataclasses.replace(ctx, volume_filter=volume_filter)
    _check(state, ctx, mesh, volume_dims)
    resolution = state.px.shape[-1]
    streams = state.px.shape[0] if state.px.ndim == 3 else 1
    if state.px.shape[-2] * mesh.size != resolution:
        raise ValueError(f"a state of {state.px.shape[-2]} rows is not 1/{mesh.size} of a "
                         f"{resolution}-row framebuffer")
    lanes = Mesh.lane_tables(mesh, resolution, streams)
    rng = torch.empty(state.px.numel(), dtype=torch.int32, device=state.px.device)
    for it in range(steps):
        idx, frac, dist, maj = KS.slab_advance(state, ctx, lanes, ctx.seed_bits, it == 0, rng,
                                               volume_dims, n_bins)
        rows = distributed_rows(ctx.density.table, idx, mesh)
        KS.slab_finish(state, ctx, lanes, rows, frac, dist, maj, idx, rng, n_bins, volume_dims)
    return state, Mesh.gather_rows(radiance_to_rgb(state.radiance, ctx.bin_xyz), mesh)

