"""Slab-sharded volumes, the forward and the PRB backward with its
optimizer: counterpart of ``vpt_tpu/parallel/slab.py``.

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
one reduce-scatter (``mesh.COLLECTIVES``); ``render_slab`` is one dispatch
of such steps.

The backward (``prb_grads_slab``, ``prb_window_grads_slab``) is the packed
PRB backward of ``kernels/spectral_backward.py`` with density gradients
only, cut as the forward is: no rank ever holds the whole packed adjoint.

    - the taped dispatch: the same step loop, K27 asking for every lane's
      row and K28 in TAPE mode writing K4's tape row (the global row in
      ``vol_row0``);
    - per dispatch, one K5 launch in ROUTED mode appends each scattering
      lane-step's nonzero volume row to a pair list as a (slot id, global
      row, 8 values) pair instead of adding it; one all-gather of the
      lists (their whole capacity, as JAX's fixed-size gather moves every
      slot); K29 ``slab_scatter`` adds the pairs each rank owns, up to each
      list's count, into its (rows / n, 8) adjoint slab (the transpose of
      the routed gather);
    - per backward, K30 ``slab_contract`` transposes the rank's slab of the
      packing into its (slab_z + 1, H, W) partial of the raw gradient; its
      first plane goes to the rank before (one ``halo_from_next``), and
      the z-sharded gradient is gathered to every rank (one ``gather_rows``).

A window of K dispatches therefore makes K * steps all-gathers and
reduce-scatters in its untaped forward, as many in its taped re-simulation,
K pair all-gathers and K K29 launches, and one halo and one gradient gather.
The optimizer (``make_spectral_prb_step_slab``, ``fit_spectral_slab``)
keeps the raw (D, H, W) density and the Adam moments replicated; each rank
packs only its slab of the f32 table from them (K31 ``slab_pack``) every
step, and the loss is one ``all_reduce``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vpt_tpu_torch import optim
from vpt_tpu_torch.kernels import slab as KS
from vpt_tpu_torch.kernels import spectral_backward as SB
from vpt_tpu_torch.models.mcm_spectral import radiance_to_rgb
from vpt_tpu_torch.ops import interp, sampling
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


def _lanes(state, mesh):
    """This rank's lane table, after checking the state is its rows."""
    resolution = state.px.shape[-1]
    streams = state.px.shape[0] if state.px.ndim == 3 else 1
    if state.px.shape[-2] * mesh.size != resolution:
        raise ValueError(f"a state of {state.px.shape[-2]} rows is not 1/{mesh.size} of a "
                         f"{resolution}-row framebuffer")
    return Mesh.lane_tables(mesh, resolution, streams)


def _dispatch(state, ctx, mesh, volume_dims, steps, n_bins, seed, lanes, tape=None, fields=None):
    """One dispatch of ``steps`` slab steps from ``state`` (updated in
    place) with frame seed ``seed``; with ``tape`` ((steps, F, N) f32) the
    taped steps, which write the tape rows of ``fields``."""
    rng = torch.empty(state.px.numel(), dtype=torch.int32, device=state.px.device)
    for it in range(steps):
        idx, frac, dist, maj = KS.slab_advance(state, ctx, lanes, seed, it == 0, rng,
                                               volume_dims, n_bins, tape=tape is not None)
        rows = distributed_rows(ctx.density.table, idx, mesh)
        KS.slab_finish(state, ctx, lanes, rows, frac, dist, maj, idx, rng, n_bins, volume_dims,
                       tape=None if tape is None else tape[it], fields=fields)
    return state


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
    _dispatch(state, ctx, mesh, volume_dims, steps, n_bins, ctx.seed_bits, _lanes(state, mesh))
    return state, Mesh.gather_rows(radiance_to_rgb(state.radiance, ctx.bin_xyz), mesh)


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------
WRT = frozenset({"density"})


def distributed_scatter_add(adj_slab: torch.Tensor, flat_idx: torch.Tensor,
                            updates: torch.Tensor, mesh: Mesh.RayMesh) -> torch.Tensor:
    """The routed adjoint scatter (JAX ``_distributed_scatter_add``), the
    exact transpose of ``distributed_rows``: every rank's (N,) int32 global
    rows ``flat_idx`` (-1: none) and (N, 8) f32 ``updates`` become a pair
    list in slot order (the slot id the index in ``flat_idx``, the -1 rows
    left out), the lists are gathered, and each rank adds the pairs it owns
    into its (rows, 8) ``adj_slab`` (K29), in place. Returns ``adj_slab``."""
    pairs = SB.pair_buffer(flat_idx.numel(), flat_idx.device)
    slot = torch.nonzero(flat_idx >= 0)[:, 0]
    SB.append_pairs(pairs, slot.to(torch.int32), flat_idx[slot], updates[slot])
    return scatter_pairs(adj_slab, pairs, mesh)


def scatter_pairs(adj_slab: torch.Tensor, pairs: torch.Tensor, mesh: Mesh.RayMesh):
    """One all-gather of every rank's pair buffer, then K29 into this
    rank's adjoint slab (global rows [rank * rows, (rank + 1) * rows))."""
    return KS.slab_scatter(adj_slab, mesh.rank * adj_slab.shape[0], Mesh.all_gather(pairs, mesh),
                           mesh.size)


def contract_slab_adjoint(adj_slab: torch.Tensor, volume_dims, mesh: Mesh.RayMesh):
    """Every rank's (slab_z * (H+1) * (W+1), 8) slab of the packed density
    adjoint to the raw (D, H, W) gradient, on every rank (JAX
    ``_contract_slab_adjoint`` and the gather of its z-sharded result): K30,
    the halo plane from the rank after, one gather."""
    D, H, W = (int(d) for d in volume_dims)
    slab_z = adj_slab.shape[0] // ((H + 1) * (W + 1))
    part = KS.slab_contract(adj_slab, mesh.rank * slab_z, slab_z, volume_dims)
    halo = Mesh.halo_from_next(part[0], mesh)
    out = part[1:]
    out[slab_z - 1] += halo
    return Mesh.gather_rows(out, mesh, 0)[:D]


def pack_slab_rows(raw: torch.Tensor, mesh: Mesh.RayMesh) -> interp.PackedVolume:
    """This rank's z-slab of the f32 corner table of the replicated raw (D,
    H, W) grid (JAX ``_pack_slab_rows``, K31), as ``shard_packed_volume``
    gives it from the padded table: D + 1 planes padded over the ranks, the
    planes past D zero."""
    D, H, W = raw.shape
    slab_z = -(-(D + 1) // mesh.size)
    table = KS.slab_pack(raw.contiguous(), mesh.rank * slab_z, slab_z)
    return interp.PackedVolume(table, (slab_z, H + 1, W + 1), "full")


def _backward_ctx(state, ctx, mesh, volume_dims, volume_filter):
    """The ctx the slab backward renders with, checked as the packed
    backward checks its ctx (``spectral_backward.packed_ctx``) and as
    ``render_slab`` checks its slab."""
    ctx = SB.packed_ctx(ctx, volume_filter)
    _check(state, ctx, mesh, volume_dims)
    return ctx


def tape_slab_dispatch(state, ctx, mesh: Mesh.RayMesh, volume_dims, steps: int, n_bins: int,
                       seed: int, fields, lanes=None):
    """The taped slab dispatch from ``state`` (untouched) with frame seed
    ``seed``: (state_out, tape (1, steps, F, N) f32) of this rank's lanes,
    the tape K4 writes (``fields``; ``vol_row0`` the global row)."""
    lanes = _lanes(state, mesh) if lanes is None else lanes
    out = SB.clone_state(state)
    tape = torch.empty((1, steps, len(fields), out.px.numel()), dtype=torch.float32,
                       device=out.px.device)
    _dispatch(out, ctx, mesh, volume_dims, steps, n_bins, seed, lanes, tape[0], fields)
    return out, tape


def _rows(t: torch.Tensor, mesh: Mesh.RayMesh):
    """This rank's rows of a global (H, W, ...) image."""
    lo, hi = Mesh.row_range(mesh, t.shape[0])
    return t[lo:hi]


class _Reverse:
    """The slab backward's adjoint slab and (c, cb) carry, and its routed
    reverse of one taped dispatch: K5 ROUTED, the pairs' all-gather, K29."""

    def __init__(self, state, ctx, mesh, g_rows, m_final, n_bins, stride, mode, lanes):
        self.ctx, self.mesh, self.lanes = ctx, mesh, lanes
        self.fields = SB.ctx_tape_fields(ctx, WRT)
        lane, self.resolution, self.streams, n = SB._lanes(state)
        self.g_rs = SB._deposit_cotangents(g_rows, ctx, lane, n_bins, m_final)
        self.stride, self.mode = max(int(stride), 1), mode
        dev = state.px.device
        self.adj = torch.zeros((ctx.density.table.shape[0], 8), dtype=torch.float32, device=dev)
        self.cot = dict(c=torch.zeros(n, dtype=torch.float32, device=dev),
                        cb=torch.zeros(n, dtype=torch.float32, device=dev))

    def __call__(self, tape, seed: int, phase: int):
        steps, n = tape.shape[1], tape.shape[3]
        pairs = SB.pair_buffer(steps // self.stride * n, tape.device)
        SB.prb_reverse(tape, self.fields, self.g_rs, self.cot, {}, [phase], [seed],
                       scatter_stride=self.stride, scatter_mode=self.mode,
                       inv_mu=SB._inv_mu(self.ctx), resolution=self.resolution,
                       streams=self.streams, lanes=self.lanes, pairs=pairs)
        scatter_pairs(self.adj, pairs, self.mesh)


def prb_grads_slab(state, ctx, mesh: Mesh.RayMesh, volume_dims, g_image, steps: int,
                   n_bins: int, volume_filter: str = "linear", scatter_stride: int = 1,
                   scatter_mode: str = "stride"):
    """Packed-PRB density gradients of one render dispatch (frame seed
    ``ctx.seed_bits``) with the volume slab-sharded: the taped slab
    dispatch, one routed reverse (K5 ROUTED, the pairs' all-gather, K29)
    and the distributed contraction. ``ctx.density``: this rank's slab;
    ``state``: this rank's rows (untouched); ``g_image``: the global (H, W,
    3) image cotangent on every rank. Returns (state_out, the global image,
    {"density": (D, H, W)}) on every rank, close to
    ``prb_render_and_grads(wrt={"density"})`` over the replicated table."""
    ctx = _backward_ctx(state, ctx, mesh, volume_dims, volume_filter)
    lanes = _lanes(state, mesh)
    seed = int(ctx.seed_bits)
    fields = SB.ctx_tape_fields(ctx, WRT)
    state_out, tape = tape_slab_dispatch(state, ctx, mesh, volume_dims, steps, n_bins, seed,
                                         fields, lanes)
    rev = _Reverse(state, ctx, mesh, _rows(g_image, mesh), SB._m_final(state_out), n_bins,
                   scatter_stride, scatter_mode, lanes)
    rev(tape, seed, seed % rev.stride)
    image = Mesh.gather_rows(radiance_to_rgb(state_out.radiance, ctx.bin_xyz), mesh)
    return state_out, image, {"density": contract_slab_adjoint(rev.adj, volume_dims, mesh)}


def _window(state, ctx, mesh, volume_dims, seeds, steps, n_bins, scatter_stride, scatter_mode,
            cotangent):
    """The K-dispatch window backward (JAX ``prb_window_grads_slab``'s
    schedule): untaped dispatches storing each start state, then in reverse
    dispatch order a taped re-simulation and one routed reverse each, the
    carry threaded across dispatches and the window-final normalizer;
    ``cotangent(image_rows)`` gives this rank's rows of the image
    cotangent. Returns (state_f, this rank's image rows, the packed adjoint
    slab)."""
    lanes = _lanes(state, mesh)
    seeds = SB._seeds(seeds)
    st = SB.clone_state(state)
    starts = []
    for seed in seeds:
        starts.append(SB.clone_state(st))
        _dispatch(st, ctx, mesh, volume_dims, steps, n_bins, seed, lanes)
    image_rows = radiance_to_rgb(st.radiance, ctx.bin_xyz)
    rev = _Reverse(state, ctx, mesh, cotangent(image_rows), SB._m_final(st), n_bins,
                   scatter_stride, scatter_mode, lanes)
    fields = SB.ctx_tape_fields(ctx, WRT)
    for k in range(len(seeds) - 1, -1, -1):
        _, tape = tape_slab_dispatch(starts[k], ctx, mesh, volume_dims, steps, n_bins, seeds[k],
                                     fields, lanes)
        starts[k] = None
        rev(tape, seeds[k], SB._dispatch_phase(k, seeds[k], len(seeds), rev.stride))
    return st, image_rows, rev.adj


def prb_window_grads_slab(state, ctx, mesh: Mesh.RayMesh, volume_dims, seeds, g_image,
                          steps: int, n_bins: int, volume_filter: str = "linear",
                          scatter_stride: int = 1, scatter_mode: str = "stride"):
    """K-dispatch window packed-PRB density gradients with the volume
    slab-sharded, the slab form of ``prb_render_and_grads_many(window=True,
    window_storage="forward")``: ``seeds`` the dispatches' frame seeds
    (``ctx.seed_bits`` ignored); the adjoint stays a (rows / n, 8) slab a
    rank for the whole window and contracts once. Returns (state_f, the
    global image, {"density": (D, H, W)}) on every rank."""
    ctx = _backward_ctx(state, ctx, mesh, volume_dims, volume_filter)
    st, image_rows, adj = _window(state, ctx, mesh, volume_dims, seeds, steps, n_bins,
                                  scatter_stride, scatter_mode, lambda _: _rows(g_image, mesh))
    return (st, Mesh.gather_rows(image_rows, mesh),
            {"density": contract_slab_adjoint(adj, volume_dims, mesh)})


def make_spectral_prb_step_slab(optimizer: optim.Adam, mesh: Mesh.RayMesh, volume_dims,
                                steps: int, n_bins: int, resolution: int, streams: int = 1,
                                scatter_stride: int = 1, scatter_mode: str = "stride",
                                volume_filter: str = "linear", grad_clip: float = 1e3):
    """An Adam step recovering the density through the slab window backward
    (JAX ``make_spectral_prb_step_slab``): ``step(istate, state0, ctx,
    seeds, target) -> (istate, loss)``. ``istate.params["density"]``: the
    replicated raw (D, H, W) f32 grid, of which each rank packs its slab
    (K31); ``ctx``: the renderer's ctx with the fused TF (its density is
    not read); ``state0``: this rank's rows (untouched); ``target``: the
    global (H, W, 3) image. The loss is the squared error summed over the
    ranks (one all-reduce) over the global pixel count; the density is
    clipped to [0, 1] after the update."""
    numel = float(resolution * resolution * 3)

    def step(istate: optim.InverseState, state0, ctx, seeds, target):
        with torch.no_grad():
            sctx = dataclasses.replace(ctx, density=pack_slab_rows(istate.params["density"],
                                                                   mesh))
            sctx = _backward_ctx(state0, sctx, mesh, volume_dims, volume_filter)
            tgt = _rows(target, mesh)
            loss = []

            def cotangent(image_rows):
                diff = image_rows - tgt
                loss.append(Mesh.all_reduce(torch.sum(diff * diff).reshape(1), mesh)[0] / numel)
                return sampling.div_scalar(2.0 * diff, numel)

            _, _, adj = _window(state0, sctx, mesh, volume_dims, seeds, steps, n_bins,
                                scatter_stride, scatter_mode, cotangent)
            grads = {"density": contract_slab_adjoint(adj, volume_dims, mesh)}
            if grad_clip is not None:
                grads = optim.sanitize_grads(grads, grad_clip)
            params, opt_state = optimizer.update(grads, istate.opt_state, istate.params)
            params = dict(params, density=torch.clamp(params["density"], 0.0, 1.0))
        return optim.InverseState(params, opt_state, istate.step + 1), loss[0]

    return step


def fit_spectral_slab(target_image, renderer, camera, init_density, mesh: Mesh.RayMesh,
                      dispatches_per_step: int = 8, iterations: int = 50,
                      learning_rate: float = 0.02, seed: int = 0, scatter_stride: int = 1,
                      scatter_mode: str = "stride", progress=None):
    """Slab-sharded density recovery (JAX ``fit_spectral_slab``), like
    ``optim.fit_spectral(method="prb")`` learning the density alone, with
    the packed table slab-sharded over ``mesh``. ``renderer``: an
    ``MCMSpectralRenderer`` with the fused TF
    (``pack_tables={"material_tf", "light_spectrum"}``), best built with
    ``mesh=mesh`` (a renderer without one has its reset state split here).
    The stride and mode stay as given. Returns (params, losses)."""
    base_ctx = renderer.ctx(camera, seed)
    if base_ctx.material_tf.shape[-1] != 18:
        raise AssertionError("fit_spectral_slab needs the fused TF "
                             "(pack_tables={'material_tf','light_spectrum'})")
    state0 = renderer.reset(camera, seed)
    if state0.px.shape[-2] != renderer.resolution // mesh.size:
        state0 = Mesh.shard_spectral_state(state0, mesh)
    params = {"density": optim._tensor(init_density, mesh.device).clone()}
    dims = tuple(params["density"].shape)
    optimizer = optim.Adam(learning_rate)
    istate = optim.InverseState(params, optimizer.init(params), 0)
    step = make_spectral_prb_step_slab(
        optimizer, mesh, dims, renderer.config.steps, renderer.spectrum.n_bins,
        renderer.resolution, streams=renderer.streams, scatter_stride=scatter_stride,
        scatter_mode=scatter_mode, volume_filter=renderer.volume.filter)
    target = optim._tensor(target_image, mesh.device)
    losses = []
    for i in range(iterations):
        seeds = optim._frame_seeds(seed + 1 + i * dispatches_per_step, dispatches_per_step)
        istate, loss = step(istate, state0, base_ctx, seeds, target)
        losses.append(float(loss))
        if progress is not None and (i % 10 == 0 or i == iterations - 1):
            progress(i, losses[-1])
    return istate.params, losses

