"""The slab-sharded render's and backward's kernels: wrappers, plain
versions, launch counts.

Three kernels of ``vpt_tpu_torch/csrc/slab.cu`` run once each per Woodcock
step of ``parallel/slab.render_slab`` on a CUDA device (K27, all-gather,
K26, reduce-scatter, K28):

- ``slab_rows`` (K26): the owner side of the routed gather (replaces the
  owner's take, dequantization and mask in
  ``vpt_tpu/parallel/slab.py::_distributed_rows``, :64-86); plain version
  ``slab_rows_plain``.
- ``slab_advance`` (K27): the free flight of K1's step and the address of
  its one volume lookup (the first half of ``_render_body`` under
  ``render_slab``, :680-688); plain version ``slab_advance_plain``.
- ``slab_finish`` (K28): the lookup's lerp from the routed row and the
  rest of the step; plain version ``slab_finish_plain``.

The slab backward's taped step runs K27 with ``tape=True`` (every lane
requests its row, out of bounds too, as the taped step looks up every lane)
and K28's TAPE mode, which writes the lane-step's PRB tape row as K4 writes
it (``kernels/spectral_backward.py::TAPE_FIELDS``; its plain version builds
the row with ``_tape_row``). Three more kernels serve the backward
(``parallel/slab.py``):

- ``slab_scatter`` (K29): the owner side of the routed adjoint scatter, the
  transpose of K26 (``vpt_tpu/parallel/slab.py::_distributed_scatter_add``,
  :120-137): every rank's pair list (``spectral_backward.pair_buffer``),
  gathered, its first ``count`` (row, 8 values) pairs added into this rank's
  adjoint slab where it owns the row; plain version ``slab_scatter_plain``.
- ``slab_contract`` (K30): this rank's share of the packed adjoint's
  transpose (``_contract_slab_adjoint``, :160-209), the (slab_z + 1, H, W)
  partial with both folds; plain version ``slab_contract_plain``.
- ``slab_pack`` (K31): this rank's z-slab of the f32 corner table from the
  raw grid (``_pack_slab_rows``, :405-428); plain version
  ``slab_pack_plain``.

The handoff between K27 and K28 is a step's (N,) int32 row requests (-1
where the lane looks nothing up: the flight left the volume or hit its
majorant cap), the (3, N) fractions (warped under the quasicubic filter),
the (N,) flight, the (N,) local majorant (majorant mode, else None), and the
lanes' RNG words, an (N,) int32 tensor of uint32 bits updated in place.
Lanes are given as the int32 lane table (ix, iy, seed_iy) of the state's
lanes (``parallel/mesh.lane_tables``), iy the global row.

Each wrapper runs its plain version when its tensors lie on the CPU, and
launches its kernel when they lie on a CUDA device; anything else raises.
``LAUNCHES`` counts kernel launches (never plain runs); K27 and K28 also
count under each mode they ran.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.kernels import spectral_backward as SB
from vpt_tpu_torch.ops import geometry, interp, sampling

LAUNCHES = {"slab_rows": 0, "slab_rows_u8": 0, "slab_advance": 0, "slab_finish": 0,
            "slab_advance_majorant": 0, "slab_finish_majorant": 0,
            "slab_finish_environment": 0, "slab_advance_quasicubic": 0,
            "slab_advance_tape": 0, "slab_finish_tape": 0, "slab_scatter": 0,
            "slab_contract": 0, "slab_pack": 0}

STATE_FIELDS = K.STATE_FIELDS[:11]  # the fields a step reads and writes


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_layout(ctx):
    """The slab render's tables: a full packed volume (u8 or f32), the
    fused TF+light table and, if any, a packed environment map; the xy
    half-packed volume and raw or partly packed tables raise."""
    vol = ctx.density
    if not isinstance(vol, interp.PackedVolume) or vol.kind != "full":
        raise ValueError("the slab render shards the full packed corner table; an xy or raw "
                         "volume has no slab form")
    if K.is_raw(ctx):
        raise ValueError("the slab render reads the fused TF+light table and a packed "
                         "environment map, not raw or partly packed tables")
    if ctx.volume_filter not in ("linear", "quasicubic"):
        raise ValueError(f"volume filter {ctx.volume_filter!r} needs a raw grid")


def _u32(rng: torch.Tensor) -> torch.Tensor:
    """int32 bits -> the uint32 values (int64) the plain hash chain holds."""
    return rng.to(torch.int64) & sampling.MASK32


def _store_u32(dst: torch.Tensor, words: torch.Tensor):
    dst.copy_(torch.where(words >= 2**31, words - 2**32, words).to(torch.int32))


def _fields(state):
    """The state's step fields at its lane shape (the plain respawn reads
    the resolution from the lanes' last axis)."""
    return {k: getattr(state, k) for k in STATE_FIELDS}


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def slab_rows_plain(slab: torch.Tensor, lo: int, req: torch.Tensor) -> torch.Tensor:
    """Plain ``slab_rows``: (n, 8) f32, the dequantized row ``req - lo`` of
    the (rows, 8) u8|f32 ``slab`` where 0 <= req - lo < rows (req >= 0), +0.0
    elsewhere. Dequantized before masking, as JAX's ``_distributed_rows``."""
    rows = slab.shape[0]
    local = req.to(torch.int64) - int(lo)
    owned = (req >= 0) & (local >= 0) & (local < rows)
    got = interp.dequantize_rows(slab[local.clamp(0, max(rows - 1, 0))])
    return torch.where(owned[:, None], got, torch.zeros((), dtype=torch.float32, device=got.device))


def lookup_rows(volume_dims, volume_filter: str, px, py, pz):
    """A lookup's flat row in the global (D+1, H+1, W+1) corner table and
    its fractions, warped under the quasicubic filter (the address of
    ``interp.sample_volume_packed``)."""
    D, H, W = (int(d) for d in volume_dims)
    row, _, fx, fy, fz = interp.volume_rows((D + 1, H + 1, W + 1), px, py, pz)
    if volume_filter == "quasicubic":
        fx, fy, fz = (interp.quasicubic_warp(f) for f in (fx, fy, fz))
    return row, fx, fy, fz


def lerp_rows(rows, fx, fy, fz):
    """The trilinear lerp of (N, 8) corner rows, in the packed lookup's order."""
    c = [rows[..., k] for k in range(8)]
    c00 = c[0] + (c[1] - c[0]) * fx
    c01 = c[2] + (c[3] - c[2]) * fx
    c10 = c[4] + (c[5] - c[4]) * fx
    c11 = c[6] + (c[7] - c[6]) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    return c0 + (c1 - c0) * fz


def slab_advance_plain(state, ctx, lanes, seed: int, first: bool, rng: torch.Tensor,
                       volume_dims, tape: bool = False):
    """Plain ``slab_advance``: (idx, frac, dist, maj); ``rng`` updated in
    place (seeded from the lane table and ``seed`` when ``first``); with
    ``tape`` every lane requests its row."""
    lane = state.px.shape
    ix, _, seed_iy = (t.reshape(lane).to(torch.int64) for t in lanes)
    words = sampling.seed_state(ix, seed_iy, int(seed)) if first else _u32(rng).reshape(lane)
    p = _fields(state)
    words, dist, maj, capped = K.free_flight(p, words, ctx)
    px, py, pz, oob = K.sample_position(p, dist)
    row, fx, fy, fz = lookup_rows(volume_dims, ctx.volume_filter, px, py, pz)
    look = ~oob if capped is None else ~oob & ~capped
    if tape:
        look = torch.ones_like(oob)
    zero = torch.zeros((), dtype=torch.float32, device=dist.device)
    idx = torch.where(look, row, -1).to(torch.int32).reshape(-1)
    frac = torch.stack([torch.where(look, f, zero).reshape(-1) for f in (fx, fy, fz)])
    _store_u32(rng, words.reshape(-1))
    return idx, frac, dist.reshape(-1), None if maj is None else maj.reshape(-1)


def slab_finish_plain(state, ctx, lanes, rows, frac, dist, maj, idx, rng, n_bins: int,
                      tape=None, fields=None, volume_dims=None):
    """Plain ``slab_finish``: the rest of the step from the routed (N, 8)
    ``rows``; updates ``state`` and ``rng`` in place and returns the state.
    ``tape``: the step's (F, N) tape rows of ``fields``, written as the
    taped step writes them (``spectral_backward._tape_row``; the volume row
    is the global one of ``volume_dims``' table)."""
    lane = state.px.shape
    ix, iy, _ = (t.reshape(lane).to(torch.int64) for t in lanes)
    sx, sy = geometry.screen_position(ix, iy, K._f32(np.float32(1.0) / np.float32(lane[-1])))
    p = _fields(state)
    dist = dist.reshape(lane)
    maj = None if maj is None else maj.reshape(lane)
    px, py, pz, oob = K.sample_position(p, dist)
    # K27 requested no row for a lane in bounds only where the flight hit its cap
    capped = None if maj is None else ~oob & (idx.reshape(lane) < 0)
    fx, fy, fz = (f.reshape(lane) for f in frac)
    dens = lerp_rows(rows.reshape(lane + (8,)), fx, fy, fz)
    light = K.light_terms(ctx.light_direction)
    got = K.after_lookup(p, _u32(rng).reshape(lane), sx, sy, ctx, n_bins, light, dist, maj,
                         capped, (px, py, pz), oob, dens, collect=tape is not None)
    out, words = got[0], got[1]
    if tape is not None:
        D, H, W = (int(d) for d in volume_dims)
        whole = dataclasses.replace(ctx, density=_TableDims((D + 1, H + 1, W + 1)))
        tape.copy_(SB._tape_row(got[2], fields, whole, light))
    for k, v in out.items():
        p[k].copy_(v)
    _store_u32(rng, words.reshape(-1))
    return state


@dataclasses.dataclass(frozen=True)
class _TableDims:
    """The addressing of the whole (D+1, H+1, W+1) corner table, which a
    tape row's volume row refers to (a rank holds only its slab)."""

    dims: tuple
    kind: str = "full"


def slab_scatter_plain(adj: torch.Tensor, lo: int, pairs: torch.Tensor, n_ranks: int):
    """Plain ``slab_scatter``: adds into the (rows, 8) ``adj`` the first
    ``count`` pairs of each of the ``n_ranks`` pair lists gathered in
    ``pairs`` (rank order) whose global row r has lo <= r < lo + rows, by
    one ``index_add_``; returns ``adj``."""
    rows = adj.shape[0]
    rows_of, values = [], []
    for block in pairs.view(int(n_ranks), -1):
        count, _, row, val = SB.pair_views(block)
        n = min(int(count[0]), row.numel())
        rows_of.append(row[:n].to(torch.int64))
        values.append(val[:n])
    idx, upd = torch.cat(rows_of), torch.cat(values)
    local = idx - int(lo)
    owned = (idx >= 0) & (local >= 0) & (local < rows)
    return adj.index_add_(0, local[owned], upd[owned])


def _unpad_transpose(a: torch.Tensor, bit: int, axis: int) -> torch.Tensor:
    """The transpose of one edge-padded axis (JAX ``_unpad_transpose``):
    packed length N + 1 along ``axis`` to raw length N, the clipped end
    folded back in."""
    n = a.shape[axis] - 1
    g = a.narrow(axis, 1 - bit, n).clone()
    edge, end = (0, 0) if bit == 0 else (n, n - 1)
    g.select(axis, end).add_(a.select(axis, edge))
    return g


def slab_contract_plain(adj: torch.Tensor, lo: int, slab_z: int, volume_dims) -> torch.Tensor:
    """Plain ``slab_contract``: this rank's (slab_z * (H+1) * (W+1), 8)
    adjoint slab (packed planes [lo, lo + slab_z)) to the (slab_z + 1, H, W)
    partial over raw planes [lo - 1, lo + slab_z - 1], JAX's
    ``_contract_slab_adjoint`` up to its halo: plane -1 folded into plane 0,
    planes >= D zeroed and their sum added at clip(D - lo, 0, slab_z)."""
    D, H, W = (int(d) for d in volume_dims)
    A = adj.reshape(slab_z, H + 1, W + 1, 8)
    B = [torch.zeros((slab_z, H, W), dtype=torch.float32, device=adj.device) for _ in range(2)]
    for c in range(8):
        g = _unpad_transpose(_unpad_transpose(A[..., c], (c >> 1) & 1, 1), c & 1, 2)
        B[c >> 2] = B[c >> 2] + g
    zero = torch.zeros((1, H, W), dtype=torch.float32, device=adj.device)
    L = torch.cat([B[0], zero]) + torch.cat([zero, B[1]])
    planes = int(lo) - 1 + torch.arange(slab_z + 1, device=adj.device)
    L[1] = L[1] + (L[0] if lo == 0 else torch.zeros_like(L[0]))
    hi = (planes >= D)[:, None, None]
    overflow = torch.where(hi, L, torch.zeros_like(L)).sum(0)
    L = torch.where(hi, torch.zeros_like(L), L)
    L[min(max(D - int(lo), 0), slab_z)] += overflow
    return L


def slab_pack_plain(raw: torch.Tensor, lo: int, slab_z: int) -> torch.Tensor:
    """Plain ``slab_pack``: packed planes [lo, lo + slab_z) of the f32
    corner table of the raw (D, H, W) grid, flat (slab_z * (H+1) * (W+1),
    8); planes z > D are zero (JAX ``_pack_slab_rows``)."""
    D, H, W = raw.shape
    zs = int(lo) + torch.arange(slab_z, device=raw.device)
    p0 = raw[(zs - 1).clamp(0, D - 1)]
    p1 = raw[zs.clamp(0, D - 1)]
    q0 = torch.nn.functional.pad(p0[None], (1, 1, 1, 1), mode="replicate")[0]
    q1 = torch.nn.functional.pad(p1[None], (1, 1, 1, 1), mode="replicate")[0]

    def c(q, by, bx):
        return q[:, by:by + H + 1, bx:bx + W + 1]

    packed = torch.stack([c(q0, 0, 0), c(q0, 0, 1), c(q0, 1, 0), c(q0, 1, 1),
                          c(q1, 0, 0), c(q1, 0, 1), c(q1, 1, 0), c(q1, 1, 1)], dim=-1)
    packed = torch.where((zs <= D)[:, None, None, None], packed, torch.zeros_like(packed))
    return packed.reshape(-1, 8).contiguous()


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def _lib():
    lib = _build.load()
    if tuple(lib.vpt_slab_layout(k) for k in range(4)) != (
            K.MAX_BINS, K._F_COUNT, K._I_COUNT, len(SB.TAPE_FIELDS)):
        raise RuntimeError("kernel library parameter layout does not match the wrapper")
    return lib


def slab_rows(slab: torch.Tensor, lo: int, req: torch.Tensor) -> torch.Tensor:
    """The owner side of the routed gather: (n, 8) f32 rows for the (n,)
    int32 requests ``req`` (global rows, -1 = none) from this rank's (rows,
    8) u8|f32 ``slab``, which holds the global rows [lo, lo + rows)."""
    if K._route(slab, req) == "cpu":
        return slab_rows_plain(slab, lo, req)
    if slab.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"slab: expected uint8 or float32, got {slab.dtype}")
    if slab.ndim != 2 or slab.shape[1] != 8:
        raise ValueError(f"slab must be (rows, 8), got {tuple(slab.shape)}")
    # a u8 row loads as one 8-byte word, an f32 row as two float4
    K._check(slab, "slab", slab.dtype, align=8 if slab.dtype == torch.uint8 else 16)
    K._check(req, "req", torch.int32, (req.numel(),))
    out = torch.empty((req.numel(), 8), dtype=torch.float32, device=slab.device)
    lib = _lib()
    with torch.cuda.device(slab.device):
        err = lib.vpt_slab_rows(slab.data_ptr(), int(slab.dtype == torch.uint8), int(lo),
                                slab.shape[0], req.data_ptr(), out.data_ptr(), req.numel(),
                                K._stream(slab.device))
    K._raise_on(err, "slab_rows")
    LAUNCHES["slab_rows"] += 1
    LAUNCHES["slab_rows_u8"] += int(slab.dtype == torch.uint8)
    return out


def _check_step(state, lanes, n_bins, rng):
    n = state.px.numel()
    for k in STATE_FIELDS:
        t = getattr(state, k)
        shape = (n_bins,) + tuple(state.px.shape) if k == "radiance" else tuple(state.px.shape)
        K._check(t, k, torch.int32 if k in K._INT_FIELDS else torch.float32, shape)
    for t, name in zip(lanes, ("lane_ix", "lane_iy", "lane_seed_iy")):
        K._check(t, name, torch.int32)
        if t.numel() != n:
            raise ValueError(f"{name}: {t.numel()} lanes for a state of {n}")
    K._check(rng, "rng", torch.int32, (n,))


def _step_params(state, ctx, n_bins, volume_dims):
    check_layout(ctx)
    K._check_tables(ctx)
    D, H, W = (int(d) for d in volume_dims)
    return K._params(ctx, state.px.shape[-1], 1, n_bins, n_lanes=state.px.numel(),
                     vol_dims=(D + 1, H + 1, W + 1))


def slab_advance(state, ctx, lanes, seed: int, first: bool, rng: torch.Tensor, volume_dims,
                 n_bins: int, tape: bool = False):
    """K27: the step's free flight and lookup address for every lane of
    ``state`` (this rank's lanes; ``ctx.density`` this rank's slab, which
    K27 does not read). Returns (idx, frac, dist, maj); updates ``rng``.
    ``tape`` (the taped step, no majorant grid): every lane requests its
    row."""
    if tape and ctx.majorant is not None:
        raise NotImplementedError(SB._MAJORANT_REFUSAL)
    tensors = [getattr(state, k) for k in STATE_FIELDS] + list(lanes) + [rng]
    if K._route(*tensors, *K._ctx_tensors(ctx)) == "cpu":
        return slab_advance_plain(state, ctx, lanes, seed, first, rng, volume_dims, tape)
    _check_step(state, lanes, n_bins, rng)
    f, i = _step_params(state, ctx, n_bins, volume_dims)
    n = state.px.numel()
    dev = state.px.device
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    frac = torch.empty((3, n), dtype=torch.float32, device=dev)
    dist = torch.empty(n, dtype=torch.float32, device=dev)
    maj = None if ctx.majorant is None else torch.empty(n, dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.vpt_slab_advance(
            f.ctypes.data, i.ctypes.data, *(getattr(state, k).data_ptr() for k in STATE_FIELDS[:6]),
            lanes[0].data_ptr(), lanes[2].data_ptr(), int(seed) & 0xFFFFFFFF, int(bool(first)),
            rng.data_ptr(), K._ptr(ctx.majorant), idx.data_ptr(), frac.data_ptr(),
            dist.data_ptr(), K._ptr(maj), int(tape), K._stream(dev))
    K._raise_on(err, "slab_advance")
    LAUNCHES["slab_advance"] += 1
    LAUNCHES["slab_advance_tape"] += int(tape)
    LAUNCHES["slab_advance_majorant"] += int(ctx.majorant is not None)
    LAUNCHES["slab_advance_quasicubic"] += int(ctx.volume_filter == "quasicubic")
    return idx, frac, dist, maj


def slab_finish(state, ctx, lanes, rows, frac, dist, maj, idx, rng, n_bins: int, volume_dims,
                tape=None, fields=None):
    """K28: the rest of the step from the routed (N, 8) f32 ``rows`` (K26's
    rows summed over the owners); updates ``state`` and ``rng`` in place.
    TAPE mode (``tape``, the step's (F, N) f32 rows of the tape ``fields``,
    after K27 with ``tape=True``; no majorant grid): also writes the
    lane-step's tape row."""
    if tape is not None and ctx.majorant is not None:
        raise NotImplementedError(SB._MAJORANT_REFUSAL)
    tensors = ([getattr(state, k) for k in STATE_FIELDS] + list(lanes)
               + [t for t in (rows, frac, dist, maj, idx, rng, tape) if t is not None])
    if K._route(*tensors, *K._ctx_tensors(ctx)) == "cpu":
        return slab_finish_plain(state, ctx, lanes, rows, frac, dist, maj, idx, rng, n_bins,
                                 tape, fields, volume_dims)
    _check_step(state, lanes, n_bins, rng)
    n = state.px.numel()
    K._check(rows, "rows", torch.float32, (n, 8), align=16)
    K._check(frac, "frac", torch.float32, (3, n))
    K._check(dist, "dist", torch.float32, (n,))
    K._check(idx, "idx", torch.int32, (n,))
    if (maj is None) != (ctx.majorant is None):
        raise ValueError("the majorant handoff goes with a majorant grid")
    if maj is not None:
        K._check(maj, "maj", torch.float32, (n,))
    slots = None
    if tape is not None:
        K._check(tape, "tape", torch.float32, (len(fields), n))
        slots = SB._slots(fields)
    f, i = _step_params(state, ctx, n_bins, volume_dims)
    dev = state.px.device
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.vpt_slab_finish(
            f.ctypes.data, i.ctypes.data, *(getattr(state, k).data_ptr() for k in STATE_FIELDS),
            lanes[0].data_ptr(), lanes[1].data_ptr(), rng.data_ptr(), rows.data_ptr(),
            frac.data_ptr(), dist.data_ptr(), K._ptr(maj), idx.data_ptr(),
            ctx.material_tf.data_ptr(), K._ptr(ctx.environment),
            None if slots is None else slots.ctypes.data, 0 if tape is None else len(fields),
            K._ptr(tape), K._stream(dev))
    K._raise_on(err, "slab_finish")
    LAUNCHES["slab_finish"] += 1
    LAUNCHES["slab_finish_tape"] += int(tape is not None)
    LAUNCHES["slab_finish_majorant"] += int(ctx.majorant is not None)
    LAUNCHES["slab_finish_environment"] += int(ctx.environment is not None)
    return state


def slab_scatter(adj: torch.Tensor, lo: int, pairs: torch.Tensor, n_ranks: int) -> torch.Tensor:
    """K29: adds into this rank's (rows, 8) f32 adjoint slab ``adj`` (global
    rows [lo, lo + rows)) every owned pair of ``pairs``, the ``n_ranks``
    ranks' pair lists (``spectral_backward.pair_buffer``) gathered in rank
    order, each read up to its count (on the device: no host sync); pairs
    of row -1 add nothing. Returns ``adj``."""
    if K._route(adj, pairs) == "cpu":
        return slab_scatter_plain(adj, lo, pairs, n_ranks)
    K._check(adj, "adj", torch.float32, (adj.shape[0], 8), align=16)
    K._check(pairs, "pairs", torch.float32, (pairs.numel(),), align=16)
    m = (pairs.numel() // int(n_ranks) - 4) // 10
    if pairs.numel() != (4 + 10 * m) * int(n_ranks) or m % 4:
        raise ValueError(f"{pairs.numel()} floats are not {n_ranks} pair lists")
    lib = _lib()
    with torch.cuda.device(adj.device):
        err = lib.vpt_slab_scatter(pairs.data_ptr(), m, int(n_ranks), int(lo), adj.shape[0],
                                   adj.data_ptr(), K._stream(adj.device))
    K._raise_on(err, "slab_scatter")
    LAUNCHES["slab_scatter"] += 1
    return adj


def slab_contract(adj: torch.Tensor, lo: int, slab_z: int, volume_dims) -> torch.Tensor:
    """K30: this rank's (slab_z * (H+1) * (W+1), 8) f32 adjoint slab, packed
    planes [lo, lo + slab_z), to its (slab_z + 1, H, W) partial of the raw
    gradient (``slab_contract_plain`` says which planes)."""
    D, H, W = (int(d) for d in volume_dims)
    if adj.shape != (slab_z * (H + 1) * (W + 1), 8):
        raise ValueError(f"adj: expected ({slab_z * (H + 1) * (W + 1)}, 8), got {tuple(adj.shape)}")
    if K._route(adj) == "cpu":
        return slab_contract_plain(adj, lo, slab_z, volume_dims)
    K._check(adj, "adj", torch.float32)
    out = torch.empty((slab_z + 1, H, W), dtype=torch.float32, device=adj.device)
    lib = _lib()
    with torch.cuda.device(adj.device):
        err = lib.vpt_slab_contract(adj.data_ptr(), int(lo), int(slab_z), D, H, W, out.data_ptr(),
                                    K._stream(adj.device))
    K._raise_on(err, "slab_contract")
    LAUNCHES["slab_contract"] += 1
    return out


def slab_pack(raw: torch.Tensor, lo: int, slab_z: int) -> torch.Tensor:
    """K31: packed planes [lo, lo + slab_z) of the f32 corner table of the
    (D, H, W) f32 ``raw`` grid, flat (slab_z * (H+1) * (W+1), 8), zero past
    plane D."""
    if K._route(raw) == "cpu":
        return slab_pack_plain(raw, lo, slab_z)
    K._check(raw, "raw", torch.float32, tuple(raw.shape))
    if raw.ndim != 3:
        raise ValueError(f"raw must be (D, H, W), got {tuple(raw.shape)}")
    D, H, W = raw.shape
    out = torch.empty((slab_z * (H + 1) * (W + 1), 8), dtype=torch.float32, device=raw.device)
    lib = _lib()
    with torch.cuda.device(raw.device):
        err = lib.vpt_slab_pack(raw.data_ptr(), int(lo), int(slab_z), D, H, W, out.data_ptr(),
                                K._stream(raw.device))
    K._raise_on(err, "slab_pack")
    LAUNCHES["slab_pack"] += 1
    return out
