"""The packed-adjoint PRB backward of the spectral MCM renderer: wrappers,
plain versions, launch counts, and the host orchestration.

Counterpart of the packed path of ``vpt_tpu/kernels/spectral_backward.py``
(``spectral_backward_packed`` and the functions built on it). PRB (path
replay backprop) is a taped forward pass followed by a reverse pass over the
tape that propagates each step's deposit cotangent ``(c, cb)`` and scatters
the analytic per-event gradients into adjoints shaped like the PACKED tables
(one 18-wide TF+light row and one 8-wide volume row per lane-step; two
4-wide plane rows of an xy half-packed volume; an escape's 12-wide
environment row). The packed adjoints are contracted back to the raw
tables once, by the dense pack transpose K9 ``contract_corners``
(``kernels/corners.py``).

Two kernels of ``vpt_tpu_torch/csrc/spectral_backward.cu``:

- ``tape_forward`` (K4): K dispatches of ``steps`` Woodcock iterations from
  a state, writing one tape row per lane-step; replaces ``fwd_body``
  (``:660-743``) scanned by ``_tape_forward_sweep``. Plain version
  ``tape_forward_plain``. Its final state equals the forward step kernel's.
- ``prb_reverse`` (K5): the reverse pass over K stored dispatch tapes, the
  ``(c, cb)`` carry threaded across dispatches, the extinction score, and
  the stride or importance scatters; replaces ``cotangent_update`` +
  ``scatter_step`` (``:781-950``) and ``_importance_metric`` +
  ``_importance_scatter`` (``:411-540``). Plain version
  ``prb_reverse_plain``.

The tape is one f32 tensor ``(K, steps, F, lanes)`` whose F fields are
``tape_fields(wrt, env, xy)`` (int and bool fields bit-cast into f32
slots); kernel and plain version write the same layout, so their tapes
compare bitwise. Two conventions differ from the JAX tape: ``hg_cos`` is 0
where the step did not scatter, and the environment's addressing
(``env_row``, ``env_fx``, ``env_fy``, ``env_band``) is 0 where the lane did
not escape (the JAX tape holds unused values there; ``env_w`` is 0 there in
both).

The modes (JAX ``spectral_backward_packed``'s branches): the environment
map (``"environment"`` in ``wrt`` on an env ctx: the escape's texel
adjoints, 2.7 times the bilinear weights on the wavelength's channel; the
light spectrum's gradient is then 0, as it is never sampled), the
quasicubic filter (the volume rows' adjoints take the warped weights; the
positions are detached, so no warp derivative arises) and the xy
half-packed volume (``ctx.density.kind == "xy"``). The ``volume_filter``
argument decides the filter, as the static argument does in JAX: a ctx
whose ``volume_filter`` differs is rendered with the argument's.

Each wrapper runs its plain version when its tensors lie on the CPU and
launches its kernel when they lie on a CUDA device; anything else raises.
``LAUNCHES`` counts kernel launches only. The functions here never modify
the state they are given: the forward runs on a copy.

Not ported yet (each raises ``NotImplementedError``): the raw-table replay
backward ``spectral_backward`` (raw or partly packed tables, the
``nearest`` filter). Majorant mode raises as the reference's taped
backward does; its gradients come from the autodiff surrogate
(``kernels/surrogate.py``, whose tape is K4's surrogate mode in the same
CUDA source).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vpt_tpu_torch.kernels import _build, corners
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.ops import geometry, interp, sampling
from vpt_tpu_torch.ops.spectral import XYZ_TO_SRGB_KERNEL

ALL_WRT = frozenset({"density", "material_tf", "light_spectrum", "extinction"})
# the keys a backward takes: "environment" differentiates the env map (JAX
# ``want_env``), and only on a ctx that has one
LEGAL_WRT = ALL_WRT | {"environment"}
EPS = 1e-5

# tape fields in the order of TapeField in csrc/spectral_backward.cu
TAPE_FIELDS = (
    "emitted", "respawn", "pre_bin", "alpha", "albedo", "g", "hg_cos",
    "null", "scatter", "fx",                                   # always
    "dist",                                                    # extinction
    "tf_row", "fy", "light_w",                                 # TF / light
    "slope0", "slope1", "slope2", "vol_row0", "vfx", "vfy", "vfz",  # density
    "vol_row1",                                                # density, xy volume
    "env_row", "env_fx", "env_fy", "env_band", "env_w",        # environment
)
INT_FIELDS = frozenset({"pre_bin", "tf_row", "vol_row0", "vol_row1", "env_row", "env_band"})
BOOL_FIELDS = frozenset({"respawn", "null", "scatter"})
_ENV_FIELDS = TAPE_FIELDS[22:]
# must match MAX_IMP_STEPS and RParam in csrc/spectral_backward.cu
MAX_IMP_STEPS = 32
_R_COUNT = 15

# above this many bytes of stacked tape, window_storage="auto" re-simulates
# from stored start states instead (the JAX package's limit)
_TAPE_AUTO_LIMIT_BYTES = 6 * 1024**3

# a launch also counts under each mode it ran: the environment map, the
# quasicubic filter, the xy volume
LAUNCHES = {"prb_tape_forward": 0, "prb_reverse": 0,
            "prb_tape_forward_environment": 0, "prb_tape_forward_quasicubic": 0,
            "prb_tape_forward_xy": 0, "prb_reverse_environment": 0, "prb_reverse_xy": 0,
            "raw_tape": 0, "raw_replay": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def tape_fields(wrt, env: bool = False, xy: bool = False) -> tuple:
    """The tape's fields for a ``wrt`` subset, in slot order; ``env``: the
    ctx has an environment map, ``xy``: its volume is xy half-packed."""
    wrt = frozenset(wrt)
    bad = wrt - LEGAL_WRT
    if bad:
        raise ValueError(f"unknown gradient keys {sorted(bad)} (legal: {sorted(LEGAL_WRT)})")
    want = set(TAPE_FIELDS[:10])
    if "extinction" in wrt:
        want.add("dist")
    if "material_tf" in wrt or "light_spectrum" in wrt:
        want.update(("tf_row", "fy", "light_w"))
    if "density" in wrt:
        want.update(TAPE_FIELDS[14:21])
        if xy:
            want.add("vol_row1")
    if "environment" in wrt and env:
        want.update(_ENV_FIELDS)
    return tuple(f for f in TAPE_FIELDS if f in want)


def ctx_tape_fields(ctx, wrt) -> tuple:
    """``tape_fields`` of a ctx's modes."""
    return tape_fields(wrt, ctx.environment is not None, ctx.density.kind == "xy")


# the reference's taped forward refuses the majorant mode with this error
_MAJORANT_REFUSAL = ("the packed-PRB taped backward does not support the super-voxel majorant "
                     "mode; use the autodiff surrogate (render_sequence_diff / fit_spectral "
                     "method='autodiff') for majorant-mode gradients")


def _slots(fields) -> np.ndarray:
    slot = np.full(len(TAPE_FIELDS), -1, np.int32)
    for i, f in enumerate(fields):
        slot[TAPE_FIELDS.index(f)] = i
    return slot


def packed_ctx(ctx, volume_filter="linear"):
    """The ctx a packed backward renders with: checked, and with the
    ``volume_filter`` argument as its filter (the argument decides, as the
    static argument of the JAX functions does). A ctx without the fused TF
    or without a packed volume, or another filter, fails the reference's
    assertions (``spectral_backward_packed``, ``_packed_vol_meta``)."""
    if ctx.material_tf.ndim != 3 or ctx.material_tf.shape[-1] != 18:
        raise AssertionError("packed backward needs the fused TF")
    if volume_filter not in ("linear", "quasicubic"):
        raise AssertionError("packed backward supports linear/quasicubic filtering")
    if ctx.majorant is not None:
        raise NotImplementedError(_MAJORANT_REFUSAL)
    if ctx.environment is not None and (ctx.environment.ndim != 3
                                        or ctx.environment.shape[-1] != 12):
        raise ValueError("environment gradients need the packed (He+1, We+1, 12) equirect "
                         f"table, got {tuple(ctx.environment.shape)}")
    if not isinstance(ctx.density, interp.PackedVolume):
        raise AssertionError("packed backward needs a packed volume")
    if ctx.volume_filter != volume_filter:
        ctx = dataclasses.replace(ctx, volume_filter=volume_filter)
    return ctx


def _lanes(state):
    lane = tuple(state.px.shape)
    streams = lane[0] if len(lane) == 3 else 1
    return lane, lane[-1], streams, int(np.prod(lane))


def clone_state(state):
    return type(state)(*(t.clone() for t in state.tensors()))


def _bits_f(x: torch.Tensor) -> torch.Tensor:
    """int32 / bool lane tensor -> its f32 tape slot."""
    if x.dtype == torch.bool:
        return x.to(torch.float32)
    return x.to(torch.int32).view(torch.float32)


# ---------------------------------------------------------------------------
# K4: taped forward
# ---------------------------------------------------------------------------
def _tape_row(it, fields, ctx, light):
    """The tape fields of one step's internals (JAX ``fwd_body``), each a
    flat (lanes,) f32 tensor, stacked to (F, lanes)."""
    (lx, ly, lz), isotropic = light
    ex = it["tf_extras"]
    rows, fx, fy = ex["rows"], ex["fx"], ex["fy"]
    scatter = it["scatter"]
    v = dict(
        emitted=it["emitted"], respawn=_bits_f(it["respawn"]),
        pre_bin=_bits_f(it["pre_bin"]), alpha=it["alpha"], albedo=it["albedo"],
        g=it["g"], hg_cos=torch.where(scatter, it["hg_cos"], torch.zeros_like(fx)),
        null=_bits_f(it["null"]), scatter=_bits_f(scatter), fx=fx,
    )
    if "dist" in fields:
        v["dist"] = it["dist"]
    if "tf_row" in fields:
        v["tf_row"] = _bits_f(ex["row_idx"])
        v["fy"] = fy
        dx, dy, dz = it["pre_dir"]
        if isotropic:
            di = torch.ones_like(fx)
        else:
            ddot = dx * lx + dy * ly + dz * lz
            di = torch.where(it["emitted"] > 0.0, ddot, torch.zeros_like(ddot))
        v["light_w"] = torch.where(it["oob"], di * 5.0, torch.zeros_like(fx))
        if ctx.environment is not None:
            # the escape comes from the env map: the light is never sampled
            v["light_w"] = torch.zeros_like(fx)
    if "vol_row0" in fields:
        th = ctx.material_tf.shape[0] - 1
        fxc = fx[..., None]
        c00, c01 = rows[..., 0:3], rows[..., 4:7]
        c10, c11 = rows[..., 8:11], rows[..., 12:15]
        slopes = ((c10 + (c11 - c10) * fxc) - (c00 + (c01 - c00) * fxc)) * th
        for c in range(3):
            v[f"slope{c}"] = slopes[..., c]
        row0, row1, vfx, vfy, vfz = interp.volume_rows(ctx.density.dims, *it["sample_pos"],
                                                       kind=ctx.density.kind)
        if ctx.volume_filter == "quasicubic":
            # the corner adjoints take the warped weights (JAX :735-742)
            vfx, vfy, vfz = (interp.quasicubic_warp(f) for f in (vfx, vfy, vfz))
        v["vol_row0"], v["vol_row1"] = _bits_f(row0), _bits_f(row1)
        v["vfx"], v["vfy"], v["vfz"] = vfx, vfy, vfz
    if "env_row" in fields:
        # the escape's equirect addressing (K.sample_environment's ops),
        # zero where the lane did not escape
        oob = it["oob"]
        erow, efx, efy, band = K.env_addr(ctx.environment, *it["pre_dir"], it["pre_wavelength"])
        zero, izero = torch.zeros_like(fx), torch.zeros_like(erow, dtype=torch.int32)
        v["env_row"] = _bits_f(torch.where(oob, erow.to(torch.int32), izero))
        v["env_fx"] = torch.where(oob, efx, zero)
        v["env_fy"] = torch.where(oob, efy, zero)
        v["env_band"] = _bits_f(torch.where(oob, band.to(torch.int32), izero))
        v["env_w"] = torch.where(oob, torch.full_like(fx, K.ENV_GAIN), zero)
    return torch.stack([v[f].reshape(-1) for f in fields])


def tape_forward_plain(state, ctx, seeds, steps: int, n_bins: int, wrt=ALL_WRT):
    """Plain PyTorch ``tape_forward``: updates ``state`` in place (like
    ``mcm_spectral.step_plain``) and returns the tapes (K, steps, F, lanes).
    ``ctx``: checked by ``packed_ctx`` (its filter is the one rendered)."""
    ctx = packed_ctx(ctx, ctx.volume_filter)
    fields = ctx_tape_fields(ctx, wrt)
    lane, resolution, streams, _ = _lanes(state)
    device = state.px.device
    ix, iy, seed_iy = K._pixel_grid(resolution, streams, device)
    inv_res = K._f32(np.float32(1.0) / np.float32(resolution))
    sx, sy = geometry.screen_position(ix, iy, inv_res)
    light = K.light_terms(ctx.light_direction)
    p = {k: getattr(state, k) for k in K.STATE_FIELDS if k != "transmittance"}
    tapes = []
    for seed in np.asarray(seeds, np.uint32).reshape(-1):
        rng = sampling.seed_state(ix, seed_iy, int(seed))
        rows = []
        for _ in range(steps):
            p, rng, it = K._render_body(p, rng, sx, sy, ctx, n_bins, light, collect=True)
            rows.append(_tape_row(it, fields, ctx, light))
        tapes.append(torch.stack(rows))
    for k, val in p.items():
        getattr(state, k).copy_(val)
    return torch.stack(tapes)


def tape_forward(state, ctx, seeds, steps: int, n_bins: int, wrt=ALL_WRT):
    """K taped dispatches (one per frame seed) from ``state``, which stays
    untouched. Returns (state_out, tapes (K, steps, F, lanes) f32); one
    kernel launch on a CUDA device. ``ctx``: checked by ``packed_ctx`` (its
    filter is the one rendered)."""
    ctx = packed_ctx(ctx, ctx.volume_filter)
    fields = ctx_tape_fields(ctx, wrt)
    out = clone_state(state)
    tensors = out.tensors() + K._ctx_tensors(ctx)
    if K._route(*tensors) == "cpu":
        return out, tape_forward_plain(out, ctx, seeds, steps, n_bins, wrt)
    K._check_state(out, n_bins)
    K._check_tables(ctx)
    seeds = np.asarray(seeds, np.uint32).reshape(-1)
    lane, resolution, streams, n_lanes = _lanes(out)
    f, i = K._params(ctx, resolution, streams, n_bins, steps, len(seeds))
    lib = _build.load()
    _check_layout(lib)
    device = out.px.device
    tapes = torch.empty((len(seeds), steps, len(fields), n_lanes), dtype=torch.float32,
                        device=device)
    slots = _slots(fields)
    seeds_dev = torch.as_tensor(seeds.view(np.int32), device=device)
    with torch.cuda.device(device):
        err = lib.vpt_prb_tape_forward(
            f.ctypes.data, i.ctypes.data, slots.ctypes.data, len(fields),
            *(getattr(out, k).data_ptr() for k in K.STATE_FIELDS[:11]),
            ctx.density.table.data_ptr(), ctx.material_tf.data_ptr(), K._ptr(ctx.environment),
            seeds_dev.data_ptr(), tapes.data_ptr(), K._stream(device))
    K._raise_on(err, "prb_tape_forward")
    LAUNCHES["prb_tape_forward"] += 1
    for mode, on in (("environment", ctx.environment is not None),
                     ("quasicubic", ctx.volume_filter == "quasicubic"),
                     ("xy", ctx.density.kind == "xy")):
        LAUNCHES[f"prb_tape_forward_{mode}"] += int(on)
    return out, tapes


def _check_layout(lib):
    got = tuple(lib.vpt_bwd_layout(k) for k in range(5))
    want = (len(TAPE_FIELDS), _R_COUNT, MAX_IMP_STEPS, K._F_COUNT, K._I_COUNT)
    if got != want:
        raise RuntimeError(f"backward kernel layout {got} does not match the wrapper's {want}")


# ---------------------------------------------------------------------------
# K5: reverse pass
# ---------------------------------------------------------------------------
class _Row:
    """Named access to one tape row (F, lanes) of the plain reverse."""

    def __init__(self, row, col):
        self.row, self.col = row, col

    def f(self, name):
        return self.row[self.col[name]]

    def i(self, name):
        return self.f(name).view(torch.int32)

    def b(self, name):
        return self.f(name) > 0.5


def _event_grads(t: _Row, q):
    """(grad_alpha, grad_albedo, grad_graw) of one step (JAX :784-798)."""
    alpha, albedo, g = t.f("alpha"), t.f("albedo"), t.f("g")
    null, scat = t.b("null"), t.b("scatter")
    zero = torch.zeros_like(q)
    grad_alpha = (torch.where(null, -q / torch.clamp_min(1.0 - alpha, 1e-12), zero)
                  + torch.where(scat, q / torch.clamp_min(alpha, 1e-12), zero))
    grad_albedo = torch.where(scat, q / torch.clamp_min(albedo, 1e-12), zero)
    aniso = torch.abs(g) >= EPS
    cosd = t.f("hg_cos")
    g2 = g * g
    hg_score = (-2.0 * g / torch.clamp_min(1.0 - g2, 1e-9)
                - 3.0 * (g - cosd) / torch.clamp_min(1.0 + g2 - 2.0 * g * cosd, 1e-9))
    grad_graw = torch.where(scat & aniso, q * hg_score, zero) * 2.0
    return grad_alpha, grad_albedo, grad_graw


def _scatter_plain(t: _Row, c, cb, weight, adj):
    """The per-step table scatters of one tape row (JAX ``scatter_step``),
    in the kernel's order."""
    q = cb * c * weight
    ga, gb, gg = _event_grads(t, q)
    if "g_tf" in adj:
        fx, fy = t.f("fx"), t.f("fy")
        w = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
        gl = cb * weight * t.f("light_w")
        zero = torch.zeros_like(fx)
        cols = []
        for wk in w:
            cols += [gb * wk, ga * wk, gg * wk, zero]
        cols += [gl * (1 - fx), gl * fx]
        adj["g_tf"].index_add_(0, t.i("tf_row").to(torch.int64), torch.stack(cols, dim=-1))
    if "g_vol" in adj:
        gd = gb * t.f("slope0") + ga * t.f("slope1") + gg * t.f("slope2")
        vfx, vfy, vfz = t.f("vfx"), t.f("vfy"), t.f("vfz")
        w4 = ((1 - vfy) * (1 - vfx), (1 - vfy) * vfx, vfy * (1 - vfx), vfy * vfx)
        a0, a1 = gd * (1 - vfz), gd * vfz
        if adj["g_vol"].shape[1] == 4:
            # xy volume: the z0 and z1 plane rows
            adj["g_vol"].index_add_(0, t.i("vol_row0").to(torch.int64),
                                    torch.stack([a0 * wk for wk in w4], dim=-1))
            adj["g_vol"].index_add_(0, t.i("vol_row1").to(torch.int64),
                                    torch.stack([a1 * wk for wk in w4], dim=-1))
        else:
            v8 = torch.stack([a0 * wk for wk in w4] + [a1 * wk for wk in w4], dim=-1)
            adj["g_vol"].index_add_(0, t.i("vol_row0").to(torch.int64), v8)
    if "g_env" in adj:
        K.add_env_texels_plain(adj["g_env"], t.i("env_row").to(torch.int64),
                               t.i("env_band").to(torch.int64), cb * weight * t.f("env_w"),
                               t.f("env_fx"), t.f("env_fy"))


def _importance_metric_plain(t: _Row, c, cb, want_tf, want_vol, want_env=False):
    """Importance-thinning selection weight of one step (JAX
    ``_importance_metric``)."""
    ga, gb, gg = _event_grads(t, c * cb)
    m = torch.zeros_like(c)
    if want_vol:
        m = m + torch.abs(gb * t.f("slope0") + ga * t.f("slope1") + gg * t.f("slope2"))
    if want_tf:
        m = m + (torch.abs(gb) + torch.abs(ga) + torch.abs(gg) + torch.abs(cb * t.f("light_w")))
    if want_env:
        m = m + torch.abs(cb * t.f("env_w"))
    return m


def prb_reverse_plain(tapes, fields, g_rad_scaled, cot, adj, phases, seeds, *,
                      scatter_stride: int, importance: bool, inv_mu: float,
                      resolution: int, streams: int, pick_bits=None):
    """Plain PyTorch ``prb_reverse``: updates the carry ``cot`` (dict c, cb
    of (lanes,) tensors) and the adjoints ``adj`` (dict of g_ext (1,),
    g_tf (rows, 18), g_vol (rows, 8) or (rows, 4) for an xy volume, g_env
    (rows, 12), as present) in place."""
    n_disp, steps = tapes.shape[0], tapes.shape[1]
    n_bins = g_rad_scaled.shape[0]
    col = {f: i for i, f in enumerate(fields)}
    importance = importance and scatter_stride > 1
    want_tf, want_vol, want_env = "g_tf" in adj, "g_vol" in adj, "g_env" in adj
    want_scatter = want_tf or want_vol or want_env
    c, cb = cot["c"], cot["cb"]
    weight = float(scatter_stride)
    for k in range(n_disp - 1, -1, -1):
        c_all, cb_all = [None] * steps, [None] * steps
        for it in range(steps - 1, -1, -1):
            t = _Row(tapes[k, it], col)
            dep = t.b("respawn")
            b = t.i("pre_bin")
            ok = (b >= 0) & (b < n_bins)
            sel = torch.gather(g_rad_scaled, 0, b.clamp(0, n_bins - 1).to(torch.int64)[None])[0]
            c = torch.where(dep, t.f("emitted"), c)
            cb = torch.where(dep, torch.where(ok, sel, torch.zeros_like(sel)), cb)
            if "g_ext" in adj:
                adj["g_ext"] += torch.sum(c * cb * (inv_mu - t.f("dist")))
            if importance:
                c_all[it], cb_all[it] = c, cb
            elif want_scatter and it % scatter_stride == int(phases[k]):
                _scatter_plain(t, c, cb, weight, adj)
        if importance and want_scatter:
            _importance_scatter_plain(tapes[k], col, c_all, cb_all, adj, seeds[k],
                                      scatter_stride, resolution, streams, pick_bits,
                                      want_tf, want_vol, want_env)
    cot["c"], cot["cb"] = c, cb


def _importance_picks(tape, col, c_all, cb_all, seed, stride, resolution, streams,
                      pick_bits, want_tf, want_vol, want_env=False):
    """Per-lane importance picks of one dispatch (JAX ``_importance_scatter``):
    ``steps // stride`` i.i.d. step picks with probability proportional to
    the step's total scatter magnitude, each weighted S / (count * metric).
    S and the cdf are sequential sums over the steps, in the kernel's order.
    Returns (picks, weights): per pick, (lanes,) step indices and weights."""
    steps = tape.shape[0]
    absq = [_importance_metric_plain(_Row(tape[s], col), c_all[s], cb_all[s],
                                     want_tf, want_vol, want_env) for s in range(steps)]
    S = absq[0]
    for s in range(1, steps):
        S = S + absq[s]
    Sd = torch.clamp_min(S, 1e-30)
    run, cdf = torch.zeros_like(S), []
    for s in range(steps):
        run = run + absq[s] / Sd
        cdf.append(run)
    cdf = torch.stack(cdf)
    absq = torch.stack(absq)
    ix, _, seed_iy = K._pixel_grid(resolution, streams, tape.device)
    bits = (int(seed) if pick_bits is None else int(pick_bits)) ^ 0x7F4A7C15
    pick_state = sampling.seed_state(ix.reshape(-1), seed_iy.reshape(-1), bits)
    count = steps // stride
    picks, weights = [], []
    for j in range(count):
        state = sampling.pcg_hash(pick_state ^ ((0x9E3779B9 * (j + 1)) & sampling.MASK32))
        u = sampling.uniform_from_state(state)
        sel = torch.sum((cdf < u[None]).to(torch.int64), dim=0).clamp(0, steps - 1)
        a = torch.gather(absq, 0, sel[None])[0]
        picks.append(sel)
        weights.append(torch.where(a > 0.0, S / (count * torch.clamp_min(a, 1e-30)),
                                   torch.zeros_like(a)))
    return picks, weights


def _importance_scatter_plain(tape, col, c_all, cb_all, adj, seed, stride, resolution,
                              streams, pick_bits, want_tf, want_vol, want_env):
    """The importance-thinned scatters of one dispatch."""
    picks, weights = _importance_picks(tape, col, c_all, cb_all, seed, stride, resolution,
                                       streams, pick_bits, want_tf, want_vol, want_env)
    c_all, cb_all = torch.stack(c_all), torch.stack(cb_all)
    for sel, w in zip(picks, weights):
        row = torch.gather(tape, 0, sel[None, None].expand(1, tape.shape[1], tape.shape[2]))[0]
        _scatter_plain(_Row(row, col), torch.gather(c_all, 0, sel[None])[0],
                       torch.gather(cb_all, 0, sel[None])[0], w, adj)


def prb_reverse(tapes, fields, g_rad_scaled, cot, adj, phases, seeds, *,
                scatter_stride: int, scatter_mode: str, inv_mu: float,
                resolution: int, streams: int, pick_bits=None):
    """The reverse pass over K stored dispatch tapes (dispatch K-1 first),
    threading ``cot`` (dict c, cb) across them and accumulating into
    ``adj``; both are updated in place. ``phases``/``seeds``: per-dispatch
    stride phase and frame seed. One kernel launch on a CUDA device."""
    if scatter_mode not in ("stride", "importance"):
        raise ValueError(f"unknown scatter_mode {scatter_mode!r}")
    n_disp, steps, n_fields, n_lanes = tapes.shape
    if n_fields != len(fields) or len(phases) != n_disp or len(seeds) != n_disp:
        raise ValueError("tape, fields, phases and seeds disagree")
    if steps % scatter_stride:
        raise ValueError(f"scatter_stride {scatter_stride} must divide steps {steps} (unbiasedness)")
    importance = scatter_mode == "importance" and scatter_stride > 1
    if importance and steps > MAX_IMP_STEPS:
        raise ValueError(f"importance thinning supports at most {MAX_IMP_STEPS} steps, got {steps}")
    if ("g_ext" in adj) != ("dist" in fields):
        raise ValueError("the extinction adjoint needs the tape's dist field")
    if (("g_tf" in adj) != ("tf_row" in fields) or ("g_vol" in adj) != ("vol_row0" in fields)
            or ("g_env" in adj) != ("env_row" in fields)):
        raise ValueError("adjoints and tape fields disagree")
    xy = "g_vol" in adj and adj["g_vol"].shape[1] == 4
    if xy != ("vol_row1" in fields):
        raise ValueError("an xy volume's (rows, 4) adjoint needs the tape's vol_row1 field")
    tensors = [tapes, g_rad_scaled, cot["c"], cot["cb"], *adj.values()]
    if K._route(*tensors) == "cpu":
        return prb_reverse_plain(tapes, fields, g_rad_scaled, cot, adj, phases, seeds,
                                 scatter_stride=scatter_stride, importance=importance,
                                 inv_mu=inv_mu, resolution=resolution, streams=streams,
                                 pick_bits=pick_bits)
    K._check(tapes, "tapes", torch.float32)
    K._check(g_rad_scaled, "g_rad_scaled", torch.float32, (g_rad_scaled.shape[0], n_lanes))
    for name in ("c", "cb"):
        K._check(cot[name], name, torch.float32, (n_lanes,))
    if "g_ext" in adj:
        K._check(adj["g_ext"], "g_ext", torch.float32, (1,))
    if "g_tf" in adj:
        K._check(adj["g_tf"], "g_tf", torch.float32, (adj["g_tf"].shape[0], 18), align=8)
    if "g_vol" in adj:
        K._check(adj["g_vol"], "g_vol", torch.float32,
                 (adj["g_vol"].shape[0], 4 if xy else 8), align=16)
    if "g_env" in adj:
        K._check(adj["g_env"], "g_env", torch.float32, (adj["g_env"].shape[0], 12))
    r = np.array([
        n_lanes, resolution, steps, n_disp, n_fields, scatter_stride, int(importance),
        int("g_ext" in adj), int("g_tf" in adj), int("g_vol" in adj), g_rad_scaled.shape[0],
        int(pick_bits is not None),
        int(np.uint32(0 if pick_bits is None else int(pick_bits) & 0xFFFFFFFF).view(np.int32)),
        int("g_env" in adj), int(xy),
    ], np.int32)
    assert r.shape == (_R_COUNT,)
    lib = _build.load()
    _check_layout(lib)
    device = tapes.device
    phases_dev = torch.as_tensor(np.asarray(phases, np.int32), device=device)
    seeds_dev = torch.as_tensor(np.asarray(seeds, np.uint32).view(np.int32), device=device)
    slots = _slots(fields)

    def ptr(name):
        return adj[name].data_ptr() if name in adj else None

    # the extinction score, summed across blocks in f64 (csrc block_add)
    ext_acc = torch.zeros(1, dtype=torch.float64, device=device) if "g_ext" in adj else None
    with torch.cuda.device(device):
        err = lib.vpt_prb_reverse(
            r.ctypes.data, float(np.float32(inv_mu)), slots.ctypes.data, tapes.data_ptr(),
            g_rad_scaled.data_ptr(), cot["c"].data_ptr(), cot["cb"].data_ptr(),
            phases_dev.data_ptr(), seeds_dev.data_ptr(), K._ptr(ext_acc), ptr("g_tf"),
            ptr("g_vol"), ptr("g_env"), K._stream(device))
    K._raise_on(err, "prb_reverse")
    LAUNCHES["prb_reverse"] += 1
    LAUNCHES["prb_reverse_environment"] += int("g_env" in adj)
    LAUNCHES["prb_reverse_xy"] += int(xy)
    if ext_acc is not None:
        adj["g_ext"] += ext_acc.to(torch.float32)


# ---------------------------------------------------------------------------
# host side: cotangents, adjoints, contraction
# ---------------------------------------------------------------------------
def _inv_mu(ctx) -> float:
    return float(np.float32(1.0) / np.float32(ctx.extinction))


def _deposit_cotangents(g_image, ctx, lane, n_bins, m_final):
    """Per-bin, per-lane deposit cotangent g_rad / m_final, (B, lanes)."""
    cm = torch.as_tensor(XYZ_TO_SRGB_KERNEL, dtype=torch.float32,
                         device=ctx.bin_xyz.device) @ ctx.bin_xyz  # (3, B)
    g_rad = torch.einsum("hwc,cb->bhw", g_image, cm)
    if len(lane) == 3:
        g_rad = sampling.div_scalar(g_rad[:, None], float(lane[0])).expand((n_bins,) + lane)
    return (g_rad / m_final[None]).reshape(n_bins, -1).contiguous()


def _m_final(state):
    return torch.clamp_min(state.samples, 1).to(torch.float32)


def _packed_adj_init(ctx, wrt):
    """Zero packed adjoints for a ``wrt`` subset: g_ext (1,), g_tf
    (Hp*Wp, 18), g_vol (rows, 8), or (rows, 4) for an xy volume, g_env
    (He+1 * We+1, 12) on an env ctx."""
    dev = ctx.material_tf.device
    adj = {}
    if "extinction" in wrt:
        adj["g_ext"] = torch.zeros(1, dtype=torch.float32, device=dev)
    if "material_tf" in wrt or "light_spectrum" in wrt:
        Hp, Wp, CC = ctx.material_tf.shape
        adj["g_tf"] = torch.zeros((Hp * Wp, CC), dtype=torch.float32, device=dev)
    if "density" in wrt:
        adj["g_vol"] = torch.zeros((int(np.prod(ctx.density.dims)), ctx.density.width),
                                   dtype=torch.float32, device=dev)
    if "environment" in wrt and ctx.environment is not None:
        HpE, WpE, _ = ctx.environment.shape
        adj["g_env"] = torch.zeros((HpE * WpE, 12), dtype=torch.float32, device=dev)
    return adj


def _contract_packed_adjoints(acc, ctx, wrt):
    """Packed adjoints -> gradients addressing the RAW tables: the dense pack
    transpose, K9 ``contract_corners`` (``kernels/corners.py``)."""
    grads = {}
    if "extinction" in wrt:
        grads["extinction"] = acc["g_ext"].reshape(())
    if "material_tf" in wrt or "light_spectrum" in wrt:
        g_mtf, g_light = corners.contract_tf(acc["g_tf"].reshape(ctx.material_tf.shape),
                                             material_tf="material_tf" in wrt,
                                             light="light_spectrum" in wrt)
        if g_mtf is not None:
            grads["material_tf"] = g_mtf
        if g_light is not None:
            grads["light_spectrum"] = g_light
    if "density" in wrt:
        grads["density"] = corners.contract_volume(acc["g_vol"], ctx.density.dims,
                                                   ctx.density.kind)
    if "environment" in wrt and ctx.environment is not None:
        grads["environment"] = corners.contract_env(acc["g_env"].reshape(ctx.environment.shape))
    return grads


def _image(state, ctx):
    from vpt_tpu_torch.models.mcm_spectral import radiance_to_rgb

    return radiance_to_rgb(state.radiance, ctx.bin_xyz)


def _dispatch_phase(k: int, seed: int, n_dispatches: int, scatter_stride: int) -> int:
    """Thinning phase of window dispatch k: k % stride when the window
    covers every phase uniformly (K % stride == 0), else the dispatch's
    frame seed picks it (JAX ``_dispatch_phase``)."""
    stride = max(int(scatter_stride), 1)
    if scatter_stride <= 1 or n_dispatches % scatter_stride == 0:
        return int(k) % stride
    return int(seed) % stride


# ---------------------------------------------------------------------------
# one dispatch
# ---------------------------------------------------------------------------
def spectral_backward_packed(state0, ctx, g_image, steps: int, n_bins: int,
                             volume_filter: str = "linear", wrt=ALL_WRT,
                             scatter_stride: int = 1, scatter_mode: str = "stride",
                             pick_bits=None, scatter_phase=None, m_final=None,
                             adj_in=None, raw_adjoints: bool = False, cot_in=None,
                             return_cot: bool = False, forward_only: bool = False,
                             tape_in=None, state_out_in=None):
    """Hand-derived gradients of one render dispatch, packed tables.

    Returns (state_out, image, grads) with grads addressing the RAW tables,
    like the JAX function of the same name; ``state0`` stays untouched.
    ``m_final`` overrides the deposit normalizer, ``adj_in`` seeds the packed
    adjoints, ``raw_adjoints`` returns them uncontracted, ``cot_in`` /
    ``return_cot`` thread the (c, cb) carry, ``forward_only`` returns
    (state_out, tape (steps, F, lanes)) and ``tape_in`` / ``state_out_in``
    run the reverse pass on a stored tape."""
    ctx = packed_ctx(ctx, volume_filter)
    wrt = frozenset(wrt)
    fields = ctx_tape_fields(ctx, wrt)
    if tape_in is None:
        state_out, tapes = tape_forward(state0, ctx, [ctx.seed_bits], steps, n_bins, wrt)
    else:
        state_out, tapes = state_out_in, tape_in[None]
    if forward_only:
        return state_out, tapes[0]
    lane, resolution, streams, n_lanes = _lanes(state0)
    if m_final is None:
        m_final = _m_final(state_out)
    g_rs = _deposit_cotangents(g_image, ctx, lane, n_bins, m_final)
    adj = ({k: v.clone() for k, v in adj_in.items()} if adj_in is not None
           else _packed_adj_init(ctx, wrt))
    zero = torch.zeros(n_lanes, dtype=torch.float32, device=state0.px.device)
    cot = (dict(c=cot_in["c"].reshape(-1).clone(), cb=cot_in["cb"].reshape(-1).clone())
           if cot_in is not None else dict(c=zero, cb=zero.clone()))
    stride = max(int(scatter_stride), 1)
    phase = (int(scatter_phase) if scatter_phase is not None
             else int(ctx.seed_bits) % stride)
    prb_reverse(tapes, fields, g_rs, cot, adj, [phase], [ctx.seed_bits],
                scatter_stride=stride, scatter_mode=scatter_mode, inv_mu=_inv_mu(ctx),
                resolution=resolution, streams=streams, pick_bits=pick_bits)
    cot_out = (dict(c=cot["c"].reshape(lane), cb=cot["cb"].reshape(lane))
               if return_cot else None)
    image = _image(state_out, ctx)
    out = adj if raw_adjoints else _contract_packed_adjoints(adj, ctx, wrt)
    return (state_out, image, out, cot_out) if return_cot else (state_out, image, out)


def prb_render_and_grads(state0, ctx, g_image, steps: int, n_bins: int,
                         volume_filter: str = "linear", wrt=ALL_WRT,
                         scatter_stride: int = 1, scatter_mode: str = "stride",
                         scatter_phase=None, pick_bits=None):
    """Forward dispatch + hand-derived backward: (state_out, image, grads),
    grads addressing the raw tables, routed by the ctx's tables as the
    reference routes them: the packed ctx (fused TF, full or xy packed
    volume, with or without an environment map) to the packed-adjoint
    backward; a fully raw ctx (raw grid, raw (H, W, 4) TF) to the raw
    replay backward ``spectral_backward``, which returns all four
    gradients whatever ``wrt`` and the thinning arguments say, as the
    reference's does; any other mix raises ``ValueError``."""
    packed_vol = isinstance(ctx.density, interp.PackedVolume)
    if ctx.material_tf.shape[-1] == 18 and packed_vol:
        return spectral_backward_packed(state0, ctx, g_image, steps, n_bins, volume_filter,
                                        wrt=wrt, scatter_stride=scatter_stride,
                                        scatter_mode=scatter_mode, pick_bits=pick_bits,
                                        scatter_phase=scatter_phase)
    if ctx.material_tf.shape[-1] == 4 and not packed_vol and ctx.density.ndim == 3:
        return spectral_backward(state0, ctx, g_image, steps, n_bins, volume_filter)
    dens = ctx.density.dims if packed_vol else tuple(ctx.density.shape)
    raise ValueError(
        "prb_render_and_grads needs either a fully raw ctx (pack_tables=False) "
        "or the standard packed ctx (fused 18-wide TF + packed volume); got "
        f"material_tf {tuple(ctx.material_tf.shape)}, density {dens}")


# ---------------------------------------------------------------------------
# the raw-table replay backward (B9): K13 raw_tape, K14 raw_replay
# ---------------------------------------------------------------------------
def _bilinear_corners(u, v, H: int, W: int):
    """Corner indices + weights of a raw (H, W, C) texture's bilinear lookup
    (JAX ``_bilinear_corners``): ((y0, y1, x0, x1), (w00, w01, w10, w11),
    (fx, fy))."""
    x0, x1, fx = interp._coords(u, W)
    y0, y1, fy = interp._coords(v, H)
    w = ((1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy)
    return (y0, y1, x0, x1), w, (fx, fy)


def _trilinear_corners(u, v, w, D: int, H: int, W: int, volume_filter: str = "linear"):
    """Flat corner indices and weights of a raw grid's trilinear lookup
    (JAX ``_trilinear_corners``): the smoothstep-warped fractions for
    "quasicubic", the linear ones for every other filter, "nearest"
    included (the reference has no nearest branch, ROADMAP C)."""
    x0, x1, fx = interp._coords(u, W)
    y0, y1, fy = interp._coords(v, H)
    z0, z1, fz = interp._coords(w, D)
    if volume_filter == "quasicubic":
        fx, fy, fz = (interp.quasicubic_warp(f) for f in (fx, fy, fz))
    idx, wts = [], []
    for zi, wz in ((z0, 1 - fz), (z1, fz)):
        for yi, wy in ((y0, 1 - fy), (y1, fy)):
            for xi, wx in ((x0, 1 - fx), (x1, fx)):
                idx.append((zi * H + yi) * W + xi)
                wts.append(wz * wy * wx)
    return idx, wts


def _tf_row_slope(tf_table, t, dens, channel: int):
    """d(bilinear TF value)/d(density coordinate) of one channel of a raw
    (H, W, C) TF: H * (x-lerped row1 - row0) (JAX ``_tf_row_slope``)."""
    H, W, _ = tf_table.shape
    (y0, y1, x0, x1), _, (fx, _) = _bilinear_corners(t, dens, H, W)
    flat = tf_table[..., channel].reshape(-1)
    c00, c01 = flat[(y0 * W + x0).to(torch.int64)], flat[(y0 * W + x1).to(torch.int64)]
    c10, c11 = flat[(y1 * W + x0).to(torch.int64)], flat[(y1 * W + x1).to(torch.int64)]
    r0 = c00 + (c01 - c00) * fx
    r1 = c10 + (c11 - c10) * fx
    return (r1 - r0) * H


# the raw tape's fields per lane-step, (steps, 2, lanes) f32: the deposit,
# and bit 0 respawn with bits 8.. the pre-step bin (RawTapeField in
# csrc/raw_backward.cu)
RAW_TAPE_FIELDS = ("emitted", "flags")


def raw_ctx(ctx, volume_filter="linear"):
    """The ctx the raw replay backward renders with: checked as the
    reference checks it (an environment map fails its assertion, the
    majorant mode its taped forward, a light other than a raw (N,) table
    its unpacking), with the ``volume_filter`` argument as its filter."""
    if ctx.environment is not None:
        raise AssertionError("the raw replay backward does not support environment maps; use "
                             "the packed path (pack_tables=True), which carries env-texel "
                             "gradients")
    if ctx.majorant is not None:
        raise NotImplementedError(_MAJORANT_REFUSAL)
    if isinstance(ctx.density, interp.PackedVolume) or ctx.material_tf.shape[-1] != 4:
        raise ValueError("the raw replay backward needs the raw grid and the raw (H, W, 4) TF")
    if ctx.light_spectrum.ndim != 1:
        raise ValueError("the raw replay backward needs the raw (N,) light spectrum, got "
                         f"{tuple(ctx.light_spectrum.shape)}")
    if volume_filter not in ("linear", "quasicubic", "nearest"):
        raise ValueError(f"unknown volume filter {volume_filter!r}")
    if ctx.volume_filter != volume_filter:
        ctx = dataclasses.replace(ctx, volume_filter=volume_filter)
    return ctx


def raw_tape_plain(state, ctx, steps: int, n_bins: int):
    """Plain PyTorch ``raw_tape``: one dispatch with ``ctx.seed_bits``,
    updating ``state`` in place; returns the tape (steps, 2, lanes)."""
    lane, resolution, streams, _ = _lanes(state)
    device = state.px.device
    ix, iy, seed_iy = K._pixel_grid(resolution, streams, device)
    sx, sy = geometry.screen_position(ix, iy, K._f32(np.float32(1.0) / np.float32(resolution)))
    light = K.light_terms(ctx.light_direction)
    p = {k: getattr(state, k) for k in K.STATE_FIELDS if k != "transmittance"}
    rng = sampling.seed_state(ix, seed_iy, ctx.seed_bits)
    rows = []
    for _ in range(steps):
        p, rng, it = K._render_body(p, rng, sx, sy, ctx, n_bins, light, collect=True)
        flags = (it["pre_bin"].to(torch.int32) << 8) | it["respawn"].to(torch.int32)
        rows.append(torch.stack([it["emitted"].reshape(-1), flags.reshape(-1).view(torch.float32)]))
    for k, val in p.items():
        getattr(state, k).copy_(val)
    return torch.stack(rows)


def raw_tape(state, ctx, steps: int, n_bins: int):
    """K13: the taped dispatch of the raw backward from ``state``, which
    stays untouched: (state_out, tape (steps, 2, lanes) f32); one kernel
    launch on a CUDA device. Its state equals ``K.step``'s bit for bit."""
    out = clone_state(state)
    if K._route(*out.tensors(), *K._ctx_tensors(ctx)) == "cpu":
        return out, raw_tape_plain(out, ctx, steps, n_bins)
    K._check_state(out, n_bins)
    K._check_tables(ctx)
    lane, resolution, streams, n_lanes = _lanes(out)
    f, i = K._params(ctx, resolution, streams, n_bins, steps, 1)
    lib = _build.load()
    _check_raw_layout(lib)
    device = out.px.device
    tape = torch.empty((steps, len(RAW_TAPE_FIELDS), n_lanes), dtype=torch.float32,
                       device=device)
    with torch.cuda.device(device):
        err = lib.vpt_raw_tape(f.ctypes.data, i.ctypes.data, int(ctx.seed_bits) & 0xFFFFFFFF,
                               *(getattr(out, k).data_ptr() for k in K.STATE_FIELDS[:11]),
                               K.density_table(ctx).data_ptr(), ctx.material_tf.data_ptr(),
                               K._light_ptr(ctx), tape.data_ptr(), K._stream(device))
    K._raise_on(err, "raw_tape")
    LAUNCHES["raw_tape"] += 1
    return out, tape


def _check_raw_layout(lib):
    got = tuple(lib.vpt_raw_layout(k) for k in range(3))
    want = (K._F_COUNT, K._I_COUNT, len(RAW_TAPE_FIELDS))
    if got != want:
        raise RuntimeError(f"raw backward kernel layout {got} does not match the wrapper's {want}")


def _raw_carry(tape, g_rad_scaled):
    """The reverse scan over a raw tape (JAX ``rev_body``): per step the
    (c, cb) of the first respawn at or after it, zero if none."""
    steps, n_bins = tape.shape[0], g_rad_scaled.shape[0]
    c = torch.zeros(tape.shape[2], dtype=torch.float32, device=tape.device)
    cb = torch.zeros_like(c)
    out = [None] * steps
    for it in range(steps - 1, -1, -1):
        flags = tape[it, 1].view(torch.int32)
        dep = (flags & 1) > 0
        b = flags >> 8
        sel = torch.gather(g_rad_scaled, 0, b.clamp(0, n_bins - 1).to(torch.int64)[None])[0]
        c = torch.where(dep, tape[it, 0], c)
        cb = torch.where(dep, torch.where((b >= 0) & (b < n_bins), sel, torch.zeros_like(sel)),
                         cb)
        out[it] = (c, cb)
    return out


def raw_replay_plain(state0, ctx, tape, g_rad_scaled, steps: int, n_bins: int,
                     inv_mu: float):
    """Plain PyTorch ``raw_replay``: the reverse scan, then the replay of
    the dispatch from ``state0`` (untouched) with its analytic scatters (JAX
    ``rep_body``). Returns the raw gradients (density (D, H, W),
    material_tf (H, W, 4), light_spectrum (N,), extinction ())."""
    lane, resolution, streams, _ = _lanes(state0)
    device = state0.px.device
    carry = _raw_carry(tape, g_rad_scaled)
    ix, iy, seed_iy = K._pixel_grid(resolution, streams, device)
    sx, sy = geometry.screen_position(ix, iy, K._f32(np.float32(1.0) / np.float32(resolution)))
    light = K.light_terms(ctx.light_direction)
    (ldx, ldy, ldz), isotropic = light
    p = {k: getattr(state0, k).clone() for k in K.STATE_FIELDS if k != "transmittance"}
    rng = sampling.seed_state(ix, seed_iy, ctx.seed_bits)
    D, H, W = ctx.density.shape
    TH, TW, TC = ctx.material_tf.shape
    (LN,) = ctx.light_spectrum.shape
    g_dens = torch.zeros(D * H * W, dtype=torch.float32, device=device)
    g_tf = torch.zeros(TH * TW * TC, dtype=torch.float32, device=device)
    g_ls = torch.zeros(LN, dtype=torch.float32, device=device)
    g_ext = torch.zeros((), dtype=torch.float64, device=device)
    for step in range(steps):
        p, rng, it = K._render_body(p, rng, sx, sy, ctx, n_bins, light, collect=True)
        c, cb = (x.reshape(lane) for x in carry[step])
        q = cb * c
        zero = torch.zeros_like(q)
        t_lam = sampling.div_scalar(it["pre_wavelength"] - 400.0, 300.0)
        ga, gb, gg = _event_grads(_Internals(it), q)
        g_ext += torch.sum((q * (inv_mu - it["dist"])).to(torch.float64))
        # the light spectrum, pathwise at escape (weights cb)
        dx, dy, dz = it["pre_dir"]
        ddot = dx * ldx + dy * ldy + dz * ldz
        di = (torch.ones_like(q) if isotropic
              else torch.where(it["emitted"] > 0.0, ddot, zero))
        gl = torch.where(it["oob"], cb * di * 5.0, zero)
        tl = t_lam * LN - 0.5
        fl = torch.floor(tl)
        l0 = torch.clamp(interp._index(fl), 0, LN - 1)
        l1 = torch.clamp(interp._index(fl) + 1, 0, LN - 1)
        lf = tl - fl
        g_ls.index_add_(0, l0.reshape(-1).to(torch.int64), (gl * (1 - lf)).reshape(-1))
        g_ls.index_add_(0, l1.reshape(-1).to(torch.int64), (gl * lf).reshape(-1))
        # the TF texels: 3 channels x 4 corners
        dens = it["dens"]
        (y0, y1, x0, x1), (w00, w01, w10, w11), _ = _bilinear_corners(t_lam, dens, TH, TW)
        for ch, gval in ((0, gb), (1, ga), (2, gg)):
            for yi, xi, wc in ((y0, x0, w00), (y0, x1, w01), (y1, x0, w10), (y1, x1, w11)):
                g_tf.index_add_(0, ((yi * TW + xi) * TC + ch).reshape(-1).to(torch.int64),
                                (gval * wc).reshape(-1))
        # the density chain: the channel slopes, trilinear-scattered
        gd = (gb * _tf_row_slope(ctx.material_tf, t_lam, dens, 0)
              + ga * _tf_row_slope(ctx.material_tf, t_lam, dens, 1)
              + gg * _tf_row_slope(ctx.material_tf, t_lam, dens, 2))
        idx, wts = _trilinear_corners(*it["sample_pos"], D, H, W, ctx.volume_filter)
        for i, wt in zip(idx, wts):
            g_dens.index_add_(0, i.reshape(-1).to(torch.int64), (gd * wt).reshape(-1))
    return dict(density=g_dens.reshape(D, H, W), material_tf=g_tf.reshape(TH, TW, TC),
                light_spectrum=g_ls, extinction=g_ext.to(torch.float32))


class _Internals:
    """A step's internals in the named access of ``_event_grads``."""

    def __init__(self, it):
        self.it = it

    def f(self, name):
        return self.it[name]

    def b(self, name):
        return self.it[name]


def raw_replay(state0, ctx, tape, g_rad_scaled, steps: int, n_bins: int):
    """K14: the raw backward's reverse scan, replay and scatters of one
    dispatch from ``state0`` (untouched), given its K13 tape and the
    per-lane deposit cotangents ``g_rad_scaled`` (n_bins, lanes). Returns
    the raw gradients (density, material_tf, light_spectrum, extinction);
    one kernel launch on a CUDA device."""
    inv_mu = _inv_mu(ctx)
    tensors = [*state0.tensors(), *K._ctx_tensors(ctx), tape, g_rad_scaled]
    if K._route(*tensors) == "cpu":
        return raw_replay_plain(state0, ctx, tape, g_rad_scaled, steps, n_bins, inv_mu)
    K._check_state(state0, n_bins)
    K._check_tables(ctx)
    lane, resolution, streams, n_lanes = _lanes(state0)
    K._check(tape, "tape", torch.float32, (steps, len(RAW_TAPE_FIELDS), n_lanes))
    K._check(g_rad_scaled, "g_rad_scaled", torch.float32, (n_bins, n_lanes))
    f, i = K._params(ctx, resolution, streams, n_bins, steps, 1)
    lib = _build.load()
    _check_raw_layout(lib)
    device = state0.px.device
    D, H, W = ctx.density.shape
    TH, TW, TC = ctx.material_tf.shape
    g = dict(density=torch.zeros((D, H, W), dtype=torch.float32, device=device),
             material_tf=torch.zeros((TH, TW, TC), dtype=torch.float32, device=device),
             light_spectrum=torch.zeros(ctx.light_spectrum.shape, dtype=torch.float32,
                                        device=device))
    ext_acc = torch.zeros(1, dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        err = lib.vpt_raw_replay(
            f.ctypes.data, i.ctypes.data, int(ctx.seed_bits) & 0xFFFFFFFF,
            float(np.float32(inv_mu)), *(getattr(state0, k).data_ptr() for k in K.STATE_FIELDS[:10]),
            K.density_table(ctx).data_ptr(), ctx.material_tf.data_ptr(), K._light_ptr(ctx),
            tape.data_ptr(), g_rad_scaled.data_ptr(), g["density"].data_ptr(),
            g["material_tf"].data_ptr(), g["light_spectrum"].data_ptr(), ext_acc.data_ptr(),
            K._stream(device))
    K._raise_on(err, "raw_replay")
    LAUNCHES["raw_replay"] += 1
    g["extinction"] = ext_acc.to(torch.float32).reshape(())
    return g


def spectral_backward(state0, ctx, g_image, steps: int, n_bins: int,
                      volume_filter: str = "linear"):
    """Hand-derived gradients of one render dispatch over raw tables, by
    path replay (JAX ``spectral_backward``): (state_out, image, grads),
    grads = dict(density (D, H, W), material_tf (H, W, 4), light_spectrum
    (N,), extinction ()), the cotangents of the dispatch's image contracted
    with ``g_image``; ``state0`` stays untouched. K13 tapes the dispatch,
    K14 walks each lane's tape, replays the dispatch and scatters the
    analytic terms into the raw tables."""
    ctx = raw_ctx(ctx, volume_filter)
    state_out, tape = raw_tape(state0, ctx, steps, n_bins)
    lane, _, _, _ = _lanes(state0)
    g_rs = _deposit_cotangents(g_image, ctx, lane, n_bins, _m_final(state_out))
    grads = raw_replay(state0, ctx, tape, g_rs, steps, n_bins)
    return state_out, _image(state_out, ctx), grads


# ---------------------------------------------------------------------------
# K-dispatch windows
# ---------------------------------------------------------------------------
def _seeds(seeds):
    return [int(s) for s in np.asarray(seeds, np.uint32).reshape(-1)]


def _prb_many_core(state0, ctx, seeds, g_image, steps, n_bins, wrt, scatter_stride,
                   m_final, starts=None, scatter_mode: str = "stride"):
    """The packed backward over K per-dispatch seeds, one dispatch per K4/K5
    launch pair, contracting once at the end.

    ``starts=None`` (sequential): forward dispatch order, each dispatch with
    a zero carry and its own sample counts; returns (state, image, grads).
    ``starts`` given (window, forward storage): reverse dispatch order from
    the stored start states, the carry threaded across dispatches and the
    window-final ``m_final``; returns grads."""
    seeds = _seeds(seeds)
    n = len(seeds)
    fields = ctx_tape_fields(ctx, wrt)
    lane, resolution, streams, n_lanes = _lanes(state0)
    stride = max(int(scatter_stride), 1)
    adj = _packed_adj_init(ctx, wrt)
    inv_mu = _inv_mu(ctx)
    dev = state0.px.device

    def zero_cot():
        return dict(c=torch.zeros(n_lanes, dtype=torch.float32, device=dev),
                    cb=torch.zeros(n_lanes, dtype=torch.float32, device=dev))

    if starts is None:
        state = state0
        for k, seed in enumerate(seeds):
            state, tapes = tape_forward(state, ctx, [seed], steps, n_bins, wrt)
            g_rs = _deposit_cotangents(g_image, ctx, lane, n_bins, _m_final(state))
            prb_reverse(tapes, fields, g_rs, zero_cot(), adj,
                        [_dispatch_phase(k, seed, n, stride)], [seed],
                        scatter_stride=stride, scatter_mode=scatter_mode, inv_mu=inv_mu,
                        resolution=resolution, streams=streams)
        return state, _image(state, ctx), _contract_packed_adjoints(adj, ctx, wrt)

    g_rs = _deposit_cotangents(g_image, ctx, lane, n_bins, m_final)
    cot = zero_cot()
    for k in range(n - 1, -1, -1):
        _, tapes = tape_forward(starts[k], ctx, [seeds[k]], steps, n_bins, wrt)
        prb_reverse(tapes, fields, g_rs, cot, adj,
                    [_dispatch_phase(k, seeds[k], n, stride)], [seeds[k]],
                    scatter_stride=stride, scatter_mode=scatter_mode, inv_mu=inv_mu,
                    resolution=resolution, streams=streams)
    return _contract_packed_adjoints(adj, ctx, wrt)


def _tape_forward_sweep(state0, ctx, seeds, steps, n_bins, wrt):
    """One taped forward over the K dispatches (one K4 launch):
    (state_f, tapes (K, steps, F, lanes), image, m_final)."""
    state_f, tapes = tape_forward(state0, ctx, _seeds(seeds), steps, n_bins, wrt)
    return state_f, tapes, _image(state_f, ctx), _m_final(state_f)


def _tape_reverse_sweep(state0, ctx, seeds, tapes, m_final, g_image, steps, n_bins, wrt,
                        scatter_stride, scatter_mode: str = "stride"):
    """One reverse pass over the stored tapes (one K5 launch), the carry
    threaded across dispatches; contracts the packed adjoints once."""
    seeds = _seeds(seeds)
    lane, resolution, streams, n_lanes = _lanes(state0)
    stride = max(int(scatter_stride), 1)
    adj = _packed_adj_init(ctx, wrt)
    dev = state0.px.device
    cot = dict(c=torch.zeros(n_lanes, dtype=torch.float32, device=dev),
               cb=torch.zeros(n_lanes, dtype=torch.float32, device=dev))
    phases = [_dispatch_phase(k, s, len(seeds), stride) for k, s in enumerate(seeds)]
    prb_reverse(tapes, ctx_tape_fields(ctx, wrt),
                _deposit_cotangents(g_image, ctx, lane, n_bins, m_final),
                cot, adj, phases, seeds, scatter_stride=stride, scatter_mode=scatter_mode,
                inv_mu=_inv_mu(ctx), resolution=resolution, streams=streams)
    return _contract_packed_adjoints(adj, ctx, wrt)


def _window_tape_bytes(state0, ctx, steps, n_dispatches, wrt) -> int:
    """Bytes of the stacked window tape."""
    return (int(np.prod(state0.px.shape)) * steps * n_dispatches
            * len(ctx_tape_fields(ctx, wrt)) * 4)


def resolve_storage(window_storage, tape_bytes: int) -> str:
    """A window's schedule, "tape" or "forward"; "auto" keeps the tape while
    its ``tape_bytes`` fit under ``_TAPE_AUTO_LIMIT_BYTES``."""
    if window_storage == "auto":
        return "tape" if tape_bytes <= _TAPE_AUTO_LIMIT_BYTES else "forward"
    if window_storage not in ("tape", "forward"):
        raise ValueError(f"unknown window_storage {window_storage!r}")
    return window_storage


def _window_forward(state0, ctx, seeds, steps, n_bins):
    """Untaped K-dispatch forward (one K1 launch per dispatch):
    (m_final, image, start_states, state_f), ``start_states`` listing each
    dispatch's start state; ``state0`` stays untouched."""
    state = clone_state(state0)
    starts = []
    for s in _seeds(seeds):
        starts.append(clone_state(state))
        K.step(state, ctx, [s], steps, n_bins)
    return _m_final(state), _image(state, ctx), starts, state


def prb_render_and_grads_many(state0, ctx, seeds, g_image, steps: int, n_bins: int,
                              volume_filter: str = "linear", wrt=ALL_WRT,
                              scatter_stride: int = 1, scatter_mode: str = "stride",
                              window: bool = True, window_storage: str = "auto"):
    """K taped fwd+bwd dispatches: (state_out, image, grads), grads summed
    over the window and addressing the raw tables.

    ``window=True``: the window-exact estimator (reverse dispatch order, the
    (c, cb) carry threaded across dispatch boundaries, window-final
    normalizer). ``window=False``: K sequential single-dispatch backwards.
    ``window_storage``: "tape" (one K4 launch taping all K dispatches, one
    K5 launch), "forward" (store start states, re-simulate each dispatch
    taped in reverse order), or "auto" (tape while it fits in 6 GiB)."""
    ctx = packed_ctx(ctx, volume_filter)
    wrt = frozenset(wrt)
    if not window:
        return _prb_many_core(state0, ctx, seeds, g_image, steps, n_bins, wrt,
                              scatter_stride, None, scatter_mode=scatter_mode)
    n = len(_seeds(seeds))
    if resolve_storage(window_storage, _window_tape_bytes(state0, ctx, steps, n, wrt)) == "tape":
        state_f, tapes, image, m_final = _tape_forward_sweep(state0, ctx, seeds, steps,
                                                             n_bins, wrt)
        grads = _tape_reverse_sweep(state0, ctx, seeds, tapes, m_final, g_image, steps,
                                    n_bins, wrt, scatter_stride, scatter_mode)
        return state_f, image, grads
    m_final, image, starts, state_f = _window_forward(state0, ctx, seeds, steps, n_bins)
    grads = _prb_many_core(state0, ctx, seeds, g_image, steps, n_bins, wrt, scatter_stride,
                           m_final, starts=starts, scatter_mode=scatter_mode)
    return state_f, image, grads


def prb_loss_and_grads(state0, ctx, seeds, target, steps: int, n_bins: int,
                       volume_filter: str = "linear", wrt=frozenset({"density"}),
                       scatter_stride: int = 1, scatter_mode: str = "stride",
                       window_storage: str = "auto"):
    """MSE loss + hand-derived gradients over a K-dispatch render window,
    the engine of ``optim.fit_spectral(method="prb")``:
    (state_out, image, loss, grads). The image cotangent is
    g = 2 (image - target) / numel."""
    ctx = packed_ctx(ctx, volume_filter)
    wrt = frozenset(wrt)
    n = len(_seeds(seeds))
    if resolve_storage(window_storage, _window_tape_bytes(state0, ctx, steps, n, wrt)) == "tape":
        state_f, tapes, image, m_final = _tape_forward_sweep(state0, ctx, seeds, steps,
                                                             n_bins, wrt)
        g_image = sampling.div_scalar(2.0 * (image - target), float(image.numel()))
        grads = _tape_reverse_sweep(state0, ctx, seeds, tapes, m_final, g_image, steps,
                                    n_bins, wrt, scatter_stride, scatter_mode)
    else:
        m_final, image, starts, state_f = _window_forward(state0, ctx, seeds, steps, n_bins)
        g_image = sampling.div_scalar(2.0 * (image - target), float(image.numel()))
        grads = _prb_many_core(state0, ctx, seeds, g_image, steps, n_bins, wrt,
                               scatter_stride, m_final, starts=starts,
                               scatter_mode=scatter_mode)
    loss = torch.mean((image - target) ** 2)
    return state_f, image, loss, grads
