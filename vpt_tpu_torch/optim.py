"""Inverse rendering with the spectral MCM renderer: recover scene tables
from a target render by Adam on the packed-adjoint PRB gradients or the
autodiff surrogate's.

Counterpart of the spectral half of ``vpt_tpu/optim.py``: the inverse
checkpoints (``save_inverse_checkpoint``, ``load_inverse_checkpoint``),
``sanitize_grads``, ``spectral_render_loss`` and
``make_spectral_inverse_step`` (the surrogate), ``_pack_params_into_ctx``,
``make_spectral_prb_step``, the adaptive scatter-stride policy
(``live_gradient_fraction``, ``auto_initial_stride``,
``auto_initial_policy``, ``EvalStallDetector``) and ``fit_spectral``. A PRB
iteration is one ``prb_loss_and_grads`` window: K taped forward
dispatches, the loss and its image cotangent, the reverse sweep, the
contraction to the raw tables, and an Adam step. An autodiff iteration
re-packs the learned tables by ``corners.PackCorners``, renders through
``render_sequence_diff`` and backpropagates with torch autograd, whose
per-dispatch backward is the surrogate's hand-written kernels
(``kernels/surrogate.py``).

Adam is written out as plain tensor ops in the order optax uses, so a
trajectory follows ``vpt_tpu.optim.fit_spectral``'s. A learned extinction
is read to the host once per iteration (the kernels take it as a scalar).

The learnable keys are density, material_tf, light_spectrum, extinction
and, on an env-lit renderer, environment (the raw (He, We, 3) equirect
map). A learned density is re-packed into the renderer's volume kind, the
full corner table or the xy half-packed one. ``fit_spectral`` renders with
the linear filter whatever the renderer's, as the reference does: its
loss and its PRB step pass no filter, and its ctx holds none.

Not ported yet (each raises ``NotImplementedError``): the EAM
``fit_density`` loop, and the autodiff surrogate over an xy half-packed
volume or raw or partly packed tables (the next slice), which is where the
reference routes a raw renderer by default; ``method="prb"`` on such a
renderer fails the reference's assertions (``AssertionError``: the packed
backward needs the fused TF and a packed volume). A compacted renderer raises
``ValueError``, as the reference's ``fit_spectral`` does (its reset state
has the lane table's shape).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import NamedTuple

import numpy as np
import torch

from vpt_tpu_torch.kernels import corners
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.kernels.spectral_backward import clone_state, packed_ctx, prb_loss_and_grads
from vpt_tpu_torch.kernels.surrogate import check_ctx as check_surrogate_ctx
from vpt_tpu_torch.models.mcm_spectral import radiance_to_rgb, render_sequence_diff
from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.ops.sampling import div_scalar

LIVE_FRACTION_STRIDE_THRESHOLD = 0.15
LEARNABLE = frozenset({"density", "material_tf", "light_spectrum", "extinction", "environment"})


class InverseState(NamedTuple):
    params: dict  # raw tables by name (any subset of the learnable keys)
    opt_state: dict
    step: int


class Adam:
    """Adam in optax's form: mu, nu moments, bias corrections
    mu / (1 - b1^t) and nu / (1 - b2^t), update
    -lr * mu_hat / (sqrt(nu_hat) + eps)."""

    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params: dict) -> dict:
        return dict(count=0, mu={k: torch.zeros_like(v) for k, v in params.items()},
                    nu={k: torch.zeros_like(v) for k, v in params.items()})

    def update(self, grads: dict, state: dict, params: dict):
        """(new params, new state) after one step on ``grads``."""
        count = state["count"] + 1
        out, mu, nu = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            mu[k] = (1 - self.b1) * g + self.b1 * state["mu"][k]
            nu[k] = (1 - self.b2) * (g ** 2) + self.b2 * state["nu"][k]
            bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** count
            bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** count
            mu_hat = div_scalar(mu[k], float(bc1))
            nu_hat = div_scalar(nu[k], float(bc2))
            u = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            out[k] = p + (-self.lr) * u
        return out, dict(count=count, mu=mu, nu=nu)


def _leaves(istate: InverseState) -> list:
    """``jax.tree.leaves`` order of ``vpt_tpu.optim.InverseState`` with an
    ``optax.adam`` state: the params by sorted key, Adam's count, mu and nu
    by sorted key, the step."""
    keys = sorted(istate.params)
    opt = istate.opt_state
    return ([istate.params[k] for k in keys] + [opt["count"]] + [opt["mu"][k] for k in keys]
            + [opt["nu"][k] for k in keys] + [istate.step])


def save_inverse_checkpoint(path: str, istate: InverseState) -> None:
    """Persist (params, Adam state, step) as ``vpt_tpu.optim`` does: an
    ``np.savez`` of ``n_leaves`` and ``leaf_i`` in its leaf order (counts
    as int32 scalars), so the files interchange both ways."""
    leaves = []
    for leaf in _leaves(istate):
        if torch.is_tensor(leaf):
            leaves.append(leaf.detach().cpu().numpy())
        else:
            leaves.append(np.asarray(leaf, np.int32))
    np.savez(path, n_leaves=len(leaves), **{f"leaf_{i}": v for i, v in enumerate(leaves)})


def load_inverse_checkpoint(path: str, template: InverseState) -> InverseState:
    """Restore an ``InverseState`` saved by ``save_inverse_checkpoint`` (or
    by ``vpt_tpu.optim``'s) onto the template's devices; the template's
    values are ignored, its params keys give the structure."""
    keys = sorted(template.params)
    n = len(keys)
    with np.load(path) as data:
        got = int(data["n_leaves"])
        if got != 3 * n + 2:
            raise ValueError(f"checkpoint has {got} leaves; template has {3 * n + 2} "
                             "(different params subset or optimizer?)")
        leaves = [data[f"leaf_{i}"] for i in range(got)]

    def tensor(a, like):
        return torch.as_tensor(np.array(a, np.float32), device=like.device).reshape(like.shape)

    params = {k: tensor(leaves[i], template.params[k]) for i, k in enumerate(keys)}
    mu = {k: tensor(leaves[n + 1 + i], template.params[k]) for i, k in enumerate(keys)}
    nu = {k: tensor(leaves[2 * n + 1 + i], template.params[k]) for i, k in enumerate(keys)}
    return InverseState(params, dict(count=int(leaves[n]), mu=mu, nu=nu), int(leaves[-1]))


def sanitize_grads(grads: dict, clip: float) -> dict:
    """NaN -> 0, +/-inf -> +/-clip, then clamp to [-clip, clip]: the spike
    guard against the score estimator's heavy tails (see vpt_tpu.optim)."""
    return {k: torch.clamp(torch.nan_to_num(g, nan=0.0, posinf=clip, neginf=-clip), -clip, clip)
            for k, g in grads.items()}


def spectral_render_loss(params: dict, state0, base_ctx, seeds, target, steps: int, n_bins: int,
                         raw_mtf=None, raw_light=None):
    """MSE between the autodiff surrogate's render (``render_sequence_diff``
    from ``state0``) and ``target``, differentiable w.r.t. ``params``: raw
    tables (any subset of ``LEARNABLE``) that ``corners.PackCorners`` packs
    into the base ctx's representation. ``raw_mtf`` / ``raw_light`` stand in
    for the fused table's unlearned half. The port always packs (JAX
    ``pack_params=True``); the fused table carries the light pair, so the
    light comes from it in both cases. Rendered with the linear filter, as
    the reference's loss is."""
    _check_keys(params, base_ctx)
    updates = {}
    if "density" in params:
        vol = base_ctx.density
        updates["density"] = interp.PackedVolume(
            corners.pack_volume_diff(params["density"], vol.kind), vol.dims, vol.kind)
    if "material_tf" in params or "light_spectrum" in params:
        mtf = params.get("material_tf", raw_mtf)
        light = params.get("light_spectrum", raw_light)
        if mtf is None or light is None:
            raise ValueError("fused-TF ctx needs raw_mtf/raw_light fallbacks when only "
                             "one of material_tf/light_spectrum is learned")
        updates["material_tf"] = corners.pack_tf_diff(mtf, light)
    if "extinction" in params:
        updates["extinction"] = params["extinction"]
    if "environment" in params:
        updates["environment"] = corners.pack_env_diff(params["environment"])
    ctx = dataclasses.replace(base_ctx, **updates)
    img = render_sequence_diff(seeds, state0, ctx, steps, n_bins)
    return torch.mean((img - target) ** 2)


def _check_keys(params, base_ctx):
    unknown = set(params) - LEARNABLE
    if unknown:
        raise NotImplementedError(f"learning {sorted(unknown)} is not ported")
    if "environment" in params and base_ctx.environment is None:
        raise ValueError("learning the environment needs an env-lit renderer (its ctx has no "
                         "environment map to re-pack into)")


def make_spectral_inverse_step(optimizer: Adam, steps: int, n_bins: int,
                               clip_params=("density", "material_tf"), grad_clip: float = 1e3,
                               raw_mtf=None, raw_light=None):
    """An Adam step on the autodiff surrogate's gradients:
    ``step(istate, state0, base_ctx, seeds, target) -> (istate, loss)``.
    ``grad_clip``: the ``sanitize_grads`` spike guard (None disables)."""

    def step(istate: InverseState, state0, base_ctx, seeds, target):
        params = {k: v.detach().requires_grad_(True) for k, v in istate.params.items()}
        loss = spectral_render_loss(params, state0, base_ctx, seeds, target, steps, n_bins,
                                    raw_mtf=raw_mtf, raw_light=raw_light)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        with torch.no_grad():
            if grad_clip is not None:
                grads = sanitize_grads(grads, grad_clip)
            new, opt_state = optimizer.update(grads, istate.opt_state,
                                              {k: v.detach() for k, v in params.items()})
            for key in clip_params:
                if key in new:
                    new[key] = torch.clamp(new[key], 0.0, 1.0)
        return InverseState(new, opt_state, istate.step + 1), loss.detach()

    return step


def _pack_params_into_ctx(base_ctx, params: dict, raw_mtf=None, raw_light=None) -> dict:
    """Re-pack learned RAW tables into the base ctx's packed representation
    (a flat f32 ``PackedVolume`` of the base's kind, full or xy; the fused
    18-wide TF+light table; the 12-wide environment map) by K10
    ``pack_corners`` (``kernels/corners.py``): the ctx fields to replace.
    ``raw_mtf`` / ``raw_light`` stand in for the fused table's unlearned
    half."""
    _check_keys(params, base_ctx)
    updates = {}
    if "density" in params:
        vol = base_ctx.density
        updates["density"] = interp.PackedVolume(corners.pack_volume(params["density"], vol.kind),
                                                 vol.dims, vol.kind)
    if "material_tf" in params or "light_spectrum" in params:
        mtf = params.get("material_tf", raw_mtf)
        light = params.get("light_spectrum", raw_light)
        if mtf is None or light is None:
            raise ValueError("fused-TF ctx needs raw_mtf/raw_light fallbacks when only "
                             "one of material_tf/light_spectrum is learned")
        fused, pairs = corners.pack_tf(mtf, light, pairs="light_spectrum" in params)
        updates["material_tf"] = fused
        if pairs is not None:
            updates["light_spectrum"] = pairs
    if "extinction" in params:
        updates["extinction"] = np.float32(float(params["extinction"]))
    if "environment" in params:
        updates["environment"] = corners.pack_env(params["environment"])
    return updates


def make_spectral_prb_step(optimizer: Adam, steps: int, n_bins: int, wrt,
                           scatter_stride: int = 1, scatter_mode: str = "stride",
                           clip_params=("density", "material_tf"), raw_mtf=None,
                           raw_light=None, grad_clip: float = 1e3):
    """An Adam step on the packed-adjoint PRB gradients:
    ``step(istate, state0, base_ctx, seeds, target) -> (istate, loss)``.
    ``wrt`` must cover every learned key; ``state0`` stays untouched."""
    wrt = frozenset(wrt)

    def step(istate: InverseState, state0, base_ctx, seeds, target):
        with torch.no_grad():
            packed = _pack_params_into_ctx(base_ctx, istate.params, raw_mtf=raw_mtf,
                                           raw_light=raw_light)
            ctx = dataclasses.replace(base_ctx, **packed)
            _, _, loss, grads = prb_loss_and_grads(
                state0, ctx, seeds, target, steps, n_bins, wrt=wrt,
                scatter_stride=scatter_stride, scatter_mode=scatter_mode)
            grads = {k: grads[k].reshape(istate.params[k].shape) for k in istate.params}
            if grad_clip is not None:
                grads = sanitize_grads(grads, grad_clip)
            params, opt_state = optimizer.update(grads, istate.opt_state, istate.params)
            for key in clip_params:
                if key in params:
                    params[key] = torch.clamp(params[key], 0.0, 1.0)
        return InverseState(params, opt_state, istate.step + 1), loss

    return step


def live_gradient_fraction(density, tf_table, eps: float = 1e-6) -> float:
    """Fraction of voxels whose density lands on a TF row with nonzero
    alpha-slope along the density axis: the voxels a density gradient can
    reach through the TF chain. One host pass over the raw tables."""
    tf = np.asarray(tf_table, np.float64)
    H = tf.shape[0]
    alpha = tf[..., 1]
    row_slope = np.abs(np.diff(alpha, axis=0)).max(axis=1)
    d = np.asarray(density, np.float64).ravel()
    r0 = np.clip(np.floor(d * H - 0.5).astype(np.int64), 0, H - 2)
    return float((row_slope[r0] > eps).mean())


def auto_initial_stride(init_density, tf_table, dense_stride: int = 4,
                        threshold: float = LIVE_FRACTION_STRIDE_THRESHOLD):
    """(stride, live fraction): ``dense_stride`` on broad gradient support,
    1 on concentrated support. Prefer ``auto_initial_policy``."""
    frac = live_gradient_fraction(init_density, tf_table)
    return (dense_stride if frac >= threshold else 1), frac


def auto_initial_policy(init_density, tf_table, stride: int = 4,
                        threshold: float = LIVE_FRACTION_STRIDE_THRESHOLD):
    """(scatter_mode, stride, live fraction): uniform stride thinning on
    broad gradient support, importance thinning at the same budget on
    concentrated support."""
    frac = live_gradient_fraction(init_density, tf_table)
    if frac >= threshold:
        return "stride", stride, frac
    return "importance", stride, frac


class EvalStallDetector:
    """A stall is ``patience`` fixed-seed eval losses in a row that fail to
    improve on the best by ``rel_improve``."""

    def __init__(self, rel_improve: float = 0.02, patience: int = 2):
        self.rel_improve = rel_improve
        self.patience = patience
        self.best = float("inf")
        self.strikes = 0

    def update(self, eval_loss: float) -> bool:
        if eval_loss < self.best * (1.0 - self.rel_improve):
            self.best = eval_loss
            self.strikes = 0
        else:
            self.strikes += 1
        return self.strikes >= self.patience


def _frame_seeds(first: int, n: int) -> list:
    return [int(np.uint32((first + k) * 2654435761 % 2**32)) for k in range(n)]


def fit_spectral(target_image, renderer, camera, init_params: dict,
                 dispatches_per_step: int = 8, iterations: int = 100,
                 learning_rate: float = 0.02, seed: int = 0, progress=None,
                 method: str | None = None, scatter_stride="auto",
                 scatter_mode: str = "stride", checkpoint: str | None = None,
                 checkpoint_every: int = 25, eval_every: int = 10,
                 eval_dispatches: int = 16, return_info: bool = False):
    """Recover spectral-MCM scene tables from a target HDR render.
    ``init_params``: a subset of ``LEARNABLE`` (environment on an env-lit
    renderer), arrays or tensors. The renderer's volume kind (full or xy)
    is kept; its filter is not: the fit renders with the linear filter, as
    the reference's does.

    ``method``: "prb" (the packed-adjoint backward; honours
    ``scatter_stride``) or "autodiff" (the surrogate, the one gradient
    path of the majorant mode); None picks "prb" for the packed tables
    without a majorant grid and "autodiff" otherwise, and "prb" on a
    majorant renderer raises ``ValueError``, as the reference does. ``scatter_stride="auto"``
    picks PRB's initial (mode, stride) with ``auto_initial_policy`` and,
    while thinned, anneals to stride 1 when a fixed-seed eval loss stalls;
    an integer forces the stride (lowered to the largest divisor of
    ``steps`` with a warning).

    ``checkpoint``: a path for (params, Adam state, step) snapshots every
    ``checkpoint_every`` iterations and at the end
    (``save_inverse_checkpoint``); if the file exists the run resumes from
    it and ``losses`` covers the resumed iterations only. The auto-anneal
    state is not saved, as in the reference. Returns (params, losses) or,
    with ``return_info``, (params, losses, info), as
    ``vpt_tpu.optim.fit_spectral`` does."""
    if renderer.compaction:
        # the reference's fit_spectral fails too: the compacted reset state
        # (lane table shape) does not broadcast against the pixel grid
        raise ValueError("fit_spectral on a compacted renderer: the reset state has the lane "
                         "table's shape, which the reference's fit_spectral does not broadcast "
                         "either (ValueError: incompatible shapes)")
    device = renderer.device
    # the reference's loss, PRB step and eval pass no filter: linear
    base_ctx = dataclasses.replace(renderer.ctx(camera, seed), volume_filter="linear")
    if method is None:
        # the reference's default: PRB on the packed tables (fused TF and a
        # packed volume) without a majorant grid, else the surrogate
        packed = (base_ctx.material_tf.shape[-1] == 18
                  and isinstance(base_ctx.density, interp.PackedVolume))
        method = "prb" if packed and base_ctx.majorant is None else "autodiff"
    elif method == "prb" and base_ctx.majorant is not None:
        raise ValueError("the packed-PRB backward does not support the super-voxel majorant "
                         "mode; use method='autodiff' (the surrogate carries majorant-mode "
                         "gradients)")
    if method == "prb":
        packed_ctx(base_ctx)
    elif method == "autodiff":
        check_surrogate_ctx(base_ctx)
    else:
        raise ValueError(f"unknown method {method!r} (prb | autodiff)")
    state0 = renderer.reset(camera, seed)
    steps = renderer.config.steps
    n_bins = renderer.spectrum.n_bins

    params = {k: torch.as_tensor(np.asarray(v, np.float32) if not torch.is_tensor(v) else v,
                                 dtype=torch.float32, device=device).clone()
              for k, v in init_params.items()}
    optimizer = Adam(learning_rate)
    istate = InverseState(params, optimizer.init(params), 0)
    raw_mtf = torch.as_tensor(np.array(renderer.material_tf.table, np.float32), device=device)
    raw_light = torch.as_tensor(np.array(renderer.light.spectrum_array(), np.float32),
                                device=device)

    info = dict(method=method, live_fraction=None, stride_history=[], eval_checks=[])
    anneal_armed = False
    if method == "prb":
        if scatter_stride == "auto":
            probe_density = init_params.get("density", renderer.volume.density)
            probe_tf = init_params.get("material_tf", renderer.material_tf.table)
            if torch.is_tensor(probe_density):
                probe_density = probe_density.detach().cpu().numpy()
            if torch.is_tensor(probe_tf):
                probe_tf = probe_tf.detach().cpu().numpy()
            scatter_mode, scatter_stride, frac = auto_initial_policy(probe_density, probe_tf)
            info["live_fraction"] = frac
            anneal_armed = scatter_stride > 1
        if steps % scatter_stride != 0:
            eff = max(d for d in range(1, scatter_stride + 1) if steps % d == 0)
            warnings.warn(f"scatter_stride={scatter_stride} does not divide steps={steps}; "
                          f"using the largest divisor {eff} (the effective estimator differs "
                          "from the requested one)")
            scatter_stride = eff

        def make_step(stride, mode):
            return make_spectral_prb_step(optimizer, steps, n_bins, wrt=frozenset(params),
                                          scatter_stride=stride, scatter_mode=mode,
                                          raw_mtf=raw_mtf, raw_light=raw_light)

        step = make_step(scatter_stride, scatter_mode)
        info["stride_history"].append((0, f"{scatter_mode}:{scatter_stride}"))
    else:
        scatter_stride = 1
        step = make_spectral_inverse_step(optimizer, steps, n_bins, raw_mtf=raw_mtf,
                                          raw_light=raw_light)
        info["stride_history"].append((0, "autodiff"))

    start = 0
    if checkpoint and os.path.exists(checkpoint):
        istate = load_inverse_checkpoint(checkpoint, istate)
        start = istate.step
    target = torch.as_tensor(np.asarray(target_image, np.float32) if not torch.is_tensor(
        target_image) else target_image, dtype=torch.float32, device=device)

    detector = None
    if anneal_armed:
        eval_seeds = _frame_seeds(31337, eval_dispatches)
        detector = EvalStallDetector()

        def eval_loss(p):
            with torch.no_grad():
                packed = _pack_params_into_ctx(base_ctx, p, raw_mtf=raw_mtf, raw_light=raw_light)
                ctx = dataclasses.replace(base_ctx, **packed)
                s = clone_state(state0)
                K.step(s, ctx, eval_seeds, steps, n_bins)
                img = radiance_to_rgb(s.radiance, ctx.bin_xyz)
                return float(torch.mean((img - target) ** 2))

    losses = []
    for i in range(start, iterations):
        seeds = _frame_seeds(seed + 1 + i * dispatches_per_step, dispatches_per_step)
        istate, loss = step(istate, state0, base_ctx, seeds, target)
        losses.append(float(loss))
        if anneal_armed and (i + 1) % eval_every == 0:
            ev = eval_loss(istate.params)
            info["eval_checks"].append((i + 1, ev))
            if detector.update(ev):
                warnings.warn(f"eval loss stalled at iteration {i + 1} under {scatter_mode} "
                              f"thinning (stride {scatter_stride}); annealing to the exact "
                              "estimator (stride 1)")
                scatter_stride, scatter_mode = 1, "stride"
                step = make_step(1, "stride")
                info["stride_history"].append((i + 1, "stride:1"))
                anneal_armed = False
        if progress is not None and (i % 10 == 0 or i == iterations - 1):
            progress(i, losses[-1])
        if checkpoint and ((i + 1) % checkpoint_every == 0 or i == iterations - 1):
            save_inverse_checkpoint(checkpoint, istate)
    info["final_stride"] = int(scatter_stride)
    if return_info:
        return istate.params, losses, info
    return istate.params, losses
