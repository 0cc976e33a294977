"""Inverse rendering with the spectral MCM renderer: recover scene tables
from a target render by Adam on the packed-adjoint PRB gradients.

Counterpart of the PRB half of ``vpt_tpu/optim.py``: ``sanitize_grads``,
``_pack_params_into_ctx``, ``make_spectral_prb_step``, the adaptive
scatter-stride policy (``live_gradient_fraction``, ``auto_initial_stride``,
``auto_initial_policy``, ``EvalStallDetector``) and
``fit_spectral(method="prb")``. Each iteration is one
``prb_loss_and_grads`` window: K taped forward dispatches, the loss and its
image cotangent, the reverse sweep, the contraction to the raw tables, and
an Adam step.

Adam is written out as plain tensor ops in the order optax uses, so a
trajectory follows ``vpt_tpu.optim.fit_spectral``'s. A learned extinction
is read to the host once per iteration (the kernels take it as a scalar).

Not ported yet (each raises ``NotImplementedError``): the autodiff
surrogate (``method="autodiff"``), the inverse checkpoints
(``checkpoint=``), the EAM ``fit_density`` loop, and renderers in the
majorant, environment, quasicubic or compaction modes.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import NamedTuple

import numpy as np
import torch

from vpt_tpu_torch.kernels import corners
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.kernels.spectral_backward import (_check_packed_ctx, clone_state,
                                                      prb_loss_and_grads)
from vpt_tpu_torch.models.mcm_spectral import radiance_to_rgb
from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.ops.sampling import div_scalar

LIVE_FRACTION_STRIDE_THRESHOLD = 0.15


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


def sanitize_grads(grads: dict, clip: float) -> dict:
    """NaN -> 0, +/-inf -> +/-clip, then clamp to [-clip, clip]: the spike
    guard against the score estimator's heavy tails (see vpt_tpu.optim)."""
    return {k: torch.clamp(torch.nan_to_num(g, nan=0.0, posinf=clip, neginf=-clip), -clip, clip)
            for k, g in grads.items()}


def _pack_params_into_ctx(base_ctx, params: dict, raw_mtf=None, raw_light=None) -> dict:
    """Re-pack learned RAW tables into the base ctx's packed representation
    (a flat f32 ``PackedVolume``, the fused 18-wide TF+light table) by K10
    ``pack_corners`` (``kernels/corners.py``): the ctx fields to replace.
    ``raw_mtf`` / ``raw_light`` stand in for the fused table's unlearned
    half."""
    unknown = set(params) - {"density", "material_tf", "light_spectrum", "extinction"}
    if unknown:
        raise NotImplementedError(f"learning {sorted(unknown)} is not ported")
    updates = {}
    if "density" in params:
        updates["density"] = interp.PackedVolume(corners.pack_volume(params["density"]),
                                                 base_ctx.density.dims)
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
    """Recover spectral-MCM scene tables from a target HDR render by the
    PRB gradients (``method="prb"``, the default for the port's packed
    renderer). ``init_params``: a subset of {density, material_tf,
    light_spectrum, extinction}, arrays or tensors. ``scatter_stride="auto"``
    picks the initial (mode, stride) with ``auto_initial_policy`` and, while
    thinned, anneals to stride 1 when a fixed-seed eval loss stalls; an
    integer forces the stride (lowered to the largest divisor of ``steps``
    with a warning). Returns (params, losses) or, with ``return_info``,
    (params, losses, info), as ``vpt_tpu.optim.fit_spectral`` does."""
    if method is None:
        method = "prb"
    if method == "autodiff":
        raise NotImplementedError("fit_spectral(method='autodiff') (the autodiff surrogate) "
                                  "is not ported to the torch package")
    if method != "prb":
        raise ValueError(f"unknown method {method!r} (prb | autodiff)")
    if checkpoint is not None:
        raise NotImplementedError("fit_spectral checkpoints are not ported to the torch package")
    if renderer.compaction:
        raise NotImplementedError("fit_spectral on a compacted renderer (the backward over "
                                  "a lane table) is not ported to the torch package")
    device = renderer.device
    base_ctx = renderer.ctx(camera, seed)
    _check_packed_ctx(base_ctx)
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
        warnings.warn(f"scatter_stride={scatter_stride} does not divide steps={steps}; using "
                      f"the largest divisor {eff} (the effective estimator differs from the "
                      "requested one)")
        scatter_stride = eff

    def make_step(stride, mode):
        return make_spectral_prb_step(optimizer, steps, n_bins, wrt=frozenset(params),
                                      scatter_stride=stride, scatter_mode=mode,
                                      raw_mtf=raw_mtf, raw_light=raw_light)

    step = make_step(scatter_stride, scatter_mode)
    info["stride_history"].append((0, f"{scatter_mode}:{scatter_stride}"))
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
    for i in range(iterations):
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
    info["final_stride"] = int(scatter_stride)
    if return_info:
        return istate.params, losses, info
    return istate.params, losses
