"""Tone-mapping operators on torch tensors (counterpart of
``vpt_tpu/postprocess/tonemap.py``): artistic, range, reinhard, reinhard2,
uncharted2, filmic, unreal, aces, lottes, uchimura.

Each maps a linear-HDR (..., 3) image to display RGB in [0, 1], elementwise.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict

import torch

TONEMAPPERS: Dict[str, Callable] = {}


def register_tonemapper(key):
    def wrap(fn):
        TONEMAPPERS[key] = fn
        return fn

    return wrap


def make_tonemapper(key: str, **kw):
    """Factory dispatch by string key."""
    try:
        fn = TONEMAPPERS[key]
    except KeyError:
        raise ValueError(f"unknown tonemapper {key!r}; known: {sorted(TONEMAPPERS)}") from None
    return functools.partial(fn, **kw) if kw else fn


def _exposure_gamma(curve):
    """Most operators share the exposure -> curve -> 1/gamma shape."""

    def apply(x, exposure=1.0, gamma=2.2):
        y = curve(x * exposure)
        return torch.clamp(torch.abs(y) ** (1.0 / gamma) * torch.sign(y), 0.0, 1.0)

    return apply


@register_tonemapper("artistic")
def artistic(x, low=0.0, mid=0.5, high=1.0, saturation=1.0, gamma=2.2):
    """Low/mid/high levels + saturation + mid-anchored gamma."""
    c = (x - low) / (high - low)
    gray = torch.full((3,), 3.0 ** -0.5, dtype=x.dtype, device=x.device)
    luma = torch.sum(c * gray, dim=-1, keepdim=True)
    c = luma * gray + (c - luma * gray) * saturation
    midpoint = (mid - low) / (high - low)
    exponent = -math.log(midpoint) / math.log(2.0)
    return torch.clamp(torch.abs(c) ** (exponent / gamma), 0.0, 1.0)


@register_tonemapper("range")
def range_(x, minimum=0.0, maximum=1.0, gamma=2.2):
    y = (x - minimum) / (maximum - minimum)
    return torch.clamp(torch.abs(y) ** (1.0 / gamma) * torch.sign(y), 0.0, 1.0)


@register_tonemapper("reinhard")
@_exposure_gamma
def reinhard(x):
    return x / (1.0 + x)


@register_tonemapper("reinhard2")
@_exposure_gamma
def reinhard2(x):
    l_white = 4.0
    return (x * (1.0 + x / (l_white * l_white))) / (1.0 + x)


def _uncharted2_curve(x):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f


@register_tonemapper("uncharted2")
@_exposure_gamma
def uncharted2(x):
    w = 11.2
    exposure_bias = 2.0
    return _uncharted2_curve(exposure_bias * x) / _uncharted2_curve(w)


@register_tonemapper("filmic")
def filmic(x, exposure=1.0, gamma=2.2):
    # the filmic curve bakes in its own ^2.2, then the shared 1/gamma
    y = torch.clamp_min(x * exposure - 0.004, 0.0)
    y = (y * (6.2 * y + 0.5)) / (y * (6.2 * y + 1.7) + 0.06)
    y = y ** 2.2
    return torch.clamp(y ** (1.0 / gamma), 0.0, 1.0)


@register_tonemapper("unreal")
@_exposure_gamma
def unreal(x):
    return x / (x + 0.155) * 1.019


@register_tonemapper("aces")
@_exposure_gamma
def aces(x):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


@register_tonemapper("lottes")
@_exposure_gamma
def lottes(x):
    a, d = 1.6, 0.977
    hdr_max, mid_in, mid_out = 8.0, 0.18, 0.267
    b = (-(mid_in ** a) + hdr_max ** a * mid_out) / (
        (hdr_max ** (a * d) - mid_in ** (a * d)) * mid_out
    )
    c = (hdr_max ** (a * d) * mid_in ** a - hdr_max ** a * mid_in ** (a * d) * mid_out) / (
        (hdr_max ** (a * d) - mid_in ** (a * d)) * mid_out
    )
    x = torch.clamp_min(x, 0.0)
    return x ** a / (x ** (a * d) * b + c)


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


@register_tonemapper("uchimura")
@_exposure_gamma
def uchimura(x):
    p, a, m, l, c, b = 1.0, 1.0, 0.22, 0.4, 1.33, 0.0
    l0 = ((p - m) * l) / a
    s0 = m + l0
    s1 = m + a * l0
    c2 = (a * p) / (p - s1)
    cp = -c2 / p

    x = torch.clamp_min(x, 0.0)
    w0 = 1.0 - _smoothstep(0.0, m, x)
    w2 = (x >= m + l0).to(x.dtype)
    w1 = 1.0 - w0 - w2

    t = m * (x / m) ** c + b
    s = p - (p - s1) * torch.exp(cp * (x - s0))
    lin = m + a * (x - m)
    return t * w0 + lin * w1 + s * w2

