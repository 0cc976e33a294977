"""Counter/hash RNG and sampling distributions on torch lane tensors.

Counterpart of ``vpt_tpu/ops/sampling.py``: the same PCG chain and the same
masked draws, so each lane consumes the reference's data-dependent number
of uniforms in the reference's order.

RNG states are int64 tensors that hold uint32 values. PyTorch has no uint32
``+``, ``>>`` or comparisons on the CPU, so the hash computes in int64 and
masks with ``& 0xFFFFFFFF``; every product stays below 2**63 because both
factors are below 2**32. ``int64 -> float32`` rounds like the reference's
``u32 -> f32``.
"""

from __future__ import annotations

import numpy as np
import torch

TWOPI = 6.28318530718
EPS = 1e-5
MASK32 = 0xFFFFFFFF

# f32(~0u) in WGSL: 4294967295 rounds to 2^32 as float32.
INV_U32_MAX = float(np.float32(1.0) / np.float32(np.float64(0xFFFFFFFF)))


def div_scalar(x: torch.Tensor, s: float) -> torch.Tensor:
    """IEEE division of ``x`` by the scalar ``s``. On CUDA, PyTorch turns
    ``tensor / python_scalar`` into a multiply by the reciprocal, which is
    off by an ulp for many values (e.g. 126 of the 256 u8 codes / 255);
    dividing by a device tensor keeps the true division."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG-style avalanche hash on uint32 values held in int64."""
    x = (x.to(torch.int64) * 747796405 + 2891336453) & MASK32
    x = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & MASK32
    return (x >> 22) ^ x


def hash3(x, y, z) -> torch.Tensor:
    """Squash-linear 3-component seed hash."""
    x, y, z = (torch.as_tensor(a).to(torch.int64) & MASK32 for a in (x, y, z))
    return pcg_hash((19 * x + 47 * y + 101 * z + 131) & MASK32)


def seed_state(ix, iy, frame_seed_bits: int) -> torch.Tensor:
    """Per-pixel chain seed: hash3(pixel_x, pixel_y, frame_seed_bits)."""
    z = torch.full_like(ix, int(frame_seed_bits) & MASK32, dtype=torch.int64)
    return hash3(ix, iy, z)


def uniform_from_state(state: torch.Tensor) -> torch.Tensor:
    """Map a uint32 state to [0,1) the way WGSL's f32 division does."""
    return state.to(torch.float32) * INV_U32_MAX


def draw(state, mask):
    """Advance the chain where ``mask``; return (new_state, uniform).

    Where mask is False the state is untouched and the uniform is garbage
    (callers select it away)."""
    state = torch.where(mask, pcg_hash(state), state)
    return state, uniform_from_state(state)


def draw_square(state, mask):
    """Two masked draws -> (state, (u, v)) uniform in the unit square."""
    state, x = draw(state, mask)
    state, y = draw(state, mask)
    return state, (x, y)


def draw_disk(state, mask):
    """Two masked draws -> (state, (x, y)) uniform on the unit disk."""
    state, u1 = draw(state, mask)
    state, u2 = draw(state, mask)
    radius = torch.sqrt(u1)
    angle = u2 * float(np.float32(TWOPI))
    return state, (radius * torch.cos(angle), radius * torch.sin(angle))


def draw_sphere(state, mask):
    """Marsaglia (1972) uniform direction: disk sample -> sphere point."""
    state, (dx, dy) = draw_disk(state, mask)
    norm = dx * dx + dy * dy
    radius = 2.0 * torch.sqrt(torch.clamp_min(1.0 - norm, 0.0))
    return state, (radius * dx, radius * dy, 1.0 - 2.0 * norm)


def draw_exponential(state, mask, rate):
    """Free-flight distance: -ln(u)/rate; ``rate`` a float or a lane tensor."""
    state, u = draw(state, mask)
    if torch.is_tensor(rate):
        return state, -torch.log(u) / rate
    return state, div_scalar(-torch.log(u), rate)


def rsqrt_safe(x):
    """1/sqrt(x) with 0-input guarded (degenerate tangent frame)."""
    return torch.where(x > 0, 1.0 / torch.sqrt(torch.clamp_min(x, 1e-30)),
                       torch.zeros_like(x))


def draw_hg(state, mask, g, dx, dy, dz):
    """Henyey-Greenstein direction about (dx,dy,dz) with per-lane g.

    A uniform sphere direction is returned as-is where |g| < EPS; the cosine
    draw happens only on lanes where |g| >= EPS."""
    state, (ux, uy, uz) = draw_sphere(state, mask)
    aniso = torch.abs(g) >= EPS
    state, ucos = draw(state, mask & aniso)

    gs = torch.where(aniso, g, torch.full_like(g, 0.5))
    g2 = gs * gs
    c = (1.0 - g2) / (1.0 - gs + 2.0 * gs * ucos)
    hgcos = (1.0 + g2 - c * c) / (2.0 * gs)
    hgcos = torch.where(aniso, hgcos, torch.zeros_like(hgcos))

    udotd = ux * dx + uy * dy + uz * dz
    cx = ux - udotd * dx
    cy = uy - udotd * dy
    cz = uz - udotd * dz
    cn = rsqrt_safe(cx * cx + cy * cy + cz * cz)
    s = torch.sqrt(torch.clamp_min(1.0 - hgcos * hgcos, 0.0))
    ox = s * cx * cn + hgcos * dx
    oy = s * cy * cn + hgcos * dy
    oz = s * cz * cn + hgcos * dz
    return state, (torch.where(aniso, ox, ux), torch.where(aniso, oy, uy),
                   torch.where(aniso, oz, uz))
