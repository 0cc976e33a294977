"""Ray-setup geometry: cube intersection and stochastic unprojection.

Counterpart of ``vpt_tpu/ops/geometry.py``; every function works on lane
tensors of any shape.
"""

from __future__ import annotations

import torch

from vpt_tpu_torch.ops import sampling


def intersect_cube(ox, oy, oz, dx, dy, dz):
    """Slab test of a ray against the unit cube [0,1]^3 -> (tnear, tfar).

    Division by a zero direction component gives +/-inf (or NaN for a zero
    numerator) by design; ``torch.minimum``/``maximum`` propagate NaN like
    the reference's min/max."""
    t0x, t0y, t0z = (0.0 - ox) / dx, (0.0 - oy) / dy, (0.0 - oz) / dz
    t1x, t1y, t1z = (1.0 - ox) / dx, (1.0 - oy) / dy, (1.0 - oz) / dz
    tnear = torch.maximum(
        torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
        torch.minimum(t0z, t1z),
    )
    tfar = torch.minimum(
        torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
        torch.maximum(t0z, t1z),
    )
    return tnear, tfar


def apply_homogeneous(m, x, y, z: float):
    """(4,4) row-major matrix times (x, y, z, 1) with perspective divide.

    ``m``: a float32 numpy array or nested list; its entries are exact
    float32 values, so each scalar product rounds like the reference's."""
    m = [[float(v) for v in row] for row in m]
    out = []
    for i in range(4):
        out.append(m[i][0] * x + m[i][1] * y + m[i][2] * z + m[i][3] * 1.0)
    rx, ry, rz, rw = out
    return rx / rw, ry / rw, rz / rw


def unproject_rand(state, mask, sx, sy, inv_mvp, inv_resolution: float, blur: float):
    """Jittered NDC->world unprojection (depth of field + AA jitter).

    Draw order: disk (2 draws) for the near-plane offset, then square
    (2 draws) for the far-plane jitter. Returns (state, near, far)."""
    state, (ox, oy) = sampling.draw_disk(state, mask)
    near_x = sx + ox * blur
    near_y = sy + oy * blur

    state, (ax, ay) = sampling.draw_square(state, mask)
    far_x = sx + (ax * 2.0 - 1.0) * inv_resolution
    far_y = sy + (ay * 2.0 - 1.0) * inv_resolution

    near = apply_homogeneous(inv_mvp, near_x, near_y, -1.0)
    far = apply_homogeneous(inv_mvp, far_x, far_y, 1.0)
    return state, near, far


def normalize3(x, y, z):
    inv = 1.0 / torch.sqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


def screen_position(ix, iy, inv_resolution: float):
    """Pixel index -> NDC with the reference's y-flip."""
    sx = ((ix.to(torch.float32) + 0.5) * inv_resolution - 0.5) * 2.0
    sy = ((iy.to(torch.float32) + 0.5) * inv_resolution - 0.5) * -2.0
    return sx, sy
