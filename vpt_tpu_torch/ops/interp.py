"""Texture sampling on torch lane tensors, raw and packed tables.

Counterpart of ``vpt_tpu/ops/interp.py``. Packed tables: a trilinear
footprint of the volume is one 8-wide corner row (kind "full") or two
4-wide rows of its z planes (kind "xy", the half-packed big-volume table
at 4x memory instead of 8x), a bilinear footprint of the material TF plus
the light spectrum's linear pair is one 18-wide row (or, without the light,
one 4C-wide row), a linear footprint of a 1D table one (N+1, 2) pair.
Raw tables: a (D, H, W) grid (linear, quasicubic or nearest filter), an
(H, W, C) texture, an (N,) table, each lookup gathering its corners one by
one. A raw lookup and the packed lookup of the same table lerp the same
corner values in the same order, so they give the same bits.
Semantics match WebGPU ``textureSampleLevel`` with normalized coordinates,
linear filtering and clamp-to-edge addressing.

Tables are always stored flat, ``(rows, C)``. The numpy packers run once
on the host when a renderer is built; the torch packers (``*_t``) give the
same values bit for bit and are differentiable, so the inverse loop re-packs
learned tables on the device every step and the backward contracts packed
adjoints through their VJP. The samplers here are the plain PyTorch
versions of the lookups that the CUDA kernels
(``vpt_tpu_torch/csrc/mcm_common.cuh``) do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from vpt_tpu_torch.ops.sampling import div_scalar

# f32 saturation bounds for float -> int32 index conversion (see _index)
_INT_LIMIT = float(2**31 - 128)


@dataclass
class PackedVolume:
    """A packed volume table stored flat.

    ``table``: (rows, width) uint8 or float32 tensor; ``dims``: the padded
    table dims, rows == prod(dims); ``kind``: "full" (width 8, dims (D+1,
    H+1, W+1)) or "xy" (width 4, dims (D, H+1, W+1)), as the JAX
    ``PackedVolume`` defines them."""

    table: torch.Tensor
    dims: tuple
    kind: str = "full"

    def __post_init__(self):
        self.dims = tuple(int(d) for d in self.dims)
        if self.kind not in ("full", "xy"):
            raise ValueError(f"packed volume kind must be 'full' or 'xy', got {self.kind!r}")
        if self.table.ndim != 2 or self.table.shape[1] != self.width:
            raise ValueError(f"a {self.kind} packed volume table must be (rows, {self.width}), "
                             f"got {tuple(self.table.shape)}")
        if self.table.shape[0] != self.dims[0] * self.dims[1] * self.dims[2]:
            raise ValueError(f"table rows {self.table.shape[0]} != prod(dims) {self.dims}")
        if self.table.dtype not in (torch.uint8, torch.float32):
            raise ValueError(f"packed volume table must be uint8 or float32, got {self.table.dtype}")

    @property
    def width(self) -> int:
        return 4 if self.kind == "xy" else 8

    @property
    def raw_shape(self) -> tuple:
        """The (D, H, W) shape of the raw grid the table packs."""
        D, Hp, Wp = self.dims
        return (D if self.kind == "xy" else D - 1, Hp - 1, Wp - 1)


def pack_volume_corners(density) -> np.ndarray:
    """Every trilinear footprint as one contiguous 8-value row.

    Input (D, H, W); output (D+1, H+1, W+1, 8), where row [z, y, x] holds the
    corners of the cell whose low corner is voxel (z-1, y-1, x-1) of the
    edge-padded volume. Corner order: bit2 = z, bit1 = y, bit0 = x."""
    d = np.asarray(density)
    p = np.pad(d, 1, mode="edge")
    corners = np.stack(
        [
            p[:-1, :-1, :-1], p[:-1, :-1, 1:],
            p[:-1, 1:, :-1], p[:-1, 1:, 1:],
            p[1:, :-1, :-1], p[1:, :-1, 1:],
            p[1:, 1:, :-1], p[1:, 1:, 1:],
        ],
        axis=-1,
    )
    return np.ascontiguousarray(corners, dtype=d.dtype)


def pack_volume_corners_xy(density) -> np.ndarray:
    """The half-packed volume: each row holds the 4 xy corners of one depth
    plane. Input (D, H, W); output (D, H+1, W+1, 4), corner order
    (y0x0, y0x1, y1x0, y1x1); a lookup reads the rows of planes z0 and z1."""
    d = np.asarray(density)
    p = np.pad(d, ((0, 0), (1, 1), (1, 1)), mode="edge")
    corners = np.stack([p[:, :-1, :-1], p[:, :-1, 1:], p[:, 1:, :-1], p[:, 1:, 1:]], axis=-1)
    return np.ascontiguousarray(corners, dtype=d.dtype)


def is_u8_quantized(density) -> bool:
    """True when every density equals round(d*255)/255 (the readers' u8 format)."""
    d = np.asarray(density)
    q = np.round(d * 255.0)
    return bool(np.allclose(q / 255.0, d, atol=1e-7))


def pack_volume_auto(density, device, kind: str = "full") -> PackedVolume:
    """Pack a raw (D, H, W) grid into a flat table of ``kind`` ("full" or
    "xy") on ``device``: uint8 when the source is u8-quantized (exact: the
    sampler dequantizes to k/255), float32 otherwise. A u8 source is
    quantized before packing, so a 512^3 volume packs through a 1 GB u8
    array instead of a 4 GB float one."""
    if kind not in ("full", "xy"):
        raise ValueError(f"packed volume kind must be 'full' or 'xy', got {kind!r}")
    d = np.asarray(density, np.float32)
    if is_u8_quantized(d):
        d = np.round(d * 255.0).astype(np.uint8)
    packed = (pack_volume_corners_xy if kind == "xy" else pack_volume_corners)(d)
    return PackedVolume(torch.as_tensor(packed.reshape(-1, packed.shape[-1]), device=device),
                        packed.shape[:3], kind)


def pack_tex2d_corners(tex) -> np.ndarray:
    """(H, W, C) -> (H+1, W+1, 4*C) bilinear corner rows, corner order
    (y0x0, y0x1, y1x0, y1x1), channels fastest."""
    t = np.asarray(tex)
    p = np.pad(t, ((1, 1), (1, 1), (0, 0)), mode="edge")
    corners = np.concatenate([p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]], axis=-1)
    return np.ascontiguousarray(corners, dtype=t.dtype)


def pack_tex1d_corners(tex) -> np.ndarray:
    """(N,) -> (N+1, 2) linear pair rows."""
    t = np.asarray(tex)
    p = np.pad(t, 1, mode="edge")
    return np.ascontiguousarray(np.stack([p[:-1], p[1:]], axis=-1), dtype=t.dtype)


def pack_tex2d_with_tex1d(tex2d, tex1d) -> np.ndarray:
    """Fuse a (W,) table that shares the 2D texture's x coordinate into its
    corner rows: (H+1, W+1, 4*C + 2). The spectral renderer samples the TF
    and the light spectrum at the same wavelength coordinate, so one row
    load serves both."""
    t2 = pack_tex2d_corners(tex2d)
    t1 = pack_tex1d_corners(tex1d)
    Hp, Wp, _ = t2.shape
    if t1.shape[0] != Wp:
        raise ValueError(f"1D table length {t1.shape[0] - 1} != 2D texture width {Wp - 1}")
    aux = np.broadcast_to(t1[None], (Hp, Wp, 2))
    return np.ascontiguousarray(np.concatenate([t2, aux], axis=-1), t2.dtype)


def pack_volume_corners_t(density: torch.Tensor) -> torch.Tensor:
    """Differentiable torch ``pack_volume_corners``: (D, H, W) ->
    (D+1, H+1, W+1, 8), the same values bit for bit."""
    p = F.pad(density[None, None], (1, 1, 1, 1, 1, 1), mode="replicate")[0, 0]
    return torch.stack(
        [
            p[:-1, :-1, :-1], p[:-1, :-1, 1:],
            p[:-1, 1:, :-1], p[:-1, 1:, 1:],
            p[1:, :-1, :-1], p[1:, :-1, 1:],
            p[1:, 1:, :-1], p[1:, 1:, 1:],
        ],
        dim=-1,
    )


def pack_volume_corners_xy_t(density: torch.Tensor) -> torch.Tensor:
    """Differentiable torch ``pack_volume_corners_xy``: (D, H, W) ->
    (D, H+1, W+1, 4), the same values bit for bit."""
    p = F.pad(density[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    return torch.stack([p[:, :-1, :-1], p[:, :-1, 1:], p[:, 1:, :-1], p[:, 1:, 1:]], dim=-1)


def pack_tex2d_corners_t(tex: torch.Tensor) -> torch.Tensor:
    """Differentiable torch ``pack_tex2d_corners``: (H, W, C) -> (H+1, W+1, 4C)."""
    p = F.pad(tex.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0].permute(1, 2, 0)
    return torch.cat([p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]], dim=-1)


def pack_tex1d_corners_t(tex: torch.Tensor) -> torch.Tensor:
    """Differentiable torch ``pack_tex1d_corners``: (N,) -> (N+1, 2)."""
    p = F.pad(tex[None, None], (1, 1), mode="replicate")[0, 0]
    return torch.stack([p[:-1], p[1:]], dim=-1)


def pack_tex2d_with_tex1d_t(tex2d: torch.Tensor, tex1d: torch.Tensor) -> torch.Tensor:
    """Differentiable torch ``pack_tex2d_with_tex1d``: (H+1, W+1, 4C + 2)."""
    t2 = pack_tex2d_corners_t(tex2d)
    t1 = pack_tex1d_corners_t(tex1d)
    Hp, Wp, _ = t2.shape
    if t1.shape[0] != Wp:
        raise ValueError(f"1D table length {t1.shape[0] - 1} != 2D texture width {Wp - 1}")
    return torch.cat([t2, t1[None].expand(Hp, Wp, 2)], dim=-1)


def _index(f: torch.Tensor) -> torch.Tensor:
    """float32 (already integral) -> int32 with saturation, NaN -> 0: the
    float->int conversion of XLA and of CUDA's cvt.rzi (a plain cast of an
    out-of-range float is undefined in C++)."""
    f = torch.nan_to_num(f, nan=0.0, posinf=_INT_LIMIT, neginf=-_INT_LIMIT)
    return torch.clamp(f, -_INT_LIMIT, _INT_LIMIT).to(torch.int32)


def _coords(u, n: int):
    """Normalized coord -> (lo index, hi index, frac) with clamp-to-edge, as
    the raw lookups address a table of n texels (JAX ``_coords``)."""
    t = u * n - 0.5
    i0 = torch.floor(t)
    frac = t - i0
    base = _index(i0)
    return torch.clamp(base, 0, n - 1), torch.clamp(base + 1, 0, n - 1), frac


def _nearest_coords(u, n: int):
    """Normalized coord -> the nearest texel's index, clamped to [0, n-1]."""
    return torch.clamp(_index(torch.floor(u * n)), 0, n - 1)


def _base_and_frac(t, n: int):
    """Normalized coord -> (clamped row index into the padded table, frac)."""
    s = t * n - 0.5
    i0 = torch.floor(s)
    frac = s - i0
    return torch.clamp(_index(i0) + 1, 0, n), frac


def dequantize_rows(rows: torch.Tensor) -> torch.Tensor:
    """Gathered corner rows -> float32. uint8 codes dequantize by IEEE
    division to exactly float32(k)/float32(255) (the readers' values)."""
    if rows.dtype == torch.uint8:
        return div_scalar(rows.to(torch.float32), 255.0)
    return rows.to(torch.float32)


def volume_rows(dims, u, v, w, kind: str = "full"):
    """The addressing of a packed volume lookup: (row0, row1, fx, fy, fz)
    before any weight warp. A full table's corner row is row0 (row1 ==
    row0); an xy table's rows of the z0 and z1 planes are row0 and row1
    (the z planes unpadded, so both clamp to [0, D - 1], as JAX's
    ``_sample_volume_packed_xy`` does)."""
    D0, Hp, Wp = dims
    bx, fx = _base_and_frac(u, Wp - 1)
    by, fy = _base_and_frac(v, Hp - 1)
    if kind == "xy":
        # the padded-table index b = clamp(i + 1, 0, D) gives z0 = clamp(i,
        # 0, D - 1) = max(b - 1, 0) and z1 = clamp(i + 1, 0, D - 1) = min(b, D - 1)
        bz, fz = _base_and_frac(w, D0)
        plane = by * Wp + bx
        row0 = torch.clamp_min(bz - 1, 0) * (Hp * Wp) + plane
        row1 = torch.clamp_max(bz, D0 - 1) * (Hp * Wp) + plane
        return row0, row1, fx, fy, fz
    bz, fz = _base_and_frac(w, D0 - 1)
    row = (bz * Hp + by) * Wp + bx
    return row, row, fx, fy, fz


def quasicubic_warp(f):
    """The quasicubic filter's smoothstep weight warp, f*f*(3 - 2f)."""
    return f * f * (3.0 - 2.0 * f)


def sample_volume_packed(table: torch.Tensor, dims, u, v, w, mode: str = "linear",
                         kind: str = "full"):
    """Trilinear (or quasi-cubic) sample of a flat packed volume table:
    kind "full", one (rows, 8) corner row at padded dims (D+1, H+1, W+1);
    kind "xy", two (rows, 4) rows of the z0 / z1 planes at dims (D, H+1,
    W+1). (u, v, w) index (W, H, D). Both kinds lerp the same corner values
    in the same order, so they give the same bits. ``mode="quasicubic"``
    smoothstep-warps the weights, f*f*(3 - 2f)."""
    row0, row1, fx, fy, fz = volume_rows(dims, u, v, w, kind)
    if mode == "quasicubic":
        fx, fy, fz = quasicubic_warp(fx), quasicubic_warp(fy), quasicubic_warp(fz)
    elif mode != "linear":
        raise ValueError(f"packed volumes support linear/quasicubic, not {mode!r}")
    if kind == "xy":
        rows = dequantize_rows(torch.cat([table[row0.to(torch.int64)],
                                          table[row1.to(torch.int64)]], dim=-1))
    else:
        rows = dequantize_rows(table[row0.to(torch.int64)])
    c = [rows[..., k] for k in range(8)]
    c00 = c[0] + (c[1] - c[0]) * fx
    c01 = c[2] + (c[3] - c[2]) * fx
    c10 = c[4] + (c[5] - c[4]) * fx
    c11 = c[6] + (c[7] - c[6]) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    return c0 + (c1 - c0) * fz


def sample_volume_raw(density: torch.Tensor, u, v, w, mode: str = "linear"):
    """Sample a raw (D, H, W) grid at normalized (u, v, w), which index (W,
    H, D): trilinear ("linear"), smoothstep-warped trilinear ("quasicubic")
    or the nearest voxel ("nearest"); JAX ``sample_volume`` on a raw grid.
    The trilinear lookup equals the packed table's bit for bit: the same
    fractions, the same 8 corners, the same lerps."""
    D, H, W = density.shape
    flat = density.reshape(-1)
    if mode == "nearest":
        ix, iy, iz = _nearest_coords(u, W), _nearest_coords(v, H), _nearest_coords(w, D)
        return flat[((iz * H + iy) * W + ix).to(torch.int64)]
    x0, x1, fx = _coords(u, W)
    y0, y1, fy = _coords(v, H)
    z0, z1, fz = _coords(w, D)
    if mode == "quasicubic":
        fx, fy, fz = quasicubic_warp(fx), quasicubic_warp(fy), quasicubic_warp(fz)
    elif mode != "linear":
        raise ValueError(f"unknown volume filter {mode!r}")

    def fetch(iz, iy, ix):
        return flat[((iz * H + iy) * W + ix).to(torch.int64)]

    c = [fetch(zi, yi, xi) for zi in (z0, z1) for yi in (y0, y1) for xi in (x0, x1)]
    c00 = c[0] + (c[1] - c[0]) * fx
    c01 = c[2] + (c[3] - c[2]) * fx
    c10 = c[4] + (c[5] - c[4]) * fx
    c11 = c[6] + (c[7] - c[6]) * fx
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    return c0 + (c1 - c0) * fz


def sample_volume(density, u, v, w, mode: str = "linear"):
    """Sample a volume at normalized (u, v, w): a ``PackedVolume`` (linear
    or quasicubic) or a raw (D, H, W) grid (also nearest)."""
    if isinstance(density, PackedVolume):
        return sample_volume_packed(density.table, density.dims, u, v, w, mode, density.kind)
    return sample_volume_raw(density, u, v, w, mode)


def is_packed_tex2d(tex) -> bool:
    """A ``pack_tex2d_corners`` table (trailing width 4C > 4), as JAX's
    ``sample_tex2d`` tells it from a raw (H, W, C <= 4) texture."""
    return tex.shape[-1] > 4 and tex.shape[-1] % 4 == 0


def sample_tex2d(tex: torch.Tensor, u, v):
    """Bilinear sample of a texture at normalized (u, v) -> (..., C); u
    indexes W, v indexes H. ``tex``: a raw (H, W, C <= 4) texture (4
    corner gathers) or a pack_tex2d_corners (Hp, Wp, 4C) table (one row)."""
    if not is_packed_tex2d(tex):
        H, W, C = tex.shape
        flat = tex.reshape(-1, C)
        x0, x1, fx = _coords(u, W)
        y0, y1, fy = _coords(v, H)

        def fetch(iy, ix):
            return flat[(iy * W + ix).to(torch.int64)]

        fxc, fyc = fx[..., None], fy[..., None]
        c00, c01 = fetch(y0, x0), fetch(y0, x1)
        c10, c11 = fetch(y1, x0), fetch(y1, x1)
        c0 = c00 + (c01 - c00) * fxc
        c1 = c10 + (c11 - c10) * fxc
        return c0 + (c1 - c0) * fyc
    packed = tex
    Hp, Wp, C4 = packed.shape
    C = C4 // 4
    bx, fx = _base_and_frac(u, Wp - 1)
    by, fy = _base_and_frac(v, Hp - 1)
    rows = packed.reshape(-1, C4)[(by * Wp + bx).to(torch.int64)]
    fxc = fx[..., None]
    fyc = fy[..., None]
    c0 = rows[..., 0:C] + (rows[..., C:2 * C] - rows[..., 0:C]) * fxc
    c1 = rows[..., 2 * C:3 * C] + (rows[..., 3 * C:4 * C] - rows[..., 2 * C:3 * C]) * fxc
    return c0 + (c1 - c0) * fyc


def sample_tex2d_fused1d(packed: torch.Tensor, u, v, C: int = 4, return_extras: bool = False):
    """Sample a pack_tex2d_with_tex1d table ((Hp, Wp, 4C+2) tensor) at
    normalized (u, v) -> (mat (..., C), aux): the bilinear TF value and the
    1D table's linear sample at ``u``, from one row.

    ``return_extras``: also return dict(rows, row_idx, fx, fy), the gathered
    row and its addressing, which the packed-adjoint backward's tape uses."""
    Hp, Wp, CC = packed.shape
    if CC != 4 * C + 2:
        raise ValueError(f"fused table width {CC} != 4*{C}+2")
    bx, fx = _base_and_frac(u, Wp - 1)
    by, fy = _base_and_frac(v, Hp - 1)
    row_idx = by * Wp + bx
    rows = packed.reshape(-1, CC)[row_idx.to(torch.int64)]
    c00 = rows[..., 0 * C: 1 * C]
    c01 = rows[..., 1 * C: 2 * C]
    c10 = rows[..., 2 * C: 3 * C]
    c11 = rows[..., 3 * C: 4 * C]
    fxc = fx[..., None]
    fyc = fy[..., None]
    c0 = c00 + (c01 - c00) * fxc
    c1 = c10 + (c11 - c10) * fxc
    mat = c0 + (c1 - c0) * fyc
    l0 = rows[..., 4 * C]
    l1 = rows[..., 4 * C + 1]
    aux = l0 + (l1 - l0) * fx
    if return_extras:
        return mat, aux, dict(rows=rows, row_idx=row_idx, fx=fx, fy=fy)
    return mat, aux


def sample_tex1d(tex: torch.Tensor, u):
    """Linear sample of a raw (N,) table (two gathers) or of a
    pack_tex1d_corners (N+1, 2) pair table (one row) at normalized u. JAX
    selects the pair row by a one-hot matmul, exact since every other
    product is zero; the row gather gives the same bits."""
    if tex.ndim == 2:
        N = tex.shape[0] - 1
        b, frac = _base_and_frac(u, N)
        rows = tex[b.to(torch.int64)]
        return rows[..., 0] + (rows[..., 1] - rows[..., 0]) * frac
    (N,) = tex.shape
    x0, x1, fx = _coords(u, N)
    c0 = tex[x0.to(torch.int64)]
    c1 = tex[x1.to(torch.int64)]
    return c0 + (c1 - c0) * fx
