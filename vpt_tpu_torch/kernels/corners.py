"""The corner-packing kernels: the re-pack of learned raw tables and the
contraction of packed adjoints back to them. Wrappers, plain versions,
launch counts.

Two kernels of ``vpt_tpu_torch/csrc/corners.cu``:

- ``contract_corners`` (K9): the dense pack transpose, packed adjoints ->
  gradients addressing the raw tables (replaces
  ``vpt_tpu/kernels/spectral_backward.py::_contract_packed_adjoints``, the
  ``jax.vjp`` of ``ops/interp.py::pack_*_jnp``). Wrappers
  ``contract_volume`` (full or xy table), ``contract_tf`` and
  ``contract_env``; plain versions ``contract_volume_plain``,
  ``contract_volume_xy_plain``, ``contract_tex2d_plain``,
  ``contract_tex1d_plain`` and ``contract_light_plain``. A gather with one
  thread per raw cell,
  no atomics: the plain versions add the same terms in the kernel's order
  (``axis_slots``), so the two agree bit for bit.
- ``pack_corners`` (K10): the re-pack of learned raw tables on every
  ``fit_spectral`` iteration (replaces ``vpt_tpu/optim.py::
  _pack_params_into_ctx``'s ``pack_*_jnp``). Wrappers ``pack_volume`` (full
  or xy table), ``pack_tf`` and ``pack_env``; their plain versions are the
  torch packers ``interp.pack_*_t``, bit-equal to the numpy and JAX packers.

``PackCorners`` (``pack_volume_diff``, ``pack_tf_diff``, ``pack_env_diff``)
is the re-pack under torch autograd, K10 forward and K9 backward: the
autodiff surrogate's loss packs its raw parameters through it.

Each wrapper runs its plain version when its tensors lie on the CPU and
launches its kernel when they lie on a CUDA device; anything else raises.
``LAUNCHES`` counts kernel launches only. The plain versions take any
floating dtype (the tests run them in float64); the kernels take float32.
"""

from __future__ import annotations

import torch

from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.ops import interp

# a launch also counts under its table: "_xy" (an xy volume), "_env" (an
# environment map)
LAUNCHES = {"contract_corners": 0, "pack_corners": 0, "contract_corners_xy": 0,
            "contract_corners_env": 0, "pack_corners_xy": 0, "pack_corners_env": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def axis_slots(n: int, device):
    """The packed entries that hold each raw index ``a`` of an axis of ``n``
    cells: packed index ``i`` with corner bit ``b`` where clamp(i + b - 1,
    0, n - 1) == a. Four slots, in the kernel's order: (0, 0) where a == 0;
    (a, 1); (a + 1, 0); (n, 1) where a == n - 1. Returns a list of
    (index tensor, bit, valid mask) per slot."""
    a = torch.arange(n, device=device)
    ones = torch.ones(n, dtype=torch.bool, device=device)
    return [(torch.zeros_like(a), 0, a == 0), (a, 1, ones), (a + 1, 0, ones),
            (torch.full_like(a, n), 1, a == n - 1)]


def _add(acc, valid, term):
    # an absent slot adds +0.0, which leaves the sum's bits as they are
    # (the sum starts at +0.0, so it is never -0.0)
    return acc + torch.where(valid, term, torch.zeros_like(term))


def contract_volume_plain(g_packed: torch.Tensor, dims) -> torch.Tensor:
    """Plain ``contract_volume``: the packed volume adjoint (rows, 8) with
    padded dims (D+1, H+1, W+1) -> the raw (D, H, W) gradient."""
    Dp, Hp, Wp = (int(d) for d in dims)
    g = g_packed.reshape(Dp, Hp, Wp, 8)
    dev = g.device
    zs, ys, xs = axis_slots(Dp - 1, dev), axis_slots(Hp - 1, dev), axis_slots(Wp - 1, dev)
    acc = torch.zeros((Dp - 1, Hp - 1, Wp - 1), dtype=g.dtype, device=dev)
    for iz, bz, vz in zs:
        for iy, by, vy in ys:
            for ix, bx, vx in xs:
                term = g[iz[:, None, None], iy[None, :, None], ix[None, None, :],
                         bz * 4 + by * 2 + bx]
                acc = _add(acc, vz[:, None, None] & vy[None, :, None] & vx[None, None, :], term)
    return acc


def contract_volume_xy_plain(g_packed: torch.Tensor, dims) -> torch.Tensor:
    """Plain ``contract_volume`` of an xy table: the (rows, 4) adjoint with
    dims (D, H+1, W+1) -> the raw (D, H, W) gradient, each voxel summing the
    2-D slots of its own z plane (the z axis is not padded)."""
    D, Hp, Wp = (int(d) for d in dims)
    g = g_packed.reshape(D, Hp, Wp, 4)
    dev = g.device
    acc = torch.zeros((D, Hp - 1, Wp - 1), dtype=g.dtype, device=dev)
    for iy, by, vy in axis_slots(Hp - 1, dev):
        for ix, bx, vx in axis_slots(Wp - 1, dev):
            term = g[:, iy[:, None], ix[None, :], by * 2 + bx]
            acc = _add(acc, (vy[:, None] & vx[None, :])[None], term)
    return acc


def contract_tex2d_plain(g_packed: torch.Tensor, channels: int = 4) -> torch.Tensor:
    """Plain transpose of ``pack_tex2d_corners``: a (H+1, W+1, >= 4C)
    adjoint (its first 4C channels: 4 corners x C) -> the raw (H, W, C)
    gradient."""
    Hp, Wp = g_packed.shape[:2]
    dev = g_packed.device
    acc = torch.zeros((Hp - 1, Wp - 1, channels), dtype=g_packed.dtype, device=dev)
    for iy, by, vy in axis_slots(Hp - 1, dev):
        for ix, bx, vx in axis_slots(Wp - 1, dev):
            c0 = (by * 2 + bx) * channels
            term = g_packed[iy[:, None], ix[None, :], c0:c0 + channels]
            acc = _add(acc, (vy[:, None] & vx[None, :])[..., None], term)
    return acc


def contract_tex1d_plain(g_packed: torch.Tensor) -> torch.Tensor:
    """Plain transpose of ``pack_tex1d_corners``: (N+1, 2) -> (N,)."""
    n = g_packed.shape[0] - 1
    acc = torch.zeros(n, dtype=g_packed.dtype, device=g_packed.device)
    for ix, bx, vx in axis_slots(n, g_packed.device):
        acc = _add(acc, vx, g_packed[ix, bx])
    return acc


def contract_light_plain(g_tf: torch.Tensor) -> torch.Tensor:
    """Plain light half of ``contract_tf``: the fused (Hp, Wp, 18) adjoint's
    light pair summed over the TF rows in row order (the pack broadcast it
    over them), then transposed as a 1-D table -> the raw (Wp - 1,)
    gradient."""
    rows = torch.zeros_like(g_tf[0, :, 16:18])
    for y in range(g_tf.shape[0]):
        rows = rows + g_tf[y, :, 16:18]
    return contract_tex1d_plain(rows)


def pack_volume_plain(density: torch.Tensor, kind: str = "full") -> torch.Tensor:
    """Plain ``pack_volume``: (D, H, W) -> flat ((D+1)(H+1)(W+1), 8), or of
    kind "xy" flat (D(H+1)(W+1), 4)."""
    if kind == "xy":
        return interp.pack_volume_corners_xy_t(density).reshape(-1, 4)
    return interp.pack_volume_corners_t(density).reshape(-1, 8)


def pack_env_plain(env: torch.Tensor) -> torch.Tensor:
    """Plain ``pack_env``: (He, We, 3) -> (He+1, We+1, 12)."""
    return interp.pack_tex2d_corners_t(env).contiguous()


def pack_tf_plain(mtf: torch.Tensor, light: torch.Tensor, pairs: bool = False):
    """Plain ``pack_tf``: (the fused (TH+1, TW+1, 18) table, the light's
    (TW+1, 2) pairs or None)."""
    fused = interp.pack_tex2d_with_tex1d_t(mtf, light).contiguous()
    return fused, (interp.pack_tex1d_corners_t(light) if pairs else None)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def _check(t, name, shape, align=4):
    K._check(t, name, torch.float32, shape, align=align)


def contract_volume(g_packed: torch.Tensor, dims, kind: str = "full") -> torch.Tensor:
    """The raw (D, H, W) density gradient of a packed volume adjoint: (rows,
    8) with padded dims ``dims`` (D+1, H+1, W+1), or of ``kind`` "xy"
    (rows, 4) with dims (D, H+1, W+1); one kernel launch on a CUDA
    device."""
    xy = kind == "xy"
    if K._route(g_packed) == "cpu":
        return (contract_volume_xy_plain if xy else contract_volume_plain)(g_packed, dims)
    D0, Hp, Wp = (int(d) for d in dims)
    _check(g_packed, "g_packed", (D0 * Hp * Wp, 4 if xy else 8))
    D = D0 if xy else D0 - 1
    out = torch.empty((D, Hp - 1, Wp - 1), dtype=torch.float32, device=g_packed.device)
    lib = _build.load()
    fn = lib.vpt_contract_volume_xy if xy else lib.vpt_contract_volume
    with torch.cuda.device(g_packed.device):
        err = fn(g_packed.data_ptr(), out.data_ptr(), D, Hp - 1, Wp - 1,
                 K._stream(g_packed.device))
    K._raise_on(err, f"contract_corners ({kind} volume)")
    LAUNCHES["contract_corners"] += 1
    LAUNCHES["contract_corners_xy"] += int(xy)
    return out


def contract_env(g_env: torch.Tensor) -> torch.Tensor:
    """The raw (He, We, 3) environment gradient of a packed (He+1, We+1,
    12) environment adjoint; one kernel launch on a CUDA device."""
    if g_env.ndim != 3 or g_env.shape[-1] != 12:
        raise ValueError(f"g_env must be a packed (He+1, We+1, 12) adjoint, got "
                         f"{tuple(g_env.shape)}")
    if K._route(g_env) == "cpu":
        return contract_tex2d_plain(g_env, channels=3)
    Hp, Wp, _ = g_env.shape
    _check(g_env, "g_env", (Hp, Wp, 12))
    out = torch.empty((Hp - 1, Wp - 1, 3), dtype=torch.float32, device=g_env.device)
    lib = _build.load()
    with torch.cuda.device(g_env.device):
        err = lib.vpt_contract_env(g_env.data_ptr(), out.data_ptr(), Hp - 1, Wp - 1,
                                   K._stream(g_env.device))
    K._raise_on(err, "contract_corners (environment)")
    LAUNCHES["contract_corners"] += 1
    LAUNCHES["contract_corners_env"] += 1
    return out


def contract_tf(g_tf: torch.Tensor, material_tf: bool = True, light: bool = True):
    """(material_tf gradient (TH, TW, 4) or None, light_spectrum gradient
    (TW,) or None) of a fused (TH+1, TW+1, 18) TF+light adjoint; one kernel
    launch on a CUDA device."""
    if not (material_tf or light):
        raise ValueError("contract_tf needs material_tf or light")
    if g_tf.ndim != 3 or g_tf.shape[-1] != 18:
        raise ValueError(f"g_tf must be a fused (Hp, Wp, 18) adjoint, got {tuple(g_tf.shape)}")
    if K._route(g_tf) == "cpu":
        return (contract_tex2d_plain(g_tf) if material_tf else None,
                contract_light_plain(g_tf) if light else None)
    Hp, Wp, _ = g_tf.shape
    _check(g_tf, "g_tf", (Hp, Wp, 18), align=8)
    dev = g_tf.device
    g_mtf = (torch.empty((Hp - 1, Wp - 1, 4), dtype=torch.float32, device=dev)
             if material_tf else None)
    g_light = torch.empty(Wp - 1, dtype=torch.float32, device=dev) if light else None
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.vpt_contract_tf(g_tf.data_ptr(), K._ptr(g_mtf), K._ptr(g_light), Hp - 1,
                                  Wp - 1, K._stream(dev))
    K._raise_on(err, "contract_corners (tf)")
    LAUNCHES["contract_corners"] += 1
    return g_mtf, g_light


def pack_volume(density: torch.Tensor, kind: str = "full") -> torch.Tensor:
    """The flat ((D+1)(H+1)(W+1), 8) corner table of a raw (D, H, W)
    density, or of ``kind`` "xy" the flat (D(H+1)(W+1), 4) table; one kernel
    launch on a CUDA device."""
    xy = kind == "xy"
    if K._route(density) == "cpu":
        return pack_volume_plain(density, kind)
    if density.ndim != 3:
        raise ValueError(f"density must be (D, H, W), got {tuple(density.shape)}")
    D, H, W = density.shape
    _check(density, "density", (D, H, W))
    rows = D * (H + 1) * (W + 1) if xy else (D + 1) * (H + 1) * (W + 1)
    out = torch.empty((rows, 4 if xy else 8), dtype=torch.float32, device=density.device)
    lib = _build.load()
    fn = lib.vpt_pack_volume_xy if xy else lib.vpt_pack_volume
    with torch.cuda.device(density.device):
        err = fn(density.data_ptr(), out.data_ptr(), D, H, W, K._stream(density.device))
    K._raise_on(err, f"pack_corners ({kind} volume)")
    LAUNCHES["pack_corners"] += 1
    LAUNCHES["pack_corners_xy"] += int(xy)
    return out


def pack_env(env: torch.Tensor) -> torch.Tensor:
    """The packed (He+1, We+1, 12) table of a raw (He, We, 3) environment
    map; one kernel launch on a CUDA device."""
    if K._route(env) == "cpu":
        return pack_env_plain(env)
    if env.ndim != 3 or env.shape[-1] != 3:
        raise ValueError(f"environment must be (He, We, 3), got {tuple(env.shape)}")
    He, We, _ = env.shape
    _check(env, "environment", (He, We, 3))
    out = torch.empty((He + 1, We + 1, 12), dtype=torch.float32, device=env.device)
    lib = _build.load()
    with torch.cuda.device(env.device):
        err = lib.vpt_pack_env(env.data_ptr(), out.data_ptr(), He, We, K._stream(env.device))
    K._raise_on(err, "pack_corners (environment)")
    LAUNCHES["pack_corners"] += 1
    LAUNCHES["pack_corners_env"] += 1
    return out


class PackCorners(torch.autograd.Function):
    """The re-pack as a differentiable function: forward K10 (the torch
    packers on the CPU), backward K9, its exact transpose. ``kind``
    "volume": (density,) -> the flat (rows, 8) table ("volume_xy": the
    flat (rows, 4) xy table); "tf": (material_tf,
    light_spectrum) -> the fused (TH+1, TW+1, 18) table; "env":
    (environment,) -> the packed (He+1, We+1, 12) table."""

    @staticmethod
    def forward(ctx, kind, *raw):
        ctx.kind = kind
        with torch.no_grad():
            if kind in ("volume", "volume_xy"):
                D, H, W = raw[0].shape
                ctx.dims = (D, H + 1, W + 1) if kind == "volume_xy" else (D + 1, H + 1, W + 1)
                return pack_volume(raw[0].contiguous(), "xy" if kind == "volume_xy" else "full")
            if kind == "env":
                return pack_env(raw[0].contiguous())
            return pack_tf(raw[0].contiguous(), raw[1].contiguous())[0]

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.kind in ("volume", "volume_xy"):
            return None, contract_volume(g, ctx.dims, "xy" if ctx.kind == "volume_xy" else "full")
        if ctx.kind == "env":
            return None, contract_env(g)
        want_mtf, want_light = ctx.needs_input_grad[1], ctx.needs_input_grad[2]
        if not (want_mtf or want_light):
            return None, None, None
        g_mtf, g_light = contract_tf(g, material_tf=want_mtf, light=want_light)
        return None, g_mtf, g_light


def pack_volume_diff(density: torch.Tensor, kind: str = "full") -> torch.Tensor:
    """``pack_volume`` of ``kind`` under autograd (its backward is
    ``contract_volume``)."""
    return PackCorners.apply("volume_xy" if kind == "xy" else "volume", density)


def pack_env_diff(env: torch.Tensor) -> torch.Tensor:
    """``pack_env`` under autograd (its backward is ``contract_env``)."""
    return PackCorners.apply("env", env)


def pack_tf_diff(mtf: torch.Tensor, light: torch.Tensor) -> torch.Tensor:
    """The fused table of ``pack_tf`` under autograd (its backward is
    ``contract_tf``)."""
    return PackCorners.apply("tf", mtf, light)


def pack_tf(mtf: torch.Tensor, light: torch.Tensor, pairs: bool = False):
    """(the fused (TH+1, TW+1, 18) TF+light table, the light's (TW+1, 2)
    linear pairs when ``pairs`` else None) of a raw (TH, TW, 4) material TF
    and a (TW,) light spectrum; one kernel launch on a CUDA device."""
    if K._route(mtf, light) == "cpu":
        return pack_tf_plain(mtf, light, pairs)
    if mtf.ndim != 3 or mtf.shape[-1] != 4:
        raise ValueError(f"material_tf must be (TH, TW, 4), got {tuple(mtf.shape)}")
    TH, TW, _ = mtf.shape
    _check(mtf, "material_tf", (TH, TW, 4), align=16)
    _check(light, "light_spectrum", (TW,))
    dev = mtf.device
    out = torch.empty((TH + 1, TW + 1, 18), dtype=torch.float32, device=dev)
    out_pairs = torch.empty((TW + 1, 2), dtype=torch.float32, device=dev) if pairs else None
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.vpt_pack_tf(mtf.data_ptr(), light.data_ptr(), out.data_ptr(),
                              K._ptr(out_pairs), TH, TW, K._stream(dev))
    K._raise_on(err, "pack_corners (tf)")
    LAUNCHES["pack_corners"] += 1
    return out, out_pairs
