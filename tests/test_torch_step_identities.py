"""The arithmetic identities the Hopper step (``csrc/mcm_common.cuh``) uses
in place of IEEE operations, checked in numpy at float32. The step kernels
K1 and K4 must stay bit-equal to their unchanged plain versions, so each
replacement has to give the IEEE result by construction:

- a u8 code over 255 is a byte permute, a subtract and the corrected
  product with RN(1/255) (``u8_unit``);
- a quotient by a divisor shared within the step (the deposit's sample
  count, the extinction, a ray point's w, a direction component in the slab
  test) is RN(a * y) with y = RN(1/b), corrected by two FMAs (``quot``);
  outside [2^-60, 2^60] the kernel divides;
- a lane outside the volume reads its escape light from density row 0 of
  the fused TF table (``sample_light``), since the table holds the same
  light pair in every row;
- K25's Markstein variant (``probes/lao_variants.py``, timed on the card
  against the IEEE divisions ``csrc/lao.cu`` keeps) divides a cone point's
  three direction components by their shared norm, the cone integral by
  light_coef, the alpha step by 100 and the shadow remap by f32(1.3) with
  the same ``quot``, the last two with RN reciprocals written as constants;
  and ``csrc/lao.cu`` dequantizes a u8 corner without ``u8_unit``'s zero
  test.

FMAs and the final rounding are emulated exactly: a product of two floats
is exact in float64, TwoSum gives the exact sum as a float64 pair, and the
pair is rounded to float32 once, ties broken by the low part.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.ops.sampling import div_scalar
from vpt_tpu_torch.scene.camera import Camera, OrbitController

SRC = Path(__file__).resolve().parent.parent / "vpt_tpu_torch" / "csrc"
COMMON = (SRC / "mcm_common.cuh").read_text()
LAO = (SRC / "lao.cu").read_text()
LAO_PROBE = (SRC.parent.parent / "probes" / "lao_variants.py").read_text()


def _const(name):
    m = re.search(rf"constexpr float {name} = (0x[0-9a-fp.+-]+)f;", COMMON)
    assert m, name
    return np.float32(float.fromhex(m.group(1)))


DIV_LO, DIV_HI, INV255 = _const("kDivLo"), _const("kDivHi"), _const("kInv255")
F32 = np.float32


def _round_pair(s, e):
    """float32 nearest to the exact s + e, where (s, e) is a TwoSum pair."""
    f = s.astype(F32)
    f64 = f.astype(np.float64)
    other = np.nextafter(f, np.where(s > f64, F32(np.inf), F32(-np.inf)).astype(F32))
    lo, hi = np.minimum(f, other), np.maximum(f, other)
    tie = (s != f64) & (s == (f64 + other.astype(np.float64)) / 2) & (e != 0)
    return np.where(tie, np.where(e > 0, hi, lo), f)


def _fma(x, y, z):
    """Exact emulation of __fmaf_rn(x, y, z) on float32 arrays."""
    p = x.astype(np.float64) * y.astype(np.float64)  # exact: 24 + 24 bits
    z = z.astype(np.float64)
    s = p + z
    bb = s - p
    e = (p - (s - bb)) + (z - bb)
    return _round_pair(s, e)


def _in_range(x):
    return (np.abs(x) >= DIV_LO) & (np.abs(x) <= DIV_HI)


def _quot(a, b):
    """The kernel's ``quot(a, recip(b))``: the corrected product where both
    operands lie in the exact range (or a is zero), else IEEE division."""
    a, b = np.broadcast_arrays(F32(a), F32(b))
    with np.errstate(all="ignore"):
        y = F32(1) / b  # __frcp_rn: the correctly rounded reciprocal
        q = (a.astype(np.float64) * y.astype(np.float64)).astype(F32)
        r = _fma(-b, q, a)
        fast = np.where(a == 0, q, _fma(r, y, q))
        return np.where(_in_range(b) & ((a == 0) | _in_range(a)), fast, a / b)


def _assert_ieee(a, b, what):
    a, b = np.broadcast_arrays(F32(a), F32(b))
    with np.errstate(all="ignore"):
        want = a / b
    got = _quot(a, b)
    bad = got.view(np.int32) != want.view(np.int32)
    bad &= ~(np.isnan(got) & np.isnan(want))
    assert not bad.any(), (f"{what}: {int(bad.sum())} quotients differ, e.g. "
                           f"{a[bad][:3]} / {b[bad][:3]} -> {got[bad][:3]} vs {want[bad][:3]}")


def _radiance_numerators(seed):
    """target - rad values of the deposit: edges, and random values over
    the radiance range of both signs."""
    edges = np.array([0.0, -0.0, 1.0, -1.0, 0.5, 1 / 3, 2 / 3, 5.0, 255.0, 1e-7, 3e-38,
                      float(DIV_LO), float(np.nextafter(DIV_LO, F32(1))),
                      float(np.nextafter(DIV_LO, F32(0))), float(DIV_HI),
                      float(np.nextafter(DIV_HI, F32(0))), float(np.nextafter(DIV_HI, F32(np.inf))),
                      1e-45, np.inf, np.nan], F32)
    rng = np.random.default_rng(seed)
    mags = np.exp(rng.uniform(np.log(1e-6), np.log(50.0), 24)).astype(F32)
    rand = mags * rng.choice(F32([-1, 1]), 24)
    return np.concatenate([edges, -edges, rand])


@pytest.mark.parametrize("lo", [1, 1 << 18, 2 << 18, 3 << 18])
def test_deposit_quotient_equals_ieee_for_sample_counts_to_2_20(lo):
    """rad += (target - rad) / samples over samples 1..2^20, in four parts."""
    a = _radiance_numerators(lo)[:, None]
    for start in range(lo, lo + (1 << 18), 1 << 15):
        b = np.arange(start, start + (1 << 15), dtype=np.float64).astype(F32)[None, :]
        _assert_ieee(a, b, f"samples {start}..")


def test_flight_quotient_equals_ieee_over_the_extinction_range():
    """-log(u) / extinction: u from uint32 states (u = s * 2^-32, down to
    2^-32 and up to 1), extinctions of the configs and log-uniform
    1e-3..1e5."""
    rng = np.random.default_rng(1)
    states = np.concatenate([rng.integers(1, 2**32, 20000, dtype=np.uint64),
                             np.array([0, 1, 2, 2**31, 2**32 - 1], np.uint64)])
    u = states.astype(F32) * F32(2.0**-32)
    with np.errstate(divide="ignore"):
        num = -np.log(u)
    ext = np.concatenate([F32([2.0, 6.0, 20.0, 30.0, 40.0, 60.0, 1.0]),
                          np.exp(rng.uniform(np.log(1e-3), np.log(1e5), 200)).astype(F32)])
    _assert_ieee(num[:, None], ext[None, :], "flight")


def test_slab_quotient_equals_ieee_over_direction_components():
    """(0 - f) / d and (1 - f) / d of the slab test: direction components
    of both signs down to 2^-70 (the fallback below 2^-60), exact zeros
    (division by zero), ray origins over [-20, 20]."""
    rng = np.random.default_rng(2)
    mags = np.exp(rng.uniform(np.log(2.0**-70), 0.0, 3000)).astype(F32)
    d = np.concatenate([mags * rng.choice(F32([-1, 1]), mags.size),
                        F32([0.0, -0.0, 1.0, -1.0, 0.5, -0.5, DIV_LO, -DIV_LO])])
    d = np.concatenate([d, rng.uniform(-1, 1, 3000).astype(F32)])
    f = np.concatenate([rng.uniform(-20, 20, 300).astype(F32), F32([0.0, 1.0, 0.5, -0.0])])
    _assert_ieee((F32(0) - f)[:, None], d[None, :], "slab t0")
    _assert_ieee((F32(1) - f)[:, None], d[None, :], "slab t1")


def _frame_directions():
    """K22's per-frame scattering directions: the host's draws for 400
    seeds, the axes and signed zeros, tiny and huge components."""
    from vpt_tpu_torch.models.mcs import _host_scatter_direction

    d = np.stack([_host_scatter_direction(s) for s in range(400)])
    special = F32([0.0, -0.0, 1.0, -1.0, 1e-30, -1e-30, 2.0**-70, -(2.0**-70), 3e38])
    grid = np.stack(np.meshgrid(special, special, special, indexing="ij"), -1).reshape(-1, 3)
    return np.concatenate([d, grid]).astype(F32)


def _collision_points(n=600):
    """Collision coordinates in the unit cube, its faces, signed zero and a
    rounding's step outside it."""
    rng = np.random.default_rng(9)
    edges = F32([0.0, -0.0, 1.0, 0.5, 1e-7, -1e-8, np.nextafter(F32(1), F32(2)), 1e-40])
    return np.concatenate([rng.uniform(0, 1, n).astype(F32), edges])


def test_cube_exit_quotients_by_a_frames_reciprocal_equal_ieee():
    """cube_exit's (0 - c) / d and (1 - c) / d by quot with each frame
    direction component's reciprocal, computed once per frame (K22's
    McsFrame): IEEE's quotient at every collision coordinate, exactly zero
    and tiny components taking the division."""
    d = _frame_directions().reshape(-1)
    c = _collision_points()
    _assert_ieee((F32(0) - c)[:, None], d[None, :], "exit t0")
    _assert_ieee((F32(1) - c)[:, None], d[None, :], "exit t1")


def _ieee_exit(c, d):
    """csrc/mcs.cu cube_exit on arrays: (n, 3) points, (3,) direction."""
    def nmax(a, b):
        return np.where(np.isnan(a) | np.isnan(b), a + b, np.fmax(a, b))

    def nmin(a, b):
        return np.where(np.isnan(a) | np.isnan(b), a + b, np.fmin(a, b))

    with np.errstate(all="ignore"):
        t0 = (F32(0) - c) / d
        t1 = (F32(1) - c) / d
    m = nmax(t0, t1)
    return nmax(nmin(nmin(m[:, 0], m[:, 1]), m[:, 2]), F32(0))


def test_cube_exit_by_the_directions_faces_equals_both_quotients():
    """K22's cube_exit_frame: where every direction component is finite and
    nonzero and the point finite, the larger quotient on each axis is the
    face's (1 - c where the component is positive, 0 - c where negative),
    bit for bit, since rounding is monotone; elsewhere both quotients."""
    rng = np.random.default_rng(4)
    c = rng.uniform(0, 1, (2000, 3)).astype(F32)
    c = np.concatenate([c, np.stack(np.meshgrid(*[F32([0.0, -0.0, 1.0, 1e-40])] * 3,
                                                indexing="ij"), -1).reshape(-1, 3)])
    for d in _frame_directions():
        if not (np.isfinite(d).all() and (d != 0).all()):
            continue
        face = np.where(d > 0, F32(1), F32(0))
        with np.errstate(all="ignore"):
            t = (face - c) / d
        got = np.fmax(np.fmin(np.fmin(t[:, 0], t[:, 1]), t[:, 2]), F32(0))
        want = _ieee_exit(c, d)
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), d


def test_homogeneous_quotient_equals_ieee_for_camera_rays():
    """apply_homogeneous's x/w, y/w, z/w on the near and far points of
    random screen positions, for several camera poses (the row sums in
    float32, left to right, as the kernel computes them without FMA)."""
    rng = np.random.default_rng(3)
    cams = [Camera(), Camera(translation=np.array([0.0, 0.0, 1.2])),
            Camera(fovy=0.7, aspect=1.5, near=0.05, far=20.0)]
    for yaw, pitch, dist in ((0.7, -0.3, 2.0), (2.5, 0.9, 3.1), (-1.2, 0.2, 40.0)):
        cam = Camera()
        OrbitController(yaw=yaw, pitch=pitch, focus_distance=dist).apply(cam)
        cams.append(cam)
    sx, sy = (rng.uniform(-1.01, 1.01, 20000).astype(F32) for _ in range(2))
    for cam in cams:
        m = cam.inverse_mvp().astype(F32)
        for z in (F32(-1), F32(1)):
            r = [m[i, 0] * sx + m[i, 1] * sy + m[i, 2] * z + m[i, 3] * F32(1) for i in range(4)]
            for i in range(3):
                _assert_ieee(r[i], r[3], f"homogeneous row {i}")


def test_u8_dequantization_table_equals_div_scalar_for_all_codes():
    codes = np.arange(256, dtype=np.uint32)
    # the byte permute builds 0x4B0000kk = 2^23 + k; minus 2^23 is k exactly
    v = (np.uint32(0x4B000000) | codes).view(F32) - F32(8388608.0)
    np.testing.assert_array_equal(v, codes.astype(F32))
    # the kernel's constant is RN(1/255), the reciprocal _quot takes
    assert INV255 == F32(1) / F32(255)
    want = div_scalar(torch.arange(256, dtype=torch.float32), 255.0).numpy()
    assert np.array_equal(_quot(v, F32(255)).view(np.int32), want.view(np.int32))


def test_lao_u8_dequantization_without_the_zero_test_equals_div_scalar():
    """K25's lao_u8: u8_unit's corrected product with RN(1/255) but no zero
    test (codes are never negative, and code 0 gives +0 either way): all
    256 codes equal the IEEE division bit for bit, code 0 as +0."""
    assert "return __fmaf_rn(__fmaf_rn(-255.0f, q, v), kInv255, q);" in LAO
    codes = np.arange(256, dtype=np.uint32)
    v = (np.uint32(0x4B000000) | codes).view(F32) - F32(8388608.0)
    q = (v.astype(np.float64) * INV255.astype(np.float64)).astype(F32)
    got = _fma(_fma(np.full_like(v, -255.0), q, v), np.full_like(v, INV255), q)
    want = div_scalar(torch.arange(256, dtype=torch.float32), 255.0).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert got[0].view(np.int32) == 0


def test_quotient_falls_back_outside_the_exact_range():
    """Operands outside [2^-60, 2^60], infinities and NaN take the division
    (so they equal it trivially); the exact range's own edges are in."""
    for b in (F32(2.0**-61), F32(2.0**61), F32(np.inf), F32(np.nan), F32(0.0), F32(1e-45)):
        assert not _in_range(np.array([b])).any()
    for x in (DIV_LO, DIV_HI, F32(1.0), F32(-3.0)):
        assert _in_range(np.array([x])).all()
    a = F32([1e-30, 3e30, np.inf, -np.inf, np.nan, 1e-45, 1.0, -0.0])
    for b in F32([1e-30, 3e30, 1.0, -2.5, 0.0, np.inf]):
        _assert_ieee(a, b, f"fallback b={b}")


def _lao_constant(divisor):
    """(divisor, reciprocal) of one of the Markstein variant's constants."""
    import ast

    m = re.search(r"MARKSTEIN_RECIPROCALS = (\{[^}]*\})", LAO_PROBE)
    assert m
    y = ast.literal_eval(m.group(1))[divisor]
    b = {"100.0f": F32(100.0), "F32(1.3)": F32(1.3)}[divisor]
    return b, F32(float.fromhex(y.rstrip("f")))


def test_lao_constant_reciprocals_are_correctly_rounded():
    """The Markstein variant's constant divisors carry RN(1 / b), the
    reciprocal _quot takes."""
    for divisor in ("100.0f", "F32(1.3)"):
        b, y = _lao_constant(divisor)
        assert y == F32(1) / b, divisor


def test_lao_cone_quotients_equal_ieee():
    """A cone point's jx / |j|, jy / |j|, jz / |j|: j = light + d - p with
    sample points over the unit cube widened by the march's overshoot, the
    light's view position from several cameras and random ones over
    [-20, 20]^3, the jitter offset d = lao_dx * (radius * tt); |j| the IEEE
    norm in float32, as the kernel computes it (no FMA)."""
    from vpt_tpu_torch.kernels.lao import cone_table, light_view

    rng = np.random.default_rng(23)
    lights = [light_view(cam.inverse_mvp(), np.array([2.0, -3.0, -5.0], F32))
              for cam in (Camera(), Camera(translation=np.array([0.0, 0.0, 1.2])))]
    lights += list(rng.uniform(-20, 20, (6, 3)).astype(F32))
    tt = cone_table(0.05)[:, 0]
    n = 20000
    p = rng.uniform(-0.05, 1.05, (3, n)).astype(F32)
    lao_dx = rng.uniform(-0.58, 0.58, n).astype(F32)
    radius = F32(0.19)
    for light in lights:
        d = lao_dx * (radius * rng.choice(tt, n))
        j = [(F32(light[a]) + d) - p[a] for a in range(3)]
        norm = np.sqrt(j[0] * j[0] + j[1] * j[1] + j[2] * j[2])
        for a in range(3):
            _assert_ieee(j[a], norm, f"cone axis {a}")


def test_lao_integral_and_remap_quotients_equal_ieee():
    """acc_lao / light_coef over cone integrals [0, 20] and coefficients
    1e-4..1e4 (the default 1.0 among them); (1 - acc_a) * value * ext / 100
    over alphas [0, 0.9], values [0, 1] and extinctions 1e-2..1e4; (bias +
    shadow * 1.2) / f32(1.3) over shadows [0, 1], densest around the
    remap's zero (shadow 1/6), each quotient by the variant's constant."""
    rng = np.random.default_rng(29)
    acc = np.concatenate([rng.uniform(0, 20, 4000).astype(F32), F32([0.0, 1.0, 20.0, 1e-7])])
    coef = np.concatenate([np.exp(rng.uniform(np.log(1e-4), np.log(1e4), 300)).astype(F32),
                           F32([1.0, 0.5, 2.0, 3.0])])
    _assert_ieee(acc[:, None], coef[None, :], "cone integral")
    b, _ = _lao_constant("100.0f")
    alpha = rng.uniform(0, 0.9, 200000).astype(F32)
    value = rng.uniform(0, 1, 200000).astype(F32)
    ext = np.exp(rng.uniform(np.log(1e-2), np.log(1e4), 200000)).astype(F32)
    _assert_ieee((F32(1) - alpha) * value * ext, b, "alpha step")
    b, _ = _lao_constant("F32(1.3)")
    sixth = np.float32(1 / 6)
    near = sixth + (np.arange(-20000, 20000) * np.spacing(sixth)).astype(F32)
    shadow = np.concatenate([rng.uniform(0, 1, 400000).astype(F32), near, F32([0.0, 1.0])])
    bias = F32(1.0 * (1.0 - 1.2))
    _assert_ieee(bias + shadow * F32(1.2), b, "shadow remap")


def test_lao_quotients_fall_back_outside_the_exact_range():
    """Numerators below 2^-60 and a cone norm of 0, below 2^-60, infinite or
    NaN (the light's cone through a sample point) take the division."""
    a = F32([1e-20, -1e-30, 1e-45, 0.0, -0.0, 1.0, np.nan])
    for b in F32([0.0, 1e-19, 2.0**-61, np.inf, np.nan, 1.0, 100.0, 1.3]):
        _assert_ieee(a, b, f"fallback b={b}")
    assert not _in_range(F32([1e-20, 1e-30, 1e-45, 0.0])).any()


@pytest.mark.parametrize("torch_pack", [False, True])
def test_hoisted_light_equals_every_row_lookup(torch_pack):
    """The escape light from density row 0 at the lane's wavelength column
    equals the fused table's light sample at every density row, for a
    seeded TF and light spectrum; packed as the renderer packs it (numpy)
    and as the inverse loop re-packs learned tables (torch)."""
    rng = np.random.default_rng(4)
    tf = rng.random((256, 256, 4), dtype=np.float32)
    light = rng.uniform(0.0, 2.0, 256).astype(np.float32)
    if torch_pack:
        table = interp.pack_tex2d_with_tex1d_t(torch.as_tensor(tf), torch.as_tensor(light))
    else:
        table = torch.as_tensor(interp.pack_tex2d_with_tex1d(tf, light))
    Hp, Wp, _ = table.shape
    lam = torch.cat([torch.as_tensor(rng.uniform(380.0, 720.0, 2048).astype(np.float32)),
                     torch.tensor([380.0, 400.0, 550.0, 700.0, 720.0])])
    t = div_scalar(lam - 400.0, 300.0)  # the kernel's wavelength coordinate
    bx, fx = interp._base_and_frac(t, Wp - 1)
    pair = table[0, bx.to(torch.int64), 16:18]
    hoisted = pair[:, 0] + (pair[:, 1] - pair[:, 0]) * fx
    for by in range(Hp):
        v = torch.full_like(t, (by - 0.25) / (Hp - 1))
        _, aux = interp.sample_tex2d_fused1d(table, t, v)
        assert torch.equal(aux.view(torch.int32), hoisted.view(torch.int32)), by


def test_ctx_from_numpy_refuses_a_light_pair_that_differs_between_rows():
    """The hoisted light needs every density row to repeat the light pair;
    a context from outside the packers is checked once, when it is made."""
    from vpt_tpu_torch import convert

    rng = np.random.default_rng(5)
    table = interp.pack_tex2d_with_tex1d(rng.random((8, 6, 4), dtype=np.float32),
                                         rng.random(6, dtype=np.float32))
    args = dict(inv_mvp=np.eye(4), seed_bits=1, extinction=40.0, blur=0.0, max_bounces=8,
                light_direction=(0.0, 0.0, 1.0),
                density_table=np.zeros((3, 3, 3, 8), np.float32), light_spectrum=np.ones(6),
                boundaries=np.linspace(400.0, 700.0, 5), bin_xyz=np.ones((4, 3)), device="cpu")
    ctx = convert.ctx_from_numpy(material_tf=table, **args)
    assert torch.equal(ctx.material_tf, torch.as_tensor(table))
    bad = table.copy()
    bad[3, 2, 17] += 0.5
    with pytest.raises(ValueError, match="light pair"):
        convert.ctx_from_numpy(material_tf=bad, **args)


def test_every_bin_count_has_a_step_instantiation():
    """NB, the bin count rounded up to 4, is instantiated in both step
    kernels for every bin count the wrappers accept."""
    from vpt_tpu_torch.kernels.mcm_spectral import MAX_BINS

    assert re.search(r"bins_rounded\(int n_bins\) \{ return \(n_bins \+ 3\) / 4 \* 4; \}", COMMON)
    for src in ("mcm_spectral.cu", "spectral_backward.cu"):
        listed = {int(n) for n in re.findall(r"VPT_NB\((\d+)\)", (SRC / src).read_text())}
        assert {(n + 3) // 4 * 4 for n in range(1, MAX_BINS + 1)} <= listed, src
