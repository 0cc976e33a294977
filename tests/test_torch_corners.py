"""K9 ``contract_corners`` and K10 ``pack_corners`` (``kernels/corners.py``)
against vpt_tpu, on the CPU (the plain versions).

The contraction's plain version adds the packed entries that hold a raw
cell in the kernel's order; against ``jax.vjp`` of the JAX packers, which
sums in XLA's order, it agrees to rounding (rtol and atol 1e-6). In
float64 it is the packer's exact adjoint: <pack(x), y> = <x, contract(y)>
to 1e-12. Shapes with axes of 1 and 2 cells cover the edge folds, where a
raw cell collects up to 4 entries per axis. The re-pack's plain version
is the torch packers, bit-equal to the numpy packers.
"""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vpt_tpu.kernels import spectral_backward as JB
from vpt_tpu.ops import interp as JI
from vpt_tpu_torch.kernels import corners as C
from vpt_tpu_torch.kernels import spectral_backward as TB
from vpt_tpu_torch.ops import interp as TI
from vpt_tpu_torch.optim import _pack_params_into_ctx

VOLUMES = [(1, 1, 1), (2, 3, 1), (5, 6, 7)]
TEXTURES = [(1, 1), (2, 3), (6, 5)]


def _vjp(packer, raw, cot):
    _, vjp = jax.vjp(packer, jnp.asarray(raw))
    return np.asarray(vjp(jnp.asarray(cot))[0])


@pytest.mark.parametrize("shape", VOLUMES)
def test_contract_volume_plain_matches_jax_vjp(shape):
    rng = np.random.default_rng(1)
    dims = tuple(d + 1 for d in shape)
    g = rng.standard_normal(dims + (8,)).astype(np.float32)
    want = _vjp(JI.pack_volume_corners_jnp, np.zeros(shape, np.float32), g)
    got = C.contract_volume_plain(torch.as_tensor(g.reshape(-1, 8)), dims)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", TEXTURES)
def test_contract_tex2d_plain_matches_jax_vjp(shape):
    rng = np.random.default_rng(2)
    g = rng.standard_normal((shape[0] + 1, shape[1] + 1, 16)).astype(np.float32)
    want = _vjp(JI.pack_tex2d_corners_jnp, np.zeros(shape + (4,), np.float32), g)
    got = C.contract_tex2d_plain(torch.as_tensor(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 9])
def test_contract_tex1d_plain_matches_jax_vjp(n):
    g = np.random.default_rng(3).standard_normal((n + 1, 2)).astype(np.float32)
    want = _vjp(JI.pack_tex1d_corners_jnp, np.zeros(n, np.float32), g)
    np.testing.assert_allclose(C.contract_tex1d_plain(torch.as_tensor(g)).numpy(), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", TEXTURES)
def test_contract_tf_plain_matches_jax(shape):
    """The fused TF+light adjoint: the TF half as the tex2d transpose of its
    16 corner channels, the light half as JAX's row sum then tex1d VJP."""
    rng = np.random.default_rng(4)
    TH, TW = shape
    g = rng.standard_normal((TH + 1, TW + 1, 18)).astype(np.float32)
    want_tf = _vjp(JI.pack_tex2d_corners_jnp, np.zeros((TH, TW, 4), np.float32), g[..., :16])
    want_light = _vjp(JI.pack_tex1d_corners_jnp, np.zeros(TW, np.float32),
                      np.asarray(jnp.sum(jnp.asarray(g[..., 16:]), axis=0)))
    got_tf, got_light = C.contract_tf(torch.as_tensor(g))
    np.testing.assert_allclose(got_tf.numpy(), want_tf, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_light.numpy(), want_light, rtol=1e-6, atol=1e-6)
    only_light = C.contract_tf(torch.as_tensor(g), material_tf=False)
    assert only_light[0] is None and torch.equal(only_light[1], got_light)


@pytest.mark.parametrize("shape", VOLUMES)
def test_contract_volume_xy_matches_jax_vjp(shape):
    rng = np.random.default_rng(11)
    dims = (shape[0], shape[1] + 1, shape[2] + 1)
    g = rng.standard_normal(dims + (4,)).astype(np.float32)
    want = _vjp(JI.pack_volume_corners_xy_jnp, np.zeros(shape, np.float32), g)
    got = C.contract_volume(torch.as_tensor(g.reshape(-1, 4)), dims, "xy")
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got.numpy(), C.contract_volume_xy_plain(
        torch.as_tensor(g.reshape(-1, 4)), dims).numpy())


@pytest.mark.parametrize("shape", TEXTURES)
def test_contract_env_matches_jax_vjp(shape):
    """The environment's contraction: the tex2d transpose with C = 3."""
    rng = np.random.default_rng(12)
    g = rng.standard_normal((shape[0] + 1, shape[1] + 1, 12)).astype(np.float32)
    want = _vjp(JI.pack_tex2d_corners_jnp, np.zeros(shape + (3,), np.float32), g)
    got = C.contract_env(torch.as_tensor(g))
    assert got.shape == shape + (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    raw = rng.random(shape + (3,), dtype=np.float32)
    np.testing.assert_array_equal(C.pack_env(torch.as_tensor(raw)).numpy(),
                                  TI.pack_tex2d_corners(raw))
    np.testing.assert_array_equal(C.pack_env_diff(torch.as_tensor(raw)).numpy(),
                                  np.asarray(JI.pack_tex2d_corners_jnp(jnp.asarray(raw))))


def _adjoint_case(kind, rng):
    """(raw inputs, packed table, random packed cotangent, its contraction)
    of one packer, in float64."""
    if kind == "volume":
        xs = [torch.as_tensor(rng.standard_normal((3, 1, 4)))]
        packed = TI.pack_volume_corners_t(*xs)
        y = torch.as_tensor(rng.standard_normal(packed.shape))
        return xs, packed, y, [C.contract_volume_plain(y.reshape(-1, 8), packed.shape[:3])]
    if kind == "tex2d":
        xs = [torch.as_tensor(rng.standard_normal((2, 5, 4)))]
        packed = TI.pack_tex2d_corners_t(*xs)
        y = torch.as_tensor(rng.standard_normal(packed.shape))
        return xs, packed, y, [C.contract_tex2d_plain(y)]
    if kind == "tex1d":
        xs = [torch.as_tensor(rng.standard_normal(1))]
        packed = TI.pack_tex1d_corners_t(*xs)
        y = torch.as_tensor(rng.standard_normal(packed.shape))
        return xs, packed, y, [C.contract_tex1d_plain(y)]
    if kind == "volume_xy":
        xs = [torch.as_tensor(rng.standard_normal((3, 1, 4)))]
        packed = TI.pack_volume_corners_xy_t(*xs)
        y = torch.as_tensor(rng.standard_normal(packed.shape))
        return xs, packed, y, [C.contract_volume(y.reshape(-1, 4), packed.shape[:3], "xy")]
    if kind == "env":
        xs = [torch.as_tensor(rng.standard_normal((2, 5, 3)))]
        packed = TI.pack_tex2d_corners_t(*xs)
        y = torch.as_tensor(rng.standard_normal(packed.shape))
        return xs, packed, y, [C.contract_env(y)]
    xs = [torch.as_tensor(rng.standard_normal((3, 2, 4))), torch.as_tensor(rng.standard_normal(2))]
    packed = TI.pack_tex2d_with_tex1d_t(*xs)
    y = torch.as_tensor(rng.standard_normal(packed.shape))
    return xs, packed, y, list(C.contract_tf(y))


@pytest.mark.parametrize("kind", ["volume", "tex2d", "tex1d", "tf_with_light", "volume_xy",
                                  "env"])
def test_contraction_is_the_packers_adjoint_in_float64(kind):
    """<pack(x), y> = <x, contract(y)> for the torch packers, in float64."""
    xs, packed, y, backs = _adjoint_case(kind, np.random.default_rng(5))
    for x, back in zip(xs, backs):
        assert back.dtype == torch.float64 and back.shape == x.shape
    lhs = float(torch.sum(packed * y))
    rhs = sum(float(torch.sum(x * back)) for x, back in zip(xs, backs))
    assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))


WRT = ("density", "material_tf", "light_spectrum", "extinction")
SUBSETS = [frozenset(s) for r in range(1, 5) for s in itertools.combinations(WRT, r)]


@pytest.mark.parametrize("wrt", SUBSETS, ids=lambda s: "+".join(sorted(s)))
def test_contract_packed_adjoints_matches_jax(wrt):
    rng = np.random.default_rng(6)
    vol_dims, (Hp, Wp) = (5, 4, 6), (6, 5)
    acc = dict(g_ext=rng.standard_normal(1).astype(np.float32),
               g_tf=rng.standard_normal((Hp * Wp, 18)).astype(np.float32),
               g_vol=rng.standard_normal((int(np.prod(vol_dims)), 8)).astype(np.float32))
    jctx = SimpleNamespace(material_tf=jnp.zeros((Hp, Wp, 18), jnp.float32),
                           density=JI.PackedVolume(jnp.zeros((1, 8)), vol_dims, "full"))
    tctx = SimpleNamespace(material_tf=torch.zeros((Hp, Wp, 18)),
                           density=TI.PackedVolume(torch.zeros((int(np.prod(vol_dims)), 8)),
                                                   vol_dims))
    want = JB._contract_packed_adjoints({k: jnp.asarray(v) for k, v in acc.items()}, jctx, wrt)
    got = TB._contract_packed_adjoints({k: torch.as_tensor(v) for k, v in acc.items()}, tctx, wrt)
    assert set(got) == set(want) == set(wrt)
    for k in wrt:
        # the port's extinction gradient is a scalar, the reference's a (1,) array
        want_shape = () if k == "extinction" else tuple(np.shape(want[k]))
        assert tuple(got[k].shape) == want_shape and got[k].numel() == np.size(want[k]), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]).reshape(got[k].shape),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("learned", [("density",), ("material_tf",), ("light_spectrum",),
                                     ("density", "material_tf", "light_spectrum", "extinction")])
def test_pack_params_into_ctx_equals_the_numpy_packers(learned):
    rng = np.random.default_rng(7)
    raw = dict(density=rng.random((4, 3, 5), dtype=np.float32),
               material_tf=rng.random((6, 7, 4), dtype=np.float32),
               light_spectrum=rng.random(7, dtype=np.float32),
               extinction=np.float32(3.5))
    base = SimpleNamespace(density=TI.PackedVolume(torch.zeros((5 * 4 * 6, 8)), (5, 4, 6)))
    params = {k: torch.as_tensor(raw[k]) for k in learned}
    up = _pack_params_into_ctx(base, params, raw_mtf=torch.as_tensor(raw["material_tf"]),
                               raw_light=torch.as_tensor(raw["light_spectrum"]))
    if "density" in learned:
        assert up["density"].dims == (5, 4, 6)
        np.testing.assert_array_equal(up["density"].table.numpy(),
                                      TI.pack_volume_corners(raw["density"]).reshape(-1, 8))
    if "material_tf" in learned or "light_spectrum" in learned:
        np.testing.assert_array_equal(up["material_tf"].numpy(), TI.pack_tex2d_with_tex1d(
            raw["material_tf"], raw["light_spectrum"]))
    if "light_spectrum" in learned:
        np.testing.assert_array_equal(up["light_spectrum"].numpy(),
                                      TI.pack_tex1d_corners(raw["light_spectrum"]))
    else:
        assert "light_spectrum" not in up
    assert ("extinction" in up) == ("extinction" in learned)


@pytest.mark.parametrize("wrt", [frozenset({"environment"}), frozenset({"density"}),
                                 frozenset(WRT) | {"environment"}],
                         ids=["environment", "density", "all"])
def test_contract_packed_adjoints_env_and_xy_match_jax(wrt):
    """The env-lit ctx over an xy volume: g_env (rows, 12) and the xy g_vol
    (rows, 4) contract as JAX's _contract_packed_adjoints does."""
    rng = np.random.default_rng(13)
    vol_dims, (Hp, Wp), (He, We) = (4, 5, 6), (6, 5), (3, 5)
    acc = dict(g_ext=rng.standard_normal(1).astype(np.float32),
               g_tf=rng.standard_normal((Hp * Wp, 18)).astype(np.float32),
               g_vol=rng.standard_normal((int(np.prod(vol_dims)), 4)).astype(np.float32),
               g_env=rng.standard_normal((He * We, 12)).astype(np.float32))
    jctx = SimpleNamespace(material_tf=jnp.zeros((Hp, Wp, 18), jnp.float32),
                           density=JI.PackedVolume(jnp.zeros((1, 4)), vol_dims, "xy"),
                           environment=jnp.zeros((He, We, 12), jnp.float32))
    tctx = SimpleNamespace(material_tf=torch.zeros((Hp, Wp, 18)),
                           density=TI.PackedVolume(torch.zeros((int(np.prod(vol_dims)), 4)),
                                                   vol_dims, "xy"),
                           environment=torch.zeros((He, We, 12)))
    want = JB._contract_packed_adjoints({k: jnp.asarray(v) for k, v in acc.items()}, jctx, wrt)
    got = TB._contract_packed_adjoints({k: torch.as_tensor(v) for k, v in acc.items()}, tctx, wrt)
    assert set(got) == set(want) == set(wrt)
    for k in wrt:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]).reshape(got[k].shape),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_pack_params_into_ctx_env_and_xy_equal_the_numpy_packers():
    rng = np.random.default_rng(14)
    raw = dict(density=rng.random((4, 3, 5), dtype=np.float32),
               environment=rng.random((3, 6, 3), dtype=np.float32))
    base = SimpleNamespace(density=TI.PackedVolume(torch.zeros((4 * 4 * 6, 4)), (4, 4, 6), "xy"),
                           environment=torch.zeros((4, 7, 12)))
    up = _pack_params_into_ctx(base, {k: torch.as_tensor(v) for k, v in raw.items()})
    assert up["density"].kind == "xy" and up["density"].dims == (4, 4, 6)
    np.testing.assert_array_equal(up["density"].table.numpy(),
                                  TI.pack_volume_corners_xy(raw["density"]).reshape(-1, 4))
    np.testing.assert_array_equal(up["environment"].numpy(),
                                  TI.pack_tex2d_corners(raw["environment"]))


def test_cpu_calls_launch_nothing_and_bad_shapes_raise():
    C.reset_launch_counts()
    g = torch.zeros((3 * 4 * 5, 8))
    C.contract_volume(g, (3, 4, 5))
    C.contract_tf(torch.zeros((3, 4, 18)))
    C.pack_volume(torch.zeros((2, 3, 4)))
    C.pack_tf(torch.zeros((2, 3, 4)), torch.zeros(3), pairs=True)
    C.contract_volume(torch.zeros((2 * 4 * 5, 4)), (2, 4, 5), "xy")
    C.contract_env(torch.zeros((3, 4, 12)))
    C.pack_volume(torch.zeros((2, 3, 4)), "xy")
    C.pack_env(torch.zeros((2, 3, 3)))
    assert set(C.LAUNCHES.values()) == {0}
    with pytest.raises(ValueError):
        C.contract_tf(torch.zeros((3, 4, 16)))
    with pytest.raises(ValueError):
        C.contract_tf(torch.zeros((3, 4, 18)), material_tf=False, light=False)
    with pytest.raises(ValueError):
        C.pack_tf(torch.zeros((2, 3, 4)), torch.zeros(3, device="meta"))
