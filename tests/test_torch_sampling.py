"""The port's RNG chain, masked draws and ray geometry against vpt_tpu's.

Same numpy-seeded inputs through ``vpt_tpu.ops.{sampling,geometry}`` (jax
on the CPU) and ``vpt_tpu_torch.ops.{sampling,geometry}``. Integer chains
must be bit-equal; values that pass through transcendentals (log, sqrt,
sin, cos) are compared at the stated tolerances, since XLA's and PyTorch's
CPU libm differ in the last ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.ops import geometry as jgeo
from vpt_tpu.ops import sampling as jsam
from vpt_tpu.scene.camera import Camera
from vpt_tpu_torch.ops import geometry as tgeo
from vpt_tpu_torch.ops import sampling as tsam

torch.set_num_threads(1)

N = 100_000


def _u32(seed, n=N):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _close_ulp_amplified(actual, desired):
    """Sphere points take sqrt(1 - |disk|^2): near the disk's rim a 1-ulp
    difference between XLA's and PyTorch's sin/cos grows to ~1e-5. All but
    a few lanes in 10^4 agree to 1e-6; every lane agrees to 1e-4."""
    err = np.abs(np.asarray(actual, np.float64) - np.asarray(desired, np.float64))
    assert np.mean(err <= 1e-6) >= 0.999, f"{np.mean(err <= 1e-6):.5f} of lanes within 1e-6"
    assert err.max() <= 1e-4, f"max abs diff {err.max():.3g}"


def _eq_u32(j, t):
    np.testing.assert_array_equal(np.asarray(j).astype(np.int64), t.numpy())


def test_pcg_hash_bit_equal():
    x = _u32(0)
    _eq_u32(jsam.pcg_hash(jnp.asarray(x)), tsam.pcg_hash(_t(x)))


def test_hash3_and_seed_state_bit_equal():
    x, y, z = _u32(1), _u32(2), _u32(3)
    _eq_u32(jsam.hash3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)),
            tsam.hash3(_t(x), _t(y), _t(z)))
    seed = int(_u32(4, 1)[0])
    _eq_u32(jsam.seed_state(jnp.asarray(x), jnp.asarray(y), seed),
            tsam.seed_state(_t(x), _t(y), seed))


def test_uniform_bit_equal():
    x = _u32(5)
    np.testing.assert_array_equal(np.asarray(jsam.uniform_from_state(jnp.asarray(x))),
                                  tsam.uniform_from_state(_t(x)).numpy())


def _masked(seed, n=20_000):
    rng = np.random.default_rng(seed)
    state = _u32(seed + 100, n)
    mask = rng.random(n) < 0.6
    return state, mask


@pytest.mark.parametrize("name", ["draw", "draw_square", "draw_disk", "draw_sphere",
                                  "draw_exponential"])
def test_masked_draws(name):
    state, mask = _masked(sum(map(ord, name)))
    args_j, args_t = (), ()
    if name == "draw_exponential":
        args_j, args_t = (jnp.float32(40.0),), (40.0,)
    sj, vj = getattr(jsam, name)(jnp.asarray(state), jnp.asarray(mask), *args_j)
    st, vt = getattr(tsam, name)(_t(state), torch.as_tensor(mask), *args_t)
    _eq_u32(sj, st)
    # untouched where the mask is off
    np.testing.assert_array_equal(st.numpy()[~mask], state[~mask].astype(np.int64))
    vj = vj if isinstance(vj, tuple) else (vj,)
    vt = vt if isinstance(vt, tuple) else (vt,)
    for a, b in zip(vj, vt):
        a = np.asarray(a)
        if name in ("draw", "draw_square"):
            np.testing.assert_array_equal(a, b.numpy())
        elif name == "draw_sphere":
            _close_ulp_amplified(b.numpy(), a)
        else:
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-6)


def test_draw_hg_directions():
    rng = np.random.default_rng(9)
    n = 20_000
    state, mask = _masked(9, n)
    g = rng.uniform(-0.95, 0.95, n).astype(np.float32)
    g[::7] = 0.0  # isotropic lanes skip the cosine draw
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    sj, oj = jsam.draw_hg(jnp.asarray(state), jnp.asarray(mask), jnp.asarray(g),
                          *map(jnp.asarray, d))
    st, ot = tsam.draw_hg(_t(state), torch.as_tensor(mask), torch.as_tensor(g),
                          *map(torch.as_tensor, d))
    _eq_u32(sj, st)
    for a, b in zip(oj, ot):
        _close_ulp_amplified(b.numpy(), a)


def test_intersect_cube():
    rng = np.random.default_rng(11)
    o = rng.uniform(-1, 2, (3, 5000)).astype(np.float32)
    d = rng.normal(size=(3, 5000)).astype(np.float32)
    o[0, :50] = 0.0  # zero numerators and zero directions: NaN/inf by design
    d[1, :100] = 0.0
    tj = jgeo.intersect_cube(*map(jnp.asarray, o), *map(jnp.asarray, d))
    tt = tgeo.intersect_cube(*map(torch.as_tensor, o), *map(torch.as_tensor, d))
    for a, b in zip(tj, tt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, equal_nan=True)


def test_screen_position_and_unproject_rand():
    res = 32
    iy, ix = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    sj = jgeo.screen_position(jnp.asarray(ix, jnp.uint32), jnp.asarray(iy, jnp.uint32), 1.0 / res)
    st = tgeo.screen_position(torch.as_tensor(ix), torch.as_tensor(iy), 1.0 / res)
    for a, b in zip(sj, st):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)

    m = Camera().inverse_mvp()
    state, mask = _masked(12, res * res)
    state, mask = state.reshape(res, res), mask.reshape(res, res)
    rj = jgeo.unproject_rand(jnp.asarray(state), jnp.asarray(mask), *sj, jnp.asarray(m),
                             jnp.float32(1.0 / res), jnp.float32(0.05))
    rt = tgeo.unproject_rand(_t(state), torch.as_tensor(mask), *st, m, 1.0 / res, 0.05)
    _eq_u32(rj[0], rt[0])
    for pj, pt in zip(rj[1:], rt[1:]):
        for a, b in zip(pj, pt):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)
