"""The port's packed tables and samplers against vpt_tpu.ops.interp.

The packers must produce bit-identical tables; the samplers are compared
at numpy-seeded random coordinates (including clamped ones outside
[0, 1]). The lookups are pure f32 lerps without transcendentals, so the
port is required to be bit-equal to the JAX samplers, which is stronger
than the 1e-6 tolerance the port is held to elsewhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.ops import interp as J
from vpt_tpu.scene.volume import Volume
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.ops import interp as T

torch.set_num_threads(1)


def _coords(seed, n=2000, lo=-0.2, hi=1.2):
    rng = np.random.default_rng(seed)
    return [rng.uniform(lo, hi, n).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("packer", ["pack_volume_corners", "pack_tex2d_corners",
                                    "pack_tex1d_corners"])
def test_packers_bit_equal(packer):
    rng = np.random.default_rng(0)
    shape = {"pack_volume_corners": (5, 7, 9), "pack_tex2d_corners": (6, 11, 4),
             "pack_tex1d_corners": (13,)}[packer]
    x = rng.random(shape, dtype=np.float32)
    np.testing.assert_array_equal(getattr(T, packer)(x), getattr(J, packer)(x))


def test_fused_tf_light_pack_bit_equal():
    rng = np.random.default_rng(1)
    tf = rng.random((256, 256, 4), dtype=np.float32)
    light = rng.random(256, dtype=np.float32)
    got = T.pack_tex2d_with_tex1d(tf, light)
    assert got.shape == (257, 257, 18)
    np.testing.assert_array_equal(got, J.pack_tex2d_with_tex1d(tf, light))


@pytest.mark.parametrize("scale", [1.0, 0.7134])
def test_pack_volume_auto_matches_jax_table(scale):
    """u8-quantized sources pack to the same flat u8 table as the JAX
    package; other sources to the flat f32 corner table."""
    vol = Volume.sphere_in_cube(16).density * np.float32(scale)
    got = T.pack_volume_auto(vol, "cpu")
    assert got.dims == (17, 17, 17)
    if scale == 1.0:
        want = J.pack_volume_auto(vol, "full")
        assert got.table.dtype == torch.uint8 and want.dims == got.dims
        np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    else:
        assert got.table.dtype == torch.float32
        np.testing.assert_array_equal(got.table.numpy(),
                                      J.pack_volume_corners(vol).reshape(-1, 8))


def test_u8_dequantize_exact_all_codes():
    codes = torch.arange(256, dtype=torch.uint8)[:, None]
    want = np.arange(256, dtype=np.float32) / np.float32(255.0)
    np.testing.assert_array_equal(T.dequantize_rows(codes)[:, 0].numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(J._dequantize_rows(jnp.asarray(codes.numpy())))[:, 0], want)


@pytest.mark.parametrize("table_dtype", ["u8", "f32"])
def test_sample_volume_packed_matches_jax(table_dtype):
    codes = np.arange(256, dtype=np.uint8).reshape(4, 8, 8)
    vol = codes.astype(np.float32) / np.float32(255.0)
    jv = J.PackedVolume.pack(vol, "full", table_dtype=table_dtype)
    table = torch.as_tensor(np.array(jv.table))
    u, v, w = _coords(2)
    want = np.asarray(J.sample_volume(jv, jnp.asarray(u), jnp.asarray(v), jnp.asarray(w)))
    tu, tv, tw = map(torch.as_tensor, (u, v, w))
    got = T.sample_volume_packed(table, jv.dims, tu, tv, tw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, want)  # bit-equal
    # the kernel wrapper on CPU tensors is the plain version and launches nothing
    before = dict(K.LAUNCHES)
    np.testing.assert_array_equal(K.sample_volume_packed(table, jv.dims, tu, tv, tw).numpy(), got)
    assert K.LAUNCHES == before


def test_sample_volume_packed_equals_grid_sample():
    """One PyTorch call computes K3's function: ``F.grid_sample`` on the
    dequantized (D, H, W) volume, trilinear, texel centres at half a texel
    (``align_corners=False``), edge-clamped (``padding_mode="border"``),
    with (u, v, w) mapped to [-1, 1]; chip_smoke.py times it as K3's
    library call."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 256, (5, 7, 9), dtype=np.uint8)
    vol = codes.astype(np.float32) / np.float32(255.0)
    pv = T.pack_volume_auto(vol, "cpu")
    assert pv.table.dtype == torch.uint8
    u, v, w = map(torch.as_tensor, _coords(6))
    got = T.sample_volume_packed(pv.table, pv.dims, u, v, w)
    grid = (torch.stack([u, v, w], -1) * 2.0 - 1.0).reshape(1, 1, 1, -1, 3)
    lib = torch.nn.functional.grid_sample(torch.as_tensor(vol)[None, None], grid, mode="bilinear",
                                          padding_mode="border", align_corners=False)
    np.testing.assert_allclose(lib.reshape(-1).numpy(), got.numpy(), rtol=0, atol=1e-6)


def test_sample_tex2d_fused1d_matches_jax():
    rng = np.random.default_rng(3)
    tf = rng.random((32, 24, 4), dtype=np.float32)
    light = rng.random(24, dtype=np.float32)
    packed = J.pack_tex2d_with_tex1d(tf, light)
    u, v, _ = _coords(4)
    mj, lj = J.sample_tex2d_fused1d(jnp.asarray(packed), jnp.asarray(u), jnp.asarray(v))
    mt, lt = T.sample_tex2d_fused1d(torch.as_tensor(packed), torch.as_tensor(u),
                                    torch.as_tensor(v))
    for a, b in ((mj, mt), (lj, lt)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))  # bit-equal


def test_packed_volume_validates_shape():
    with pytest.raises(ValueError):
        T.PackedVolume(torch.zeros((10, 8), dtype=torch.uint8), (2, 2, 2))
    with pytest.raises(ValueError):
        T.PackedVolume(torch.zeros((8, 4), dtype=torch.float32), (2, 2, 2))
