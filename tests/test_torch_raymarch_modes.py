"""K15's and K16's instance by table pair (``kernels/raymarch.py::
march_mode``, which fills the parameter block's RI_MODE; ``csrc/raymarch.cu``
MarchMode and its dispatch), and the identities the redesigned kernels use
in place of the plain version's operations:

- every pair the renderers and ``optim.fit_density`` build runs an instance
  of its own, and every pair the wrappers take maps to an instance the
  library builds, its flags the ones the instance reads (``mode_ok``), so
  no input K15 or K16 took before raises for want of one;
- K16's offset wrap ``x < 1 ? x : x - 1`` equals ``torch.remainder(x, 1)``
  (and the plain version's ``np.remainder``) bit for bit in float32 over
  every ``offset + k * step`` of the renderers' seeds and step counts, and
  over a sweep of [0, 2); those x grow with k, so the kernel's test of the
  two ends covers every one;
- a lookup of the raw TF at v = 0 reads row 0 twice (its k10, k11 are k00,
  k01) for every TF height;
- ``march_u8``'s dequantization without the zero test equals the plain
  division by 255 for all 256 codes;
- the 8 x 4 pixel tiles (a block 16 x 8, ``kernels.mcs.warp_tiles``'s
  layout, which ``march_pixel`` computes) cover each pixel once.
"""

import re

import numpy as np
import pytest
import torch

from vpt_tpu_torch import Volume
from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.kernels import mcs as KS
from vpt_tpu_torch.kernels import raymarch as RK
from vpt_tpu_torch.models import raymarch as TR
from vpt_tpu_torch.ops import interp
from vpt_tpu_torch.scene.tf import TransferFunction2D
from vpt_tpu_torch.session import frame_seed

F32 = np.float32
SOURCE = (_build.CSRC_DIR / "raymarch.cu").read_text()


def _mode_index(dens, tft, filt):
    return int(RK._params(np.eye(4), dens, tft, filt, 8, 4, F32(0.25), F32(0.0))[1][-1])


def test_modes_follow_the_source():
    """MARCH_MODES is MarchMode in order, RI_MODE is the block's last
    integer, and both dispatches instantiate every mode."""
    body = re.search(r"enum MarchMode \{(.*?)\};", SOURCE, re.S).group(1)
    names = re.findall(r"^\s*(MM_\w+)", body, re.M)
    assert names[-1] == "MM_COUNT" and len(names) - 1 == len(RK.MARCH_MODES)
    assert [n[3:].lower() for n in names[:-1]] == [
        m.replace(" quasicubic", "_qc") for m in RK.MARCH_MODES]
    assert re.search(r"RI_MODE,[^\n]*\n\s*RI_COUNT,", SOURCE)
    for n in names[:-1]:
        assert f"VPT_MARCH_MODE({n})" in SOURCE and f"VPT_MIP_MODE({n})" in SOURCE


def _volume(kind, filt):
    density = Volume.sphere_in_cube(16).density
    if kind == "f32":  # values no u8 code holds: packed as f32
        density = np.random.default_rng(5).random((16, 16, 16), np.float32)
    return Volume(density, filt)


@pytest.mark.parametrize("renderer", ["eam", "mip", "depth"])
@pytest.mark.parametrize("kind", ["u8", "f32"])
@pytest.mark.parametrize("filt", ["linear", "quasicubic", "nearest"])
def test_every_renderer_pair_has_its_instance(renderer, kind, filt):
    """EAM's, MIP's and Depth's tables (packed for linear and quasicubic, raw
    for nearest) run their own instance, never the generic one."""
    cls = {"eam": TR.EAMRenderer, "mip": TR.MIPRenderer, "depth": TR.DepthRenderer}[renderer]
    r = cls(_volume(kind, filt), resolution=8, device="cpu")
    got = RK.march_mode(r._density, r._tf_table, filt)
    want = ((kind + ("" if filt == "linear" else " quasicubic")) if filt != "nearest"
            else "nearest")
    assert got == want
    assert _mode_index(r._density, r._tf_table, filt) == RK.MARCH_MODES.index(want)


@pytest.mark.parametrize("filt", ["linear", "quasicubic", "nearest"])
def test_fit_density_pair_has_its_instance(filt):
    """fit_density's frame: the raw (D, H, W) grid beside the raw (H, W, 4)
    TF, under each filter."""
    dens = torch.full((8, 8, 8), 0.2)
    tft = torch.as_tensor(np.asarray(TransferFunction2D.grayscale_ramp().rasterize(), F32))
    want = {"linear": "raw", "quasicubic": "raw quasicubic", "nearest": "nearest"}[filt]
    assert RK.march_mode(dens, tft, filt) == want


def _mode_flags(mode):
    """The table flags an instance reads (csrc/raymarch.cu mode_ok): raw
    grid, u8 table, quasicubic, nearest, raw TF."""
    raw = mode in ("raw", "raw quasicubic", "nearest")
    return dict(raw=raw, u8=None if raw else mode.startswith("u8"),
                qc=mode.endswith("quasicubic"), nearest=mode == "nearest", tf_raw=raw)


@pytest.mark.parametrize("density", ["packed u8", "packed f32", "raw"])
@pytest.mark.parametrize("tf", ["packed", "raw"])
@pytest.mark.parametrize("filt", ["linear", "quasicubic", "nearest"])
def test_every_pair_the_wrappers_take_has_an_instance(density, tf, filt):
    """Each (volume, TF, filter) the table checks take maps to a mode the
    library instantiates (the pairs no renderer builds to "generic") whose
    flags are the block's, and K15 and K16 run it; the pair the checks refuse
    (a packed table under the nearest filter) is refused as before."""
    vol = _volume("f32" if density == "packed f32" else "u8", "linear")
    raw_tf = np.asarray(TransferFunction2D.grayscale_ramp().rasterize(), F32)
    dens = (torch.as_tensor(np.asarray(vol.density, F32)) if density == "raw"
            else interp.pack_volume_auto(vol.density, "cpu", "full"))
    tft = torch.as_tensor(raw_tf if tf == "raw" else interp.pack_tex2d_corners(raw_tf))
    if density != "raw" and filt == "nearest":
        with pytest.raises(ValueError, match="needs a raw grid"):
            RK._check_tables(dens, tft, filt)
        return
    RK._check_tables(dens, tft, filt)
    mode = RK.march_mode(dens, tft, filt)
    built = (density != "raw") == (tf == "packed")
    assert (mode != "generic") == built
    _, i = RK._params(np.eye(4), dens, tft, filt, 8, 4, F32(0.25), F32(0.0))
    assert i[-1] == RK.MARCH_MODES.index(mode)
    if mode != "generic":
        flags = _mode_flags(mode)
        assert (bool(i[2]), bool(i[7]), bool(i[8]), bool(i[9])) == (
            flags["raw"], flags["qc"], flags["nearest"], flags["tf_raw"])
        if flags["u8"] is not None:
            assert bool(i[3]) == flags["u8"]
    inv = np.eye(4, dtype=F32)
    acc = torch.zeros((8, 8))
    RK.mip_pass(acc, inv, dens, tft, 0.3, 4, filt)
    img = RK.eam_frame_pass(inv, dens, tft, 10.0, 0.3, 4, 8, filt)
    assert bool(torch.isfinite(acc).all()) and bool(torch.isfinite(img).all())


def _wrap(x):
    return np.where(x < F32(1), x, x - F32(1)).astype(F32)


def _offsets():
    """The MIP offsets the sessions march at: _seed_to_offset of frame_seed
    over seeds and frames."""
    return sorted({F32(TR._seed_to_offset(frame_seed(seed, f)))
                   for seed in range(8) for f in range(1, 65)} | {F32(0.0)})


@pytest.mark.parametrize("steps", [64, 50, 32, 16, 128, 7, 1])
def test_mip_wrap_equals_remainder_over_the_renderers_offsets(steps):
    step = F32(1.0 / steps)
    k = np.arange(steps, dtype=F32)
    for off in _offsets():
        x = (F32(off) + k * step).astype(F32)
        assert (x >= 0).all() and (x < 2).all() and (np.diff(x) >= 0).all()
        want = torch.remainder(torch.from_numpy(x), 1.0).numpy()
        assert np.array_equal(_wrap(x).view(np.int32), want.view(np.int32))
        assert np.array_equal(_wrap(x).view(np.int32),
                              np.remainder(x, F32(1)).view(np.int32))


def test_mip_wrap_equals_remainder_over_a_sweep_of_0_2():
    """Every 61st float32 in [0, 2), and every float within 2^12 ulps of 0,
    1 and 2 (below 2)."""
    top = int(np.array(2.0, F32).view(np.uint32))
    bits = np.arange(0, top, 61, dtype=np.uint32)
    one = int(np.array(1.0, F32).view(np.uint32))
    near = np.concatenate([np.arange(0, 4096), np.arange(one - 4096, one + 4096),
                           np.arange(top - 4096, top)]).astype(np.uint32)
    x = np.concatenate([bits, near]).view(F32)
    want = torch.remainder(torch.from_numpy(x), 1.0).numpy()
    assert np.array_equal(_wrap(x).view(np.int32), want.view(np.int32))
    assert "  return x < 1.0f ? x : x - 1.0f;" in SOURCE


@pytest.mark.parametrize("height", [1, 2, 3, 16, 255, 256, 1024])
def test_raw_tf_at_v0_reads_row_0_twice(height):
    """interp._coords of v = 0 over a raw TF of any height: both rows 0."""
    lo, hi, frac = interp._coords(torch.zeros(1), height)
    assert int(lo) == 0 and int(hi) == 0 and float(frac) == 0.5
    assert "\n  q.r1 = q.r0;\n" in SOURCE


def _fma(x, y, z):
    """__fmaf_rn(x, y, z) on float32 arrays, rounded once: the product is
    exact in float64 (24 + 24 bits), the sum a TwoSum pair (s, e), and the
    float32 nearest to s + e taken with ties to even on the exact sum."""
    p = x.astype(np.float64) * y.astype(np.float64)
    z = z.astype(np.float64)
    s = p + z
    bb = s - p
    e = (p - (s - bb)) + (z - bb)
    f = s.astype(F32)
    f64 = f.astype(np.float64)
    other = np.nextafter(f, np.where(s > f64, F32(np.inf), F32(-np.inf)).astype(F32))
    lo, hi = np.minimum(f, other), np.maximum(f, other)
    tie = (s != f64) & (s == (f64 + other.astype(np.float64)) / 2) & (e != 0)
    return np.where(tie, np.where(e > 0, hi, lo), f)


def test_march_u8_without_the_zero_test_equals_div_scalar():
    """march_u8: u8_unit's corrected product with RN(1/255), no zero test,
    for all 256 codes (the code placed in 2^23's mantissa, less 2^23)."""
    assert "  return __fmaf_rn(__fmaf_rn(-255.0f, q, v), kInv255, q);" in SOURCE
    v = np.arange(256, dtype=F32)
    inv = np.full_like(v, F32(1) / F32(255))
    q = (v * inv).astype(F32)
    got = _fma(_fma(np.full_like(v, F32(-255.0)), q, v), inv, q)
    want = (torch.arange(256, dtype=torch.float32) / 255.0).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("res", [512, 100, 24, 7])
def test_tiles_cover_each_pixel_once(res):
    """The 8 x 4 tile a warp, 16 x 8 a block, the blocks a grid over the
    image: each pixel once, the lanes outside the image idle."""
    assert ("  ix = blockIdx.x * MARCH_TILE_W + (warp & 1) * 8 + (lane & 7);\n"
            "  iy = blockIdx.y * MARCH_TILE_H + (warp >> 1) * 4 + (lane >> 3);") in SOURCE
    assert "#define MARCH_TILE_W 16\n#define MARCH_TILE_H 8" in SOURCE
    tiles = KS.warp_tiles(res)
    pix = tiles[tiles >= 0]
    assert pix.numel() == res * res and torch.equal(pix.sort().values, torch.arange(res * res))
