"""The port stands alone: it imports nothing of the JAX package ``vpt_tpu``
(nor jax), and its own copies of that package's jax-free modules (scene,
config, majorant, the CIE data) give the same values from the same inputs.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from vpt_tpu.ops import majorant as JMaj
from vpt_tpu.ops import spectral as JSp
from vpt_tpu.scene import camera as JCam
from vpt_tpu.scene.volume import Volume as JVolume
from vpt_tpu.utils import config as JCfg
from vpt_tpu_torch import convert
from vpt_tpu_torch.ops import majorant as TMaj
from vpt_tpu_torch.ops import spectral as TSp
from vpt_tpu_torch.scene import camera as TCam
from vpt_tpu_torch.scene.volume import Volume as TVolume
from vpt_tpu_torch.utils import config as TCfg

REPO = Path(__file__).resolve().parent.parent


def test_port_and_chip_smoke_import_nothing_of_the_jax_package(tmp_path):
    """Every module of vpt_tpu_torch and the chip_smoke module, imported in a
    fresh interpreter, leave vpt_tpu and jax out of sys.modules."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import vpt_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(vpt_tpu_torch.__path__,
                                                       "vpt_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        # the slab backward's entry points and kernels' wrappers
        from vpt_tpu_torch.parallel.slab import (contract_slab_adjoint, distributed_scatter_add,
                                                 fit_spectral_slab, make_spectral_prb_step_slab,
                                                 pack_slab_rows, prb_grads_slab,
                                                 prb_window_grads_slab)
        from vpt_tpu_torch.kernels.slab import slab_contract, slab_pack, slab_scatter
        import chip_smoke
        bad = sorted(k for k in sys.modules
                     if k in ("vpt_tpu", "jax") or k.startswith(("vpt_tpu.", "jax.")))
        print(len(names), bad)
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    # the walk reached the copied modules and the kernels
    assert int(n) >= 25, n


BOUNDARIES = {
    "default": JCfg.SpectrumConfig().boundaries,
    "uniform24": JCfg.SpectrumConfig.uniform(24).boundaries,
    "exponential16": JCfg.SpectrumConfig.exponential(16, 2.0).boundaries,
    "narrow": (450.0, 455.0, 460.5, 600.0),
}


@pytest.mark.parametrize("name", sorted(BOUNDARIES))
def test_bin_coefficients_and_representation_equal_jax(name):
    b = np.asarray(BOUNDARIES[name])
    for got, want in zip(TSp.bin_coefficients(b), JSp.bin_coefficients(b)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    if 4 * (len(b) - 1) + 2 > 64:  # the reference's 64-float buffer holds 15 bins at most
        for mod in (TSp, JSp):
            with pytest.raises(AssertionError, match="exceeds buffer size"):
                mod.spectrum_representation_buffer(b)
        return
    assert np.array_equal(TSp.spectrum_representation_buffer(b),
                          JSp.spectrum_representation_buffer(b))
    assert np.array_equal(TCfg.SpectrumConfig(tuple(b)).representation_buffer(),
                          JCfg.SpectrumConfig(tuple(b)).representation_buffer())


def test_cie_table_and_matrices_equal_jax():
    for got, want in zip(TSp.cie_1931(), JSp.cie_1931()):
        assert np.array_equal(got, want)
    for k in ("XYZ_TO_SRGB_KERNEL", "XYZ_TO_SRGB_HOST"):
        got, want = getattr(TSp, k), getattr(JSp, k)
        assert got.dtype == want.dtype and np.array_equal(got, want), k


def _majorant_scene(seed):
    rng = np.random.default_rng(seed)
    density = rng.random((24, 24, 24), dtype=np.float32)
    density *= rng.random((24, 24, 24)) > 0.7  # mostly empty, like a sparse scene
    table = rng.random((256, 256, 4), dtype=np.float32)
    return density, table


@pytest.mark.parametrize("block,extinction", [(4, 20.0), (8, 40.0), (6, 3.5)])
def test_build_majorant_grid_equals_jax(block, extinction):
    density, table = _majorant_scene(block)
    got = TMaj.build_majorant_grid(density, table, extinction, block=block)
    want = JMaj.build_majorant_grid(density, table, extinction, block=block)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _poses(M):
    cams = [M.Camera(), M.Camera(translation=np.array([0.0, 0.0, 1.2])),
            M.Camera(fovy=0.7, aspect=1.5, near=0.05, far=20.0)]
    for yaw, pitch, dist in ((0.7, -0.3, 2.0), (2.5, 0.9, 3.1)):
        cam = M.Camera()
        M.OrbitController(yaw=yaw, pitch=pitch, focus_distance=dist).apply(cam)
        cams.append(cam)
    cam = M.Camera()
    M.CircleAnimator(radius=1.5).apply(cam, 0.3)
    cams.append(cam)
    return cams


@pytest.mark.parametrize("pose", range(6))
def test_camera_matrices_equal_jax(pose):
    t, j = _poses(TCam)[pose], _poses(JCam)[pose]
    for attr in ("projection_matrix", "view_matrix"):
        assert np.array_equal(getattr(t, attr), getattr(j, attr)), attr
    got, want = t.inverse_mvp(), j.inverse_mvp()
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    # and the camera carried across by convert
    assert np.array_equal(convert.camera_from(j).inverse_mvp(), want)


@pytest.mark.parametrize("name,args", [("sphere_in_cube", (16,)), ("sphere_in_cube", (33,)),
                                       ("two_spheres", (16,)), ("sparse_spheres", (64,))])
def test_volume_constructors_equal_jax(name, args):
    got = getattr(TVolume, name)(*args)
    want = getattr(JVolume, name)(*args)
    assert got.density.dtype == want.density.dtype
    assert np.array_equal(got.density, want.density) and got.filter == want.filter


def test_configs_equal_jax_and_convert_carries_them():
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (256, 256, 4)).astype(np.uint8)
    pairs = [
        (TCfg.MaterialTF.from_uint8(u8), JCfg.MaterialTF.from_uint8(u8)),
        (TCfg.MaterialTF.constant(0.8, 0.6, 0.3), JCfg.MaterialTF.constant(0.8, 0.6, 0.3)),
        (TCfg.LightConfig.from_uint8((1, 0.2, 0.5), u8[0, :, 0]),
         JCfg.LightConfig.from_uint8((1, 0.2, 0.5), u8[0, :, 0])),
        (TCfg.MCMSpectralConfig(extinction=40.0, bounces=8, steps=8, blur=0.1),
         JCfg.MCMSpectralConfig(extinction=40.0, bounces=8, steps=8, blur=0.1)),
        (TCfg.SpectrumConfig.exponential(12, 1.5), JCfg.SpectrumConfig.exponential(12, 1.5)),
    ]
    for t, j in pairs:
        carried = convert.scene_from(j)
        assert type(carried) is type(t) and type(t).__module__.startswith("vpt_tpu_torch")
        for obj in (t, carried):
            if hasattr(j, "table"):
                assert np.array_equal(obj.table, j.table)
            else:
                assert obj == type(obj)(**{k: getattr(j, k) for k in j.__dataclass_fields__})
    assert TCfg.property_metadata(TCfg.MCMSpectralConfig) == JCfg.property_metadata(
        JCfg.MCMSpectralConfig)
    vol = JVolume(JVolume.sphere_in_cube(8).density, filter="quasicubic")
    tv = convert.volume_from(vol)
    assert isinstance(tv, TVolume) and tv.filter == "quasicubic"
    assert np.array_equal(tv.density, vol.density)
    with pytest.raises(TypeError):
        convert.scene_from(object())
