"""The port's RenderSession and tonemappers against vpt_tpu's, checkpoint
interchange between the two packages, and the port's independence of jax."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.postprocess import tonemap as JT
from vpt_tpu.scene.camera import Camera, OrbitController
from vpt_tpu.scene.volume import Volume
from vpt_tpu.session import RenderSession as JaxSession
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch import scene as TSC
from vpt_tpu_torch.kernels import mcm_spectral as K
from vpt_tpu_torch.postprocess import tonemap as TT
from vpt_tpu_torch.session import RenderSession, frame_seed

torch.set_num_threads(1)

RES = 32


@pytest.fixture(scope="module")
def session_args():
    return ("mcm-spectral", Volume.sphere_in_cube(16), MaterialTF.constant(0.8, 0.6, 0.3),
            LightConfig(direction=(1.0, 0.2, 0.5)), SpectrumConfig(),
            MCMSpectralConfig(extinction=20.0, steps=4))


@pytest.fixture(scope="module")
def port_args(session_args):
    """``session_args`` as the port's own scene and config types."""
    return (session_args[0], *convert.scene_from(*session_args[1:]))


def _state_arrays(session):
    s = session.state
    if hasattr(s, "tensors"):
        return [t.numpy() for t in s.tensors()]
    return [np.asarray(x) for x in s]


def test_session_image_u8_matches_jax(session_args, port_args):
    K.reset_launch_counts()
    a = RenderSession(*port_args, resolution=RES, base_seed=3, device="cpu").run(3)
    b = JaxSession(*session_args, resolution=RES, base_seed=3).run(3)
    ua, ub = a.image_u8(), b.image_u8()
    assert ua.shape == ub.shape == (RES, RES, 3) and ua.dtype == np.uint8
    close = np.all(np.abs(ua.astype(int) - ub.astype(int)) <= 1, axis=-1)
    assert close.mean() >= 0.99, f"{close.mean():.3f} of pixels within one code"
    m = a.metrics()
    assert m["frames"] == 3 and m["paths"] == int(np.asarray(b.state.samples).sum())
    # CPU tensors take the plain versions: no kernel launches
    assert not any(K.LAUNCHES.values()), K.LAUNCHES


def test_checkpoint_resume(tmp_path, port_args):
    a = RenderSession(*port_args, resolution=16, base_seed=5, device="cpu")
    a.run(3)
    ckpt = str(tmp_path / "ck.npz")
    a.save_checkpoint(ckpt)
    a.run(2)
    b = RenderSession(*port_args, resolution=16, base_seed=5, device="cpu")
    b.load_checkpoint(ckpt)
    assert b.frame == 3
    b.run(2)
    np.testing.assert_array_equal(a.hdr_image(), b.hdr_image())


def test_jax_checkpoint_loads_into_port(tmp_path, session_args, port_args):
    j = JaxSession(*session_args, resolution=16, base_seed=9, streams=2)
    j.run(2)
    ckpt = str(tmp_path / "jax.npz")
    j.save_checkpoint(ckpt)
    t = RenderSession(*port_args, resolution=16, base_seed=0, streams=2, device="cpu")
    t.load_checkpoint(ckpt)
    assert t.frame == 2 and t.base_seed == 9
    for x, y in zip(_state_arrays(t), _state_arrays(j)):
        np.testing.assert_array_equal(x, y)
    # and back: the port's checkpoint loads into the JAX session
    t.save_checkpoint(str(tmp_path / "port.npz"))
    j2 = JaxSession(*session_args, resolution=16, streams=2)
    j2.load_checkpoint(str(tmp_path / "port.npz"))
    for x, y in zip(_state_arrays(j2), _state_arrays(j)):
        np.testing.assert_array_equal(x, y)


def test_checkpoint_rejects_other_renderer_and_shape(tmp_path, port_args):
    a = RenderSession(*port_args, resolution=16, device="cpu").run(1)
    ckpt = str(tmp_path / "ck.npz")
    a.save_checkpoint(ckpt)
    b = RenderSession(*port_args, resolution=8, device="cpu")
    with pytest.raises(ValueError):
        b.load_checkpoint(ckpt)
    data = dict(np.load(ckpt))
    data["renderer_key"] = np.asarray("eam")
    np.savez(str(tmp_path / "other.npz"), **data)
    with pytest.raises(ValueError):
        a.load_checkpoint(str(tmp_path / "other.npz"))


def test_set_camera_resets_and_progress_path(port_args):
    s = RenderSession(*port_args, resolution=16, device="cpu")
    seen = []
    s.run(2, progress=seen.append)
    assert seen == [1, 2] and s.frame == 2
    cam = TSC.Camera()
    TSC.OrbitController(yaw=1.0).apply(cam)
    s.set_camera(cam)
    assert s.frame == 0 and s.hdr is None
    assert frame_seed(0, 1) != frame_seed(0, 2)


@pytest.mark.parametrize("key", sorted(JT.TONEMAPPERS))
def test_tonemappers_match_jax(key):
    assert sorted(TT.TONEMAPPERS) == sorted(JT.TONEMAPPERS)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((64, 64, 3)) * 2.0 + 0.5).astype(np.float32)
    x[0, :8] = np.array([0.0, 1e-6, 0.18, 1.0, 4.0, 11.2, 100.0, -0.5], np.float32)[:, None]
    want = np.asarray(JT.make_tonemapper(key)(jnp.asarray(x)))
    got = TT.make_tonemapper(key)(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, equal_nan=True)


def test_display_conversion_matches_jax():
    from vpt_tpu.models.mcm_spectral import radiance_to_rgb as j_rgb
    from vpt_tpu.ops import spectral as JS
    from vpt_tpu_torch.models.mcm_spectral import radiance_to_rgb as t_rgb
    from vpt_tpu_torch.ops import spectral as TS

    rng = np.random.default_rng(1)
    rad = rng.random((12, 2, 8, 8), dtype=np.float32)
    bx, by, bz = JS.bin_coefficients(np.array(SpectrumConfig().boundaries))
    bin_xyz = np.stack([bx, by, bz]).astype(np.float32)
    np.testing.assert_allclose(t_rgb(torch.as_tensor(rad), torch.as_tensor(bin_xyz)).numpy(),
                               np.asarray(j_rgb(jnp.asarray(rad), jnp.asarray(bin_xyz))),
                               rtol=1e-5, atol=1e-6)
    lin = rng.uniform(-0.1, 2.0, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(TS.srgb_gamma(torch.as_tensor(lin)).numpy(),
                               np.asarray(JS.srgb_gamma(jnp.asarray(lin))), rtol=1e-6, atol=1e-6)


def test_port_never_imports_jax(tmp_path):
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import vpt_tpu_torch, vpt_tpu_torch.session, vpt_tpu_torch.convert
        import vpt_tpu_torch.optim, vpt_tpu_torch.kernels.spectral_backward
        import vpt_tpu_torch.tools.gather_bench
        import vpt_tpu_torch.cli, vpt_tpu_torch.models.mcm_spectral_compact
        from vpt_tpu_torch import (LightConfig, MaterialTF, MCMSpectralConfig,
                                   SpectrumConfig, Volume)
        from vpt_tpu_torch.session import RenderSession
        s = RenderSession("mcm-spectral", Volume.sphere_in_cube(8),
                          MaterialTF.constant(0.8, 0.6), LightConfig(), SpectrumConfig(),
                          MCMSpectralConfig(extinction=10.0, steps=2), resolution=8,
                          device="cpu")
        s.run(2)
        assert s.image_u8().shape == (8, 8, 3)
        env = np.ones((4, 8, 3), np.float32)
        s = RenderSession("mcm-spectral", Volume.sphere_in_cube(8),
                          MaterialTF.constant(0.8, 0.6), LightConfig(), SpectrumConfig(),
                          MCMSpectralConfig(extinction=10.0, steps=2), resolution=8,
                          device="cpu", environment=env, majorant_blocks=4,
                          compaction=True)
        s.run(2)
        assert s.image_u8().shape == (8, 8, 3)
        assert "jax" not in sys.modules, "jax was imported"
        print("ok")
    """)
    repo = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(tmp_path), env=env)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
