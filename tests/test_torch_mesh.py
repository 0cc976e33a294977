"""The ray mesh of the port (``vpt_tpu_torch/parallel/mesh.py``) across gloo
processes on the CPU, against the JAX package's mesh
(``vpt_tpu/parallel/mesh.py``, ``tests/test_mesh_streams.py``).

The ranks run in spawned processes (``vpt_tpu_torch/tools/mesh_dryrun.py``:
a ``FileStore`` under the test's temporary directory, one thread each),
which import neither jax nor ``vpt_tpu``; this process compares what they
saved with JAX on the 8-device virtual CPU mesh of ``tests/conftest.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.parallel.mesh import ray_mesh as jax_ray_mesh
from vpt_tpu.parallel.mesh import shard_spectral_state as jax_shard
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.parallel.mesh import RayMesh
from vpt_tpu_torch.tools import mesh_dryrun as D

WORLDS = (1, 2, 4)
STREAMS = (1, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world size's ranks: a random state sharded and gathered back,
    and the mesh renderer's reset and renders, with streams 1 and 2."""
    jobs = [(f"shard{s}", "shard_state", dict(streams=s)) for s in STREAMS]
    jobs += [(f"render{s}", "mesh_render", dict(streams=s)) for s in STREAMS]
    return {w: D.run(w, tmp_path_factory.mktemp(f"mesh{w}"), jobs) for w in WORLDS}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_states_equal(a, b):
    for k in TM.SpectralState.field_names():
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)


@pytest.mark.parametrize("world", WORLDS[1:])
@pytest.mark.parametrize("streams", STREAMS)
def test_shard_spectral_state_matches_jax(runs, world, streams):
    """Every rank holds the rows JAX's row-sharded state puts on its
    device, in every leaf ((H, W), (S, H, W), (B, H, W), (B, S, H, W)), and
    the rows gathered back are the global state."""
    full = D.random_state(streams, seed=5)
    mesh = jax_ray_mesh(world)
    state = jax_shard(JM.SpectralState(**{k: jnp.asarray(v) for k, v in full.items()}), mesh)
    for rank, dev in enumerate(mesh.devices):
        mine = runs[world][rank][f"shard{streams}"]
        for k, leaf in state._asdict().items():
            shard = next(s for s in leaf.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(mine["shard"][k], np.asarray(shard.data), err_msg=k)
            rows = full[k].shape[-2] // world
            assert mine["shard"][k].shape[-2] == rows, k
        _assert_states_equal(mine["gathered"], full)


@pytest.mark.parametrize("world", WORLDS[1:])
@pytest.mark.parametrize("streams", STREAMS)
def test_mesh_render_equals_world_1_bit_for_bit(runs, world, streams):
    """MCMSpectralRenderer(mesh=): the reset, every state field after
    render_many and render, and both images are world 1's bit for bit; every
    rank holds the same global image."""
    ref = runs[1][0][f"render{streams}"]
    for rank in range(world):
        got = runs[world][rank][f"render{streams}"]
        for key in ("image_many", "image"):
            np.testing.assert_array_equal(_bits(got[key]), _bits(ref[key]), err_msg=key)
        _assert_states_equal(got["reset"], ref["reset"])
        _assert_states_equal(got["state"], ref["state"])
        rows = D.RES // world
        assert got["lane_shape"] == ((rows, D.RES) if streams == 1 else (streams, rows, D.RES))
    assert ref["state"]["samples"].sum() > 0


@pytest.mark.parametrize("streams", STREAMS)
def test_mesh_render_at_world_1_equals_the_renderer_without_a_mesh(runs, streams):
    """A world-1 mesh renders over a lane table (ix, global iy, seed_iy);
    the renderer without a mesh over its pixel grid: the same bits."""
    got = runs[1][0][f"render{streams}"]
    np.testing.assert_array_equal(_bits(got["image_many"]), _bits(got["plain_image_many"]))
    np.testing.assert_array_equal(_bits(got["image"]), _bits(got["plain_image"]))
    _assert_states_equal(got["state"], got["plain_state"])


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_render_makes_no_collective_before_the_image_gather(runs, world):
    """A mesh render with a replicated volume communicates once: the
    gather of the image's rows (tests/test_hlo.py:54, zero collectives in
    the render itself)."""
    for rank in range(world):
        counts = runs[world][rank]["render2"]["counts_many"]
        assert counts == {"all_gather": 0, "reduce_scatter": 0, "gather_rows": 1, "halo": 0,
                          "all_reduce": 0}, counts


def test_mesh_render_meets_the_image_contract_against_jax(runs):
    """The port's world-2 mesh render against JAX's renderer on a 2-device
    mesh, same scene and seeds: the repo's image contract
    (tests/test_mcm_spectral_parity.py)."""
    args = (Volume.sphere_in_cube(D.VOL), MaterialTF.constant(0.8, 0.6, 0.2),
            LightConfig(direction=(1.0, 0.2, 0.3)), SpectrumConfig(),
            MCMSpectralConfig(extinction=20.0, steps=D.STEPS))
    r = JM.MCMSpectralRenderer(*args, resolution=D.RES, streams=2, mesh=jax_ray_mesh(2))
    cam = Camera()
    state = r.reset(cam, 3)
    state, _ = r.render_many(state, cam, [5, 6])
    state, img = r.render(state, cam, 9)
    got = runs[2][0]["render2"]
    img, ref = got["image"], np.asarray(img)
    diff = np.abs(img - ref)
    assert np.mean(diff / (np.abs(ref) + 1e-3) < 1e-3) >= 0.995
    assert np.median(diff) < 1e-5
    assert np.mean(got["state"]["samples"] == np.asarray(state.samples)) >= 0.99


def _scene():
    args = (Volume.sphere_in_cube(D.VOL), MaterialTF.constant(0.8, 0.6, 0.2),
            LightConfig(direction=(1.0, 0.2, 0.3)), SpectrumConfig(),
            MCMSpectralConfig(extinction=20.0, steps=D.STEPS))
    return convert.scene_from(*args)


@pytest.mark.parametrize("case", ["object", "compaction", "device", "rows"])
def test_mesh_options_that_raise(case):
    """Anything but None or a RayMesh is a TypeError; compaction stays a
    single-device mode (ValueError, as in JAX); the mesh's device must be
    the renderer's, and its ranks must split the rows evenly."""
    mesh = RayMesh(group=None, rank=0, size=1, device=torch.device("cpu"), backend="gloo")
    kw = dict(resolution=16, device="cpu")
    if case == "object":
        with pytest.raises(TypeError):
            TM.MCMSpectralRenderer(*_scene(), mesh=object(), **kw)
    elif case == "compaction":
        with pytest.raises(ValueError):
            TM.MCMSpectralRenderer(*_scene(), mesh=mesh, compaction=True, **kw)
    elif case == "device":
        other = RayMesh(group=None, rank=0, size=1, device=torch.device("meta"), backend="gloo")
        with pytest.raises(ValueError):
            TM.MCMSpectralRenderer(*_scene(), mesh=other, **kw)
    else:
        three = RayMesh(group=None, rank=0, size=3, device=torch.device("cpu"), backend="gloo")
        with pytest.raises(ValueError):
            TM.MCMSpectralRenderer(*_scene(), mesh=three, **kw)


@pytest.fixture(scope="module")
def fit_runs(tmp_path_factory):
    """``fit_spectral`` on the mesh renderer at world sizes 1 and 2."""
    return {w: D.run(w, tmp_path_factory.mktemp(f"fit{w}"), [("fit", "fit_mesh", {})])
            for w in (1, 2)}


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("method", ["prb", "autodiff"])
def test_fit_spectral_on_a_mesh_renderer(fit_runs, world, method):
    """Over two ranks ``fit_spectral`` refuses a mesh renderer on every rank
    (NotImplementedError, as ``fit_density(mesh=...)``), where it once
    failed with a shape error; over one rank it fits, its losses finite."""
    for rank in fit_runs[world]:
        got = rank["fit"][method]
        if world > 1:
            assert got.get("raised") == "NotImplementedError" and "mesh" in got["message"]
        else:
            assert "raised" not in got, got
            assert len(got["losses"]) == D.FIT["iterations"] and np.isfinite(got["losses"]).all()
