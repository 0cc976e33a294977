"""The slab-sharded render's forward (``vpt_tpu_torch/parallel/slab.py``,
``kernels/slab.py``) across gloo processes on the CPU, against the port's
replicated render and the JAX package's slab (``vpt_tpu/parallel/slab.py``,
``tests/test_slab.py``, ``tests/test_mesh_streams.py``, ``tests/test_hlo.py``).

The ranks run in spawned processes (``vpt_tpu_torch/tools/mesh_dryrun.py``)
that import neither jax nor ``vpt_tpu``. Each world size renders every
mode two ways from one reset state: the replicated render (K1's plain
version over the whole table) and ``render_slab`` (K27, all-gather, K26,
reduce-scatter, K28 per step, each wrapper's plain version on CPU
tensors). JAX runs on the 8-device virtual CPU mesh of
``tests/conftest.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from vpt_tpu.models import mcm_spectral as JM
from vpt_tpu.ops import interp as JI
from vpt_tpu.parallel import slab as JS
from vpt_tpu.parallel.mesh import ray_mesh as jax_ray_mesh
from vpt_tpu.parallel.mesh import replicated, shard_spectral_state
from vpt_tpu.scene.camera import Camera
from vpt_tpu.scene.volume import Volume
from vpt_tpu.utils.config import LightConfig, MaterialTF, MCMSpectralConfig, SpectrumConfig
from vpt_tpu_torch import convert
from vpt_tpu_torch.kernels import slab as KS
from vpt_tpu_torch.models import mcm_spectral as TM
from vpt_tpu_torch.parallel import slab as TS
from vpt_tpu_torch.parallel.mesh import RayMesh
from vpt_tpu_torch.tools import mesh_dryrun as D

WORLDS = (1, 2, 4)
# (mode of mesh_dryrun.SLAB_MODES, streams)
CASES = (("default", 1), ("default", 2), ("f32", 1), ("quasicubic", 2), ("majorant", 1),
         ("majorant", 2), ("environment", 2))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jobs = [("rows_u8", "rows", dict(f32=False)), ("rows_f32", "rows", dict(f32=True))]
    jobs += [(f"{m}{s}", "slab_render", dict(mode=m, streams=s)) for m, s in CASES]
    return {w: D.run(w, tmp_path_factory.mktemp(f"slab{w}"), jobs) for w in WORLDS}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("f32", [False, True])
def test_pad_packed_for_slabs_matches_jax(n, f32):
    packed = D.packed_table(f32)
    got, want = TS.pad_packed_for_slabs(packed, n), JS.pad_packed_for_slabs(packed, n)
    assert got.dtype == want.dtype and got.shape[0] % n == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("world", WORLDS[1:])
@pytest.mark.parametrize("f32", [False, True])
def test_distributed_rows_equals_a_local_take_and_jax(runs, world, f32):
    """All-gather, K26 (plain), reduce-scatter: every rank's rows equal a
    local take of the padded, dequantized table (a zero row for -1) and
    JAX's _distributed_rows on the same requests, bit for bit, u8 too."""
    packed = JS.pad_packed_for_slabs(D.packed_table(f32), world)
    req = D.request_indices(world)
    flat = packed.reshape(-1, 8)
    take = flat[np.maximum(req, 0)].astype(np.float32)
    if not f32:
        take = (take / np.float32(255.0)).astype(np.float32)
    take[req < 0] = 0.0
    got = runs[world][0][f"rows_{'f32' if f32 else 'u8'}"]
    np.testing.assert_array_equal(_bits(got["rows"]), _bits(take))
    assert got["slab_dims"] == (packed.shape[0] // world,) + packed.shape[1:3]

    mesh = jax_ray_mesh(world)
    _, Hp, Wp, _ = packed.shape
    rows_per_device = (packed.shape[0] // world) * Hp * Wp
    fn = jax.jit(jax.shard_map(
        lambda tab, i: JS._distributed_rows(tab, i, rows_per_device, Hp * Wp * 8),
        mesh=mesh, in_specs=(P(JS.AXIS, None, None, None), P(JS.AXIS)),
        out_specs=P(JS.AXIS, None), check_vma=False))
    want = np.asarray(fn(JS.shard_packed_volume(packed, mesh),
                         jax.device_put(jnp.asarray(req), NamedSharding(mesh, P(JS.AXIS)))))
    np.testing.assert_array_equal(_bits(got["rows"]), _bits(want))


def _assert_states_equal(a, b):
    for k in TM.SpectralState.field_names():
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode,streams", CASES)
def test_slab_render_equals_the_replicated_render(runs, world, mode, streams):
    """render_slab (plain K27/K26/K28 between the collectives) equals the
    replicated render bit for bit: the image, samples and every lane field,
    at world 1, 2 and 4, with streams, the quasicubic filter, the majorant
    grid and the environment map."""
    for rank in range(world):
        got = runs[world][rank][f"{mode}{streams}"]
        np.testing.assert_array_equal(_bits(got["image"]), _bits(got["ref_image"]))
        _assert_states_equal(got["state"], got["ref_state"])
    assert got["ref_state"]["samples"].sum() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_slab_step_makes_its_two_collectives_and_three_launches(runs, world):
    """A render_slab dispatch of STEPS steps: exactly one all-gather and
    one reduce-scatter a step (and the image's row gather once), and one
    call each of K27, K26 and K28 a step (tests/test_hlo.py:81)."""
    steps = D.STEPS
    for mode, streams in CASES:
        got = runs[world][0][f"{mode}{streams}"]
        assert got["counts"] == {"all_gather": steps, "reduce_scatter": steps, "gather_rows": 1,
                                 "halo": 0, "all_reduce": 0}
        assert got["calls"] == {"slab_advance": steps, "slab_rows": steps, "slab_finish": steps}


@pytest.mark.parametrize("streams", [1, 2])
def test_slab_render_meets_the_image_contract_against_jax(runs, streams):
    """The port's world-2 slab render (the f32 table) against JAX's
    render_slab on a 2-device mesh over the same f32 corner table and
    reset: the repo's image contract (tests/test_mcm_spectral_parity.py)."""
    mode = "f32" if streams == 1 else "default"
    volume = Volume.sphere_in_cube(D.VOL)
    renderer = JM.MCMSpectralRenderer(
        volume, MaterialTF.constant(0.8, 0.6, 0.2), LightConfig(direction=(1.0, 0.2, 0.3)),
        SpectrumConfig(), MCMSpectralConfig(extinction=20.0, steps=D.STEPS),
        resolution=D.RES, streams=streams)
    cam = Camera()
    mesh = jax_ray_mesh(2)
    packed = JS.pad_packed_for_slabs(D.packed_table(f32=mode == "f32"), 2)
    ctx = jax.tree.map(lambda x: jax.device_put(x, replicated(mesh)), renderer.ctx(cam, 5))
    ctx = ctx._replace(density=JS.shard_packed_volume(packed, mesh))
    state = shard_spectral_state(renderer.reset(cam, 3), mesh)
    state, img = JS.render_slab(state, ctx, mesh, volume_dims=volume.density.shape,
                                steps=D.STEPS, n_bins=D.BINS)
    got = runs[2][0][f"{mode}{streams}"]
    ref = np.asarray(img)
    diff = np.abs(got["image"] - ref)
    assert np.mean(diff / (np.abs(ref) + 1e-3) < 1e-3) >= 0.995
    assert np.median(diff) < 1e-5
    assert np.mean(got["state"]["samples"] == np.asarray(state.samples)) >= 0.99
    assert got["state"]["samples"].sum() > 0


@pytest.mark.parametrize("pack", ["xy", "raw", "partly packed"])
def test_xy_or_raw_tables_raise(pack):
    """Only the full packed corner table has a slab form, read with the
    fused TF: an xy volume, a raw grid or a raw TF raise ValueError before
    any collective."""
    args = convert.scene_from(Volume.sphere_in_cube(D.VOL), MaterialTF.constant(0.8, 0.6, 0.2),
                              LightConfig(direction=(1.0, 0.2, 0.3)), SpectrumConfig(),
                              MCMSpectralConfig(extinction=20.0, steps=D.STEPS))
    tables = {"xy": {"density_xy", "material_tf", "light_spectrum"}, "raw": False,
              "partly packed": {"density"}}[pack]
    r = TM.MCMSpectralRenderer(*args, resolution=D.RES, pack_tables=tables, device="cpu")
    from vpt_tpu_torch import Camera as TCamera

    cam = TCamera()
    ctx = r.ctx(cam, 5)
    mesh = RayMesh(group=None, rank=0, size=1, device=torch.device("cpu"), backend="gloo")
    if pack == "partly packed":  # a full table beside a raw TF
        ctx = dataclasses.replace(ctx, density=TS.shard_packed_volume(D.packed_table(), mesh))
    with pytest.raises(ValueError):
        TS.render_slab(r.reset(cam, 3), ctx, mesh, r.volume.density.shape, D.STEPS, D.BINS)
    with pytest.raises(ValueError):
        KS.check_layout(ctx)
