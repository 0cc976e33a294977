"""The gather tool's plain versions (K6, K7) against the XLA gathers the TPU
tools time (``tools/gather_bench.py:44-46`` ``xla_gather_scalar``, and
``jnp.take_along_axis`` for the lane-wise gather). The TPU tool modules are
not imported: ``tools/gather_bench.py`` runs a benchmark when imported."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpt_tpu_torch.tools import gather_bench as G

torch.set_num_threads(1)


def test_gather_scalar_plain_matches_xla_take():
    rng = np.random.default_rng(0)
    flat = rng.random(4096, dtype=np.float32)
    idx = rng.integers(0, 4096, 10000, dtype=np.int32)
    want = np.asarray(jnp.take(jnp.asarray(flat), jnp.asarray(idx), axis=0))
    got = G.gather_scalar(torch.as_tensor(flat), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [8, 256, 1024])
def test_gather_lanewise_plain_matches_take_along_axis(n):
    rng = np.random.default_rng(n)
    tab = rng.random((n, 128), dtype=np.float32)
    idx = rng.integers(0, n, (64, 128), dtype=np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(idx), axis=0))
    got = G.gather_lanewise(torch.as_tensor(tab), torch.as_tensor(idx))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cases_cover_the_tpu_tools_and_count_no_cpu_launch():
    G.reset_launch_counts()
    cs = G.cases("cpu", lookups=1024)
    names = [c[0] for c in cs]
    assert names[0] == f"gather_scalar N={128 ** 3}"
    assert [int(n.split("=")[1]) for n in names[1:]] == list(G.LANEWISE_N)
    for _, kern, plain, tab, idx in cs:
        assert torch.equal(kern(tab, idx), plain(tab, idx))
    assert G.LAUNCHES == {"gather_scalar": 0, "gather_lanewise": 0}


ROUTES_ON_H100 = {8: ("whole", 128), 256: ("whole", 128), 1024: ("slab", 32),
                  2048: ("slab", 16), 32768: ("l2", 0), 1000: ("slab", 32), 300: ("whole", 128)}


def test_lanewise_plan_routes_on_h100():
    for n, (route, slab) in ROUTES_ON_H100.items():
        for rows in (G.L // 128, G.L // 128 + 1, 16 * G.L // 128):
            plan = G.lanewise_plan(n, rows=rows)
            assert (plan.route, plan.slab) == (route, slab), (n, rows, plan)


@pytest.mark.parametrize("smem_bytes", [G.H100_SMEM, 100_000, 49_152])
@pytest.mark.parametrize("n", sorted(set(G.LANEWISE_N) | {1000, 300}))
def test_lanewise_plan_fits_and_covers(n, smem_bytes):
    fits = [w for w in G.SLAB_WIDTHS if n * w * 4 + G.BARRIER_BYTES <= smem_bytes]
    for rows in (1, 37, G.L // 128, G.L // 128 + 1, 16 * G.L // 128):
        plan = G.lanewise_plan(n, smem_bytes, rows, 132)
        if not fits:
            assert plan == G.LanewisePlan("l2")
            continue
        assert plan.slab == fits[0] and plan.slab % 16 == 0
        assert plan.route == ("whole" if plan.slab == 128 else "slab")
        assert plan.slabs * plan.slab == 128
        assert n * plan.slab * 4 + G.BARRIER_BYTES == plan.smem <= smem_bytes
        assert plan.staged_bytes == plan.slabs * plan.blocks_per_slab * n * plan.slab * 4
        # every row in exactly one block, no empty block
        assert (plan.blocks_per_slab - 1) * plan.rows_per_block < rows
        assert plan.blocks_per_slab * plan.rows_per_block >= rows
        # one wave, rows split evenly
        per_sm = min((smem_bytes + G.RESERVED_SMEM) // (plan.smem + G.RESERVED_SMEM),
                     G.MAX_THREADS_PER_SM // G.SMEM_THREADS)
        wave = max(1, 132 * per_sm // plan.slabs)
        assert plan.blocks_per_slab <= wave
        assert plan.rows_per_block == -(-rows // wave)


# (n, shared-memory budget) pairs that reach every route at a CPU-small size
TILED_PLANS = [(24, G.H100_SMEM, "whole"), (24, 4000, "slab"), (24, 2000, "slab"),
               (24, 1000, "l2"), (300, G.H100_SMEM, "whole"), (1000, G.H100_SMEM, "slab"),
               (2048, G.H100_SMEM, "slab"), (32768, G.H100_SMEM, "l2")]


@pytest.mark.parametrize("rows", [37, 64])
@pytest.mark.parametrize("n,smem_bytes,route", TILED_PLANS)
def test_lanewise_tiled_matches_gather_and_take_along_axis(n, smem_bytes, route, rows):
    plan = G.lanewise_plan(n, smem_bytes, rows, 2)
    assert plan.route == route
    rng = np.random.default_rng(n + rows)
    tab = rng.random((n, 128), dtype=np.float32)
    idx = rng.integers(0, n, (rows, 128), dtype=np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(tab), jnp.asarray(idx), axis=0))
    tab_t, idx_t = torch.as_tensor(tab), torch.as_tensor(idx)
    got = G.gather_lanewise_tiled(tab_t, idx_t, plan, threads=3 * G.L2_THREADS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, G.gather_lanewise_plain(tab_t, idx_t))
    writes = np.zeros((rows, 128), np.int64)
    if route == "l2":
        for _, a, b in G.l2_spans(rows * 128, 3 * G.L2_THREADS):
            writes.reshape(-1)[a:b] += 1
    else:
        for lanes, rs in G.lanewise_tiles(plan, rows):
            assert lanes.stop - lanes.start == plan.slab
            writes[rs, lanes] += 1
    assert (writes == 1).all()


@pytest.mark.parametrize("tail", range(8))
def test_scalar_partition_covers_each_output_once(tail):
    n = 2 * 256 + 40 + tail  # two full tiles of 256, then a tail with n % 8 == tail
    rng = np.random.default_rng(tail)
    flat = rng.random(64, dtype=np.float32)
    idx = rng.integers(0, 64, n, dtype=np.int32)
    want = np.asarray(jnp.take(jnp.asarray(flat), jnp.asarray(idx), axis=0))
    assert G.l2_threads(n) == G.L2_THREADS
    for threads in (1, 3, 16, 64, G.l2_threads(n)):
        writes = np.zeros(n, np.int64)
        for t, a, b in G.l2_spans(n, threads):
            assert 0 <= t < threads
            assert (b - a == 4 and a % 4 == 0 and b <= 512) or (b - a == 1 and a >= 512)
            writes[a:b] += 1
        assert (writes == 1).all()
        got = G.gather_scalar_tiled(torch.as_tensor(flat), torch.as_tensor(idx), threads)
        np.testing.assert_array_equal(got.numpy(), want)


def test_l2_slot_runs_are_coalesced_per_warp():
    # the 32 slots of a warp tile: run starts at 16-byte steps, two 512-byte spans
    starts = sorted(a for t, a, b in G.l2_spans(256, 32))
    assert starts == list(range(0, 256, 4))
    first = [a for t, a, b in G.l2_spans(256, 32)][::2]
    assert first == list(range(0, 128, 4))


def test_plan_constants_match_the_cuda_source():
    src = (Path(G.__file__).resolve().parents[1] / "csrc" / "gather_bench.cu").read_text()
    for name, value in (("L2_THREADS", G.L2_THREADS), ("LW_THREADS", G.SMEM_THREADS),
                        ("LW_BARRIER", G.BARRIER_BYTES)):
        assert re.search(rf"constexpr \w+ {name} = {value};", src), name
    for w in G.SLAB_WIDTHS:
        assert f"case {w}:" in src


def test_ragged_cases_run_the_plain_versions_on_cpu():
    G.reset_launch_counts()
    names = []
    for name, kern, plain, tab, idx in G.ragged_cases("cpu"):
        assert torch.equal(kern(tab, idx), plain(tab, idx))
        names.append(name)
    assert any(n.startswith("gather_scalar n=") for n in names)
    assert any(n.startswith("gather_lanewise N=1000 M=") for n in names)
    assert G.LAUNCHES == {"gather_scalar": 0, "gather_lanewise": 0}
