"""The gather tool's plain versions (K6, K7) against the XLA gathers the TPU
tools time (``tools/gather_bench.py:44-46`` ``xla_gather_scalar``, and
``jnp.take_along_axis`` for the lane-wise gather). The TPU tool modules are
not imported: ``tools/gather_bench.py`` runs a benchmark when imported."""

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
