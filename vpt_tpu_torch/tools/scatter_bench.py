"""The scatter ceiling: K5's volume-row scatter alone, timed on the card.

Counterpart of the scatter half of ``bench.py::measure_ceilings``
(``:210-276``, ``scatter_run``): the rate at which the H100 adds 8-wide f32
rows into the packed volume adjoint, the access that ends each scattering
lane-step of K5 ``prb_reverse``. Kernel ``scatter_rows`` (K11, in
``csrc/spectral_backward.cu``, beside K5, whose two float4 atomics it
issues): one thread per index, two float4 atomics of ones into the row it
names; a negative index skips. Plain version ``scatter_rows_plain``
(``index_add_`` of ones); since every value is 1 the sums are exact
integers, so kernel and plain version agree bit for bit whatever the order
of the atomics. ``index_add_`` is also the one PyTorch call that computes
the same function (``chip_smoke.py`` times it as the library call).

``bench_rows`` makes the bench's index stream: ``iters`` steps of ``lanes``
uniform random rows of a (volume + 1)^3-row table, from a numpy seed.
"""

from __future__ import annotations

import numpy as np
import torch

from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.kernels import mcm_spectral as K

LAUNCHES = {"scatter_rows": 0}


def reset_launch_counts():
    LAUNCHES["scatter_rows"] = 0


def bench_rows(volume: int, lanes: int = 1 << 20, iters: int = 16, seed: int = 1):
    """(rows of the table, int32 index stream (iters * lanes,)) of bench.py's
    scatter ceiling."""
    rows = (volume + 1) ** 3
    idx = np.random.default_rng(seed).integers(0, rows, iters * lanes, dtype=np.int32)
    return rows, idx


def scatter_rows_plain(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain ``scatter_rows``: adds 1 to every value of each named row of
    the (R, 8) table, in place; returns the table."""
    keep = rows[rows >= 0].to(torch.int64)
    table.index_add_(0, keep, torch.ones((keep.numel(), 8), dtype=table.dtype,
                                         device=table.device))
    return table


def scatter_rows(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Adds 1 to every value of each row of the (R, 8) f32 table named by
    the int32 ``rows`` (negative: skipped), in place; one kernel launch on a
    CUDA device. The indices must lie in [0, R) or below 0."""
    if K._route(rows, table) == "cpu":
        return scatter_rows_plain(rows, table)
    K._check(rows, "rows", torch.int32, (rows.numel(),))
    K._check(table, "table", torch.float32, (table.shape[0], 8), align=16)
    lib = _build.load()
    with torch.cuda.device(table.device):
        err = lib.vpt_scatter_rows(rows.data_ptr(), rows.numel(), table.data_ptr(),
                                   K._stream(table.device))
    K._raise_on(err, "scatter_rows")
    LAUNCHES["scatter_rows"] += 1
    return table
