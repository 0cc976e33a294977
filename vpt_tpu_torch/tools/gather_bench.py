"""Gather microbenchmark on the GPU: what the TPU gather kernels of
``tools/gather_bench*.py`` computed, as two CUDA kernels
(``vpt_tpu_torch/csrc/gather_bench.cu``) beside their plain versions.

- K6 ``gather_scalar``: ``out[i] = flat[idx[i]]`` (``tools/gather_bench.py:54``
  ``pallas_gather_scalar``), at L = 4 * 512^2 lookups from the 2M-entry
  table of ``gather_bench.py:102-104``. Plain version: ``torch.take``.
- K7 ``gather_lanewise``: ``out[m, l] = tab[idx[m, l], l]`` for a (N, 128)
  table (``gather_bench.py:75`` ``pallas_gather_lanewise``,
  ``gather_bench2.py:76`` ``mk_lanewise``, ``gather_bench3.py:38``
  ``mk_dg``), at N in {8, 256, 1024, 2048, 32768}. Plain version:
  ``torch.gather(tab, 0, idx)``.

Run ``python -m vpt_tpu_torch.tools.gather_bench`` on a machine with a GPU:
it checks each kernel against its plain version and prints lookups/s for
both. The wrappers run the plain versions on CPU tensors.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.kernels.mcm_spectral import _check, _raise_on, _route, _stream

L = 4 * 512 * 512  # lanes per dispatch step of the bench workload
SCALAR_TABLE = 128 ** 3
LANEWISE_N = (8, 256, 1024, 2048, 32768)

LAUNCHES = {"gather_scalar": 0, "gather_lanewise": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def gather_scalar_plain(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K6."""
    return torch.take(flat, idx.to(torch.int64))


def gather_lanewise_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K7."""
    return torch.gather(tab, 0, idx.to(torch.int64))


def gather_scalar(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``flat[idx]`` for a 1-D f32 table and int32 indices (in range)."""
    if _route(flat, idx) == "cpu":
        return gather_scalar_plain(flat, idx)
    _check(flat, "flat", torch.float32, (flat.numel(),))
    _check(idx, "idx", torch.int32)
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    lib = _build.load()
    with torch.cuda.device(idx.device):
        err = lib.vpt_gather_scalar(flat.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
                                    _stream(idx.device))
    _raise_on(err, "gather_scalar")
    LAUNCHES["gather_scalar"] += 1
    return out


def gather_lanewise(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[m, l] = tab[idx[m, l], l]`` for a (N, 128) f32 table and
    (M, 128) int32 indices (in range)."""
    if _route(tab, idx) == "cpu":
        return gather_lanewise_plain(tab, idx)
    if tab.ndim != 2 or tab.shape[1] != 128:
        raise ValueError(f"tab must be (N, 128), got {tuple(tab.shape)}")
    _check(tab, "tab", torch.float32)
    _check(idx, "idx", torch.int32, (idx.shape[0], 128))
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    lib = _build.load()
    with torch.cuda.device(idx.device):
        err = lib.vpt_gather_lanewise(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.numel(),
                                      _stream(idx.device))
    _raise_on(err, "gather_lanewise")
    LAUNCHES["gather_lanewise"] += 1
    return out


def cases(device, seed: int = 0, lookups: int = L):
    """(name, kernel fn, plain fn, table, idx) for every size the TPU
    tools measured; inputs made from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    out = []
    flat = torch.as_tensor(rng.random(SCALAR_TABLE, dtype=np.float32), device=device)
    idx = torch.as_tensor(rng.integers(0, SCALAR_TABLE, lookups, dtype=np.int32), device=device)
    out.append((f"gather_scalar N={SCALAR_TABLE}", gather_scalar, gather_scalar_plain, flat, idx))
    for n in LANEWISE_N:
        tab = torch.as_tensor(rng.random((n, 128), dtype=np.float32), device=device)
        idx2 = torch.as_tensor(rng.integers(0, n, (lookups // 128, 128), dtype=np.int32),
                               device=device)
        out.append((f"gather_lanewise N={n}", gather_lanewise, gather_lanewise_plain, tab, idx2))
    return out


def _cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(device, reps: int = 20) -> list:
    """Check every case against its plain version (bit-exact) and time
    both with CUDA events. Raises on a mismatch."""
    results = []
    for name, kern, plain, tab, idx in cases(device):
        got, want = kern(tab, idx), plain(tab, idx)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain on {(got != want).sum().item()} lookups")
        ms = _cuda_ms(lambda: kern(tab, idx), reps)
        plain_ms = _cuda_ms(lambda: plain(tab, idx), reps)
        n = idx.numel()
        results.append(dict(name=name, lookups=n, ms=ms, plain_ms=plain_ms,
                            glookups_per_s=n / ms / 1e6, plain_glookups_per_s=n / plain_ms / 1e6))
    return results


def main():
    if not torch.cuda.is_available():
        print("gather_bench: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    for r in run(torch.device("cuda:0")):
        print(json.dumps(r))


if __name__ == "__main__":
    main()
