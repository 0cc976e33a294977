"""Gather microbenchmark on the GPU: what the TPU gather kernels of
``tools/gather_bench*.py`` computed, as two CUDA kernels
(``vpt_tpu_torch/csrc/gather_bench.cu``, whose head note gives the design)
beside their plain versions.

- K6 ``gather_scalar``: ``out[i] = flat[idx[i]]`` (``tools/gather_bench.py:54``
  ``pallas_gather_scalar``) from the 2M-entry (8 MB) table of
  ``gather_bench.py:102-104``; it reads the table through L2. Plain
  version: ``torch.take``.
- K7 ``gather_lanewise``: ``out[m, l] = tab[idx[m, l], l]`` for a (N, 128)
  table (``gather_bench.py:75`` ``pallas_gather_lanewise``,
  ``gather_bench2.py:76`` ``mk_lanewise``, ``gather_bench3.py:38``
  ``mk_dg``), at N in {8, 256, 1024, 2048, 32768}. ``lanewise_plan`` says
  how: the whole table or a slab of lanes staged in shared memory, or, when
  no slab of 16 lanes fits, K6's L2 design. Plain version:
  ``torch.gather(tab, 0, idx)``.

Both are timed at L = 4 * 512^2 lookups (the TPU tools' count) and at 16 L,
two ways: ``host_ms`` (CUDA events around back-to-back Python calls: the
whole host path, wrapper and launch included) and ``graph_ms`` (the calls
captured into a CUDA graph and replayed: device time alone).

Run ``python -m vpt_tpu_torch.tools.gather_bench`` on a machine with a GPU:
it checks each kernel against its plain version, bit for bit, and prints
one JSON line per case. The wrappers run the plain versions on CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import sys

import numpy as np
import torch

from vpt_tpu_torch.kernels import _build
from vpt_tpu_torch.kernels.mcm_spectral import _check, _raise_on, _route, _stream

L = 4 * 512 * 512  # lanes per dispatch step of the bench workload
SCALAR_TABLE = 128 ** 3
LANEWISE_N = (8, 256, 1024, 2048, 32768)
SIZES = (L, 16 * L)  # the TPU tools' lookup count, and one where the streams outweigh a launch

# The launch geometry of csrc/gather_bench.cu, and the H100's limits (the
# wrappers read the card's own with device_limits()).
L2_THREADS = 256  # threads per block of the L2 design
SMEM_THREADS = 512  # threads per block of the shared-memory design
SLAB_WIDTHS = (128, 32, 16)  # lanes per slab, widest first
BARRIER_BYTES = 16  # after the slab: the staging mbarrier
RESERVED_SMEM = 1024  # shared memory the runtime reserves per block
MAX_THREADS_PER_SM = 2048
H100_SMS, H100_SMEM = 132, 232448  # SMs; opt-in shared memory per block

LAUNCHES = {"gather_scalar": 0, "gather_lanewise": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class LanewisePlan:
    """How K7 runs. ``route`` "whole" or "slab": block (x, y) stages lanes
    [y * slab, (y + 1) * slab) of every table row into ``smem`` bytes of
    shared memory and gathers rows [x * rows_per_block, ...) of them; the
    grid is (blocks_per_slab, slabs). ``route`` "l2": K6's design with the
    lane offset, nothing staged."""

    route: str
    slab: int = 0
    slabs: int = 0
    blocks_per_slab: int = 0
    rows_per_block: int = 0
    smem: int = 0
    staged_bytes: int = 0  # all blocks together


@functools.lru_cache(maxsize=None)
def lanewise_plan(n: int, smem_bytes: int = H100_SMEM, rows: int = L // 128,
                  sms: int = H100_SMS) -> LanewisePlan:
    """K7's plan for an (n, 128) table and ``rows`` rows of indices, on a
    card with ``sms`` SMs and ``smem_bytes`` of shared memory per block.

    The slab is the widest of 128 (the whole table), 32 and 16 lanes whose
    n rows fit in ``smem_bytes``; if none fits, the L2 route. The grid is
    one wave, as many blocks as fit on the card at once (by shared memory
    and by threads), and the rows are split evenly among a slab's blocks.
    """
    for w in SLAB_WIDTHS:
        smem = n * w * 4 + BARRIER_BYTES
        if smem <= smem_bytes:
            break
    else:
        return LanewisePlan("l2")
    slabs = 128 // w
    per_sm = min((smem_bytes + RESERVED_SMEM) // (smem + RESERVED_SMEM),
                 MAX_THREADS_PER_SM // SMEM_THREADS)
    wave = max(1, sms * per_sm // slabs)  # blocks per slab that fit at once
    per_block = max(1, -(-rows // wave))
    blocks = max(1, -(-rows // per_block))
    return LanewisePlan("whole" if w == 128 else "slab", w, slabs, blocks, per_block, smem,
                        slabs * blocks * n * w * 4)


def lanewise_tiles(plan: LanewisePlan, rows: int):
    """(lanes, rows) slices of the output that each block of a "whole" or
    "slab" plan writes, one per block."""
    for y in range(plan.slabs):
        lanes = slice(y * plan.slab, (y + 1) * plan.slab)
        for x in range(plan.blocks_per_slab):
            yield lanes, slice(x * plan.rows_per_block, min(rows, (x + 1) * plan.rows_per_block))


def l2_spans(n: int, threads: int):
    """(thread, start, stop) of every span of outputs the L2 design writes
    with ``threads`` threads in its grid. Outputs go in tiles of 256; slot v
    (tile v // 32, lane v % 32), taken by grid stride, owns the runs of 4 at
    4 * (64 * (v // 32) + v % 32) and 128 outputs later; the n % 256 outputs
    of a last, partial tile go one per thread and step."""
    full = n // 256 * 256
    for t in range(threads):
        for v in range(t, full // 8, threads):
            a = 4 * (64 * (v // 32) + v % 32)
            yield t, a, a + 4
            yield t, a + 128, a + 132
        for i in range(full + t, n, threads):
            yield t, i, i + 1


def l2_threads(n: int) -> int:
    """Threads in the L2 design's grid for n outputs: one per slot, at
    least one block."""
    return max(1, -(-(n // 256 * 32) // L2_THREADS)) * L2_THREADS


def gather_scalar_plain(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K6."""
    return torch.take(flat, idx.to(torch.int64))


def gather_lanewise_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K7."""
    return torch.gather(tab, 0, idx.to(torch.int64))


def _l2_tiled(flat: torch.Tensor, offsets: torch.Tensor, threads: int) -> torch.Tensor:
    out = torch.full(offsets.shape, float("nan"), dtype=flat.dtype, device=flat.device)
    for _, a, b in l2_spans(offsets.numel(), threads):
        out[a:b] = flat[offsets[a:b]]
    return out


def gather_scalar_tiled(flat: torch.Tensor, idx: torch.Tensor,
                        threads: int | None = None) -> torch.Tensor:
    """Plain K6 run span by span as its kernel cuts the outputs
    (``threads``: its grid, by default the kernel's)."""
    off = idx.reshape(-1).to(torch.int64)
    return _l2_tiled(flat, off, threads or l2_threads(off.numel())).reshape(idx.shape)


def gather_lanewise_tiled(tab: torch.Tensor, idx: torch.Tensor, plan: LanewisePlan,
                          threads: int | None = None) -> torch.Tensor:
    """Plain K7 run block by block as ``plan`` cuts it: each block gathers
    only from the slab it staged (``threads``: the L2 route's grid, by
    default the kernel's)."""
    if plan.route == "l2":
        lane = torch.arange(128, device=idx.device)
        offsets = (idx.to(torch.int64) * 128 + lane).reshape(-1)
        return _l2_tiled(tab.reshape(-1), offsets,
                         threads or l2_threads(offsets.numel())).reshape(idx.shape)
    out = torch.full(idx.shape, float("nan"), dtype=tab.dtype, device=tab.device)
    for lanes, rows in lanewise_tiles(plan, idx.shape[0]):
        staged = tab[:, lanes].clone()
        out[rows, lanes] = torch.gather(staged, 0, idx[rows, lanes].to(torch.int64))
    return out


_LIMITS: dict = {}


def device_limits() -> dict:
    """SM count and opt-in shared memory per block of the current CUDA
    device, read from the card once (the first call also raises the
    kernels' shared-memory limit; make it before any graph capture)."""
    dev = torch.cuda.current_device()
    if dev not in _LIMITS:
        buf = (ctypes.c_int * 2)()
        _raise_on(_build.load().vpt_gather_limits(ctypes.addressof(buf)), "gather_limits")
        _LIMITS[dev] = dict(sms=buf[0], smem_bytes=buf[1])
    return _LIMITS[dev]


def card_plan(n: int, rows: int) -> LanewisePlan:
    """``lanewise_plan`` with the current card's limits."""
    lim = device_limits()
    return lanewise_plan(n, lim["smem_bytes"], rows, lim["sms"])


def gather_scalar(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``flat[idx]`` for a 1-D f32 table and int32 indices (in range);
    ``idx`` must be 16-byte aligned on a CUDA device."""
    if _route(flat, idx) == "cpu":
        return gather_scalar_plain(flat, idx)
    _check(flat, "flat", torch.float32, (flat.numel(),))
    _check(idx, "idx", torch.int32, align=16)
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
    (M, 128) int32 indices (in range), both 16-byte aligned on a CUDA
    device, run as ``card_plan(N, M)`` says."""
    if _route(tab, idx) == "cpu":
        return gather_lanewise_plain(tab, idx)
    if tab.ndim != 2 or tab.shape[1] != 128:
        raise ValueError(f"tab must be (N, 128), got {tuple(tab.shape)}")
    _check(tab, "tab", torch.float32, align=16)
    _check(idx, "idx", torch.int32, (idx.shape[0], 128), align=16)
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    lib = _build.load()
    with torch.cuda.device(idx.device):
        plan = card_plan(tab.shape[0], idx.shape[0])
        err = lib.vpt_gather_lanewise(tab.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
                                      tab.shape[0], plan.slab, plan.blocks_per_slab,
                                      plan.rows_per_block, plan.smem, _stream(idx.device))
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


def ragged_cases(device, seed: int = 1):
    """Like ``cases`` at shapes the kernels must cut unevenly: K6 with
    n % 8 != 0 (a tail, or only a tail), K7 with one row more than L / 128
    and a table of every route, 1000 and 300 rows among them."""
    rng = np.random.default_rng(seed)
    out = []
    flat = torch.as_tensor(rng.random(SCALAR_TABLE, dtype=np.float32), device=device)
    for n in (5, L + 3, L + 7):
        idx = torch.as_tensor(rng.integers(0, SCALAR_TABLE, n, dtype=np.int32), device=device)
        out.append((f"gather_scalar n={n}", gather_scalar, gather_scalar_plain, flat, idx))
    rows = L // 128 + 1
    for n in (8, 300, 1000, 2048, 32768):
        tab = torch.as_tensor(rng.random((n, 128), dtype=np.float32), device=device)
        idx2 = torch.as_tensor(rng.integers(0, n, (rows, 128), dtype=np.int32), device=device)
        out.append((f"gather_lanewise N={n} M={rows}", gather_lanewise, gather_lanewise_plain,
                    tab, idx2))
    return out


def plan_of(kern, tab, idx) -> dict:
    if kern is gather_scalar:
        return dict(route="l2")
    return dataclasses.asdict(card_plan(tab.shape[0], idx.shape[0]))


def check_exact(name, kern, plain, tab, idx):
    got, want = kern(tab, idx), plain(tab, idx)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain on {(got != want).sum().item()} "
                             f"of {idx.numel()} lookups")


REPS, REPLAYS = 20, 5  # calls per timing; graph replays per timing


def host_ms(fn) -> float:
    """CUDA events around ``REPS`` back-to-back Python calls of ``fn``: the
    time per call of the whole host path (wrapper, checks, allocation,
    launch). When the host needs longer per call than the device, this is
    the host's launch rate, not the kernel's time."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def graph_ms(fn) -> float:
    """Device time per call: ``REPS`` calls of ``fn`` captured into one CUDA
    graph, replayed ``REPLAYS`` times between two CUDA events. The host
    path runs once, at capture; a replay launches only the device work.
    Warm-up runs on a side stream, as ``torch.cuda.graph`` requires; the
    kernels must be built and their limits set (``device_limits()``)
    before the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPLAYS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (REPLAYS * REPS)
    del graph
    return ms


def check_ragged(device) -> list:
    """Each kernel equal to its plain version on ``ragged_cases``, and a
    misaligned index view refused; returns the names checked."""
    names, ragged = [], ragged_cases(device)
    for name, kern, plain, tab, idx in ragged:
        check_exact(name, kern, plain, tab, idx)
        names.append(name)
    flat, idx = ragged[0][3:]
    tab = torch.zeros((8, 128), device=device)
    rows = torch.zeros(4 * 128 + 1, dtype=torch.int32, device=device)[1:].view(4, 128)
    for what, call in (("gather_scalar", lambda: gather_scalar(flat, idx[1:])),
                       ("gather_lanewise", lambda: gather_lanewise(tab, rows))):
        try:
            call()
        except ValueError:
            names.append(f"{what} refuses a misaligned index view")
        else:
            raise AssertionError(f"{what} took a misaligned index view")
    return names


def run(device) -> list:
    """Check every case against its plain version (bit-exact) at each
    lookup count in ``SIZES``, and time kernel and plain both ways: host
    path (``host_ms``) and device time (``graph_ms``). Raises on a
    mismatch."""
    with torch.cuda.device(device):
        device_limits()  # builds the kernels and sets their limits before any capture
    results = []
    for lookups in SIZES:
        for name, kern, plain, tab, idx in cases(device, lookups=lookups):
            check_exact(name, kern, plain, tab, idx)
            n = idx.numel()
            row = dict(name=name, lookups=n, plan=plan_of(kern, tab, idx),
                       host_ms=host_ms(lambda: kern(tab, idx)),
                       plain_host_ms=host_ms(lambda: plain(tab, idx)),
                       ms=graph_ms(lambda: kern(tab, idx)),
                       plain_ms=graph_ms(lambda: plain(tab, idx)))
            row.update(glookups_per_s=n / row["ms"] / 1e6,
                       plain_glookups_per_s=n / row["plain_ms"] / 1e6)
            results.append(row)
    return results


def main():
    if not torch.cuda.is_available():
        print("gather_bench: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda:0")
    print(json.dumps(dict(device=torch.cuda.get_device_name(dev))))
    for name in check_ragged(dev):
        print(json.dumps(dict(exact=name)))
    for r in run(dev):
        print(json.dumps(r))


if __name__ == "__main__":
    main()
