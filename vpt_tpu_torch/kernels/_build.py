"""Build the CUDA sources of the port with nvcc and load them with ctypes.

``load()`` compiles each ``vpt_tpu_torch/csrc/*.cu`` into its own shared
library with a plain C interface, on first use, into
``vpt_tpu_torch/_build/`` (listed in .gitignore). The nvcc processes of the
sources that need a build run at the same time. Each library is named by a
hash of its source, the shared headers (``*.cuh`` beside it) and the flags,
so an edited source builds anew and an unchanged one loads at once. A build
or load failure raises.

``load(BASELINE_DIR)`` builds and loads ``csrc/baseline/``, the step
kernels as they were before their redesign for Hopper (the same C
interface), which ``chip_smoke.py`` checks and times beside the current
ones from a checkout; the wrappers never load it and the installed
package does not carry it.

Flags: ``sm_90a`` (Hopper), no fast math, and ``-fmad=false`` so that the
lerps ``a + (b - a) * f`` round like the JAX reference instead of
contracting into FMAs.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from types import SimpleNamespace

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BASELINE_DIR = CSRC_DIR / "baseline"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()  # guards _locks
_locks = {}  # one per source directory, so several build at once
_libs = {}
# per source directory: what its build printed (the ptxas register/spill
# report) and how long it took; build_info is the package's own sources'
build_infos = {}
build_info = build_infos.setdefault(CSRC_DIR, {"seconds": None, "log": "", "path": None})

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
_L = ctypes.c_int64
# C functions of each source: name -> (argtypes, restype)
_SIGNATURES = {
    "mcm_spectral": {
        "vpt_layout": ([_I], _I),
        "vpt_mcm_spectral_step": ([_P] * 21 + [_P], _I),
        "vpt_mcm_spectral_reset": ([_P, _P, _U] + [_P] * 15 + [_P], _I),
        "vpt_compact_image": ([_P, _L, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "vpt_sample_volume_packed": ([_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P], _I),
    },
    "spectral_backward": {
        "vpt_bwd_layout": ([_I], _I),
        "vpt_prb_tape_forward": ([_P, _P, _P, _I] + [_P] * 15 + [_P], _I),
        "vpt_prb_reverse": ([_P, _F] + [_P] * 10 + [_P], _I),
    },
    "gather_bench": {
        "vpt_gather_limits": ([_P], _I),
        "vpt_gather_scalar": ([_P, _P, _P, _L, _P], _I),
        "vpt_gather_lanewise": ([_P, _P, _P, _L, _I, _I, _I, _I, _I, _P], _I),
    },
}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources(csrc: Path):
    srcs = {s.stem: s for s in sorted(csrc.glob("*.cu"))}
    want = set(_SIGNATURES) if csrc == CSRC_DIR else set(srcs) & set(_SIGNATURES)
    if set(srcs) != want or not srcs:
        raise RuntimeError(f"CUDA sources under {csrc} are {sorted(srcs)}, "
                           f"the loader expects {sorted(want or _SIGNATURES)}")
    return srcs


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    tag = "" if src.parent == CSRC_DIR else f"{src.parent.name}_"
    return BUILD_DIR / f"libvpt_{tag}{src.stem}_{h.hexdigest()[:16]}.so"


def _compile(jobs, info):
    """Run one nvcc per (source, output) pair, all at once; raise if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    procs = []
    for src, out in jobs:
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, out, tmp, proc in procs:
        text = proc.communicate()[0]
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{src.name} ({proc.returncode})")
        else:
            os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    info["seconds"] = time.perf_counter() - t0
    info["log"] = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{info['log']}")


def load(csrc: Path = CSRC_DIR):
    """Build (if needed) and load the kernel libraries of ``csrc``; returns
    a namespace holding every C function of every source, with its ctypes
    signature."""
    csrc = Path(csrc)
    with _lock:
        lock = _locks.setdefault(csrc, threading.Lock())
    with lock:
        if csrc in _libs:
            return _libs[csrc]
        info = build_infos.setdefault(csrc, {"seconds": None, "log": "", "path": None})
        srcs = _sources(csrc)
        paths = {stem: library_path(src) for stem, src in srcs.items()}
        missing = [(srcs[stem], p) for stem, p in paths.items() if not p.exists()]
        if missing:
            _compile(missing, info)
        else:
            info["seconds"] = 0.0
        fns = {}
        for stem, path in paths.items():
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in _SIGNATURES[stem].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
                fns[name] = fn
        info["path"] = {stem: str(p) for stem, p in paths.items()}
        _libs[csrc] = SimpleNamespace(**fns)
        return _libs[csrc]


@contextlib.contextmanager
def routed(lib):
    """Route every wrapper's ``load()`` to ``lib`` (the parent design's
    build, ``load(BASELINE_DIR)``) while inside; ``chip_smoke.py`` checks
    and times it so."""
    global load
    current = load
    load = lambda *a, **kw: lib  # noqa: E731
    try:
        yield
    finally:
        load = current


def ptxas_table(log_text):
    """[(kernel, template args, registers, spill store B, spill load B)] of
    the step kernels (K1 step_kernel, K4 tape_forward_kernel) in a ptxas -v
    log; template args as NB,MAJ,ENV (K1) or NB (K4)."""
    rows, cur = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '\S*?(step_kernel|tape_forward_kernel)I(\S*?)EEEv", line)
        if m:
            args = ",".join(a or b for a, b in re.findall(r"Li(\d+)E|Lb(\d)", m.group(2) + "E"))
            cur = [m.group(1), args, None, None, None]
            continue
        if cur is None:
            continue
        s = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if s:
            cur[3], cur[4] = int(s.group(1)), int(s.group(2))
        r = re.search(r"Used (\d+) registers", line)
        if r:
            cur[2] = int(r.group(1))
            rows.append(tuple(cur))
            cur = None
    return rows
