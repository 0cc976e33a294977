"""Build the CUDA sources of the port with nvcc and load them with ctypes.

``load()`` compiles every ``vpt_tpu_torch/csrc/*.cu`` into one shared
library with a plain C interface, on first use, into
``vpt_tpu_torch/_build/`` (listed in .gitignore). The library is named by a
hash of the sources and the flags, so an edited source builds anew and an
unchanged one loads at once. A build or load failure raises.

Flags: ``sm_90a`` (Hopper), no fast math, and ``-fmad=false`` so that the
lerps ``a + (b - a) * f`` round like the JAX reference instead of
contracting into FMAs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
# what the last build printed (ptxas register/spill report) and how long it took
build_info = {"seconds": None, "log": "", "path": None}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "vpt_layout": ([_I], _I),
    "vpt_mcm_spectral_step": ([_P] * 16 + [_P], _I),
    "vpt_mcm_spectral_reset": ([_P, _P, ctypes.c_uint32] + [_P] * 12 + [_P], _I),
    "vpt_sample_volume_packed": ([_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P], _I),
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


def _sources():
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in _sources():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libvpt_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_info['log']}")
    os.replace(tmp, out)  # atomic: concurrent builders never load a partial file


def load():
    """Build (if needed) and load the kernel library; returns the ctypes handle."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _compile(path)
        else:
            build_info["seconds"] = 0.0
        lib = ctypes.CDLL(str(path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        build_info["path"] = str(path)
        _lib = lib
        return lib
