"""Build the CUDA sources of the port with nvcc and load them with ctypes.

``load()`` compiles each ``vpt_tpu_torch/csrc/*.cu`` into its own shared
library with a plain C interface, on first use, into
``vpt_tpu_torch/_build/`` (listed in .gitignore). The nvcc processes of the
sources that need a build run at the same time. Each library is named by a
hash of its source, the shared headers (``*.cuh`` beside it) and the flags,
so an edited source builds anew and an unchanged one loads at once; the
build's output (the ptxas report) is kept beside each library, so
``build_info["log"]`` holds it for a library loaded from an earlier build
too. A build or load failure raises.

Flags: ``sm_90a`` (Hopper), no fast math, and ``-fmad=false`` so that the
lerps ``a + (b - a) * f`` round like the JAX reference instead of
contracting into FMAs.
"""

from __future__ import annotations

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
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
# what the builds of the loaded libraries printed (the ptxas register/spill
# report) and how long this process's build took
build_info = {"seconds": None, "log": "", "path": None}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint32
_L = ctypes.c_int64
# C functions of each source: name -> (argtypes, restype)
_SIGNATURES = {
    "mcm_spectral": {
        "vpt_layout": ([_I], _I),
        "vpt_mcm_spectral_step": ([_P] * 22 + [_P], _I),
        "vpt_mcm_spectral_reset": ([_P, _P, _U] + [_P] * 15 + [_P], _I),
        "vpt_compact_image": ([_P, _L, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "vpt_sample_volume_packed": ([_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P], _I),
        "vpt_sample_volume_raw": ([_P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P], _I),
    },
    "spectral_backward": {
        "vpt_bwd_layout": ([_I], _I),
        "vpt_prb_tape_forward": ([_P, _P, _P, _I] + [_P] * 16 + [_P], _I),
        "vpt_prb_reverse": ([_P, _F] + [_P] * 14 + [_L, _P], _I),
        "vpt_scatter_rows": ([_P, _L, _P, _P], _I),
        "vpt_surrogate_tape_forward": ([_P, _P, _P, _I] + [_P] * 18 + [_P], _I),
    },
    "surrogate": {
        "vpt_sur_layout": ([_I], _I),
        "vpt_surrogate_reverse": ([_P, _P, _P, _I] + [_P] * 19 + [_P], _I),
    },
    "raw_backward": {
        "vpt_raw_layout": ([_I], _I),
        "vpt_raw_tape": ([_P, _P, _U] + [_P] * 14 + [_P], _I),
        "vpt_raw_replay": ([_P, _P, _U, _F] + [_P] * 19 + [_P], _I),
    },
    "corners": {
        "vpt_contract_volume": ([_P, _P, _I, _I, _I, _P], _I),
        "vpt_contract_tf": ([_P, _P, _P, _I, _I, _P], _I),
        "vpt_pack_volume": ([_P, _P, _I, _I, _I, _P], _I),
        "vpt_pack_tf": ([_P, _P, _P, _P, _I, _I, _P], _I),
        "vpt_contract_volume_xy": ([_P, _P, _I, _I, _I, _P], _I),
        "vpt_contract_env": ([_P, _P, _I, _I, _P], _I),
        "vpt_pack_volume_xy": ([_P, _P, _I, _I, _I, _P], _I),
        "vpt_pack_env": ([_P, _P, _I, _I, _P], _I),
    },
    "raymarch": {
        "vpt_march_layout": ([_I], _I),
        "vpt_march": ([_P, _P, _I] + [_P] * 6, _I),
        "vpt_mip": ([_P] * 6, _I),
        "vpt_iso": ([_P] * 9, _I),
        "vpt_iso_shade": ([_P] * 10, _I),
        "vpt_eam_backward": ([_P] * 8, _I),
    },
    "mcm": {
        "vpt_mcm_layout": ([_I], _I),
        "vpt_mcm_step": ([_P] * 22 + [_P], _I),
        "vpt_mcm_reset": ([_P, _P, _U] + [_P] * 16 + [_P], _I),
    },
    "mcs": {
        "vpt_mcs_layout": ([_I], _I),
        "vpt_mcs_frames": ([_P] * 10, _I),
        "vpt_mcs_persistent": ([_P] * 24, _I),
    },
    "dos": {
        "vpt_dos_layout": ([_I], _I),
        "vpt_dos_sweep": ([_P, _P, _I] + [_P] * 9, _I),
    },
    "lao": {
        "vpt_lao_layout": ([_I], _I),
        "vpt_lao_frame": ([_P, _P, _I, _I] + [_P] * 5, _I),
    },
    "slab": {
        "vpt_slab_layout": ([_I], _I),
        "vpt_slab_rows": ([_P, _I, _L, _L, _P, _P, _L, _P], _I),
        "vpt_slab_advance": ([_P] * 10 + [_U, _I] + [_P] * 6 + [_I, _P], _I),
        "vpt_slab_finish": ([_P] * 24 + [_I, _P, _P], _I),
        "vpt_slab_scatter": ([_P, _L, _I, _L, _L, _P, _P], _I),
        "vpt_slab_contract": ([_P, _I, _I, _I, _I, _I, _P, _P], _I),
        "vpt_slab_pack": ([_P, _I, _I, _I, _I, _I, _P, _P], _I),
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


def _sources():
    srcs = {s.stem: s for s in sorted(CSRC_DIR.glob("*.cu"))}
    if set(srcs) != set(_SIGNATURES):
        raise RuntimeError(f"CUDA sources under {CSRC_DIR} are {sorted(srcs)}, "
                           f"the loader expects {sorted(_SIGNATURES)}")
    return srcs


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [src, *sorted(src.parent.glob("*.cuh"))]:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libvpt_{src.stem}_{h.hexdigest()[:16]}.so"


def _compile(jobs):
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
            out.with_suffix(".log").write_text(text)
            os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    build_info["seconds"] = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n" + "\n".join(logs))


def load():
    """Build (if needed) and load the kernel libraries of ``csrc/``; returns
    a namespace holding every C function of every source, with its ctypes
    signature."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = _sources()
        paths = {stem: library_path(src) for stem, src in srcs.items()}
        missing = [(srcs[stem], p) for stem, p in paths.items() if not p.exists()]
        if missing:
            _compile(missing)
        else:
            build_info["seconds"] = 0.0
        build_info["log"] = "\n".join(
            f"== {srcs[stem].name}\n{p.with_suffix('.log').read_text()}"
            for stem, p in paths.items() if p.with_suffix(".log").exists())
        fns = {}
        for stem, path in paths.items():
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in _SIGNATURES[stem].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
                fns[name] = fn
        build_info["path"] = {stem: str(p) for stem, p in paths.items()}
        _lib = SimpleNamespace(**fns)
        return _lib


# the kernels whose registers and spills the ptxas report is read for
KERNELS = ("step_kernel", "tape_forward_kernel", "reverse_kernel", "contract_volume_kernel",
           "contract_volume_xy_kernel", "contract_env_kernel", "contract_tf_kernel",
           "pack_volume_kernel", "pack_volume_xy_kernel", "pack_env_kernel", "pack_tf_kernel",
           "scatter_rows_kernel", "surrogate_tape_kernel", "surrogate_reverse_kernel",
           "raw_tape_kernel", "raw_replay_kernel", "march_kernel", "mip_kernel", "iso_kernel",
           "iso_shade_kernel", "eam_backward_kernel", "mcm_step_kernel", "mcm_reset_kernel",
           "mcs_frames_kernel", "mcs_persistent_kernel", "dos_slice_kernel", "dos_display_kernel",
           "lao_frame_kernel", "slab_rows_kernel", "slab_advance_kernel", "slab_finish_kernel",
           "slab_scatter_kernel", "slab_contract_kernel", "slab_pack_kernel")
_ENTRY = re.compile(r"Compiling entry function '\S*?\d(" + "|".join(KERNELS) + r")(I\S*?EE)?[Ev]")


def ptxas_table(log_text):
    """[(kernel, template args, registers, spill store B, spill load B,
    stack frame B)] of the kernels named in ``KERNELS`` in a ptxas -v log
    (the stack frame is the thread's local memory: spills and arrays
    indexed at run time); template args as
    NB,MAJ,ENV,XY,RAW (K1 step_kernel, K4's surrogate mode
    surrogate_tape_kernel and K12 surrogate_reverse_kernel), NB,ENV,XY (K4
    tape_forward_kernel), NB (K13 raw_tape_kernel, K14 raw_replay_kernel), NS
    (K5 reverse_kernel: 0 for stride mode, else the importance step
    count), KIND,MODE (K15 march_kernel: 0 EAM, 1 Depth, then the table
    mode 0-7 of csrc/raymarch.cu MarchMode), MODE (K16 mip_kernel: the same
    table mode), LEARN_TF (K19
    eam_backward_kernel: 0 or 1), LAO,SHADOWS,MODE (K25 lao_frame_kernel:
    0 or 1 each, then the table mode 0-4 of csrc/lao.cu LaoMode), MAJ (K27
    slab_advance_kernel), NB,MAJ,ENV,TAPE (K28
    slab_finish_kernel), MODE (K20 mcm_step_kernel: the table mode 0-7 of
    csrc/mcm.cu McmMode), "" for the untemplated ones (K21 mcm_reset_kernel,
    K24 dos_slice_kernel, K26 slab_rows_kernel, K29 slab_scatter_kernel, K30
    slab_contract_kernel and K31 slab_pack_kernel among them); MODE,MAJ for
    K22 mcs_frames_kernel and K23 mcs_persistent_kernel (the table mode 0-5
    of csrc/mcs.cu McsMode, the majorant 0 or 1)."""
    rows, cur = [], None
    for line in log_text.splitlines():
        m = _ENTRY.search(line)
        if m:
            args = ",".join(a or b for a, b in re.findall(r"Li(\d+)E|Lb(\d)", m.group(2) or ""))
            cur = [m.group(1), args, None, 0, 0, 0]
            continue
        if cur is None:
            continue
        s = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if s:
            cur[5], cur[3], cur[4] = (int(g) for g in s.groups())
        r = re.search(r"Used (\d+) registers", line)
        if r:
            cur[2] = int(r.group(1))
            rows.append(tuple(cur))
            cur = None
    return rows
