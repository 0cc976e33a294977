"""The measurement behind K19's TF-row sums (``vpt_tpu_torch/csrc/raymarch.cu``,
``eam_backward_kernel<LEARN_TF = 1>``), kept as the record of why a block
sums the TF gradient's row in double; no product path runs it.

Every sample of the classic TF reads row 0, and texel 0's alpha takes the
terms of every sample in empty space: at 512^2 a texel sums ~1e6 terms,
which a signed cotangent cancels by orders of magnitude. On chip_smoke.py's
phase-20 scene (the CLI's invert scene: 512^2, 32 slices, extinction 40,
the ramp-alpha TF; the f32 ``sphere_in_cube`` grid at 64^3 and 128^3) this
times and checks two builds of K19:

- "double": the source as it is (the block's row in shared memory in
  double, flushed by double atomics);
- "float": the block's row in float (flushed into the same double row);

each against the plain version with the TF in float64 (the reference),
under a signed cotangent (uniform in [-1, 1]) and its absolute value, in
the linear and nearest filters. Per case it prints one JSON line: the
largest |K19 - reference| over max |reference| for each build, a second
run's distance from the first, the float32 plain version's distance from
the reference, and each build's device time (CUDA-graph replay).

    python -m probes.eam_tf_sums      (from the repo's root; needs a CUDA device)
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

# the shipped double row, and the float row that it replaced
FLOAT_ROW = {
    "extern __shared__ double s_tf[];": "extern __shared__ float s_tf[];",
    "float* __restrict__ g_vol, double* s_tf,": "float* __restrict__ g_vol, float* s_tf,",
    "atomicAdd(s_tf + q.x0 * 4 + ch, (double)(gx[ch] - hi));":
        "atomicAdd(s_tf + q.x0 * 4 + ch, gx[ch] - hi);",
    "atomicAdd(s_tf + q.x1 * 4 + ch, (double)hi);": "atomicAdd(s_tf + q.x1 * 4 + ch, hi);",
    "* 4 * sizeof(double);": "* 4 * sizeof(float);",
}


def build_variant(edits: dict, out_dir: Path):
    """The ray-march library with ``edits`` applied to its source: a
    namespace of its C functions."""
    from vpt_tpu_torch.kernels import _build

    src = out_dir / "csrc"
    shutil.copytree(_build.CSRC_DIR, src)
    path = src / "raymarch.cu"
    text = path.read_text()
    for old, new in edits.items():
        if old not in text:
            raise RuntimeError(f"raymarch.cu no longer holds {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    lib = out_dir / "libraymarch.so"
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    cdll = ctypes.CDLL(str(lib))
    fns = {}
    for name, (argtypes, restype) in _build._SIGNATURES["raymarch"].items():
        fn = getattr(cdll, name)
        fn.argtypes, fn.restype = argtypes, restype
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        print("eam_tf_sums: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as CS
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.kernels import raymarch as RK
    from vpt_tpu_torch.models.raymarch import _seed_to_offset

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda:0")
    shipped = _build.load()
    F = CS.EAM_FIT
    truth, tft, cams = CS.eam_fit_scene(dev)
    big = CS.eam_fit_scene(dev, 128)[0]
    inv, offset = cams[1].inverse_mvp(), np.float32(_seed_to_offset(1))
    gen = torch.Generator(device=dev).manual_seed(20)
    signed = torch.rand((F["res"], F["res"], 3), generator=gen, device=dev) * 2.0 - 1.0
    with tempfile.TemporaryDirectory() as tmp:
        variants = {"double": shipped,
                    "float": SimpleNamespace(**{**vars(shipped),
                                                **build_variant(FLOAT_ROW, Path(tmp) / "f")})}
        try:
            for label, dens, filt in (("64^3", truth, "linear"), ("128^3", big, "nearest")):
                for gname, g in (("signed", signed), ("absolute", signed.abs())):
                    rest = (F["extinction"], offset, F["slices"], filt, True)
                    ref = RK.eam_backward_plain(g.double(), inv, dens, tft.double(), *rest)[1]
                    p32 = RK.eam_backward_plain(g, inv, dens, tft, *rest)[1]
                    scale = float(ref.abs().max())
                    rec = dict(volume=label, filter=filt, cotangent=gname, max_abs=scale,
                               plain_float32=float((p32 - ref).abs().max()) / scale)
                    for name, lib in variants.items():
                        _build._lib = lib
                        k1 = RK.eam_backward(g, inv, dens, tft, *rest)[1]
                        k2 = RK.eam_backward(g, inv, dens, tft, *rest)[1]
                        rec[name] = dict(
                            err=float((k1 - ref).abs().max()) / scale,
                            rerun=float((k2 - k1).abs().max()) / scale,
                            ms=CS.device_ms(lambda: RK.eam_backward(g, inv, dens, tft, *rest)))
                    print(json.dumps(rec), flush=True)
        finally:
            _build._lib = shipped


if __name__ == "__main__":
    main()
