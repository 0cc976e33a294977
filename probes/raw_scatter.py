"""The measurement behind the raw replay backward's light scatter and K13's
register budget (``vpt_tpu_torch/csrc/raw_backward.cu``), kept as the
record of how the shipped variants were chosen; no product path runs it.

On one card, over the bench scene with every table raw (512^2 x 4
streams, the 128^3 f32 grid, the (256, 256, 4) ramp TF, the 256-texel
light, 12 bins, 8 steps, one dispatch), K14 ``raw_replay`` with an
escape's 2 light texel terms added

- "scalar": by 2 scalar atomics from every escaping lane (as the source
  has it);
- "warp": by 2 scalar atomics from one lane per texel pair of a warp,
  after the warp's lanes that add into the same pair have summed their
  terms (``__match_any_sync``, a tree of shuffles, as
  ``adjoint_common.cuh::add_env_texels`` does for the env map);
- "none": not at all (wrong light gradient; the cost of the light
  scatter is the difference to "scalar");

and K13 ``raw_tape`` under ``__launch_bounds__(128, 8)`` (as the source
has it: 64 registers) and ``(128, 10)`` (48 registers, like K1).

    python -m probes.raw_scatter [--reps 20]      (from the repo's root)

Each variant is the checkout's ``csrc/raw_backward.cu`` with the light
atomics or the bound replaced, built with the loader's flags into a
temporary directory and swapped in for the loaded library. The variants
run in turns (forward, then back) on the same tape, each held against the
plain versions (relative L2 per gradient). Per variant it prints one JSON
line: K13 and K14 ms by CUDA events, the relative errors and the ptxas
rows of the 12-bin instantiations. Needs a CUDA device; exits 1 without.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

_SHIPPED_LIGHT = """          atomicAdd(g_light + min(max(i0, 0), LN - 1), gl * (1.0f - lf));
          atomicAdd(g_light + min(max(i0 + 1, 0), LN - 1), gl * lf);
"""

_WARP_LIGHT = """          float w0 = gl * (1.0f - lf), w1 = gl * lf;
          const unsigned active = __activemask();
          const unsigned peers = __match_any_sync(active, (unsigned)i0);
          const int me = threadIdx.x & 31;
          const unsigned below = peers & ((1u << me) - 1u);
          unsigned above = peers & (0xfffffffeu << me);
          int rank = __popc(below);
          while (__any_sync(active, above)) {
            const int next = __ffs(above);
            const float t0 = __shfl_sync(active, w0, next - 1);
            const float t1 = __shfl_sync(active, w1, next - 1);
            if (next) {
              w0 += t0;
              w1 += t1;
            }
            above &= __ballot_sync(active, !(rank & 1));
            rank >>= 1;
          }
          if (below == 0) {
            atomicAdd(g_light + min(max(i0, 0), LN - 1), w0);
            atomicAdd(g_light + min(max(i0 + 1, 0), LN - 1), w1);
          }
"""

_TAPE_BOUND = "__launch_bounds__(STEP_THREADS, 8)\nraw_tape_kernel"

VARIANTS = {
    "scalar": {},
    "warp": {_SHIPPED_LIGHT: _WARP_LIGHT},
    "none": {_SHIPPED_LIGHT: ""},
    "tape10": {_TAPE_BOUND: "__launch_bounds__(STEP_THREADS, 10)\nraw_tape_kernel"},
}


def build_variant(edits: dict, out_dir: Path):
    """The raw backward library with ``edits`` applied to its source:
    (namespace of its C functions, ptxas rows of the 12-bin kernels)."""
    import shutil

    from vpt_tpu_torch.kernels import _build

    src = out_dir / "csrc"
    shutil.copytree(_build.CSRC_DIR, src)
    path = src / "raw_backward.cu"
    text = path.read_text()
    for old, new in edits.items():
        if old not in text:
            raise RuntimeError(f"raw_backward.cu no longer holds {old[:60]!r}")
        text = text.replace(old, new)
    path.write_text(text)
    lib = out_dir / "libraw_backward.so"
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(path)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    cdll = ctypes.CDLL(str(lib))
    fns = {}
    for name, (argtypes, restype) in _build._SIGNATURES["raw_backward"].items():
        fn = getattr(cdll, name)
        fn.argtypes, fn.restype = argtypes, restype
        fns[name] = fn
    rows = [dict(kernel=k, template=t, registers=g, spill_store_bytes=s, spill_load_bytes=lo)
            for k, t, g, s, lo, _ in _build.ptxas_table(r.stdout + r.stderr) if t == "12"]
    return fns, rows


def _rel(a, p):
    return float((a.double() - p.double()).norm()) / max(float(p.double().norm()), 1e-30)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m probes.raw_scatter")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("raw_scatter: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as CS
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.kernels import spectral_backward as TB

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda:0")
    shipped = _build.load()
    _, ctx, s0 = CS.raw_scene(Camera(), dev)
    out, tape = TB.raw_tape(s0, ctx, CS.STEPS, CS.BINS)
    rng = np.random.default_rng(18)
    g_img = torch.as_tensor(rng.uniform(0.5, 1.5, (CS.RES, CS.RES, 3)).astype(np.float32),
                            device=dev)
    g_rs = TB._deposit_cotangents(g_img, ctx, tuple(s0.px.shape), CS.BINS, TB._m_final(out))
    want = TB.raw_replay_plain(s0, ctx, tape, g_rs, CS.STEPS, CS.BINS, TB._inv_mu(ctx))

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(args.reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / args.reps

    with tempfile.TemporaryDirectory() as tmp:
        variants = {}
        for name, edits in VARIANTS.items():
            fns, rows = build_variant(edits, Path(tmp) / name)
            variants[name] = (SimpleNamespace(**{**vars(shipped), **fns}), rows)
        recs = {name: dict(variant=name, k13_ms=[], k14_ms=[], ptxas=rows, rel={})
                for name, (_, rows) in variants.items()}
        try:
            for name in list(variants) + list(reversed(variants)):
                _build._lib = variants[name][0]
                rec = recs[name]
                got = TB.raw_replay(s0, ctx, tape, g_rs, CS.STEPS, CS.BINS)
                rec["rel"] = {k: _rel(got[k], v) for k, v in want.items()}
                rec["k14_ms"].append(ms(lambda: TB.raw_replay(s0, ctx, tape, g_rs, CS.STEPS,
                                                              CS.BINS)))
                rec["k13_ms"].append(ms(lambda: TB.raw_tape(s0, ctx, CS.STEPS, CS.BINS)))
        finally:
            _build._lib = shipped
    for rec in recs.values():
        rec["k13_mean_ms"] = float(np.mean(rec["k13_ms"]))
        rec["k14_mean_ms"] = float(np.mean(rec["k14_ms"]))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
