"""The measurements behind K19's TF-row sums (``vpt_tpu_torch/csrc/raymarch.cu``,
``eam_backward_kernel<LEARN_TF = 1>``), kept as the record of why a block
sums the TF gradient's row in double and how it gathers the terms; no
product path runs it.

Every sample of the classic TF reads row 0, and texel 0's alpha takes the
terms of every sample in empty space: at 512^2 a texel sums ~1e6 terms,
which a signed cotangent cancels by orders of magnitude. On chip_smoke.py's
phase-20 scene (the CLI's invert scene: 512^2, 32 slices, extinction 40,
the ramp-alpha TF; the f32 ``sphere_in_cube`` grid at 64^3 and 128^3) this
builds K19 several ways, each the source with some edits:

- "source": a thread sums its run of samples on one texel pair in double
  registers, and a warp's lanes that flush the same pair together add it
  by one shared atomic a channel (``__match_any_sync``, shuffles);
- "runs, lane atomics": the runs without the warp's aggregation, each lane
  adding its own run;
- "per-warp rows": the source with a shared row per warp (no two warps on
  one address), summed by plain loads at the block's end;
- "K19<1> at 256 threads": 256 threads a block learning the TF (the
  source: 128; the block's global flush halves);
- "K19<0> at 128 threads": 128 threads a block for the density alone (the
  source: 256);
- "float row": the source summing in float (runs and row), flushed into the
  same double row;
- "parent" (``--parent DIR``, another checkout's ``vpt_tpu_torch/csrc``):
  the first design, 8 shared double atomics a sample, 128 threads a block.

Each variant runs against the plain version with the TF in float64 (the
reference), under a signed cotangent (uniform in [-1, 1]) and its absolute
value, in the linear and nearest filters: the largest |K19 - reference|
over max |reference|, and a second run's distance from the first. Then the
variants are timed in turns (forward, then back, ``--rounds`` times) by
device time (a CUDA graph of 20 calls) at 64^3 and 128^3, K19<0> and
K19<1>, with each build's ptxas row of ``eam_backward_kernel<1>``. It
prints the card, the mean run length on the scene (active samples per
flush of a thread's run, from a replay of the march with the plain
pieces), one JSON line per check, one per variant with its times, and the
ratios to the source; ``--out FILE`` appends every printed line to FILE.

    python -m probes.eam_tf_sums [--parent DIR] [--rounds 3]   (from the repo's root; needs a CUDA device)
"""

from __future__ import annotations

import argparse
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

K19_START, K19_END = "struct TfRun {", "bool march_ok("


def _edit(text, old, new):
    if old not in text:
        raise RuntimeError(f"raymarch.cu no longer holds {old!r}")
    return text.replace(old, new)


def _lane_atomics(text):
    start = text.index("  const unsigned active = __activemask();")
    end = text.index("  if (!leader) return;")
    return (text[:start] + "  const bool leader = true;\n  double s[8];\n"
            "#pragma unroll\n  for (int c = 0; c < 8; ++c) s[c] = run.s[c];\n" + text[end:])


def _warp_rows(text):
    text = _edit(text, "  extern __shared__ double s_tf[];\n  const int row = (P.i[RI_TF_W] - 1) * 4;",
                 "  extern __shared__ double s_rows[];\n  const int row = (P.i[RI_TF_W] - 1) * 4;\n"
                 "  double* s_tf = s_rows + (threadIdx.x >> 5) * row;\n"
                 "  const int n_rows = blockDim.x >> 5;")
    text = _edit(text, "    for (int k = threadIdx.x; k < row; k += blockDim.x) s_tf[k] = 0.0;",
                 "    for (int k = threadIdx.x; k < row * n_rows; k += blockDim.x) s_rows[k] = 0.0;")
    text = _edit(text, "    for (int k = threadIdx.x; k < row; k += blockDim.x)\n"
                       "      if (s_tf[k] != 0.0) atomicAdd(g_row + k, s_tf[k]);",
                 "    for (int k = threadIdx.x; k < row; k += blockDim.x) {\n"
                 "      double v = 0.0;\n"
                 "      for (int w = 0; w < n_rows; ++w) v += s_rows[w * row + k];\n"
                 "      if (v != 0.0) atomicAdd(g_row + k, v);\n"
                 "    }")
    text = _edit(text, "    const size_t smem = (size_t)(P.i[RI_TF_W] - 1) * 4 * sizeof(double);",
                 "    const size_t smem = (size_t)(P.i[RI_TF_W] - 1) * 4 * sizeof(double) * "
                 "(threads / 32);\n"
                 "    cudaFuncSetAttribute(eam_backward_kernel<true>, "
                 "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);")
    return text


def _threads(learn_tf, density):
    """K19's threads a block: ``learn_tf`` with the TF, ``density`` without."""
    return lambda text: _edit(text, "  return LEARN_TF ? 128 : 256;",
                              f"  return LEARN_TF ? {learn_tf} : {density};")


def _float_row(text):
    a, b = text.index(K19_START), text.index(K19_END)
    body = text[a:b].replace("double* __restrict__ g_row", "G_ROW").replace("double", "float")
    text = text[:a] + body.replace("G_ROW", "double* __restrict__ g_row") + text[b:]
    return _edit(text, "* 4 * sizeof(double);", "* 4 * sizeof(float);")


VARIANTS = {
    "source": lambda t: t,
    "runs, lane atomics": _lane_atomics,
    "per-warp rows": _warp_rows,
    "K19<1> at 256 threads": _threads(256, 256),
    "K19<0> at 128 threads": _threads(128, 128),
    "float row": _float_row,
}


def build(tmp: Path, parent: Path | None):
    """{label: (namespace of the raymarch library's C functions, ptxas row
    of eam_backward_kernel<1>)}, every library built at once."""
    from vpt_tpu_torch.kernels import _build

    jobs = {}
    for k, (label, edit) in enumerate(VARIANTS.items()):
        src = tmp / f"variant{k}"
        shutil.copytree(_build.CSRC_DIR, src)
        (src / "raymarch.cu").write_text(edit((src / "raymarch.cu").read_text()))
        jobs[label] = src
    if parent is not None:
        jobs["parent"] = parent
    nvcc = _build.find_nvcc()
    procs = {label: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-o", str(tmp / f"{i}.so"), str(src / "raymarch.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (label, src) in enumerate(jobs.items())}
    out = {}
    for i, (label, proc) in enumerate(procs.items()):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log[-4000:]}")
        cdll = ctypes.CDLL(str(tmp / f"{i}.so"))
        fns = {}
        for name, (argtypes, restype) in _build._SIGNATURES["raymarch"].items():
            fn = getattr(cdll, name)
            fn.argtypes, fn.restype = argtypes, restype
            fns[name] = fn
        rows = [dict(template=t, registers=g, spill_store_bytes=s, spill_load_bytes=lo,
                     stack_frame_bytes=f)
                for k, t, g, s, lo, f in _build.ptxas_table(log) if k == "eam_backward_kernel"]
        out[label] = (fns, rows)
    return out


def run_lengths(inv, dens, tft, filt, offset, F):
    """Active samples, runs (a thread's flushes) and rays with a sample on
    the scene: K19's march replayed with the plain pieces, each sample's TF
    texel pair (x0, x1) from its density."""
    from vpt_tpu_torch.kernels import raymarch as RK
    from vpt_tpu_torch.ops import interp

    res, n = F["res"], F["slices"]
    _, _, miss, entry, exit_, rsl, step = RK._march_setup(inv, res, tft.device, n)
    W = tft.shape[1]
    a = torch.zeros_like(rsl)
    key = torch.full_like(rsl, -1.0)
    samples = runs = 0
    for k in range(n + 1):
        t = float(step * np.float32(offset) + np.float32(k) * step)
        active = (t < 1.0) & (a < 0.99) & ~miss
        pos = RK._mix3(entry, exit_, t)
        d = interp.sample_volume(dens, *pos, filt)
        c = interp.sample_tex2d(tft, d, torch.zeros_like(d))
        bx = torch.clamp(torch.floor(d * W - 0.5) + 1, 0, W)
        pair = torch.clamp(bx - 1, min=0) * 4096 + torch.clamp(bx, max=W - 1)
        runs += int((active & (pair != key)).sum())
        key = torch.where(active, pair, key)
        samples += int(active.sum())
        a = torch.where(active, a + (1.0 - a) * (c[..., 3] * rsl * F["extinction"]), a)
    return dict(samples=samples, runs=runs, rays=int((key >= 0).sum()),
                samples_per_flush=samples / max(runs, 1))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m probes.eam_tf_sums")
    ap.add_argument("--parent", help="another checkout's vpt_tpu_torch/csrc")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", help="a file to append every printed line to")
    args = ap.parse_args(argv)

    def say(line):
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    if not torch.cuda.is_available():
        print("eam_tf_sums: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as CS
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.kernels import raymarch as RK
    from vpt_tpu_torch.models.raymarch import _seed_to_offset

    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda:0")
    shipped = _build.load()
    F = CS.EAM_FIT
    truth, tft, cams = CS.eam_fit_scene(dev)
    big = CS.eam_fit_scene(dev, 128)[0]
    inv, offset = cams[1].inverse_mvp(), np.float32(_seed_to_offset(1))
    for label, dens in (("64^3", truth), ("128^3", big)):
        say(json.dumps(dict(volume=label, filter="linear",
                            **run_lengths(inv, dens, tft, "linear", offset, F))))
    gen = torch.Generator(device=dev).manual_seed(20)
    signed = torch.rand((F["res"], F["res"], 3), generator=gen, device=dev) * 2.0 - 1.0
    with tempfile.TemporaryDirectory() as tmp:
        built = build(Path(tmp), Path(args.parent) if args.parent else None)
        libs = {label: SimpleNamespace(**{**vars(shipped), **fns})
                for label, (fns, _) in built.items()}
        try:
            for label, dens, filt in (("64^3", truth, "linear"), ("128^3", big, "nearest")):
                for gname, g in (("signed", signed), ("absolute", signed.abs())):
                    rest = (F["extinction"], offset, F["slices"], filt, True)
                    ref = RK.eam_backward_plain(g.double(), inv, dens, tft.double(), *rest)[1]
                    p32 = RK.eam_backward_plain(g, inv, dens, tft, *rest)[1]
                    scale = float(ref.abs().max())
                    rec = dict(volume=label, filter=filt, cotangent=gname, max_abs=scale,
                               plain_float32=float((p32 - ref).abs().max()) / scale)
                    for name, lib in libs.items():
                        _build._lib = lib
                        k1 = RK.eam_backward(g, inv, dens, tft, *rest)[1]
                        k2 = RK.eam_backward(g, inv, dens, tft, *rest)[1]
                        rec[name] = dict(err=float((k1 - ref).abs().max()) / scale,
                                         rerun=float((k2 - k1).abs().max()) / scale)
                    say(json.dumps(rec))
            order = list(libs)
            cases = [(f"k19<{int(tf)}> {label}", dens, tf)
                     for label, dens in (("64^3", truth), ("128^3", big)) for tf in (False, True)]
            turns = {(v, c[0]): [] for v in order for c in cases}
            for k in range(args.rounds):
                for name in (order if k % 2 == 0 else order[::-1]):
                    _build._lib = libs[name]
                    for case, dens, tf in cases:
                        rest = (F["extinction"], offset, F["slices"], "linear", tf)
                        turns[(name, case)].append(CS.device_ms(
                            lambda: RK.eam_backward(signed, inv, dens, tft, *rest)))
            mean = {}
            for name in order:
                mean[name] = {c[0]: sum(turns[(name, c[0])]) / args.rounds for c in cases}
                spread = {c[0]: max(turns[(name, c[0])]) - min(turns[(name, c[0])])
                          for c in cases}
                say(json.dumps(dict(variant=name, ms=mean[name], spread_ms=spread,
                                    turns_ms={c[0]: turns[(name, c[0])] for c in cases},
                                    ptxas=built[name][1])))
            say(json.dumps(dict(ratio_to_source={
                name: {c[0]: mean[name][c[0]] / mean["source"][c[0]] for c in cases}
                for name in order})))
        finally:
            _build._lib = shipped


if __name__ == "__main__":
    main()
