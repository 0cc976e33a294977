"""The measurement behind K23's redesign (``mcs_persistent_kernel`` in
``vpt_tpu_torch/csrc/mcs.cu``), kept as the record of what each lever
gave; no product path runs it.

K23 built several ways, each timed on one card on phase 23's launch (the MCS
scene: ``sphere_in_cube(128)`` as a packed u8 table, 512^2 x 4 streams, 8
steps, 16 dispatches from a warm state), exact, with ``majorant_blocks=8``
and under phase 22's environment map. Every variant is the source (its
``MM_U8`` instances only) with some of these edits, each taking one of its
levers out:

- "one row" ("- tiles"): 128 lanes of one image row a block instead of 8 x
  4 pixel tiles a warp;
- "min blocks n" / "no min blocks": ``__launch_bounds__``'s minimum of
  blocks an SM (the source asks ``MCSP_MIN_BLOCKS``, 8);
- "no one texel": the one-texel environment looked up like any map;
- "light at deposit": the shadow ray's light looked up at its deposit
  instead of where the lane scatters (as the parent did; in the "final" set
  with a one-texel map's texel there for a finite direction);
- "rgba at lookup": the TF's RGBA at every lookup instead of its alpha
  there and its RGB where the lane scatters;
- "cos, sin" ("- sincosf"): the sphere's angle by two calls.

The first design was the source at 6 blocks an SM. ``--set first-ladder``
adds its levers one at a time to the table mode alone, ``--set
first-ablation`` takes each out of it and sweeps the minimum of blocks (the
sets that chose the source's levers), ``--set final`` takes each lever out
of the source; ``--set all`` (the default) runs the three. The parent is
another checkout's ``csrc/`` (``--parent DIR``, e.g. the parent commit's
``vpt_tpu_torch/csrc`` unpacked by ``git archive``).

Each variant is built with the loader's flags into a temporary directory
(all at once) and called through its C function with the parameters of
``kernels.mcs.persistent``. Every variant's state after a launch must equal
the source's on all 16 fields bit for bit (the parent's too). The variants
run in turns (forward, then back, ``--rounds`` times) by device time (a
CUDA graph of 20 calls of a state copy and the launch, less 20 copies). It
prints the card; whether ``sincosf`` gives ``sinf``'s and ``cosf``'s bits
on every float angle in [0, f32(2 pi)] (the angles a sphere draw takes);
one JSON line per variant (ms a launch by scene: every turn, the mean and
the spread; the ptxas rows and the static SASS count of its ``<0,0>``
instance, or the parent's one kernel); then the ratios to the source.
``--out FILE`` appends every printed line to FILE too. Needs a CUDA device;
exits 1 without.

    python -m probes.mcsp_variants [--parent DIR] [--set all] [--rounds 3]   (from the root)
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch


def _edit(text, old, new):
    if old not in text:
        raise RuntimeError(f"mcs.cu: {old!r} not found")
    return text.replace(old, new)


def _u8_only(text):
    """The dispatch instantiates MM_U8 alone (the probe's scenes run it)."""
    return _edit(text, "    VPT_MCSP_MODE(MM_U8) VPT_MCSP_MODE(MM_F32) VPT_MCSP_MODE(MM_U8_QC)\n"
                       "    VPT_MCSP_MODE(MM_F32_QC) VPT_MCSP_MODE(MM_NEAREST) "
                       "VPT_MCSP_MODE(MM_GENERIC)\n",
                 "    VPT_MCSP_MODE(MM_U8)\n")


def _one_row(text):
    text = _edit(text, "  int ix, iy, stream;\n  mcsp_pixel(res, ix, iy, stream);\n",
                 "  const int g = blockIdx.x * MCS_THREADS + threadIdx.x;\n"
                 "  if (g >= P.i[SI_STREAMS] * res * res) return;\n"
                 "  const int stream = g / (res * res), pix = g - stream * res * res;\n"
                 "  const int iy = pix / res, ix = pix - iy * res;\n")
    return _edit(text, "  const dim3 grid((unsigned)(tiles * streams));",
                 "  const dim3 grid((unsigned)blocks_for(streams * res * res, MCS_THREADS));")


def _min_blocks(n):
    return lambda text: _edit(text, "#define MCSP_MIN_BLOCKS 8", f"#define MCSP_MIN_BLOCKS {n}")


def _no_min_blocks(text):
    return _edit(text, "__launch_bounds__(MCS_THREADS, MCSP_MIN_BLOCKS)",
                 "__launch_bounds__(MCS_THREADS)")


def _no_one_texel(text):
    return _edit(text, "light = one_texel ? texel : sample_env_rgb(", "light = sample_env_rgb(")


def _light_at_deposit(one_texel):
    """The shadow ray's light looked up at its deposit; with ``one_texel``
    a one-texel map's texel there for a finite direction."""
    light = ("one_texel && isfinite(sdx) && isfinite(sdy) && isfinite(sdz) ? texel : "
             if one_texel else "") + "sample_env_rgb(env, He, We, sdx, sdy, sdz)"

    def f(text):
        text = _edit(text, "  if (shadow) light = sample_env_rgb(env, He, We, sdx, sdy, sdz);\n", "")
        text = _edit(text, "        // the shadow ray's light (a drawn direction is finite)\n"
                           "        light = one_texel ? texel : sample_env_rgb(env, He, We, sdx, sdy, "
                           "sdz);\n", "")
        return _edit(text, "        const float4 v = shadow ?",
                     f"        if (shadow) light = {light};\n        const float4 v = shadow ?")
    return f


def _rgba_at_lookup(text):
    text = _edit(text, "      float density = 0.0f, alpha = 0.0f;\n",
                 "      float density = 0.0f, alpha = 0.0f;\n"
                 "      float4 rgba = make_float4(0.0f, 0.0f, 0.0f, 0.0f);\n")
    text = _edit(text, "        const float w = mode_rgba<MODE>(tf, P, density).w;\n",
                 "        rgba = mode_rgba<MODE>(tf, P, density);\n        const float w = rgba.w;\n")
    return _edit(text, "        const float4 c = mode_rgba<MODE>(tf, P, density);\n",
                 "        const float4 c = rgba;\n")


def _cos_sin(text):
    return _edit(text, "        float sa, ca;\n        sincosf(angle, &sa, &ca);\n"
                       "        const float ox = radius * ca, oy = radius * sa;\n",
                 "        const float ox = radius * cosf(angle), oy = radius * sinf(angle);\n")


def _chain(*edits):
    def f(text):
        for e in edits:
            text = e(text)
        return text
    return f


# the first design is the source at 6 blocks an SM
_SIX = _min_blocks(6)
_AT_DEPOSIT = _light_at_deposit(False)
FIRST_LADDER = {
    "mode": _chain(_one_row, _no_min_blocks, _AT_DEPOSIT, _rgba_at_lookup, _cos_sin),
    "+registers": _chain(_one_row, _SIX, _AT_DEPOSIT, _rgba_at_lookup, _cos_sin),
    "+tiles": _chain(_SIX, _AT_DEPOSIT, _rgba_at_lookup, _cos_sin),
    "+light at scatter": _chain(_SIX, _no_one_texel, _rgba_at_lookup, _cos_sin),
    "+one texel": _chain(_SIX, _rgba_at_lookup, _cos_sin),
    "+rgb at scatter": _chain(_SIX, _cos_sin),
    "+sincosf (the first design)": _SIX,
}
FIRST_ABLATION = {
    "- tiles": _chain(_SIX, _one_row),
    "- registers (no min blocks)": _no_min_blocks,
    "- light at scatter": _chain(_SIX, _AT_DEPOSIT),
    "- one texel": _chain(_SIX, _no_one_texel),
    "- rgb at scatter": _chain(_SIX, _rgba_at_lookup),
    "- sincosf": _chain(_SIX, _cos_sin),
    "min blocks 5": _min_blocks(5),
}
FINAL = {
    "- tiles": _one_row,
    "- one texel": _no_one_texel,
    "light at deposit": _light_at_deposit(True),
    "rgba at lookup": _rgba_at_lookup,
    "light at deposit, rgba at lookup": _chain(_light_at_deposit(True), _rgba_at_lookup),
    "- sincosf": _cos_sin,
    "min blocks 6": _SIX,
    "min blocks 10": _min_blocks(10),
    "no min blocks": _no_min_blocks,
}
SETS = {"first-ladder": FIRST_LADDER, "first-ablation": FIRST_ABLATION, "final": FINAL}
SETS["all"] = {f"{name}: {label}": edit for name, variants in list(SETS.items())
               for label, edit in variants.items()}

SINCOS_CHECK = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __noinline__ float only_sin(float x) { return sinf(x); }
__device__ __noinline__ float only_cos(float x) { return cosf(x); }
__device__ __noinline__ void both(float x, float* s, float* c) { sincosf(x, s, c); }
__global__ void check(uint32_t n, unsigned long long* bad, uint32_t* first) {
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i <= n; i += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(i);
    float s, c;
    both(x, &s, &c);
    if (__float_as_uint(s) != __float_as_uint(only_sin(x)) ||
        __float_as_uint(c) != __float_as_uint(only_cos(x))) {
      atomicAdd(bad, 1ull);
      atomicMin(first, i);
    }
  }
}
extern "C" int vpt_sincos_check(uint32_t n, unsigned long long* bad, uint32_t* first) {
  check<<<132 * 16, 256>>>(n, bad, first);
  return (int)cudaGetLastError();
}
"""


def sincos_check(tmp: Path, dev):
    """(angles checked, angles where sincosf's bits differ from sinf's or
    cosf's, the first such float's bits or None)."""
    from vpt_tpu_torch.kernels import _build

    src = tmp / "sincos.cu"
    src.write_text(SINCOS_CHECK)
    lib = tmp / "sincos.so"
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for the sincosf check:\n{r.stdout}{r.stderr}")
    fn = ctypes.CDLL(str(lib)).vpt_sincos_check
    fn.argtypes, fn.restype = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
    n = int(np.float32(6.28318530718).view(np.uint32))  # kTwoPi's bits: every angle up to it
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    first = torch.full((1,), -1, dtype=torch.int32, device=dev)
    if fn(n, bad.data_ptr(), first.data_ptr()) != 0:
        raise RuntimeError("the sincosf check did not launch")
    torch.cuda.synchronize()
    return n + 1, int(bad), (None if int(bad) == 0 else int(first) & 0xFFFFFFFF)


def sass_counts(lib: Path, pattern: str):
    """Static SASS of the mcs_persistent_kernel instance whose mangled name
    holds ``pattern``: its instruction count and 12 most frequent opcodes."""
    from vpt_tpu_torch.kernels import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    counts, inside = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = "mcs_persistent_kernel" in line and pattern in line
            continue
        if inside:
            op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if op:
                counts[op.group(1)] = counts.get(op.group(1), 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:12]
    local = {k: v for k, v in counts.items() if k.split(".")[0] in ("STL", "LDL", "CALL")}
    return dict(instructions=sum(counts.values()), top=top, local_and_calls=local)


def build(variants, tmp: Path, parent: Path | None):
    """{label: (vpt_mcs_persistent, ptxas rows, SASS counts)}, every library
    built at once."""
    from vpt_tpu_torch.kernels import _build

    jobs = {}
    if parent is not None:
        jobs["parent"] = parent
    for k, (label, edit) in enumerate({"source": lambda t: t, **variants}.items()):
        src = tmp / f"variant{k}"
        shutil.copytree(_build.CSRC_DIR, src)
        (src / "mcs.cu").write_text(_u8_only(edit((src / "mcs.cu").read_text())))
        jobs[label] = src
    nvcc = _build.find_nvcc()
    procs = {label: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-o", str(tmp / f"{i}.so"), str(src / "mcs.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (label, src) in enumerate(jobs.items())}
    out = {}
    for i, (label, proc) in enumerate(procs.items()):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(tmp / f"{i}.so")).vpt_mcs_persistent
        fn.argtypes, fn.restype = _build._SIGNATURES["mcs"]["vpt_mcs_persistent"]
        rows = [dict(template=t, registers=g, spill_store_bytes=s, spill_load_bytes=lo,
                     stack_frame_bytes=f)
                for k, t, g, s, lo, f in _build.ptxas_table(log) if k == "mcs_persistent_kernel"]
        sass = sass_counts(tmp / f"{i}.so", "kernelENS_9McsParams" if label == "parent"
                           else "kernelILi0ELb0EEEv")
        out[label] = (fn, rows, sass)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m probes.mcsp_variants")
    ap.add_argument("--parent", help="another checkout's vpt_tpu_torch/csrc")
    ap.add_argument("--reps", type=int, default=1, help="graph replays a turn")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", help="a file to append every printed line to")
    ap.add_argument("--set", choices=tuple(SETS), default="all")
    args = ap.parse_args(argv)

    def say(line):
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    if not torch.cuda.is_available():
        print("mcsp_variants: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as CS
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import mcs as KS

    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda:0")
    kw_p = dict(persistent=True, steps=CS.MCSP_STEPS, streams=CS.MCSP_STREAMS)
    scenes = {}
    for label, vol, env, kw in CS.mcsp_modes():
        if label not in ("u8", "majorant", "environment"):
            continue
        s = CS.mcs_make_session(dev, vol, env, {**kw_p, **kw})
        r = s.renderer
        warm = r.reset(None)
        KS.persistent(warm, r.ctx(CS.mcs_camera(), 1), CS.mcsp_seeds(1, CS.MCSP_DISPATCHES),
                      r.steps, r.volume.filter, r.streams)
        seeds = CS.mcsp_seeds(1 + CS.MCSP_DISPATCHES, CS.MCSP_DISPATCHES)
        scenes[label] = (r, warm, seeds)

    with tempfile.TemporaryDirectory() as tmp:
        n, bad, first = sincos_check(Path(tmp), dev)
        say(json.dumps(dict(sincosf_angles=n, sincosf_differs=bad, first_bits=first)))
        libs = build(SETS[args.set], Path(tmp), Path(args.parent) if args.parent else None)

        def launcher(fn, label):
            r, warm, seeds = scenes[label]
            ctx = r.ctx(CS.mcs_camera(), seeds[0])
            f, i = KS._params(ctx, CS.RES, len(seeds), 0, r.volume.filter, r.steps, r.streams)
            seeds_dev = torch.as_tensor(np.asarray(seeds, np.uint32).view(np.int32), device=dev)
            work = CS.mcsp_clone(warm)
            vol = KS.RK._volume_tensor(ctx.density)

            def copy():
                for a, b in zip(work.tensors(), warm.tensors()):
                    a.copy_(b)

            def launch():
                copy()
                K._raise_on(fn(f.ctypes.data, i.ctypes.data, vol.data_ptr(),
                               ctx.tf_table.data_ptr(), ctx.environment.data_ptr(),
                               K._ptr(ctx.majorant), seeds_dev.data_ptr(),
                               *(getattr(work, k).data_ptr() for k in KS.PERSISTENT_FIELDS),
                               K._stream(dev)), "mcs_persistent")
            return work, copy, launch

        want = {}
        for label in scenes:
            work, _, launch = launcher(libs["source"][0], label)
            launch()
            torch.cuda.synchronize()
            want[label] = CS.mcsp_clone(work)
        for name, (fn, _, _) in libs.items():
            for label in scenes:
                work, _, launch = launcher(fn, label)
                launch()
                torch.cuda.synchronize()
                bad = [k for k in KS.PERSISTENT_FIELDS
                       if not torch.equal(getattr(work, k).view(torch.uint8),
                                          getattr(want[label], k).view(torch.uint8))]
                if bad:
                    raise AssertionError(f"variant {name} ({label}) differs from the source in {bad}")
        order = list(libs)
        copy_ms = {label: CS.device_ms(launcher(libs["source"][0], label)[1]) for label in scenes}
        turns = {(name, label): [] for name in order for label in scenes}
        for k in range(args.rounds):
            for name in (order if k % 2 == 0 else order[::-1]):
                for label in scenes:
                    launch = launcher(libs[name][0], label)[2]
                    ms = sum(CS.device_ms(launch) for _ in range(args.reps)) / args.reps
                    turns[(name, label)].append(ms - copy_ms[label])
        mean = {}
        for name in order:
            mean[name] = {label: sum(turns[(name, label)]) / args.rounds for label in scenes}
            say(json.dumps(dict(
                variant=name, ms=mean[name],
                turns_ms={label: turns[(name, label)] for label in scenes},
                spread_ms={label: max(turns[(name, label)]) - min(turns[(name, label)])
                           for label in scenes},
                ptxas=libs[name][1], sass=libs[name][2])))
        say(json.dumps(dict(copy_ms=copy_ms, ratio_to_source={
            name: {label: mean[name][label] / mean["source"][label] for label in scenes}
            for name in order})))


if __name__ == "__main__":
    main()
