"""The measurement behind K25's redesign (``lao_frame_kernel`` in
``vpt_tpu_torch/csrc/lao.cu``), kept as the record of what each lever
gave; no product path runs it.

K25 built several ways, each timed on one card on phase 25's frame (the
bench volume ``sphere_in_cube(128)`` as a packed u8 table, 512^2, 64 slices,
both terms, the JAX defaults). Every variant is the source with some of
these edits:

- "markstein": the cone's three quotients by one reciprocal of |j| and
  Markstein's correction (mcm_common.cuh ``quot``), the cone integral's
  by light_coef's reciprocal, the alpha's by 100 and the shadow remap's by
  1.3 with their RN reciprocals as constants (``MARKSTEIN_RECIPROCALS``;
  tests/test_torch_step_identities.py proves each quotient IEEE's);
- "one row": 128 pixels of one image row a block instead of the 8 x 4
  pixel tiles a warp; other tile shapes (``_tiles``);
- "own lookups": 7 lookups of their own for the value and the central
  difference instead of 9 shared axes;
- "u8_unit": ``u8_unit``'s dequantization with its zero test;
- "unroll n": the cone's loop unrolled n times (the sum's order stays);
- "min blocks n" / "no min blocks": ``__launch_bounds__``'s minimum of
  blocks an SM (the source asks 6: at most 80 registers);
- "noinline rand": ``rand2_x`` out of line (where the stack frame goes);
- "diag: row 0": every lookup reading row 0, a diagnostic of what the
  lookups' scattered rows cost (its frame differs, and is not checked).

``--set final`` (the default) times the source against single edits;
``--set ablation`` and ``--set ladder`` rebuild the sets that chose it
(PERF.md): the ladder adds the levers one at a time from the table
mode alone, the ablation takes each out of the design with "markstein" and
"unroll 2" in it. The parent is another checkout's ``csrc/`` (``--parent
DIR``, e.g. the parent commit's ``vpt_tpu_torch/csrc`` unpacked by ``git
archive``).

    python -m probes.lao_variants [--parent DIR] [--reps 20] [--rounds 3]   (from the root)

Each variant is the checkout's ``csrc/`` with ``lao.cu`` edited as above,
built with the loader's flags into a temporary directory (all at once),
and called through its C function with the parameters of
``kernels.lao.lao_pass``. The variants run in turns (forward, then back,
``--rounds`` times) on the same inputs; each frame must equal the source's
bit for bit (the diagnostic aside). It prints the card, one JSON line per
variant (ms a frame by CUDA events over ``--reps`` launches: every turn,
the mean and the spread; the ptxas row and the static SASS count of its
instantiation ``<1,1,0>``, its local loads, stores and calls), then the ratios to the first variant; ``--out
FILE`` appends every printed line to FILE too. Needs a CUDA device; exits
1 without.
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

import torch

# Markstein's correction for the divisors 100 and f32(1.3): their RN reciprocals
MARKSTEIN_RECIPROCALS = {"100.0f": "0x1.47ae14p-7f", "F32(1.3)": "0x1.89d89ep-1f"}
_ONE_ROW = """{
    const int pix = blockIdx.x * LAO_THREADS + threadIdx.x;
    iy = pix / res;
    ix = pix - iy * res;
  }"""


def _edit(text, old, new):
    if old not in text:
        raise RuntimeError(f"lao.cu: {old!r} not found")
    return text.replace(old, new)


def _markstein(text):
    k100, k13 = MARKSTEIN_RECIPROCALS["100.0f"], MARKSTEIN_RECIPROCALS["F32(1.3)"]
    text = _edit(text, "  const float bias = P.f[LF_SHADOW_BIAS];\n",
                 "  const float bias = P.f[LF_SHADOW_BIAS];\n"
                 "  const Recip coef_r = recip(coef);\n"
                 f"  const Recip k100 = {{100.0f, {k100}, true}};\n"
                 f"  const Recip k13 = {{F32(1.3), {k13}, true}};\n")
    text = _edit(text, "const float jn = sqrtf(jx * jx + jy * jy + jz * jz);",
                 "const Recip jn = recip(sqrtf(jx * jx + jy * jy + jz * jz));")
    for a in ("jx", "jy", "jz"):
        text = _edit(text, f"__fdiv_rn({a}, jn)", f"quot({a}, jn)")
    text = _edit(text, "__fdiv_rn(acc_lao, coef)", "quot(acc_lao, coef_r)")
    text = _edit(text, "__fdiv_rn(bias + shadow * F32(1.2), F32(1.3))",
                 "quot(bias + shadow * F32(1.2), k13)")
    return _edit(text, "__fdiv_rn((1.0f - acc_a) * value * ext, 100.0f)",
                 "quot((1.0f - acc_a) * value * ext, k100)")


def _tiles(tile_w, tile_h, ix, iy):
    """Blocks of tile_w x tile_h pixels, a thread's pixel at (ix, iy) in
    terms of warp, lane and the block's corner (bx, by)."""
    def f(text):
        text = _edit(text, "#define LAO_TILE_W 16\n#define LAO_TILE_H 8",
                     f"#define LAO_TILE_W {tile_w}\n#define LAO_TILE_H {tile_h}")
        text = _edit(text, "  ix = blockIdx.x * LAO_TILE_W + (warp & 1) * 8 + (lane & 7);\n"
                           "  iy = blockIdx.y * LAO_TILE_H + (warp >> 1) * 4 + (lane >> 3);",
                     f"  const int bx = blockIdx.x * LAO_TILE_W, by = blockIdx.y * LAO_TILE_H;\n"
                     f"  ix = {ix};\n  iy = {iy};")
        return text
    return f


def _one_row(text):
    text = _edit(text, "  lao_pixel(ix, iy);\n", "  " + _ONE_ROW + "\n")
    return _edit(text, "const dim3 grid((unsigned)blocks_for(res, LAO_TILE_W), "
                       "(unsigned)blocks_for(res, LAO_TILE_H));",
                 "const dim3 grid((unsigned)blocks_for(res * res, LAO_THREADS));")


def _min_blocks(n):
    return lambda text: _edit(text, "#define LAO_MIN_BLOCKS 6", f"#define LAO_MIN_BLOCKS {n}")


def _no_min_blocks(text):
    return _edit(text, "__launch_bounds__(LAO_THREADS, LAO_MIN_BLOCKS)",
                 "__launch_bounds__(LAO_THREADS)")


def _unroll(n):
    return lambda text: _edit(text, "      for (int i = 0; i < n_cone; ++i) {",
                              f"#pragma unroll {n}\n      for (int i = 0; i < n_cone; ++i) {{")


def _noinline_rand(text):
    return _edit(text, "__device__ __forceinline__ float rand2_x(",
                 "__device__ __noinline__ float rand2_x(")


def _u8_unit(text):
    return _edit(text, "  return __fmaf_rn(__fmaf_rn(-255.0f, q, v), kInv255, q);",
                 "  return u8_unit(word, k);")


def _own_lookups(text):
    start = text.index("    // the value and the central difference: 7 lookups over 9 axes")
    end = text.index("    const float gmag = sqrtf(gx * gx + gy * gy + gz * gz);")
    return text[:start] + """    const float gx = lao_volume<MODE>(vol, V, p0 - h, p1, p2) -
                     lao_volume<MODE>(vol, V, p0 + h, p1, p2);
    const float gy = lao_volume<MODE>(vol, V, p0, p1 - h, p2) -
                     lao_volume<MODE>(vol, V, p0, p1 + h, p2);
    const float gz = lao_volume<MODE>(vol, V, p0, p1, p2 - h) -
                     lao_volume<MODE>(vol, V, p0, p1, p2 + h);
""" + text[end:].replace("    const float value = lao_fetch<MODE>(vol, V, x1, y1, z1);",
                         "    const float value = lao_volume<MODE>(vol, V, p0, p1, p2);")


def _row0(text):
    return _edit(text, "  const int64_t row = (int64_t)z.b * V.plane + (y.b * V.w + x.b);",
                 "  const int64_t row = 0;")


def _chain(*edits):
    def f(text):
        for e in edits:
            text = e(text)
        return text
    return f


_M8 = _chain(_markstein, _min_blocks(8))   # the design of the ladder's top
_MU = _chain(_markstein, _unroll(2))       # the design the ablation took apart
SETS = {
    "final": {
        "source": lambda t: t,
        "+ unroll 2": _unroll(2),
        "+ markstein": _markstein,
        "- tiles (one row)": _one_row,
        "warp 4x8, block 8x16": _tiles(8, 16, "bx + (warp & 1) * 4 + (lane & 3)",
                                       "by + (warp >> 1) * 8 + (lane >> 2)"),
        "warp 16x2, block 32x4": _tiles(32, 4, "bx + (warp & 1) * 16 + (lane & 15)",
                                        "by + (warp >> 1) * 2 + (lane >> 4)"),
        "warps 8x4 in a row, block 32x4": _tiles(32, 4, "bx + warp * 8 + (lane & 7)",
                                                 "by + (lane >> 3)"),
        "warps 8x4 in a column, block 8x16": _tiles(8, 16, "bx + (lane & 7)",
                                                    "by + warp * 4 + (lane >> 3)"),
        "min blocks 5": _min_blocks(5),
        "min blocks 8": _min_blocks(8),
        "no min blocks": _no_min_blocks,
    },
    "ladder": {
        "mode": _chain(_one_row, _no_min_blocks, _own_lookups, _u8_unit),
        "+markstein": _chain(_markstein, _one_row, _no_min_blocks, _own_lookups, _u8_unit),
        "+tiles": _chain(_markstein, _no_min_blocks, _own_lookups, _u8_unit),
        "+occupancy": _chain(_M8, _own_lookups, _u8_unit),
        "+shared axes": _chain(_M8, _u8_unit),
        "+u8 without zero test": _M8,
        "min blocks 6": _markstein,
        "min blocks 10": _chain(_markstein, _min_blocks(10)),
        "min blocks 12": _chain(_markstein, _min_blocks(12)),
        "cone unrolled 2": _chain(_M8, _unroll(2)),
        "cone unrolled 4": _chain(_M8, _unroll(4)),
        "cone unrolled 2, min blocks 6": _MU,
        "noinline rand": _chain(_M8, _noinline_rand),
        "diag: row 0": _chain(_M8, _row0),
    },
    "ablation": {
        "source": _MU,
        "- markstein": _unroll(2),
        "- tiles": _chain(_MU, _one_row),
        "- shared axes": _chain(_MU, _own_lookups),
        "- u8 without zero test": _chain(_MU, _u8_unit),
        "- cone unroll": _markstein,
        "mode only": _chain(_one_row, _own_lookups, _u8_unit, _no_min_blocks),
        "min blocks 4": _chain(_MU, _min_blocks(4)),
        "min blocks 5": _chain(_MU, _min_blocks(5)),
        "min blocks 8": _chain(_MU, _min_blocks(8)),
        "no min blocks": _chain(_MU, _no_min_blocks),
        "cone unrolled 4": _chain(_markstein, _unroll(4)),
        "diag: row 0": _chain(_MU, _row0),
    },
}
UNCHECKED = ("diag: row 0",)


def sass_counts(lib: Path, template: str):
    """Static SASS of one lao_frame_kernel instantiation in ``lib``: its
    instruction count and its 12 most frequent opcodes (cuobjdump)."""
    from vpt_tpu_torch.kernels import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    counts, inside = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = "lao_frame_kernel" in line and template in line
            continue
        if inside:
            op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if op:
                counts[op.group(1)] = counts.get(op.group(1), 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:12]
    local = {k: v for k, v in counts.items() if k.split(".")[0] in ("STL", "LDL", "CALL")}
    return dict(instructions=sum(counts.values()), top=top, local_and_calls=local)


def build(variants, tmp: Path, parent: Path | None):
    """{label: (vpt_lao_frame, ptxas rows, SASS counts)}, every library
    built at once."""
    from vpt_tpu_torch.kernels import _build

    jobs = {}
    if parent is not None:
        jobs["parent"] = parent
    for label, edit in variants.items():
        src = tmp / label.replace(" ", "_").replace("+", "p")
        shutil.copytree(_build.CSRC_DIR, src)
        (src / "lao.cu").write_text(edit((src / "lao.cu").read_text()))
        jobs[label] = src
    nvcc = _build.find_nvcc()
    procs = {label: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-o", str(tmp / f"{i}.so"), str(src / "lao.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (label, src) in enumerate(jobs.items())}
    out = {}
    for i, (label, proc) in enumerate(procs.items()):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log[-4000:]}")
        fn = ctypes.CDLL(str(tmp / f"{i}.so")).vpt_lao_frame
        fn.argtypes, fn.restype = _build._SIGNATURES["lao"]["vpt_lao_frame"]
        rows = [dict(template=t, registers=g, spill_store_bytes=s, spill_load_bytes=lo,
                     stack_frame_bytes=f)
                for k, t, g, s, lo, f in _build.ptxas_table(log)
                if k == "lao_frame_kernel" and t in ("1,1", "1,1,0")]
        sass = sass_counts(tmp / f"{i}.so", "ILb1ELb1E" + ("EE" if label == "parent" else "Li0EEE"))
        out[label] = (fn, rows, sass)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m probes.lao_variants")
    ap.add_argument("--parent", help="another checkout's vpt_tpu_torch/csrc")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", help="a file to append every printed line to")
    ap.add_argument("--set", choices=tuple(SETS), default="final")
    args = ap.parse_args(argv)

    def say(line):
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    if not torch.cuda.is_available():
        print("lao_variants: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as CS
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import lao as KL
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.models.lao import LAORenderer

    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    dev, cam = torch.device("cuda:0"), Camera()
    r = LAORenderer(CS.mode_volumes()[0][1], slices=CS.LAO_SLICES, resolution=CS.RM_RES,
                    device=dev)
    args_, kw = CS.lao_inputs(r, cam)
    want = KL.lao_pass(*args_, **kw, cone=r._cone, exact=r.exact_stop)
    exact = r.exact_stop and KL.cone_clear(cam.inverse_mvp(), r.light_position,
                                           r.params["light_radius"], r.params["lao_step"],
                                           r.slices)
    f, i = KL._params(*args_[:9], r.slices, r.resolution, r._cone.shape[0], exact,
                      kw["volume_filter"])
    vol = args_[1].table
    out = torch.empty_like(want)
    stream = K._stream(dev)

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(SETS[args.set], Path(tmp), Path(args.parent) if args.parent else None)

        def launch(fn):
            err = fn(f.ctypes.data, i.ctypes.data, 1, 1, vol.data_ptr(), args_[2].data_ptr(),
                     r._cone.data_ptr(), out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"vpt_lao_frame: CUDA error {err}")

        def ms(fn):
            launch(fn)
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(args.reps):
                launch(fn)
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) / args.reps

        for label, (fn, _, _) in libs.items():
            out.fill_(float("nan"))
            launch(fn)
            torch.cuda.synchronize()
            if (label not in UNCHECKED
                    and not torch.equal(out.view(torch.int32), want.view(torch.int32))):
                raise AssertionError(f"variant {label}: the frame differs from the source's")
        order = list(libs)
        turns = {label: [] for label in order}
        for k in range(args.rounds):
            for label in (order if k % 2 == 0 else order[::-1]):
                turns[label].append(ms(libs[label][0]))
        mean = {label: sum(t) / len(t) for label, t in turns.items()}
        for label in order:
            say(json.dumps(dict(variant=label, ms=mean[label], turns_ms=turns[label],
                                spread_ms=max(turns[label]) - min(turns[label]),
                                ptxas=libs[label][1], sass=libs[label][2])))
        say(json.dumps(dict(ratio_to_first={label: mean[label] / mean[order[0]]
                                            for label in order})))


if __name__ == "__main__":
    main()
