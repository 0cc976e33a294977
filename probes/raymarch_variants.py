"""The measurement behind the redesign of K16 ``mip_kernel`` and K15
``march_kernel<EAM|DEPTH>`` (``vpt_tpu_torch/csrc/raymarch.cu``), kept as
the record of what each lever gave; no product path runs it.

K15 and K16 built several ways, each timed on one card on phase 19's pass
(the bench volume ``sphere_in_cube(128)`` as a packed u8 table, 512^2, the
JAX defaults: EAM and Depth 64 slices, MIP 64 steps, the session's first
offset) and on phase 20's frame alone (the 64^3 raw f32 grid of the CLI's
invert scene, 512^2, 32 slices). Every variant is the source with some of
these edits:

- "generic" / "- mode": every table pair through the generic instance (the
  tables' layout read from the parameter block at each lookup, as the
  parent);
- "one row" / "- tiles": 128 pixels of one image row a block instead of the
  8 x 4 pixel tiles a warp;
- "batch n" / "mip batch n" / "eam batch n" / "depth batch n": the samples
  whose lookups a thread issues together (1: one sample at a time);
- "fmodf" / "- wrap": K16's offset wrap by ``fmodf`` at every sample;
- "rgba" / "- alpha words": K16's and Depth's TF lookups load the four
  float4 texels, not their alpha words;
- "- u8 dequant": a u8 corner dequantized by ``u8_unit`` (with its zero
  test) instead of ``march_u8``;
- "- one TF row": the raw TF's second row computed as the plain lookup
  does (``min(by, H - 1)``) instead of taken as the first;
- "mip ... blocks", "eam at n blocks", "depth at n blocks": the minimum
  of blocks an SM in ``__launch_bounds__`` (the source asks 1 for K16, 3
  for EAM and 8 for Depth).

``--set final`` (the default) times the source against single edits;
``--set ladder`` adds the levers one at a time from the parent's design
(the generic instance, one row, one sample, fmodf, rgba, ``u8_unit``, two
TF rows), ``--set ablation`` takes each out of the source; ``--set
measure`` times nothing and prints the parent's and the source's ptxas
rows and SASS (the question what a sample costs) and the trips per ray of
each pass (over a row of 32 pixels and over an 8 x 4 tile;
``chip_smoke.rm_trip_stats``). The parent
is another checkout's ``csrc/`` (``--parent DIR``, e.g. the parent
commit's ``vpt_tpu_torch/csrc`` unpacked by ``git archive``).

    python -m probes.raymarch_variants [--parent DIR] [--set final|ladder|ablation|measure]
        [--modes u8|all] [--rounds 3] [--out FILE]     (from the root)

Each variant is the checkout's ``csrc/`` with ``raymarch.cu`` edited as
above, built with the loader's flags into a temporary directory (all at
once), and called through its C functions with the parameters of
``kernels.raymarch``'s wrappers (the parent reads the block's first 12
integers, the same but for the instance). Every variant's outputs must
equal the plain versions' bit for bit. The variants run in turns (forward,
then back, ``--rounds`` times); a kernel's time is its device time, 20
launches in a CUDA graph replayed between CUDA events. It prints the card,
one JSON line per variant (ms by kernel: the mean, every turn, the spread;
the ptxas rows of every kernel of the source and the static SASS of K16
and K15 in the timed modes: the instruction count, the largest loops' and
the per-sample share of the batched loop), then the ratios to the first
variant. Needs a CUDA device; exits 1 without.
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

_ONE_ROW = """  {
    const int pix_ = blockIdx.x * MARCH_THREADS + threadIdx.x;
    iy = pix_ / P.i[RI_RES];
    ix = pix_ - iy * P.i[RI_RES];
  }
"""


def _edit(text, old, new, count=None):
    if old not in text or (count is not None and text.count(old) != count):
        raise RuntimeError(f"raymarch.cu: {old!r} not found (or not {count} times)")
    return text.replace(old, new)


def _one_row(text):
    text = _edit(text, "  march_pixel(ix, iy);\n", _ONE_ROW, 2)
    return _edit(text, "  return dim3((unsigned)blocks_for(P.i[RI_RES], MARCH_TILE_W),\n"
                       "              (unsigned)blocks_for(P.i[RI_RES], MARCH_TILE_H));",
                 "  return dim3((unsigned)blocks_for(P.i[RI_RES] * P.i[RI_RES], MARCH_THREADS));")


def _generic(text):
    text = _edit(text, "switch (P.i[RI_MODE] * 2 + mode) {", "switch (MM_GENERIC * 2 + mode) {")
    return _edit(text, "switch (P.i[RI_MODE]) {", "switch (MM_GENERIC) {")


def _batch(mip=None, eam=None, depth=None):
    def f(text):
        for name, n, was in (("MIP_BATCH", mip, 8), ("EAM_BATCH", eam, 8),
                             ("DEPTH_BATCH", depth, 2)):
            if n is not None:
                text = _edit(text, f"#define {name} {was}\n", f"#define {name} {n}\n")
        return text
    return f


# sample_volume's u8 path (u8_unit, with its zero test) under the signature
# of the source's u8 lookup
_U8_UNIT = """template <bool QC>
__device__ __forceinline__ float sample_volume_u8_unit(const void* t, int Dp, int Hp, int Wp,
                                                       float u, float v, float w) {
  return sample_volume(t, 1, Dp, Hp, Wp, u, v, w, nullptr, QC, false);
}

"""


def _u8_unit(text):
    text = _edit(text, "return sample_volume_u8<MODE == MM_U8_QC>(vol,",
                 "return sample_volume_u8_unit<MODE == MM_U8_QC>(vol,")
    marker = "// the volume density at (u, v, w) in MODE's table"
    return _edit(text, marker, _U8_UNIT + marker)


def _two_rows(text):
    return _edit(text, "  q.r1 = q.r0;\n",
                 "  q.r1 = q.raw ? t + (int64_t)min(by, Hp - 2) * (q.Wp - 1) : q.r0;\n", 1)


def _fmodf(text):
    return _edit(text, "mip_wrap_02(offset + (float)", "mip_wrap(offset + (float)", 2)


def _rgba(text):
    start = text.index("__device__ __forceinline__ float tf_alpha(const TfAt0& q, float x) {")
    end = text.index("\n}\n", start) + 3
    return (text[:start] + "__device__ __forceinline__ float tf_alpha(const TfAt0& q, float x) {\n"
            "  return tf_rgba(q, x).w;\n}\n" + text[end:])


def _mip_blocks(n=None):
    """K16's minimum of blocks an SM (None: no minimum in __launch_bounds__)."""
    bounds = "MARCH_THREADS" if n is None else f"MARCH_THREADS, {n}"
    return lambda text: _edit(text, "__launch_bounds__(MARCH_THREADS, 1)\nmip_kernel(",
                              f"__launch_bounds__({bounds})\nmip_kernel(")


def _min_blocks(eam=None, depth=None):
    """K15's minimum of blocks an SM for EAM and Depth."""
    def f(text):
        for name, n, was in (("EAM_MIN_BLOCKS", eam, 3), ("DEPTH_MIN_BLOCKS", depth, 8)):
            if n is not None:
                text = _edit(text, f"#define {name} {was}\n", f"#define {name} {n}\n")
        return text
    return f


def _chain(*edits):
    def f(text):
        for e in edits:
            text = e(text)
        return text
    return f


_ONE = _batch(1, 1, 1)
_PARENT_DESIGN = (_generic, _one_row, _ONE, _fmodf, _rgba, _u8_unit, _two_rows)
SETS = {
    "measure": {"source": lambda t: t},
    "final": {
        "source": lambda t: t,
        "mip batch 4": _batch(mip=4),
        "mip batch 16": _batch(mip=16),
        "mip without a minimum of blocks": _mip_blocks(None),
        "mip at 16 blocks": _mip_blocks(16),
        "eam at 1 block": _min_blocks(eam=1),
        "eam at 4 blocks": _min_blocks(eam=4),
        "eam batch 4": _batch(eam=4),
        "eam batch 16": _batch(eam=16),
        "depth at 1 block": _min_blocks(depth=1),
        "depth at 10 blocks": _min_blocks(depth=10),
        "depth at 12 blocks": _min_blocks(depth=12),
    },
    "ladder": {
        "parent design": _chain(*_PARENT_DESIGN),
        "+ mode": _chain(_one_row, _ONE, _fmodf, _rgba, _u8_unit, _two_rows),
        "+ wrap": _chain(_one_row, _ONE, _rgba, _u8_unit, _two_rows),
        "+ alpha words": _chain(_one_row, _ONE, _u8_unit, _two_rows),
        "+ u8 dequant": _chain(_one_row, _ONE, _two_rows),
        "+ one TF row": _chain(_one_row, _ONE),
        "+ tiles": _ONE,
        "+ batch (source)": lambda t: t,
    },
    "ablation": {
        "source": lambda t: t,
        "- mode": _generic,
        "- tiles": _one_row,
        "- batch": _ONE,
        "- wrap": _fmodf,
        "- alpha words": _rgba,
        "- u8 dequant": _u8_unit,
        "- one TF row": _two_rows,
        "parent design": _chain(*_PARENT_DESIGN),
    },
}


# the SASS symbols of each kernel key: this source's (by MarchMode m), the parent's
KERNELS = {
    "k16": ("mip_kernelILi{m}EE", "mip_kernelENS_5March"),
    "k15 eam": ("march_kernelILi0ELi{m}EE", "march_kernelILi0EE"),
    "k15 depth": ("march_kernelILi1ELi{m}EE", "march_kernelILi1EE"),
}


def sass_counts(lib: Path, symbol: str, batch: int):
    """Static SASS of the function whose name holds ``symbol`` in ``lib``:
    its instruction count, its three largest loops (instructions between a
    backward branch and its target) and the largest loop's count over
    ``batch`` (the instructions a sample of the batched loop)."""
    from vpt_tpu_torch.kernels import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    addrs, branches, inside, counts = [], [], False, {}
    for line in text.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = symbol in line
            continue
        if not inside:
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)
        if not m:
            continue
        addr, op = int(m.group(1), 16), m.group(2)
        addrs.append(addr)
        counts[op] = counts.get(op, 0) + 1
        t = re.search(r"0x([0-9a-f]+)", m.group(3))
        if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
            branches.append((int(t.group(1), 16), addr))
    loops = sorted((sum(1 for a in addrs if lo <= a <= hi) for lo, hi in branches), reverse=True)
    loads = {k: v for k, v in counts.items() if k.startswith(("LDG", "LD.", "LDL", "STL"))}
    return dict(instructions=len(addrs), loops=loops[:3],
                per_sample=(loops[0] / batch) if loops else None, loads=loads)


def _defines(text):
    return {k: int(v) for k, v in re.findall(r"#define (MIP_BATCH|EAM_BATCH|DEPTH_BATCH) (\d+)",
                                               text)}


def _only_modes(text, modes):
    """The dispatch cut to the instances of ``modes`` (MarchMode indices),
    so that a variant builds faster; the other modes' cases are dropped."""
    names = re.search(r"enum MarchMode \{(.*?)\};", text, re.S).group(1)
    names = re.findall(r"^\s*(MM_\w+)", names, re.M)[:-1]
    for i, n in enumerate(names):
        if i not in modes:
            text = _edit(text, f"VPT_MARCH_MODE({n})", "")
            text = _edit(text, f"VPT_MIP_MODE({n})", "")
    return text


def build(variants, tmp: Path, parent: Path | None, modes):
    """{label: (lib, ptxas rows, SASS by kernel)}, every library built at once."""
    from vpt_tpu_torch.kernels import _build

    jobs = {}
    if parent is not None:
        jobs["parent"] = (parent, None)
    for label, edit in variants.items():
        src = tmp / re.sub(r"[^\w]", "_", label)
        shutil.copytree(_build.CSRC_DIR, src)
        text = _only_modes(edit((src / "raymarch.cu").read_text()), modes)
        (src / "raymarch.cu").write_text(text)
        jobs[label] = (src, _defines(text))
    nvcc = _build.find_nvcc()
    procs = {label: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-o", str(tmp / f"{i}.so"), str(src / "raymarch.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (label, (src, _)) in enumerate(jobs.items())}
    out = {}
    for i, (label, proc) in enumerate(procs.items()):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(tmp / f"{i}.so"))
        for name, (args, res) in _build._SIGNATURES["raymarch"].items():
            getattr(lib, name).argtypes, getattr(lib, name).restype = args, res
        rows = [dict(kernel=k, template=t, registers=g, spill_store_bytes=s, spill_load_bytes=lo,
                     stack_frame_bytes=f)
                for k, t, g, s, lo, f in _build.ptxas_table(log)]
        defines = jobs[label][1]
        sass = {}
        for key, (sym, parent_sym) in KERNELS.items():
            for m in modes:
                if defines is None:
                    symbol, batch = parent_sym, 1
                else:
                    symbol = sym.format(m=m)
                    batch = defines[{"k16": "MIP_BATCH", "k15 eam": "EAM_BATCH",
                                     "k15 depth": "DEPTH_BATCH"}[key]]
                sass[f"{key} <{m}>"] = sass_counts(tmp / f"{i}.so", symbol, batch)
        out[label] = (lib, rows, sass)
    return out


def scenes(dev, modes):
    """{kernel key: (C call taking a library, output, plain output)}: K16,
    K15 EAM (merged into a random running average at frame 3) and Depth on
    phase 19's tables in ``modes``, and K15's frame alone on phase 20's."""
    import chip_smoke as CS
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import raymarch as RK
    from vpt_tpu_torch.models import raymarch as TR
    from vpt_tpu_torch.session import frame_seed

    inv, res = Camera().inverse_mvp(), CS.RM_RES
    offset = np.float32(TR._seed_to_offset(frame_seed(0, 1)))
    gen = torch.Generator(device=dev).manual_seed(5)
    acc0 = torch.rand((res, res, 3), generator=gen, device=dev)
    mip0 = torch.rand((res, res), generator=gen, device=dev) * 0.5
    frame = torch.tensor(3, dtype=torch.int32, device=dev)
    e, d, steps = CS.RM_EAM, CS.RM_DEPTH, CS.RM_MIP_STEPS
    out = {}
    for label, dens, tft, filt in CS.rm_modes(dev):
        mode = RK.march_mode(dens, tft, filt)
        if mode not in modes:
            continue
        vol = RK._volume_tensor(dens)
        m = RK.MARCH_MODES.index(mode)
        f_e, i_e = RK._params(inv, dens, tft, filt, res, e["slices"] + 1,
                              np.float32(1.0 / e["slices"]), offset,
                              extinction=np.float32(e["extinction"]))
        f_d, i_d = RK._params(inv, dens, tft, filt, res, d["slices"] + 1,
                              np.float32(1.0 / d["slices"]), offset,
                              extinction=np.float32(d["extinction"]),
                              threshold=np.float32(d["threshold"]))
        f_m, i_m = RK._params(inv, dens, tft, filt, res, steps, np.float32(1.0 / steps), offset)
        acc, img, mip = acc0.clone(), torch.empty_like(acc0), mip0.clone()
        out[f"k15 eam <{m}>"] = (
            lambda lib, f=f_e, i=i_e, vol=vol, tft=tft, acc=acc: lib.vpt_march(
                f.ctypes.data, i.ctypes.data, 0, vol.data_ptr(), tft.data_ptr(), acc.data_ptr(),
                frame.data_ptr(), None, K._stream(dev)), acc,
            RK.eam_pass_plain(acc0.clone(), frame, inv, dens, tft, e["extinction"], offset,
                              e["slices"], filt), acc0)
        out[f"k15 depth <{m}>"] = (
            lambda lib, f=f_d, i=i_d, vol=vol, tft=tft, img=img: lib.vpt_march(
                f.ctypes.data, i.ctypes.data, 1, vol.data_ptr(), tft.data_ptr(), None, None,
                img.data_ptr(), K._stream(dev)), img,
            RK.depth_pass_plain(inv, dens, tft, d["extinction"], d["threshold"], offset,
                                d["slices"], res, filt), None)
        out[f"k16 <{m}>"] = (
            lambda lib, f=f_m, i=i_m, vol=vol, tft=tft, mip=mip: lib.vpt_mip(
                f.ctypes.data, i.ctypes.data, vol.data_ptr(), tft.data_ptr(), mip.data_ptr(),
                K._stream(dev)), mip,
            RK.mip_pass_plain(mip0.clone(), inv, dens, tft, offset, steps, filt), mip0)
    F = CS.EAM_FIT
    truth, tft, cams = CS.eam_fit_scene(dev)
    inv1, off1 = cams[1].inverse_mvp(), np.float32(TR._seed_to_offset(1))
    f, i = RK._params(inv1, truth, tft, "linear", F["res"], F["slices"] + 1,
                      np.float32(1.0 / F["slices"]), off1, extinction=np.float32(F["extinction"]))
    img = torch.empty((F["res"], F["res"], 3), device=dev)
    out["k15 frame <4>"] = (
        lambda lib: lib.vpt_march(f.ctypes.data, i.ctypes.data, 0, truth.data_ptr(),
                                  tft.data_ptr(), None, None, img.data_ptr(), K._stream(dev)), img,
        RK.eam_frame(inv1, truth, tft, F["extinction"], off1, F["slices"], F["res"]), None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m probes.raymarch_variants")
    ap.add_argument("--parent", help="another checkout's vpt_tpu_torch/csrc")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", help="a file to append every printed line to")
    ap.add_argument("--set", choices=tuple(SETS), default="final")
    ap.add_argument("--modes", choices=("u8", "all"), default="u8")
    args = ap.parse_args(argv)

    def say(line):
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    if not torch.cuda.is_available():
        print("raymarch_variants: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    import chip_smoke as CS
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import raymarch as RK
    from vpt_tpu_torch.models import raymarch as TR
    from vpt_tpu_torch.session import frame_seed
    from vpt_tpu_torch.tools.gather_bench import graph_ms

    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda:0")
    modes = ("u8",) if args.modes == "u8" else ("u8", "f32", "u8 quasicubic", "nearest")
    calls = scenes(dev, modes)
    mode_ix = sorted({RK.MARCH_MODES.index(m) for m in modes} | {4, 7})

    if args.set == "measure":
        inv = Camera().inverse_mvp()
        offset = TR._seed_to_offset(frame_seed(0, 1))
        _, dens, tft, filt = CS.rm_modes(dev)[0]
        miss = CS.ray_miss(CS.RM_RES, Camera(), dev)
        for kind in ("mip", "eam", "depth"):
            reads, _ = CS.rm_replay(kind, inv, dens, tft, filt, offset)
            say(json.dumps(dict(pass_=kind, trips=CS.rm_trip_stats(reads.trips, miss))))

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(SETS[args.set], Path(tmp), Path(args.parent) if args.parent else None,
                     mode_ix)
        for label, (lib, _, _) in libs.items():
            for key, (call, got, want, start) in calls.items():
                for _ in range(2):  # a second launch: the tile queues start empty again
                    if start is not None:
                        got.copy_(start)
                    else:
                        got.fill_(float("nan"))
                    err = call(lib)
                    torch.cuda.synchronize()
                    if err:
                        raise RuntimeError(f"{label} {key}: CUDA error {err}")
                    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                        raise AssertionError(f"variant {label}, {key}: differs from the plain "
                                             "version")
        order = list(libs)
        turns = {label: {key: [] for key in calls} for label in order}
        if args.set != "measure":
            for k in range(args.rounds):
                for label in (order if k % 2 == 0 else order[::-1]):
                    for key, (call, *_rest) in calls.items():
                        turns[label][key].append(graph_ms(lambda: call(libs[label][0])))
        mean = {label: {key: (sum(t) / len(t) if t else None) for key, t in ts.items()}
                for label, ts in turns.items()}
        for label in order:
            say(json.dumps(dict(variant=label, ms=mean[label], turns_ms=turns[label],
                                spread_ms={k: (max(t) - min(t) if t else None)
                                           for k, t in turns[label].items()},
                                ptxas=libs[label][1], sass=libs[label][2])))
        if args.set != "measure":
            say(json.dumps(dict(ratio_to_first={
                label: {key: mean[label][key] / mean[order[0]][key] for key in calls}
                for label in order})))


if __name__ == "__main__":
    main()
