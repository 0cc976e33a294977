"""The measurement behind K22's and K20's redesign (``mcs_frames_kernel`` in
``vpt_tpu_torch/csrc/mcs.cu``, ``mcm_step_kernel`` in ``csrc/mcm.cu``), kept
as the record of what each lever gave; no product path runs it.

Each kernel built several ways, each timed on one card: K22 on phase 22's
16-frame launch (``sphere_in_cube(128)`` as a packed u8 table, 512^2, the
frustum-filling camera, extinction 50), exact, with ``majorant_blocks=8``,
under phase 21's environment map, over phase 22's f32 volume (a smoothed
random density: short loops) and with ``max_collisions=16``; K20 on phase
21's launch of 16 dispatches (the bench volume's u8 table at 512^2, 8
steps, from the reset state) with the white texel and under the map. Every
variant is the source (the instances its scenes and the generic variant
run) with some of these edits, each taking one of its levers out:

K22 (``--kernel k22``):
- "per-pixel frame values" (``- frame values``): each lane takes a frame's
  light by ``sample_env_rgb`` and its quotients (``cube_exit``, the mean)
  by IEEE division instead of from the block's shared table;
- "six exit quotients" (``- exit faces``): ``cube_exit``'s two quotients on
  each axis, also where the direction's signs decide the face;
- "fresh diffuse" (``- diffuse from its trip``): the collision's density
  looked up again instead of taken from the trip that looked it up there;
- "generic" (``- mode``): the runtime-flag instance for every table;
- "one row" (``- tiles``): 128 pixels of the rows a block instead of an
  8 x 4 pixel tile a warp and 16 x 8 a block (K23's layout);
- "min blocks n": ``__launch_bounds__`` asking room for n blocks an SM
  (the source asks none);
- "one stream, ...", the design this PR timed first: each lane's frames as
  one stream of trips, a pass of the loop one trip of whichever loop the
  lane is in, and the lanes of a warp whose loop ended turning together
  (the shadow segment, or the frame's image and the next chain) once 8 of
  them wait or once their waited passes reach 32 lane-passes, or none
  runs.

K20 (``--kernel k20``):
- "generic" (``- mode``) and "tiles" as above; "min blocks n" / ``- 10
  blocks`` (no minimum): ``__launch_bounds__``'s minimum of blocks an SM
  (the source asks ``MCM_MIN_BLOCKS``, 10);
- "no one texel": the one-texel environment looked up like any map;
- "near point per respawn": the camera ray's near point computed at every
  respawn, also where blur is +0;
- "mean by quotients": the running mean by three IEEE divisions instead of
  one reciprocal and ``quot``;
- "cos, sin" (``- sincosf``): the disk's angle by two calls.

``--set ladder`` adds the levers one at a time to the variant with all of
them out, ``--set ablation`` takes each out of the source, ``--set all``
(the default) runs both. The parent is another checkout's ``csrc/``
(``--parent DIR``, e.g. the parent commit's ``vpt_tpu_torch/csrc`` unpacked
by ``git archive``), built and timed beside them.

Each variant is built with the loader's flags into a temporary directory
(all at once) and called through its C function with the parameters of the
wrappers (``kernels.mcs.frames``, ``kernels.mcm.step``). Every variant's
result must equal the source's bit for bit (the parent's too): K22's acc,
K20's 14 state fields. The variants run in turns (forward, then back,
``--rounds`` times) by device time (a CUDA graph of 20 calls; K20's calls
each copy the reset state first, less 20 copies). It prints the card; one
JSON line per variant (ms a launch by scene: every turn, the median and the
spread; the ptxas rows and the static SASS count of its u8 instance, or the
parent's); then the medians' ratios to the source. ``--out FILE`` appends
every printed line to FILE too. Needs a CUDA device; exits 1 without.

    python -m probes.mcs_mcm_variants [--kernel k22|k20|both] [--parent DIR]
        [--set all] [--rounds 3]   (from the root)
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
        raise RuntimeError(f"{old!r} not found")
    return text.replace(old, new)


def _chain(*edits):
    def f(text):
        for e in edits:
            text = e(text)
        return text
    return f


# ---------------------------------------------------------------------------
# K22 (csrc/mcs.cu)
# ---------------------------------------------------------------------------
def _k22_u8_only(text):
    """The dispatches instantiate MM_U8, MM_F32 and MM_GENERIC alone (the
    scenes' tables and the generic variant; K23 MM_U8)."""
    text = _edit(text, "    VPT_MCS_MODE(MM_U8) VPT_MCS_MODE(MM_F32) VPT_MCS_MODE(MM_U8_QC)\n"
                       "    VPT_MCS_MODE(MM_F32_QC) VPT_MCS_MODE(MM_NEAREST) "
                       "VPT_MCS_MODE(MM_GENERIC)\n",
                 "    VPT_MCS_MODE(MM_U8) VPT_MCS_MODE(MM_F32) VPT_MCS_MODE(MM_GENERIC)\n")
    return _edit(text, "    VPT_MCSP_MODE(MM_U8) VPT_MCSP_MODE(MM_F32) VPT_MCSP_MODE(MM_U8_QC)\n"
                       "    VPT_MCSP_MODE(MM_F32_QC) VPT_MCSP_MODE(MM_NEAREST) "
                       "VPT_MCSP_MODE(MM_GENERIC)\n",
                 "    VPT_MCSP_MODE(MM_U8)\n")


# frames_chunk's lanes as one stream of trips each (the design this PR
# timed first): each pass of the loop takes one trip of the loop the lane is
# in; a lane whose loop ended waits, and the waiting lanes of a warp take
# their turn together ({rule}): a collision's shadow segment, or the frame's
# image merged and the next frame's chain seeded
_ONE_STREAM = r"""  const int cap = P.i[SI_MAX_COLLISIONS];
  int k = 0, trips = 0;
  bool finished = !run, waiting = false;
  bool shadow = false;
  bool looked = false;
  uint32_t s = pcg_hash(base + 101u * F[0].seed);
  Segment cur = g;
  float dist = 0.0f, trans = 1.0f, density = 0.0f;
  int idle = 0;
  while (true) {
    if (!finished && !waiting) {
      bool over = trips >= cap;
      if (!over) {
        bool capped;
        float m;
        dist = dist + flight<MAJ>(s, P, ext, maj, cur, dist, capped, m);
        ++trips;
        looked = false;
        over = dist > cur.len;
        if (!over && !capped) {
          const float t = __fdiv_rn(dist, cur.den);
          const float d = mode_density<MODE>(vol, P, lerp(cur.fx, cur.tx, t),
                                             lerp(cur.fy, cur.ty, t), lerp(cur.fz, cur.tz, t));
          float alpha = mode_rgba<MODE>(tf, P, d).w;
          if (MAJ) alpha = nmin(__fdiv_rn(alpha, m), 1.0f);
          if (shadow) {
            trans = trans * (1.0f - alpha);
          } else {
            const float u = draw(s);
            density = d;
            looked = true;
            over = u < alpha;
          }
        }
        over = over || trips >= cap;
      }
      waiting = over;
    }
    const unsigned waits = __ballot_sync(0xffffffffu, waiting);
    const unsigned runs = __ballot_sync(0xffffffffu, !finished && !waiting);
    idle += __popc(waits);
    if (runs != 0 && !({rule})) continue;
    idle = 0;
    if (waits == 0) break;
    if (!waiting) continue;
    waiting = false;
    const McsFrame& f = F[k];
    if (!shadow && !(dist > cur.len)) {
      const float t = __fdiv_rn(dist, cur.den);
      const float cx = lerp(cur.fx, cur.tx, t), cy = lerp(cur.fy, cur.ty, t);
      const float cz = lerp(cur.fz, cur.tz, t);
      if (!looked) density = mode_density<MODE>(vol, P, cx, cy, cz);
      const float stf = cube_exit_frame(cx, cy, cz, f);
      cur = segment(cx, cy, cz, cx + f.dx.b * stf, cy + f.dy.b * stf, cz + f.dz.b * stf);
      shadow = true;
      dist = 0.0f;
      trans = 1.0f;
      trips = 0;
      continue;
    }
    float4 img = view;
    if (shadow) {
      const float4 diffuse = mode_rgba<MODE>(tf, P, density);
      const float3 light = f.light;
      img = make_float4(diffuse.x * light.x * trans, diffuse.y * light.y * trans,
                        diffuse.z * light.z * trans, diffuse.w * 1.0f * trans);
    }
    mean_add(a, img, f.n);
    if (++k == kn) {
      finished = true;
      continue;
    }
    s = pcg_hash(base + 101u * F[k].seed);
    cur = g;
    shadow = false;
    dist = 0.0f;
    trips = 0;
  }
}

"""


def _one_stream(rule):
    """The lanes as one stream of trips, turning by ``rule`` (a condition
    on the warp's waiting lanes ``waits`` and their waited passes
    ``idle``)."""
    def f(text):
        a = text.index("  const int cap = P.i[SI_MAX_COLLISIONS];\n  if (!run) return;")
        b = text.index("// K22: K frames per pixel merged into acc")
        return text[:a] + _ONE_STREAM.replace("{rule}", rule) + text[b:]
    return f


def _per_pixel_frame_values(text):
    """Each lane's light by sample_env_rgb, its quotients by IEEE division."""
    text = _edit(text, "const float2* __restrict__ maj) {\n  if (live && !run)",
                 "const float2* __restrict__ maj, const float* __restrict__ env) {\n"
                 "  if (live && !run)")
    text = _edit(text, "frames_chunk<MODE, MAJ>(a, live, run, base, ray, view, F, kn, P, ext, vol, tf, "
                       "maj);",
                 "frames_chunk<MODE, MAJ>(a, live, run, base, ray, view, F, kn, P, ext, vol, tf, maj, "
                 "env);")
    text = _edit(text, "const float3 light = f.light;",
                 "const float3 light = sample_env_rgb(env, P.i[SI_ENV_H], P.i[SI_ENV_W], f.dx.b, "
                 "f.dy.b, f.dz.b);")
    text = _edit(text, "const float stf = cube_exit_frame(cx, cy, cz, f);",
                 "const float stf = cube_exit(cx, cy, cz, f.dx.b, f.dy.b, f.dz.b);")
    for c in "xyzw":
        text = _edit(text, f"a.{c} = a.{c} + quot(img.{c} - a.{c}, n);",
                     f"a.{c} = a.{c} + __fdiv_rn(img.{c} - a.{c}, n.b);")
    return text


def _no_exit_faces(text):
    return _edit(text, "if (f.faces && isfinite(x) && isfinite(y) && isfinite(z))", "if (false)")


def _fresh_diffuse(text):
    return _edit(text, "if (!looked) density = mode_density<MODE>(vol, P, cx, cy, cz);",
                 "density = mode_density<MODE>(vol, P, cx, cy, cz);")


def _k22_generic(text):
    text = _edit(text, "return launch_frames<true>(mode,", "return launch_frames<true>(MM_GENERIC,")
    return _edit(text, "return launch_frames<false>(mode,", "return launch_frames<false>(MM_GENERIC,")


def _k22_rows(text):
    """128 pixels of the rows a block instead of 8 x 4 pixel tiles a warp."""
    text = _edit(text, "  int ix, iy, stream;\n  mcsp_pixel(res, ix, iy, stream);\n"
                       "  const bool live = ix < res && iy < res;  // every thread takes part in the "
                       "fills\n  const int pix = iy * res + ix;\n",
                 "  const int pix = blockIdx.x * MCS_THREADS + threadIdx.x;\n"
                 "  const bool live = pix < res * res;\n"
                 "  const int iy = pix / res, ix = pix - iy * res;\n")
    return _edit(text, "const dim3 grid((unsigned)((int64_t)blocks_for(res, MCSP_TILE_W) * "
                       "blocks_for(res, MCSP_TILE_H)));",
                 "const dim3 grid((unsigned)blocks_for(res * res, MCS_THREADS));")


def _k22_min_blocks(n):
    """``__launch_bounds__`` asking room for n blocks an SM."""
    return lambda text: _edit(text, "template <int MODE, bool MAJ>\n__global__ void "
                                    "__launch_bounds__(MCS_THREADS)\nmcs_frames_kernel(",
                              "template <int MODE, bool MAJ>\n__global__ void "
                              f"__launch_bounds__(MCS_THREADS, {n})\nmcs_frames_kernel(")


K22_LEVERS = (("frame values", _per_pixel_frame_values), ("exit faces", _no_exit_faces),
              ("diffuse from its trip", _fresh_diffuse), ("mode", _k22_generic),
              ("tiles", _k22_rows))
K22_EXTRA = {"one stream, 8 lanes turn": _one_stream("__popc(waits) >= 8"),
             "one stream, idle budget 32": _one_stream("idle >= 32"),
             **{f"min blocks {n}": _k22_min_blocks(n) for n in (6, 8, 10, 12)}}

# ---------------------------------------------------------------------------
# K20 (csrc/mcm.cu)
# ---------------------------------------------------------------------------


def _k20_u8_only(text):
    return _edit(text, "    VPT_MCM_MODE(MC_U8) VPT_MCM_MODE(MC_F32) VPT_MCM_MODE(MC_U8_QC) "
                       "VPT_MCM_MODE(MC_F32_QC)\n    VPT_MCM_MODE(MC_RAW) VPT_MCM_MODE(MC_RAW_QC) "
                       "VPT_MCM_MODE(MC_NEAREST)\n",
                 "    VPT_MCM_MODE(MC_U8)\n")


def _k20_generic(text):
    return _edit(text, "const int mode = P.i[MI_MODE];", "const int mode = MC_GENERIC;")


def _no_one_texel(text):
    return _edit(text, "c.one_texel && isfinite(L.dx) && isfinite(L.dy) && isfinite(L.dz)",
                 "false")


def _near_per_respawn(text):
    return _edit(text, "c.hoisted = __float_as_uint(P.f[MF_BLUR]) == 0u;", "c.hoisted = false;")


def _mean_by_quotients(text):
    text = _edit(text, "const Recip denom = recip((float)max(L.samples, 1));",
                 "const float denom = (float)max(L.samples, 1);")
    for c, e in (("r", "er"), ("g", "eg"), ("b", "eb")):
        text = _edit(text, f"L.r{c} = L.r{c} + quot({e} - L.r{c}, denom);",
                     f"L.r{c} = L.r{c} + __fdiv_rn({e} - L.r{c}, denom);")
    return text


def _cos_sin(text):
    return _edit(text, "if (respawn || scatter) draw_disk_sincos(s, kx, ky);",
                 "if (respawn || scatter) draw_disk(s, kx, ky);")


def _k20_tiles(text):
    """Over the pixel grid an 8 x 4 pixel tile a warp, 16 x 8 a block."""
    text = _edit(text, "  const int lane = blockIdx.x * blockDim.x + threadIdx.x;\n"
                       "  if (lane >= P.i[MI_N_LANES]) return;\n  uint32_t ix, iy;\n"
                       "  float sx, sy;\n  mcm_pixel(lane, P, lane_ix, lane_iy, ix, iy, sx, sy);\n"
                       "  const McmLaneConst c",
                 "  const int res = P.i[MI_RES], n = P.i[MI_N_LANES];\n  int lane;\n"
                 "  if (lane_ix == nullptr && n == res * res) {\n"
                 "    const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;\n"
                 "    const int tiles_x = (res + 15) / 16;\n"
                 "    const int px = (blockIdx.x % tiles_x) * 16 + (warp & 1) * 8 + (l & 7);\n"
                 "    const int py = (blockIdx.x / tiles_x) * 8 + (warp >> 1) * 4 + (l >> 3);\n"
                 "    if (px >= res || py >= res) return;\n    lane = py * res + px;\n"
                 "  } else {\n    lane = blockIdx.x * blockDim.x + threadIdx.x;\n"
                 "    if (lane >= n) return;\n  }\n  uint32_t ix, iy;\n  float sx, sy;\n"
                 "  mcm_pixel(lane, P, lane_ix, lane_iy, ix, iy, sx, sy);\n"
                 "  const McmLaneConst c")
    return _edit(text, "const dim3 grid((unsigned)blocks_for(n, MCM_THREADS));",
                 "const dim3 grid((unsigned)(lane_ix == nullptr && (int64_t)P.i[MI_RES] * "
                 "P.i[MI_RES] == n ? (int64_t)blocks_for(P.i[MI_RES], 16) * "
                 "blocks_for(P.i[MI_RES], 8) : blocks_for(n, MCM_THREADS)));")


def _k20_min_blocks(n):
    return lambda text: _edit(text, "#define MCM_MIN_BLOCKS 10", f"#define MCM_MIN_BLOCKS {n}")


def _k20_no_min_blocks(text):
    return _edit(text, "__launch_bounds__(MCM_THREADS, MCM_MIN_BLOCKS)",
                 "__launch_bounds__(MCM_THREADS)")


K20_LEVERS = (("mode", _k20_generic), ("one texel", _no_one_texel),
              ("near point once", _near_per_respawn), ("mean by a reciprocal", _mean_by_quotients),
              ("sincosf", _cos_sin), ("10 blocks", _k20_no_min_blocks))
K20_EXTRA = {"tiles": _k20_tiles, "min blocks 8": _k20_min_blocks(8),
             "min blocks 12": _k20_min_blocks(12)}


def variant_sets(levers, extra):
    """{set: {label: edit}}: the ladder (every lever out, then each put back
    in turn; its last step is the source) and the ablation (each lever out
    of the source, and the extra variants)."""
    ladder = {}
    for k in range(len(levers)):
        out = [edit for _, edit in levers[k:]]
        name = "all out" if k == 0 else "+" + levers[k - 1][0]
        ladder[name] = _chain(*out)
    ladder["+" + levers[-1][0] + " (the source)"] = lambda t: t
    ablation = {f"- {name}": edit for name, edit in levers}
    ablation.update(extra)
    return {"ladder": ladder, "ablation": ablation}


KERNELS = {
    "k22": dict(source="mcs.cu", fn="vpt_mcs_frames", sig="mcs", kernel="mcs_frames_kernel",
                mangled="kernelILi0ELb0EEEv", cut=_k22_u8_only,
                sets=variant_sets(K22_LEVERS, K22_EXTRA)),
    "k20": dict(source="mcm.cu", fn="vpt_mcm_step", sig="mcm", kernel="mcm_step_kernel",
                mangled="kernelILi0EEEv", cut=_k20_u8_only,
                sets=variant_sets(K20_LEVERS, K20_EXTRA)),
}


def sass_counts(lib: Path, kernel: str, pattern: str | None):
    """Static SASS of the ``kernel`` instance whose mangled name holds
    ``pattern`` (any, for None): its instruction count, 12 most frequent
    opcodes, local-memory and call instructions."""
    from vpt_tpu_torch.kernels import _build

    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    counts, inside = {}, False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line and (pattern is None or pattern in line)
            continue
        if inside:
            op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
            if op:
                counts[op.group(1)] = counts.get(op.group(1), 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:12]
    local = {k: v for k, v in counts.items() if k.split(".")[0] in ("STL", "LDL", "CALL")}
    return dict(instructions=sum(counts.values()), top=top, local_and_calls=local)


def build(spec, variants, tmp: Path, parent: Path | None):
    """{label: (C function, ptxas rows, SASS counts)}, every library built
    at once."""
    from vpt_tpu_torch.kernels import _build

    jobs = {}
    if parent is not None:
        jobs["parent"] = parent
    for k, (label, edit) in enumerate({"source": lambda t: t, **variants}.items()):
        src = tmp / f"{spec['sig']}{k}"
        shutil.copytree(_build.CSRC_DIR, src)
        f = src / spec["source"]
        f.write_text(spec["cut"](edit(f.read_text())))
        jobs[label] = src
    nvcc = _build.find_nvcc()
    procs = {label: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-o", str(tmp / f"{spec['sig']}_{i}.so"),
         str(src / spec["source"])], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, (label, src) in enumerate(jobs.items())}
    out = {}
    for i, (label, proc) in enumerate(procs.items()):
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label}:\n{log[-4000:]}")
        lib = tmp / f"{spec['sig']}_{i}.so"
        fn = getattr(ctypes.CDLL(str(lib)), spec["fn"])
        fn.argtypes, fn.restype = _build._SIGNATURES[spec["sig"]][spec["fn"]]
        rows = [dict(template=t, registers=g, spill_store_bytes=s, spill_load_bytes=lo,
                     stack_frame_bytes=fr)
                for k, t, g, s, lo, fr in _build.ptxas_table(log) if k == spec["kernel"]]
        sass = sass_counts(lib, spec["kernel"], None if label == "parent" else spec["mangled"])
        out[label] = (fn, rows, sass)
    return out


def k22_scenes(dev):
    """{label: launcher(fn, parent) -> (result tensor, launch)} on phase
    22's scene: the 16-frame launch of K22 as ``mcs_device_ms`` makes it."""
    import chip_smoke as CS
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import mcs as KS

    frames = [(k + 1) * 2654435761 % 2**32 for k in range(CS.MCS_FRAMES)]
    scenes = {}
    for label, vol, env, kw in CS.mcs_modes():
        if label not in ("u8", "majorant", "environment", "f32", "max_collisions=16"):
            continue
        r = CS.mcs_make_session(dev, vol, env, kw).renderer
        ctx, dirs = CS.mcs_inputs(r, frames)

        def launcher(fn, parent, r=r, ctx=ctx, dirs=dirs):
            f, i = KS._params(ctx, CS.RES, len(frames), r.max_collisions, r.volume.filter)
            inputs = torch.as_tensor(KS._frame_inputs(frames, dirs), device=dev)
            acc = torch.zeros((CS.RES, CS.RES, 4), dtype=torch.float32, device=dev)
            frame = torch.zeros((), dtype=torch.int32, device=dev)
            vol_t = KS.RK._volume_tensor(ctx.density)

            def launch():
                K._raise_on(fn(f.ctypes.data, i.ctypes.data, vol_t.data_ptr(),
                               ctx.tf_table.data_ptr(), ctx.environment.data_ptr(),
                               K._ptr(ctx.majorant), inputs.data_ptr(), acc.data_ptr(),
                               frame.data_ptr(), K._stream(dev)), "mcs_frames")
            return acc, launch, None
        scenes[label] = launcher
    return scenes


def k20_scenes(dev):
    """{label: launcher} on phase 21's scene: a launch of 16 dispatches from
    the reset state, each call copying the reset state into its working
    state first (``copy`` is timed alone and subtracted)."""
    import chip_smoke as CS
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import mcm as KM
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.models.mcm import MCMState

    cam = Camera()
    frames = [(k + 1) * 2654435761 % 2**32 for k in range(CS.MCM_FRAMES)]
    seeds_dev = torch.as_tensor(np.asarray(frames, np.uint32).view(np.int32), device=dev)
    scenes = {}
    for label, vol, env, pack, compaction in CS.mcm_modes():
        if label not in ("u8", "environment"):
            continue
        r = CS.mcm_renderer(vol, env, pack, compaction, dev)
        ctx = r.ctx(cam, 7)
        s0 = MCMState(**KM.reset(ctx, CS.RES, dev))

        def launcher(fn, parent, ctx=ctx, s0=s0):
            f, i = KM._params(ctx, CS.RES, s0.px.numel(), CS.STEPS, len(frames))
            if parent:  # the parent's block has no MI_MODE
                i = np.ascontiguousarray(i[:-1])
            work = CS.clone_state(s0)

            def copy():
                for a, b in zip(work.tensors(), s0.tensors()):
                    a.copy_(b)

            def launch():
                copy()
                K._raise_on(fn(f.ctypes.data, i.ctypes.data,
                               *(getattr(work, k).data_ptr() for k in KM.STATE_FIELDS),
                               K.density_table(ctx).data_ptr(), ctx.tf_table.data_ptr(),
                               ctx.environment.data_ptr(), 0, 0, seeds_dev.data_ptr(),
                               K._stream(dev)), "mcm_step")
            return work, launch, copy
        scenes[label] = launcher
    return scenes


def run_kernel(name, args, say, dev, tmp: Path):
    import chip_smoke as CS

    spec = KERNELS[name]
    variants = {}
    for set_name in (("ladder", "ablation") if args.set == "all" else (args.set,)):
        for label, edit in spec["sets"][set_name].items():
            variants[f"{set_name}: {label}"] = edit
    parent = Path(args.parent) if args.parent else None
    libs = build(spec, variants, tmp, parent)
    scenes = (k22_scenes if name == "k22" else k20_scenes)(dev)

    def snapshot(out):
        if torch.is_tensor(out):
            return out.clone()
        return [t.clone() for t in out.tensors()]

    def same(a, b):
        a, b = (a if isinstance(a, list) else [a]), (b if isinstance(b, list) else [b])
        return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8)) for x, y in zip(a, b))

    want = {}
    for label, launcher in scenes.items():
        out, launch, _ = launcher(libs["source"][0], False)
        launch()
        torch.cuda.synchronize()
        want[label] = snapshot(out)
    for vname, (fn, _, _) in libs.items():
        for label, launcher in scenes.items():
            out, launch, _ = launcher(fn, vname == "parent")
            launch()
            torch.cuda.synchronize()
            if not same(snapshot(out), want[label]):
                raise AssertionError(f"{name} variant {vname} ({label}) differs from the source")
    order = list(libs)
    copy_ms = {}
    for label, launcher in scenes.items():
        copy = launcher(libs["source"][0], False)[2]
        copy_ms[label] = CS.device_ms(copy) if copy is not None else 0.0
    turns = {(v, label): [] for v in order for label in scenes}
    for k in range(args.rounds):
        for v in (order if k % 2 == 0 else order[::-1]):
            for label, launcher in scenes.items():
                launch = launcher(libs[v][0], v == "parent")[1]
                turns[(v, label)].append(CS.device_ms(launch) - copy_ms[label])
    median = {}
    for v in order:
        median[v] = {label: float(np.median(turns[(v, label)])) for label in scenes}
        say(json.dumps(dict(
            kernel=name, variant=v, median_ms=median[v],
            turns_ms={label: turns[(v, label)] for label in scenes},
            spread_ms={label: max(turns[(v, label)]) - min(turns[(v, label)])
                       for label in scenes},
            ptxas=libs[v][1], sass=libs[v][2])))
    say(json.dumps(dict(kernel=name, copy_ms=copy_ms, ratio_to_source={
        v: {label: median[v][label] / median["source"][label] for label in scenes}
        for v in order})))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m probes.mcs_mcm_variants")
    ap.add_argument("--kernel", choices=("k22", "k20", "both"), default="both")
    ap.add_argument("--parent", help="another checkout's vpt_tpu_torch/csrc")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", help="a file to append every printed line to")
    ap.add_argument("--set", choices=("ladder", "ablation", "all"), default="all")
    args = ap.parse_args(argv)

    def say(line):
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    if not torch.cuda.is_available():
        print("mcs_mcm_variants: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    say(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda:0")
    from vpt_tpu_torch.kernels import _build

    _build.load()  # the scenes' renderers and resets run the checkout's kernels
    with tempfile.TemporaryDirectory() as tmp:
        for name in (("k22", "k20") if args.kernel == "both" else (args.kernel,)):
            run_kernel(name, args, say, dev, Path(tmp))
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
