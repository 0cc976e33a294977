"""Two checkouts' step kernels side by side on one card: K1
``mcm_spectral_step`` in its default, environment, quasicubic and majorant
modes and the default-mode K4 ``prb_tape_forward`` (all four keys) on
``chip_smoke``'s bench scene (512^2 x 4 streams, 128^3 u8
``sphere_in_cube``, 12 bins, 8 steps; its seeded 256x512 equirect map, its
quasicubic volume, a majorant grid of 16^3 blocks), with the ptxas
registers and spills of their 12-bin instantiations and of K5
``prb_reverse``'s. A checkout that renders raw tables also times K1 over
them (``pack_tables=False``, the RAW instantiation), printed beside the
ratios: the default K1 and K4 against the other checkout's show what the
raw template costs the packed builds.

With ``--what lao_slab`` it times instead K25 ``lao_frame`` through
``kernels.lao.lao_pass`` by device time (a CUDA graph of 20 calls) on phase
25's scene (the bench volume at 512^2, 64 slices, both terms) in the four
table modes of ``chip_smoke.mode_volumes``,
and the slab backward's reverse half of one dispatch at world size 1 (a
one-rank NCCL group): ``pair_buffer``, K5 ROUTED over a one-dispatch K4
tape of the bench scene (``wrt={density}``) and ``parallel.slab.
scatter_pairs`` (the pairs' all-gather and K29), whole calls by CUDA
events, host path included, and their device work alone (the kernels'
device time under torch.profiler, split by kernel), at stride 1, stride 4
and importance 4, with K5 ROUTED (and its new pair buffer) by CUDA events
and K29 (on one list) by device time (a CUDA graph of 20 calls) beside
them; the ptxas rows of
K25, K5 and K29.

With ``--what eam_mcsp`` it times K19 ``eam_backward`` without and with the
TF (``kernels.raymarch.eam_backward``) on phase 20's scene (the CLI's invert
scene at 512^2, 32 slices, the signed cotangent) over the 64^3 and 128^3
grids, and K23 ``mcs_persistent`` on phase 23's launch (512^2 x 4 streams, 8
steps, 16 dispatches from a warm state) in the modes of
``chip_smoke.mcsp_modes`` (u8, f32, quasicubic, nearest, the environment
map, the majorant, one stream), all by device time (a CUDA graph of 20
calls; K23's less the state copies, ``chip_smoke.mcsp_device_ms``), with
the ptxas rows of K19 and K23.

With ``--what mcs_mcm`` it times K22 ``mcs_frames`` on phase 22's 16-frame
launch (512^2, the frustum-filling camera, ``sphere_in_cube(128)``) in the
modes of ``chip_smoke.mcs_modes`` (u8, f32, quasicubic, nearest, the
environment map, the majorant, ``max_collisions=16``; ``chip_smoke.
mcs_device_ms``) and K20 ``mcm_step`` on phase 21's launch of 16 dispatches
from the reset state (512^2, the bench volume, 8 steps) in the modes of
``chip_smoke.mcm_modes`` (u8, f32, quasicubic, raw, nearest, the
environment map, the lane table; each call copying the reset state first,
less the copies), all by device time (a CUDA graph of 20 calls), with the
ptxas rows of K20-K23.

With ``--what raymarch`` it times K16 ``mip_pass``, K15 ``eam_pass``,
``eam_frame_pass`` and ``depth_pass`` on phase 19's scene (the bench volume
at 512^2, the JAX defaults, the session's first offset) in the four table
modes of ``chip_smoke.rm_modes`` (u8, f32, quasicubic, nearest) and on
BASELINE config 1's 64^3 raw tables (256^2, 64 slices, extinction 80), and
K15's frame alone on phase 20's 64^3 raw grid (``fit_density``'s), all by
device time (a CUDA graph of 20 calls), with the ptxas rows of K15-K19.
``--out FILE`` appends every printed line to FILE too.

    python -m vpt_tpu_torch.tools.ab_step --other DIR
        [--what step|lao_slab|eam_mcsp|mcs_mcm|raymarch] [--reps 50] [--rounds 2]

``DIR`` is another checkout of the repo (for example the parent commit
unpacked by ``git archive`` into a gitignored directory). Each checkout
builds its own kernels into its own ``vpt_tpu_torch/_build``. The two run
in turns, other, this, this, other (``--rounds`` times), one process each,
so that a drift of the card's clocks falls on both. A run is this file
started with ``--child`` inside the checkout: it imports that checkout's
``vpt_tpu_torch`` and ``chip_smoke`` (for the scene), so it uses only what
both sides of a change share. Per run it prints one JSON line (the
checkout, its times by CUDA events, the ptxas rows), then one line of the
means and the ratios this / other (with ``lao_slab``, ``eam_mcsp``,
``mcs_mcm`` and ``raymarch`` also the medians, their ratios and each side's
spread). Needs a CUDA device; exits 1 without.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
K1_MODES = ("default", "environment", "quasicubic", "majorant")
KEYS = tuple(f"k1_{m}_ms" for m in K1_MODES) + ("k4_ms",)


def child(reps: int) -> dict:
    """One timing run of the checkout on ``sys.path``: K1 in each mode (one
    dispatch per call) and the default K4 (2 dispatches per call), ``reps``
    calls each between CUDA events after one warm-up call."""
    import torch

    import chip_smoke as CS
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.kernels import spectral_backward as TB
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    dev, cam = torch.device("cuda:0"), Camera()
    one, two = [2654435761], [2654435761 * 3 % 2**32, 2654435761 * 4 % 2**32]
    extra = dict(default={}, environment=dict(environment=CS.seeded_envmap()), quasicubic={},
                 majorant=dict(majorant_blocks=16))
    out = {}
    for mode in K1_MODES:
        r = MCMSpectralRenderer(*CS.mode_args(mode == "quasicubic"), resolution=CS.RES,
                                streams=CS.STREAMS, device=dev, **extra[mode])
        ctx, state = r.ctx(cam, 7), r.reset(cam, 7)
        out[f"k1_{mode}_ms"] = ms(lambda: K.step(state, ctx, one, CS.STEPS, CS.BINS))
        if mode == "default":
            s0 = r.reset(cam, 7)
            out["k4_ms"] = ms(lambda: TB.tape_forward(s0, ctx, two, CS.STEPS, CS.BINS,
                                                      TB.ALL_WRT))
        del r, ctx, state
    try:
        r = MCMSpectralRenderer(*CS.mode_args(False), resolution=CS.RES, streams=CS.STREAMS,
                                pack_tables=False, device=dev)
    except NotImplementedError:  # a checkout without raw tables
        out["k1_raw_ms"] = None
    else:
        ctx, state = r.ctx(cam, 7), r.reset(cam, 7)
        out["k1_raw_ms"] = ms(lambda: K.step(state, ctx, one, CS.STEPS, CS.BINS))
        del r, ctx, state
    out["build_seconds"] = _build.build_info["seconds"]
    out["ptxas"] = [dict(kernel=k, template=t, registers=g, spill_store_bytes=s,
                         spill_load_bytes=lo, stack_frame_bytes=f)
                    for k, t, g, s, lo, f in _build.ptxas_table(_build.build_info["log"])
                    if (k in ("step_kernel", "tape_forward_kernel", "raw_tape_kernel",
                              "raw_replay_kernel") and t.split(",")[0] == "12")
                    or k == "reverse_kernel"]
    return out


def child_lao_slab(reps: int) -> dict:
    """One timing run of K25 in four table modes and of the slab
    backward's reverse half in three scatter modes, on the checkout on
    ``sys.path``, through the API both sides of a change share."""
    import torch

    import chip_smoke as CS
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.kernels import lao as KL
    from vpt_tpu_torch.kernels import slab as KS
    from vpt_tpu_torch.kernels import spectral_backward as TB
    from vpt_tpu_torch.models.lao import LAORenderer
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu_torch.parallel import mesh as Mesh
    from vpt_tpu_torch.parallel import slab as TS
    from vpt_tpu_torch.tools.gather_bench import graph_ms
    from vpt_tpu_torch.tools.profile_fit import device_kernels
    from torch.profiler import ProfilerActivity, profile

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    dev, cam = torch.device("cuda:0"), Camera()
    out = {}
    for label, v in CS.mode_volumes():
        r = LAORenderer(v, slices=CS.LAO_SLICES, resolution=CS.RM_RES, device=dev)
        args, kw = CS.lao_inputs(r, cam)
        out[f"k25 {label}_ms"] = graph_ms(lambda: KL.lao_pass(*args, **kw, cone=r._cone,
                                                              exact=r.exact_stop))
        del r

    mesh = Mesh.ray_mesh(device=dev)
    r = MCMSpectralRenderer(*CS.bench_scene_args(), resolution=CS.RES, streams=CS.STREAMS,
                            device=dev)
    ctx, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    seed = 2654435761 * 5 % 2**32
    fields = TB.ctx_tape_fields(ctx, CS.SLAB_WRT)
    sk, tape = TB.tape_forward(s0, ctx, [seed], CS.STEPS, CS.BINS, CS.SLAB_WRT)
    lane, res, streams, n = TB._lanes(s0)
    lanes = Mesh.lane_tables(mesh, CS.RES, CS.STREAMS)
    g_img = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (CS.RES, CS.RES, 3)).astype(
        np.float32), device=dev)
    g_rs = TB._deposit_cotangents(g_img, ctx, lane, CS.BINS, TB._m_final(sk))
    adj = torch.zeros((ctx.density.table.shape[0], 8), device=dev)
    for stride, mode in CS.MODES:
        phase = TB._dispatch_phase(0, seed, 1, stride)
        kw = dict(scatter_stride=stride, scatter_mode=mode, inv_mu=TB._inv_mu(ctx),
                  resolution=res, streams=streams, lanes=lanes)
        slots = CS.STEPS // stride

        def routed(pairs):
            cot = dict(c=torch.zeros(n, device=dev), cb=torch.zeros(n, device=dev))
            TB.prb_reverse(tape, fields, g_rs, cot, {}, [phase], [seed], pairs=pairs, **kw)

        def reverse_half():
            pairs = TB.pair_buffer(slots * n, dev)
            routed(pairs)
            TS.scatter_pairs(adj, pairs, mesh)

        kept = TB.pair_buffer(slots * n, dev)
        routed(kept)
        out[f"slab reverse {mode}{stride}_ms"] = ms(reverse_half)
        # the same calls' device work alone, under the profiler: the host's
        # gaps (allocation, NCCL's host side) left out
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                reverse_half()
            torch.cuda.synchronize()
        split = {k: v["ms"] / reps for k, v in device_kernels(prof).items()}
        out[f"slab reverse device {mode}{stride}_ms"] = sum(split.values()) or None
        out[f"slab reverse device {mode}{stride} split"] = split
        # K5 ROUTED with its buffer made as the main path makes it, K29 on one list
        out[f"k5 routed {mode}{stride}_ms"] = ms(lambda: routed(TB.pair_buffer(slots * n, dev)))
        out[f"k29 {mode}{stride}_ms"] = graph_ms(lambda: KS.slab_scatter(adj, 0, kept, 1))
        del kept
    out["build_seconds"] = _build.build_info["seconds"]
    out["ptxas"] = [dict(kernel=k, template=t, registers=g, spill_store_bytes=sp,
                         spill_load_bytes=lo, stack_frame_bytes=f)
                    for k, t, g, sp, lo, f in _build.ptxas_table(_build.build_info["log"])
                    if k in ("lao_frame_kernel", "reverse_kernel", "slab_scatter_kernel")]
    return out


def child_eam_mcsp() -> dict:
    """One timing run of K19 (both instances, two grids) and of K23 in
    phase 23's modes on the checkout on ``sys.path``, through the API both
    sides of a change share."""
    import torch

    import chip_smoke as CS
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.kernels import mcs as KS
    from vpt_tpu_torch.kernels import raymarch as RK
    from vpt_tpu_torch.models.raymarch import _seed_to_offset

    dev, F = torch.device("cuda:0"), CS.EAM_FIT
    truth, tft, cams = CS.eam_fit_scene(dev)
    inv, offset = cams[1].inverse_mvp(), np.float32(_seed_to_offset(1))
    gen = torch.Generator(device=dev).manual_seed(20)
    g = torch.rand((F["res"], F["res"], 3), generator=gen, device=dev) * 2.0 - 1.0
    out = {}
    for label, dens in ((f"{F['volume']}^3", truth), ("128^3", CS.eam_fit_scene(dev, 128)[0])):
        for tf in (False, True):
            args = (g, inv, dens, tft, F["extinction"], offset, F["slices"], "linear", tf)
            out[f"k19<{int(tf)}> {label}_ms"] = CS.device_ms(lambda: RK.eam_backward(*args))
    kw_p = dict(persistent=True, steps=CS.MCSP_STEPS, streams=CS.MCSP_STREAMS)
    for label, vol, env, kw in CS.mcsp_modes():
        r = CS.mcs_make_session(dev, vol, env, {**kw_p, **kw}).renderer
        warm = r.reset(None)
        KS.persistent(warm, r.ctx(CS.mcs_camera(), 1), CS.mcsp_seeds(1, CS.MCSP_DISPATCHES),
                      r.steps, r.volume.filter, r.streams)
        seeds = CS.mcsp_seeds(1 + CS.MCSP_DISPATCHES, CS.MCSP_DISPATCHES)
        out[f"k23 {label}_ms"] = CS.mcsp_device_ms(r, warm, seeds)
        del r, warm
        torch.cuda.empty_cache()
    out["build_seconds"] = _build.build_info["seconds"]
    out["ptxas"] = [dict(kernel=k, template=t, registers=r, spill_store_bytes=sp,
                         spill_load_bytes=lo, stack_frame_bytes=f)
                    for k, t, r, sp, lo, f in _build.ptxas_table(_build.build_info["log"])
                    if k in ("eam_backward_kernel", "mcs_persistent_kernel")]
    return out


def child_mcs_mcm() -> dict:
    """One timing run of K22 in phase 22's modes and of K20 in phase 21's
    modes on the checkout on ``sys.path``, through the API both sides of a
    change share."""
    import torch

    import chip_smoke as CS
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.kernels import mcm as KM
    from vpt_tpu_torch.kernels import mcm_spectral as K
    from vpt_tpu_torch.models.mcm import MCMState

    dev, out = torch.device("cuda:0"), {}
    frames = [(k + 1) * 2654435761 % 2**32 for k in range(CS.MCS_FRAMES)]
    for label, vol, env, kw in CS.mcs_modes():
        r = CS.mcs_make_session(dev, vol, env, kw).renderer
        ctx, dirs = CS.mcs_inputs(r, frames)
        out[f"k22 {label}_ms"] = CS.mcs_device_ms(r, ctx, frames, dirs)
        del r, ctx
        torch.cuda.empty_cache()
    lib, cam = _build.load(), Camera()
    seeds = [(k + 1) * 2654435761 % 2**32 for k in range(CS.MCM_FRAMES)]
    seeds_dev = torch.as_tensor(np.asarray(seeds, np.uint32).view(np.int32), device=dev)
    for label, vol, env, pack, compaction in CS.mcm_modes():
        r = CS.mcm_renderer(vol, env, pack, compaction, dev)
        ctx = r.ctx(cam, 7)
        lanes = None
        if compaction:
            t = r._compact_tables(cam)
            lanes = (t["lane_ix"], t["lane_iy"])
        s0 = MCMState(**KM.reset(ctx, CS.RES, dev, lanes))
        work = CS.clone_state(s0)
        f, i = KM._params(ctx, CS.RES, s0.px.numel(), CS.STEPS, len(seeds))
        ix, iy = lanes or (None, None)

        def copy():
            for a, b in zip(work.tensors(), s0.tensors()):
                a.copy_(b)

        def launch():
            copy()
            K._raise_on(lib.vpt_mcm_step(
                f.ctypes.data, i.ctypes.data, *(getattr(work, k).data_ptr() for k in KM.STATE_FIELDS),
                K.density_table(ctx).data_ptr(), ctx.tf_table.data_ptr(), ctx.environment.data_ptr(),
                K._ptr(ix), K._ptr(iy), seeds_dev.data_ptr(), K._stream(dev)), "mcm_step")

        out[f"k20 {label}_ms"] = CS.device_ms(launch) - CS.device_ms(copy)
        del r, ctx, s0, work
        torch.cuda.empty_cache()
    out["build_seconds"] = _build.build_info["seconds"]
    out["ptxas"] = [dict(kernel=k, template=t, registers=r, spill_store_bytes=sp,
                         spill_load_bytes=lo, stack_frame_bytes=f)
                    for k, t, r, sp, lo, f in _build.ptxas_table(_build.build_info["log"])
                    if k in ("mcs_frames_kernel", "mcs_persistent_kernel", "mcm_step_kernel",
                             "mcm_reset_kernel")]
    return out


def child_raymarch() -> dict:
    """One timing run of K16, K15 EAM (merged into a running average, and
    the frame alone) and K15 Depth on phase 19's scene in its four table
    modes and on BASELINE config 1's 64^3 raw tables, and of K15's frame
    alone on phase 20's 64^3 raw grid, on the checkout on ``sys.path``,
    through the wrappers both sides of a change share."""
    import torch

    import chip_smoke as CS
    from vpt_tpu_torch import Camera, Volume
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.kernels import raymarch as RK
    from vpt_tpu_torch.models import raymarch as TR
    from vpt_tpu_torch.scene.camera import OrbitController
    from vpt_tpu_torch.session import frame_seed

    dev, out = torch.device("cuda:0"), {}
    offset = TR._seed_to_offset(frame_seed(0, 1))
    d, steps = CS.RM_DEPTH, CS.RM_MIP_STEPS

    def time_modes(label, inv, dens, tft, filt, res, extinction, slices):
        acc = torch.zeros((res, res, 3), device=dev)
        frame = torch.tensor(3, dtype=torch.int32, device=dev)
        mip = torch.zeros((res, res), device=dev)
        out[f"k16 {label}_ms"] = CS.device_ms(
            lambda: RK.mip_pass(mip, inv, dens, tft, offset, steps, filt))
        out[f"k15 eam {label}_ms"] = CS.device_ms(
            lambda: RK.eam_pass(acc, frame, inv, dens, tft, extinction, offset, slices, filt))
        out[f"k15 eam frame {label}_ms"] = CS.device_ms(
            lambda: RK.eam_frame_pass(inv, dens, tft, extinction, offset, slices, res, filt))
        out[f"k15 depth {label}_ms"] = CS.device_ms(
            lambda: RK.depth_pass(inv, dens, tft, d["extinction"], d["threshold"], offset,
                                  d["slices"], res, filt))

    inv = Camera().inverse_mvp()
    for label, dens, tft, filt in CS.rm_modes(dev):
        time_modes(label, inv, dens, tft, filt, CS.RM_RES, CS.RM_EAM["extinction"],
                   CS.RM_EAM["slices"])
    # BASELINE config 1: 64^3, 256^2, 64 slices, extinction 80, raw tables
    cam1 = Camera()
    OrbitController(yaw=0.5, pitch=-0.3).apply(cam1)
    tf1 = np.zeros((256, 256, 4), np.float32)
    tf1[..., :3] = (0.9, 0.7, 0.4)
    tf1[..., 3] = np.linspace(0, 1, 256)[None, :]
    time_modes("config 1", cam1.inverse_mvp(),
               torch.as_tensor(Volume.sphere_in_cube(64).density, device=dev),
               torch.as_tensor(tf1, device=dev), "linear", 256, 80.0, 64)
    F = CS.EAM_FIT
    truth, tft, cams = CS.eam_fit_scene(dev)
    args = (cams[1].inverse_mvp(), truth, tft, F["extinction"], np.float32(TR._seed_to_offset(1)),
            F["slices"], F["res"])
    out["k15 fit frame_ms"] = CS.device_ms(lambda: RK.eam_frame_pass(*args))
    out["build_seconds"] = _build.build_info["seconds"]
    out["ptxas"] = [dict(kernel=k, template=t, registers=r, spill_store_bytes=sp,
                         spill_load_bytes=lo, stack_frame_bytes=f)
                    for k, t, r, sp, lo, f in _build.ptxas_table(_build.build_info["log"])
                    if k in ("march_kernel", "mip_kernel", "iso_kernel", "iso_shade_kernel",
                             "eam_backward_kernel")]
    return out


CHILDREN = {"step": child, "lao_slab": child_lao_slab, "eam_mcsp": lambda reps: child_eam_mcsp(),
            "mcs_mcm": lambda reps: child_mcs_mcm(), "raymarch": lambda reps: child_raymarch()}


def run_in(root: Path, reps: int, what: str) -> dict:
    """One timing process inside the checkout ``root``."""
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                          "--reps", str(reps), "--what", what], cwd=root, env=env,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"ab_step in {root} failed:\n{out.stderr[-4000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    rec["checkout"] = str(root)
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m vpt_tpu_torch.tools.ab_step")
    p.add_argument("--other", help="another checkout of the repo")
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--what", choices=tuple(CHILDREN), default="step")
    p.add_argument("--out", help="a file to append every printed line to")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        # started as a file: import the checkout's package, not this directory
        here = Path(__file__).resolve().parent
        sys.path[:] = [q for q in sys.path if Path(q or ".").resolve() != here]
        print(json.dumps(CHILDREN[args.what](args.reps)))
        return
    if args.other is None:
        p.error("--other is required")
    import torch

    if not torch.cuda.is_available():
        print("ab_step: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()

    def say(line):
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    say(smi)
    other = Path(args.other).resolve()
    runs = {"other": [], "this": []}
    for side in ("other", "this", "this", "other") * args.rounds:
        rec = run_in(other if side == "other" else ROOT, args.reps, args.what)
        runs[side].append(rec)
        say(json.dumps(dict(side=side, **rec)))
    if args.what != "step":
        keys = [k for k in runs["this"][0] if k.endswith("_ms") and k in runs["other"][0]
                and all(r.get(k) is not None for recs in runs.values() for r in recs)]
        mean = {side: {k: sum(r[k] for r in recs) / len(recs) for k in keys}
                for side, recs in runs.items()}
        spread = {side: {k: max(r[k] for r in recs) - min(r[k] for r in recs) for k in keys}
                  for side, recs in runs.items()}
        median = {side: {k: float(np.median([r[k] for r in recs])) for k in keys}
                  for side, recs in runs.items()}
        say(json.dumps(dict(mean=mean, median=median, spread=spread,
                            ratio={k: mean["this"][k] / mean["other"][k] for k in keys},
                            median_ratio={k: median["this"][k] / median["other"][k]
                                          for k in keys})))
        return
    mean = {side: {k: sum(r[k] for r in recs) / len(recs) for k in KEYS}
            for side, recs in runs.items()}
    ratio = {k: mean["this"][k] / mean["other"][k] for k in KEYS}
    raw = {side: [r["k1_raw_ms"] for r in recs if r.get("k1_raw_ms") is not None]
           for side, recs in runs.items()}
    k1_raw = {side: sum(v) / len(v) for side, v in raw.items() if v}
    say(json.dumps(dict(mean=mean, ratio=ratio, k1_raw_ms=k1_raw)))


if __name__ == "__main__":
    main()
