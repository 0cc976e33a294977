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

    python -m vpt_tpu_torch.tools.ab_step --other DIR [--reps 50] [--rounds 2]

``DIR`` is another checkout of the repo (for example the parent commit
unpacked by ``git archive`` into a gitignored directory). Each checkout
builds its own kernels into its own ``vpt_tpu_torch/_build``. The two run
in turns, other, this, this, other (``--rounds`` times), one process each,
so that a drift of the card's clocks falls on both. A run is this file
started with ``--child`` inside the checkout: it imports that checkout's
``vpt_tpu_torch`` and ``chip_smoke`` (for the scene), so it uses only what
both sides of a change share. Per run it prints one JSON line (the
checkout, K1 ms per dispatch in each mode and K4 ms per 2 dispatches by
CUDA events, the ptxas rows), then one line of the means and the ratios
this / other. Needs a CUDA device; exits 1 without.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

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


def run_in(root: Path, reps: int) -> dict:
    """One timing process inside the checkout ``root``."""
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                          "--reps", str(reps)], cwd=root, env=env, capture_output=True, text=True)
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
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        # started as a file: import the checkout's package, not this directory
        here = Path(__file__).resolve().parent
        sys.path[:] = [q for q in sys.path if Path(q or ".").resolve() != here]
        print(json.dumps(child(args.reps)))
        return
    if args.other is None:
        p.error("--other is required")
    import torch

    if not torch.cuda.is_available():
        print("ab_step: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    other = Path(args.other).resolve()
    runs = {"other": [], "this": []}
    for side in ("other", "this", "this", "other") * args.rounds:
        rec = run_in(other if side == "other" else ROOT, args.reps)
        runs[side].append(rec)
        print(json.dumps(dict(side=side, **rec)), flush=True)
    mean = {side: {k: sum(r[k] for r in recs) / len(recs) for k in KEYS}
            for side, recs in runs.items()}
    ratio = {k: mean["this"][k] / mean["other"][k] for k in KEYS}
    raw = {side: [r["k1_raw_ms"] for r in recs if r.get("k1_raw_ms") is not None]
           for side, recs in runs.items()}
    k1_raw = {side: sum(v) / len(v) for side, v in raw.items() if v}
    print(json.dumps(dict(mean=mean, ratio=ratio, k1_raw_ms=k1_raw)))


if __name__ == "__main__":
    main()
