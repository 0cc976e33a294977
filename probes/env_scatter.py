"""The measurement behind the environment adjoint's scatter
(``add_env_texels`` in ``vpt_tpu_torch/csrc/adjoint_common.cuh``), kept as
the record of how the shipped variant was chosen; no product path runs it.

The scatter three ways, on one card: K5
``prb_reverse`` and K12 ``surrogate_reverse`` over the env-lit bench scene
(512^2 x 4 streams, 128^3 u8 ``sphere_in_cube``, a seeded 256x512x3
equirect map, 12 bins, 8 steps, 2 dispatches), with an escape's 4 texel
terms added

- "warp": by 4 scalar atomics from one lane per (row, channel) of a warp,
  after the warp's lanes that add into the same row and channel have
  summed their terms (``__match_any_sync``, a tree of shuffles):
  ``add_env_texels`` in ``csrc/adjoint_common.cuh`` as the source has it;
- "scalar": by 4 scalar atomics from every lane;
- "float4": as the whole 12-wide row, 3 float4 atomics, 8 entries of 0.

    python -m probes.env_scatter [--reps 10]      (from the repo's root)

Each variant is the checkout's ``csrc/`` with ``add_env_texels``'s body
replaced, built with the loader's flags into a temporary directory and
swapped in for the loaded backward libraries. The variants run in turns
(forward, then back) on the same tapes, each held against the plain
versions (relative L2 per output). Per variant it prints one JSON line:
K5 ms at stride 1 and importance 4 with ``wrt={environment}`` and with all
five keys, K12 ms with all five adjoints, the relative errors, and the
ptxas rows of K5's stride-mode and K12's env instantiations. Needs a CUDA
device; exits 1 without.
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
from types import SimpleNamespace

import numpy as np
import torch

_SCALAR = """{
  float* p = g_env + row * 12 + band;
  atomicAdd(p, g * ((1 - fx) * (1 - fy)));
  atomicAdd(p + 3, g * (fx * (1 - fy)));
  atomicAdd(p + 6, g * ((1 - fx) * fy));
  atomicAdd(p + 9, g * (fx * fy));
}
"""

_FLOAT4 = """{
  const float w0 = g * ((1 - fx) * (1 - fy)), w1 = g * (fx * (1 - fy));
  const float w2 = g * ((1 - fx) * fy), w3 = g * (fx * fy);
  float v[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const float w = i < 3 ? w0 : i < 6 ? w1 : i < 9 ? w2 : w3;
    v[i] = (i % 3 == band) ? w : 0.0f;
  }
  float* p = g_env + row * 12;
  add4(p, v[0], v[1], v[2], v[3]);
  add4(p + 4, v[4], v[5], v[6], v[7]);
  add4(p + 8, v[8], v[9], v[10], v[11]);
}
"""

_WARP = None  # the shipped body

_BODY = re.compile(r"(__device__ __forceinline__ void add_env_texels\([^)]*\) )(\{.*?\n\})\n",
                   re.S)


def build_variant(body, out_dir: Path):
    """The backward libraries with ``add_env_texels``'s body replaced:
    (namespace of their C functions, ptxas rows)."""
    from vpt_tpu_torch.kernels import _build

    src = out_dir / "csrc"
    shutil.copytree(_build.CSRC_DIR, src)
    hdr = src / "adjoint_common.cuh"
    text = hdr.read_text()
    if not _BODY.search(text):
        raise RuntimeError("add_env_texels not found in adjoint_common.cuh")
    if body is not None:
        text = _BODY.sub(lambda m: m.group(1) + body.strip() + "\n", text, count=1)
        hdr.write_text(text)
    fns, log = {}, []
    nvcc = _build.find_nvcc()
    for stem in ("spectral_backward", "surrogate"):
        lib = out_dir / f"lib{stem}.so"
        r = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(src / f"{stem}.cu")],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {stem}:\n{r.stdout}{r.stderr}")
        log.append(r.stdout + r.stderr)
        cdll = ctypes.CDLL(str(lib))
        for name, (argtypes, restype) in _build._SIGNATURES[stem].items():
            fn = getattr(cdll, name)
            fn.argtypes, fn.restype = argtypes, restype
            fns[name] = fn
    rows = [dict(kernel=k, template=t, registers=g, spill_store_bytes=s, spill_load_bytes=lo)
            for k, t, g, s, lo, _ in _build.ptxas_table("\n".join(log))
            if (k == "reverse_kernel" and t == "0") or (k == "surrogate_reverse_kernel"
                                                        and t == "12,0,1")]
    return fns, rows


def _rel(a, p):
    return float((a - p).norm()) / max(float(p.norm()), 1e-30)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m probes.env_scatter")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("env_scatter: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    from vpt_tpu_torch import Camera
    from vpt_tpu_torch.kernels import _build
    from vpt_tpu_torch.kernels import spectral_backward as TB
    from vpt_tpu_torch.kernels import surrogate as S
    from vpt_tpu_torch.models.mcm_spectral import MCMSpectralRenderer
    from vpt_tpu_torch.tools.profile_fit import _bench_scene, seeded_envmap

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda:0")
    shipped = _build.load()
    r = MCMSpectralRenderer(*_bench_scene(), resolution=512, streams=4,
                            environment=seeded_envmap(), device=dev)
    cam = Camera()
    ctx, s0 = r.ctx(cam, 7), r.reset(cam, 7)
    seeds = [2654435761 * k % 2**32 for k in (3, 4)]
    lane, res, streams, n = TB._lanes(s0)
    rng = np.random.default_rng(0)
    g_img = torch.as_tensor(rng.uniform(-1, 1, (512, 512, 3)).astype(np.float32), device=dev)
    all5 = TB.ALL_WRT | {"environment"}

    # K5's cases: (wrt, tape, fields, deposit cotangents) x (stride, mode)
    k5_cases = {}
    for label, wrt in (("environment", frozenset({"environment"})), ("all", all5)):
        sk, tape = TB.tape_forward(s0, ctx, seeds, 8, 12, wrt)
        g_rs = TB._deposit_cotangents(g_img, ctx, lane, 12, TB._m_final(sk))
        for stride, mode in ((1, "stride"), (4, "importance")):
            k5_cases[f"{label}/{mode}{stride}"] = (wrt, tape, TB.ctx_tape_fields(ctx, wrt), g_rs,
                                                   stride, mode)

    def k5(case, plain=False):
        wrt, tape, fields, g_rs, stride, mode = k5_cases[case]
        adj = TB._packed_adj_init(ctx, wrt)
        cot = dict(c=torch.zeros(n, device=dev), cb=torch.zeros(n, device=dev))
        phases = [TB._dispatch_phase(k, s, len(seeds), stride) for k, s in enumerate(seeds)]
        kw = dict(scatter_stride=stride, inv_mu=TB._inv_mu(ctx), resolution=res, streams=streams)
        if plain:
            TB.prb_reverse_plain(tape, fields, g_rs, cot, adj, phases, seeds,
                                 importance=mode == "importance", **kw)
        else:
            TB.prb_reverse(tape, fields, g_rs, cot, adj, phases, seeds, scatter_mode=mode, **kw)
        return adj

    # K12's case: the surrogate tape and a seeded random carry
    s_out, tk = S.tape_forward(s0, ctx, seeds, 8, 12)
    flds = S.fields(False)

    def g(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)

    carry0 = dict(c=g(n), gp=[g(n) for _ in range(3)], gd=[g(n) for _ in range(3)],
                  grad=g(12, n) / 512.0)
    adj0 = TB._packed_adj_init(ctx, all5)

    def copy_carry():
        return {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
                for k, v in carry0.items()}

    def k12(plain=False):
        carry, adj = copy_carry(), {k: v.clone() for k, v in adj0.items()}
        (S.reverse_plain if plain else S.reverse)(tk, flds, s_out.samples, carry, adj, ctx, 12)
        return carry, adj

    want5 = {case: k5(case, plain=True) for case in k5_cases}
    want12 = k12(plain=True)

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
        for name, body in (("warp", _WARP), ("scalar", _SCALAR), ("float4", _FLOAT4)):
            fns, rows = build_variant(body, Path(tmp) / name)
            variants[name] = (SimpleNamespace(**{**vars(shipped), **fns}), rows)
        recs = {name: dict(variant=name, k5={}, k12_ms=[], ptxas=rows, rel={})
                for name, (_, rows) in variants.items()}
        order = list(variants) + list(reversed(variants))
        try:
            for name in order:
                _build._lib = variants[name][0]
                rec = recs[name]
                for case in k5_cases:
                    got = k5(case)
                    for k, v in want5[case].items():
                        rec["rel"][f"k5 {case} {k}"] = _rel(got[k], v)
                    rec["k5"].setdefault(case, []).append(ms(lambda: k5(case)))
                carry, adj = k12()
                for k, v in want12[1].items():
                    rec["rel"][f"k12 {k}"] = _rel(adj[k], v)
                rec["rel"]["k12 gd"] = _rel(torch.stack(carry["gd"]), torch.stack(want12[0]["gd"]))
                pool = iter([copy_carry() for _ in range(args.reps + 1)])
                adj_t = {k: v.clone() for k, v in adj0.items()}
                rec["k12_ms"].append(ms(lambda: S.reverse(tk, flds, s_out.samples, next(pool),
                                                          adj_t, ctx, 12)))
        finally:
            _build._lib = shipped
    for rec in recs.values():
        rec["k5_mean_ms"] = {c: float(np.mean(v)) for c, v in rec["k5"].items()}
        rec["k12_mean_ms"] = float(np.mean(rec["k12_ms"]))
        rec["max_rel"] = max(rec["rel"].values())
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
