"""The build's wall time per source, for this checkout's kernels and
another's, built in turns on one machine: how much a change to the CUDA
sources adds to the first ``kernels/_build.load()`` of every process that
runs them (``chip_smoke.py`` pays it inside its time limit). No product path
runs it.

    python -m vpt_tpu_torch.tools.build_times --other DIR [--order other,this,this,other]

``DIR`` is another checkout's root (e.g. the parent commit unpacked by
``git archive`` into the ignored ``_probe/``). Each build compiles every
``vpt_tpu_torch/csrc/*.cu`` of one tree at once, with the loader's nvcc and
flags (``_build.NVCC_FLAGS``), into a temporary directory, as ``load()``
does; the wall time of a build is its slowest source's. Per build it prints
one line, the total and each source's seconds (slowest first), and at the
end one JSON object of all of them. Needs nvcc; exits 1 without.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from vpt_tpu_torch.kernels import _build


def build_seconds(csrc: Path) -> dict:
    """Compiles every source of ``csrc`` at once; {"total": s, source: s}."""
    nvcc = _build.find_nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {s.name: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", f"{tmp}/{s.stem}.so",
                                           str(s)], stdout=subprocess.DEVNULL,
                                          stderr=subprocess.DEVNULL)
                 for s in sorted(csrc.glob("*.cu"))}
        done = {}
        while len(done) < len(procs):
            for name, p in procs.items():
                if name not in done and p.poll() is not None:
                    if p.returncode != 0:
                        raise RuntimeError(f"nvcc failed for {csrc / name}")
                    done[name] = round(time.perf_counter() - t0, 2)
            time.sleep(0.05)
    return {"total": max(done.values()), **done}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="another checkout's root")
    ap.add_argument("--order", default="other,this,this,other")
    args = ap.parse_args()
    try:
        _build.find_nvcc()
    except RuntimeError as e:
        print(f"build_times: {e}", file=sys.stderr)
        sys.exit(1)
    trees = {"this": _build.CSRC_DIR, "other": Path(args.other) / "vpt_tpu_torch" / "csrc"}
    out = []
    for name in args.order.split(","):
        rec = dict(tree=name, **build_seconds(trees[name]))
        out.append(rec)
        per = sorted(((k, v) for k, v in rec.items() if k.endswith(".cu")), key=lambda kv: -kv[1])
        print(f"# {name}: total {rec['total']:.2f} s; "
              + ", ".join(f"{k} {v:.2f}" for k, v in per), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
