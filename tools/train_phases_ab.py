#!/usr/bin/env python3
"""Two checkouts' full-width train steps on one CUDA card, in turns.

    python3 tools/train_phases_ab.py BEFORE_DIR AFTER_DIR [--order baab] [--out DIR]

Runs `chip_smoke.py`'s train, eg3d and eg3d_ada phases of each checkout in
its own process (device, build, then the three phases: the G-NeRF step
median, the EG3D and EG3D-ADA amortised steps, each tree's own code), in
the order given (`a` = BEFORE_DIR, `b` = AFTER_DIR; default a, b, b, a, so
that a drift of the card shows in both), and prints each run's summary
lines: step ms, amortised step ms, per-phase medians, and whatever each
tree prints of its draws. Each run's whole output goes to
`OUT/ab_<i>_<a|b>.log`. Compare two versions only within one call.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

KEEP = ("step_ms", "amortised", "threefry share", "main: n=", "greg: n=", "dreg: n=",
        "[build] built")
PHASES = ("c.phase_device(); from gnerf_tpu_torch.utils.device import resolve_device; "
          "resolve_device('cuda'); c.phase_build(); c.phase_train(); c.phase_eg3d(); "
          "c.phase_eg3d_ada()")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--order", default="abba")
    ap.add_argument("--out", default="ab_logs")
    args = ap.parse_args(argv)
    roots = {"a": os.path.abspath(args.before), "b": os.path.abspath(args.after)}
    os.makedirs(args.out, exist_ok=True)
    failed = 0
    for i, which in enumerate(args.order):
        root = roots[which]
        code = f"import sys; sys.path.insert(0, {root!r}); import chip_smoke as c; {PHASES}"
        t0 = time.time()
        proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                              text=True)
        with open(os.path.join(args.out, f"ab_{i}_{which}.log"), "w") as fh:
            fh.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        print(f"=== run {i} {which} ({root}): rc={proc.returncode} {time.time() - t0:.1f} s",
              flush=True)
        for line in proc.stdout.splitlines():
            if any(k in line for k in KEEP):
                print(line, flush=True)
        if proc.returncode:
            failed += 1
            print(proc.stderr[-3000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
