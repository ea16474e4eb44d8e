#!/usr/bin/env python3
"""Where the host's time goes in one full-width EG3D Gmain + Dmain under ADA,
for one or more checkouts on one CUDA card.

    python3 tools/ada_host_probe.py DIR [DIR ...] [--steps 6] [--aug_p 0.5]

Each checkout runs in its own process, with its own `chip_smoke.py` and
`gnerf_tpu_torch`: the `ffhq` preset's G and the 512^2 dual D
(`chip_smoke._full_width_eg3d`, aug='ada' at p = --aug_p), Gmain + Dmain
alone (cur_nimg set so that no regularization phase runs), three steps of
warm-up. It prints the step's wall ms on the host clock (the card
synchronized before and after, --steps steps), then, from three steps under
cProfile, the host ms per step: all of it, the part spent waiting for the
card (`item`, `cpu`, `tolist`, `synchronize`),
key splits and fold_ins (`utils.prng.split` / `fold_in` and, where a tree
has them, `torch.Generator` seeding), and draws (`utils.prng`'s draws and
torch's own random ops), with the functions of the step that take the most
host time. cProfile slows Python code, so its ms are for comparing parts
and trees, not step times.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

KEY_FUNCS = ("split", "fold_in", "PRNGKey", "step_generator", "_aug_generator")
DRAW_FUNCS = ("uniform", "normal", "bits", "randint")
TORCH_DRAWS = ("rand", "randn", "randint", "rand_like", "randn_like", "normal_", "uniform_",
               "bernoulli", "bernoulli_", "multinomial", "manual_seed")
WAITS = ("'item'", "'cpu'", "'tolist'", "synchronize")


def _part(stats) -> dict:
    """Host seconds by part from a pstats.Stats over the profiled steps."""
    out = dict(keys=0.0, draws=0.0, waits=0.0)
    for (path, _, func), (_, _, tt, ct, _) in stats.stats.items():
        ours = path.replace(os.sep, "/")
        if ours.endswith("utils/prng.py") and func in KEY_FUNCS:
            out["keys"] += ct
        elif ours.endswith("training/train.py") and func == "step_generator":
            out["keys"] += ct
        elif ours.endswith("training/eg3d_loss.py") and func == "_aug_generator":
            out["keys"] += ct
        elif ours.endswith("utils/prng.py") and func in DRAW_FUNCS:
            out["draws"] += ct
        elif path == "~" and any(f"'{n}'" in func or f".{n}>" in func for n in TORCH_DRAWS):
            out["draws"] += tt
        elif path == "~" and any(w in func for w in WAITS):
            out["waits"] += tt
    return out


def one(root: str, steps: int, aug_p: float) -> int:
    sys.path.insert(0, root)
    import cProfile
    import pstats

    import torch

    import chip_smoke as c
    from gnerf_tpu_torch.training import make_eg3d_phase_steps
    from gnerf_tpu_torch.utils.device import resolve_device

    print(c.card_line(), flush=True)
    resolve_device("cuda")
    c.phase_build()
    state, cfg = c._full_width_eg3d(0, aug="ada", aug_p=aug_p)
    phases = make_eg3d_phase_steps(cfg)
    batches = c._eg3d_batches(2)

    def step(i):
        state.cur_nimg = c.TRAIN_BATCH * (4 * i + 1)  # sched_idx % 4 == 1: Gmain + Dmain
        c._eg3d_step(phases, state, batches[i % 2], aug_p=aug_p)

    for i in range(3):
        step(i)
    torch.cuda.synchronize()
    walls = []
    for i in range(steps):
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    for i in range(3):
        prof.enable()
        step(i)
        torch.cuda.synchronize()
        prof.disable()
    profiled = (time.perf_counter() - t0) * 1e3 / 3
    stats = pstats.Stats(prof)
    part = {k: v * 1e3 / 3 for k, v in _part(stats).items()}
    walls.sort()
    print(f"[ada_host] {root}: Gmain + Dmain at p={aug_p}: wall {walls[len(walls) // 2]:.1f} ms "
          f"median of {steps} ({walls[0]:.1f}-{walls[-1]:.1f}); profiled {profiled:.1f} ms per "
          f"step: waiting for the card {part['waits']:.2f} ms, key splits {part['keys']:.2f} ms, "
          f"draws {part['draws']:.2f} ms", flush=True)
    top = sorted(((tt, f"{os.path.basename(p)}:{ln} {fn}", nc)
                  for (p, ln, fn), (_, nc, tt, _, _) in stats.stats.items()), reverse=True)
    for tt, name, nc in top[:15]:
        print(f"[ada_host]   self {tt * 1e3 / 3:8.2f} ms per step, {nc // 3:6d} calls: {name}",
              flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--aug_p", type=float, default=0.5)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        return one(os.path.abspath(args.roots[0]), args.steps, args.aug_p)
    failed = 0
    for root in args.roots:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), root, "--one",
                               "--steps", str(args.steps), "--aug_p", str(args.aug_p)],
                              cwd=root, capture_output=True, text=True)
        print(f"=== {root}: rc={proc.returncode}", flush=True)
        print("\n".join(line for line in proc.stdout.splitlines()
                        if line.startswith(("[ada_host]", "NVIDIA"))), flush=True)
        if proc.returncode:
            failed += 1
            print(proc.stderr[-3000:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
