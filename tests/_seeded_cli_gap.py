#!/usr/bin/env python3
"""How far two steps of the default `--objective gnerf` CLI run from `--seed`
move each network: the port's run against the JAX CLI's, and the port's run
against itself with 4 CPU threads instead of 1 (a change of summation order
alone).

    JAX_PLATFORMS=cpu python3 tests/_seeded_cli_gap.py [--threads 4]

Runs both CLIs on the CPU at the tests' tiny widths (the `tiny_clis` set-up
of tests/test_torch_seeded_cli.py: E, G's mapping and the depth D train)
and prints, per snapshot network, the share of values off rtol 1e-4 / atol
1e-5 and the largest gap, then each run's validation metrics. A few
minutes: the JAX CLI compiles its step. A script beside the tests, not a
test: it imports both packages, as only the tests may.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TESTS))
sys.path.insert(0, TESTS)


def _gaps(a_dir, b_dir) -> dict:
    import numpy as np

    from gnerf_tpu.utils import checkpoint as jckpt

    snap = "network-snapshot-final.npz"
    a, _ = jckpt.load_checkpoint(os.path.join(a_dir, snap))
    b, _ = jckpt.load_checkpoint(os.path.join(b_dir, snap))
    out = {}
    for root in sorted(a):
        fa, fb = jckpt.flatten_tree(a[root]), jckpt.flatten_tree(b[root])
        off = sum(int((~np.isclose(fa[k], fb[k], rtol=1e-4, atol=1e-5)).sum()) for k in fa)
        n = sum(v.size for v in fa.values())
        top = max(float(np.abs(fa[k] - fb[k]).max()) for k in fa)
        out[root] = (off, n, top)
    return out


def _val(run_dir) -> dict:
    with open(os.path.join(run_dir, "stats.jsonl")) as fh:
        stats = json.loads(fh.readline())
    return {k: v for k, v in stats.items() if k.startswith("Metrics/")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    import torch
    from _pytest.monkeypatch import MonkeyPatch

    import test_torch_seeded_cli as cli
    from gnerf_tpu_torch.training.train import run_training

    mp = MonkeyPatch()
    cli.tiny_clis.__wrapped__(mp)
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        port_dir, jax_dir = cli.run_both(pathlib.Path(tmp))
        torch.set_num_threads(args.threads)
        other = run_training(outdir=os.path.join(tmp, "port_threads"), device="cpu",
                             dataset_name="synthetic", batch=2, kimg=0.004, tick=1, snap=1,
                             seed=3, z_dim=32, w_dim=32)
        for name, (a, b) in (("port vs JAX", (port_dir, jax_dir)),
                             (f"port vs port at {args.threads} threads", (port_dir, other))):
            for root, (off, n, top) in _gaps(a, b).items():
                print(f"{name}: {root} {off} of {n} off ({off / n:.2%}), largest gap {top:.3e}",
                      flush=True)
        for name, d in (("JAX", jax_dir), ("port", port_dir),
                        (f"port at {args.threads} threads", other)):
            print(f"validation {name}: {_val(d)}", flush=True)
    mp.undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
