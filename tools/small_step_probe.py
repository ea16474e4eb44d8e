#!/usr/bin/env python3
"""The tiny G-NeRF train step of `chip_smoke.py` on the card against the CPU,
by trainable set, key and convolution library.

    python3 tools/small_step_probe.py [--card-draws]

For each trainable set (E and G's mapping, the default; all of G and D with
E in eval mode; D alone), with rng=None and seeded from the CLI's step key
of seed 0, with cuDNN on and off on the card, prints the largest relative
stat gap and the gradients' gaps (the Adam first moments of both
optimizers): the largest element's gap over its tensor's largest, with the
tensor, and the largest L2 gap over the tensor's norm. `chip_smoke.py`'s
small phase holds the rng=None step and the seeded step with D training to
1e-3 of each tensor's largest. `--card-draws` makes every draw of the
seeded CPU runs on the card and copies it to the CPU (the same key, so the
CPU step takes the card's values bit for bit, where its own normal values
differ from the card's in the last place): what stays of the seeded gap
then comes from the step's arithmetic, not from the draws.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SETS = {"E (default)": {}, "G + D, E eval": dict(train_gen=True, train_en=False),
        "D alone": dict(train_en=False)}


def _batch():
    import numpy as np
    from PIL import Image

    from gnerf_tpu_torch.training import SyntheticDataset, collate

    batch = collate([SyntheticDataset(resolution=16, depth_resolution=8, size=4)[i]
                     for i in range(2)])
    rs = np.random.RandomState(0)
    batch["condition_image"] = np.stack([np.asarray(Image.fromarray(
        rs.randint(0, 256, (8, 8, 3), np.uint8)).resize((64, 64), Image.BILINEAR))
        .transpose(2, 0, 1) for _ in range(2)])
    return batch


@contextlib.contextmanager
def _card_draws(on: bool):
    """While on, a draw asked for on the CPU is made on the card and copied
    back (`utils.prng`'s words all come from `threefry_draw` and
    `threefry_draws`)."""
    import torch

    from gnerf_tpu_torch.utils import prng

    plain, plain_many = prng.threefry_draw, prng.threefry_draws

    def card(key, shape, part=None, device=None, kind="bits", minval=0.0, maxval=1.0):
        dev = key.device if device is None else torch.device(device)
        if dev.type != "cpu":
            return plain(key, shape, part, device, kind, minval, maxval)
        return plain(key, shape, part, "cuda", kind, minval, maxval).cpu()

    def card_many(draws, device):
        if torch.device(device).type != "cpu":
            return plain_many(draws, device)
        return [x.cpu() for x in plain_many(draws, "cuda")]

    prng.threefry_draw, prng.threefry_draws = (card, card_many) if on else (plain, plain_many)
    try:
        yield
    finally:
        prng.threefry_draw, prng.threefry_draws = plain, plain_many


def _run(dev, kw, seeded, batch):
    import torch

    import chip_smoke
    from gnerf_tpu_torch.training import make_train_step
    from gnerf_tpu_torch.training.train import step_key

    state, cfg = chip_smoke._tiny_trainer(dev, **kw)
    names = {}
    for pre, m in (("g", state.g), ("enc", state.enc), ("disc", state.disc)):
        names.update({id(p): f"{pre}.{n}" for n, p in m.named_parameters()})
    _, stats = make_train_step(cfg)(
        state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
        step_key(0, 0) if seeded else None)
    grads = {}
    for opt in (state.opt_g, state.opt_d):
        for p in (p for grp in (opt.param_groups if opt else ()) for p in grp["params"]):
            if p in opt.state:
                grads[names[id(p)]] = opt.state[p]["exp_avg"].cpu()
    return {k: float(v) for k, v in stats.items()}, grads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--card-draws", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from gnerf_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        raise SystemExit("small_step_probe: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    resolve_device("cuda")
    batch = _batch()
    for cudnn in (True, False):
        for name, kw in SETS.items():
            for seeded in (False, True):
                if args.card_draws and not seeded:
                    continue
                with torch.backends.cudnn.flags(enabled=cudnn):
                    with _card_draws(args.card_draws):
                        sa, a = _run("cpu", kw, seeded, batch)
                    sb, b = _run("cuda", kw, seeded, batch)
                stat = max(abs(sb[k] - v) / max(abs(v), 1e-3) for k, v in sa.items())
                top = {k: float((b[k] - g).abs().max() / g.abs().max().clamp_min(1e-12))
                       for k, g in a.items()}
                l2 = max(float((b[k] - g).norm() / g.norm().clamp_min(1e-12))
                         for k, g in a.items())
                worst = max(top, key=top.get)
                how = "rng=None" if not seeded else (
                    "seeded, card draws" if args.card_draws else "seeded")
                print(f"cudnn={cudnn} {name:16s} {how:8s}: "
                      f"stats {stat:.2e}; gradients max {top[worst]:.2e} ({worst}), "
                      f"L2 {l2:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
