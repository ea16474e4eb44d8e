"""Readings that the limits of `correct` are set from: the program's gap to
the reference and the control's, per seed, at the cell's own size.

    python3 benchmark/calibrate.py --workload orbit-ffhq512 --seeds 11,12,13 --seconds 3

For each seed one process sets the cell up, runs its traffic for a short
window at the cell's own load, frees the program and computes the compared
number twice over the same sampled outputs: the program against the
reference (the lower reading), and the control against the reference (the
upper reading). The control is the reference in the program's place one
precision below the configuration's: bf16 parts in float8 e4m3, fp32 parts
with TF32 on. Prints one JSON line per seed. The benchmark's runs never run
this; `tests/test_bench_correct.py` runs it on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import gnerf_infer, harness  # noqa: E402
from benchmark.reference import gnerf as ref  # noqa: E402


def readings(workload: str, seed: int, seconds: float, device: str = "cuda", cell=None) -> dict:
    """{"seed", "lower", "upper", "frames"} for one seed of an inference
    cell; for a training cell, see `train_readings`."""
    import torch

    cell = cell or harness.load_cell(workload)
    cell.seed, cell.seconds, cell.device = seed, seconds, device
    drv = harness.driver(cell.traffic["kind"]).Driver(cell, lambda msg: None)
    drv.setup()
    if cell.traffic["kind"] == "train":
        return train_readings(workload, seed, drv)
    drv.window(seconds)
    drv.release()
    samples = drv.samples()
    poses = [s[:3] for s in samples]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        dtype = gnerf_infer.DTYPES[cell.config["dtype"]["backbone"]]
        want = gnerf_infer.reference_frames(cell, drv.s.host, drv.s.photos, poses, dtype)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        control = gnerf_infer.reference_frames(cell, drv.s.host, drv.s.photos, poses, ref.FP8)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    got = [s[3] for s in samples]
    return {"workload": workload, "seed": seed, "frames": len(samples),
            "lower": gnerf_infer.worst_mad(want, got),
            "upper": gnerf_infer.worst_mad(control, want),
            "lower_max_gap": gnerf_infer.max_gap(want, got),
            "upper_max_gap": gnerf_infer.max_gap(control, want),
            "lower_each": [gnerf_infer.worst_mad([w], [g]) for w, g in zip(want, got)]}


def train_readings(workload: str, seed: int, drv) -> dict:
    """A training cell's gaps for one seed: the program's checked steps
    against the reference (lower), the reference with TF32 on (the
    control), and the reference with half of each batch left out (a
    planted fault), each against the reference."""
    import torch

    from benchmark.drivers.train import GAPS, compare

    drv.release()
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        want = drv.reference_readings()
        half = drv.reference_readings(half=True)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        control = drv.reference_readings()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    out = {"workload": workload, "seed": seed}
    for name, got in (("lower", drv.readings), ("control", control), ("half_batch", half)):
        gaps = compare(got, want)
        out[name] = {k: gaps[k] for k in GAPS}
        out[name + "_left_out"] = gaps["left_out"]
    out["losses"] = {"program": drv.readings["losses"], "reference": want["losses"]}
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    harness.card(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds)), flush=True)


if __name__ == "__main__":
    main()
