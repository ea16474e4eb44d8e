"""OFFLINE converter: torchvision `inception_v3` weights -> npz for FID,
without JAX (the port's `tools/convert_inception.py`).

    python -m gnerf_tpu_torch.tools.convert_inception --pt inception_v3_google-*.pth \
        --out inception_fid.npz

Accepts a torchvision state_dict checkpoint (or a full module / torchscript
that exposes state_dict) and writes, through
`training/inception.py::convert_torch_inception`, the npz that
`training.inception.load_inception` (and the JAX package's) reads: pinned
pretrained features, so Frechet numbers are comparable across runs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..training.inception import convert_torch_inception
from ..utils import checkpoint as ckpt_lib


def convert(pt: str, out: str) -> int:
    """Converts the weights `pt` into the npz `out`; returns the number of
    parameters written."""
    obj = torch.load(pt, map_location="cpu")
    if not isinstance(obj, dict):
        obj = obj.state_dict()
    state = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
             for k, v in obj.items()}
    tree = convert_torch_inception(state)
    ckpt_lib.save_checkpoint(
        out, {"inception": tree},
        config={"source": os.path.basename(pt), "pretrained": True,
                "feature": "pool3-2048"})
    n = sum(v.size for v in ckpt_lib.flatten_tree(tree).values())
    print(f"wrote {out}: {n / 1e6:.1f}M params")
    return n


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pt", required=True,
                    help="torchvision inception_v3 .pth (state_dict)")
    ap.add_argument("--out", required=True, help="output .npz path")
    args = ap.parse_args(argv)
    convert(args.pt, args.out)


if __name__ == "__main__":
    main()
