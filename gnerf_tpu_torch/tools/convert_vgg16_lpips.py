"""OFFLINE converter: NVIDIA `vgg16.pt` (TorchScript LPIPS net) -> npz,
without JAX (the port's `tools/convert_vgg16_lpips.py`).

The reference training loop downloads
`stylegan2-ada-pytorch/pretrained/metrics/vgg16.pt` and uses
`vgg16(img_0_255, resize_images=True, return_lpips=True)` as its perceptual
loss (reference `training/training_loop.py:177-179,345-354`). This tool
ingests that torchscript (or a plain state_dict with the same tensors) into
the `VGG16LPIPS` layout both packages read:

    python -m gnerf_tpu_torch.tools.convert_vgg16_lpips --pt vgg16.pt \
        --out lpips_vgg16.npz [--device cpu]

Mapping is by shape sequence (13 3x3 conv layers following the VGG16
config, five per-channel LPIPS linear weights of dims 64/128/256/512/512,
optional ScalingLayer shift/scale buffers). The LPIPS linears are stored as
sqrt(w) because `VGG16LPIPS` folds them into the embedding
(sum((sqrt(w)*df)^2) == sum(w*df^2), `training/losses.py::VGG16LPIPS.apply`).

Because the exact preprocessing inside the torchscript (resize target,
interpolation antialiasing, whitening) is not recoverable from tensors
alone, the converter CALIBRATES: it runs the live torchscript and the
port's `VGG16LPIPS` side by side on random image pairs, on `--device` (the
card unless named; fp32 with TF32 off), over a small grid of candidate
configs and keeps the one that reproduces the torchscript's LPIPS
distances, refusing to write output if none matches. The chosen config and
residual error are recorded in the npz metadata and picked up by
`losses.load_lpips`.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..training.losses import VGG16LPIPS
from ..utils.checkpoint import load_jax_params
from ..utils.device import resolve_device

# VGG16 conv channel sequence (torchvision "D" config).
VGG_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
LPIPS_DIMS = (64, 128, 256, 512, 512)
# richzhang/PerceptualSimilarity ScalingLayer constants — used as a
# calibration candidate when the torchscript does not expose its own.
RZ_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
RZ_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)


def extract_tensors(obj) -> dict:
    """Named tensors of a torchscript module / nn.Module / state_dict."""
    if isinstance(obj, dict):
        return {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                              else v, dtype=np.float32) for k, v in obj.items()}
    out = {}
    for name, p in obj.named_parameters():
        out[name] = p.detach().cpu().numpy().astype(np.float32)
    for name, b in obj.named_buffers():
        out[name] = b.detach().cpu().numpy().astype(np.float32)
    return out


def map_params(sd: dict) -> dict:
    """Shape-sequence mapping into the VGG16LPIPS param tree (numpy)."""
    convs = [(k, v) for k, v in sd.items()
             if v.ndim == 4 and v.shape[2:] == (3, 3)]
    if len(convs) != len(VGG_CHANNELS):
        raise ValueError(
            f"expected {len(VGG_CHANNELS)} 3x3 conv weights, found "
            f"{len(convs)}: {[k for k, _ in convs]}")
    # Keep archive traversal order and verify it follows the VGG16 config.
    in_c = 3
    params: dict = {}
    for i, ((k, w), out_c) in enumerate(zip(convs, VGG_CHANNELS)):
        if w.shape[:2] != (out_c, in_c):
            raise ValueError(
                f"conv {i} ({k}) has shape {w.shape}, expected "
                f"({out_c}, {in_c}, 3, 3) — archive order does not follow "
                "the VGG16 layer sequence")
        bias_key = k.replace("weight", "bias")
        b = sd.get(bias_key)
        if b is None or b.shape != (out_c,):
            raise ValueError(f"missing bias for conv {i} ({bias_key})")
        params[f"conv{i}"] = {"weight": w, "bias": b}
        in_c = out_c

    # LPIPS linear weights: (1, C, 1, 1) convs or (C,) vectors, in dim order.
    lin_cands = []
    for k, v in sd.items():
        flat = v.reshape(-1)
        if v.ndim == 4 and v.shape[0] == 1 and v.shape[2:] == (1, 1):
            lin_cands.append((k, flat))
        elif v.ndim == 1 and v.shape[0] in LPIPS_DIMS and "bias" not in k \
                and "shift" not in k and "scale" not in k:
            lin_cands.append((k, flat))
    lins = []
    used = set()
    for d in LPIPS_DIMS:
        hit = next((i for i, (k, v) in enumerate(lin_cands)
                    if i not in used and v.shape[0] == d), None)
        if hit is None:
            raise ValueError(f"no LPIPS linear weight of dim {d} found")
        used.add(hit)
        lins.append(lin_cands[hit][1])
    for i, w in enumerate(lins):
        params[f"lin{i}"] = np.sqrt(np.clip(w, 0.0, None))

    # Optional whitening buffers.
    for k, v in sd.items():
        lk = k.lower()
        if v.size == 3 and "shift" in lk:
            params.setdefault("preprocess", {})["shift"] = v.reshape(3)
        if v.size == 3 and "scale" in lk:
            params.setdefault("preprocess", {})["scale"] = v.reshape(3)
    if "preprocess" in params and set(params["preprocess"]) != {"shift", "scale"}:
        raise ValueError("found only one of shift/scale whitening buffers")
    return params


def _distance(params: dict, resize_to: int, antialias: bool, a: torch.Tensor,
              b: torch.Tensor) -> np.ndarray:
    """Squared embedding distance of the port's `VGG16LPIPS` holding
    `params`, on the device of `a` and `b`."""
    net = VGG16LPIPS(resize_to=resize_to, antialias=antialias,
                     preprocess="preprocess" in params, device="meta")
    load_jax_params(net, params, device=a.device)
    with torch.no_grad():
        return (net.apply(a) - net.apply(b)).square().sum(1).cpu().numpy()


def calibrate(ts_module, params: dict, rtol: float = 5e-3, device=None) -> dict:
    """Pick (resize_to, antialias, whitening) reproducing the torchscript.

    Runs `ts(img, resize_images=True, return_lpips=True)` on random [0,255]
    image pairs at two resolutions and compares squared-embedding-distance
    against the port's net for each candidate config, both on `device`
    (CUDA unless named; `ts_module` is moved there)."""
    device = resolve_device(device)
    ts_module = ts_module.to(device)
    rng = np.random.RandomState(0)
    pairs = []
    for res in (64, 128):
        a = rng.rand(2, 3, res, res).astype(np.float32) * 255.0
        b = np.clip(a + rng.randn(*a.shape).astype(np.float32) * 40.0,
                    0.0, 255.0)
        pairs.append((torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)))

    with torch.no_grad():
        ref = []
        for a, b in pairs:
            fa = ts_module(a, resize_images=True, return_lpips=True)
            fb = ts_module(b, resize_images=True, return_lpips=True)
            ref.append((fa - fb).square().sum(1).cpu().numpy())
    ref = np.concatenate(ref)

    pre_candidates = [params.get("preprocess")]
    if params.get("preprocess") is None:
        pre_candidates.append({"shift": RZ_SHIFT, "scale": RZ_SCALE})

    best = None
    for resize_to in (256, 224):
        for antialias in (True, False):
            for pre in pre_candidates:
                p = dict(params)
                if pre is not None:
                    p["preprocess"] = pre
                else:
                    p.pop("preprocess", None)
                got = np.concatenate([
                    _distance(p, resize_to, antialias, a, b)
                    for a, b in pairs])
                err = float(np.max(np.abs(got - ref) / (np.abs(ref) + 1e-8)))
                cand = {"resize_to": resize_to, "antialias": antialias,
                        "whitening": pre is not None, "calibration_err": err,
                        "_params": p}
                if best is None or err < best["calibration_err"]:
                    best = cand
    if best["calibration_err"] > rtol:
        raise RuntimeError(
            f"calibration failed: best config {best['resize_to']}/"
            f"antialias={best['antialias']}/whitening={best['whitening']} "
            f"still has rel err {best['calibration_err']:.2e} (> {rtol:.0e}) "
            "vs the torchscript — the source file's preprocessing is not "
            "covered by the candidate grid; inspect it and extend calibrate()")
    return best


def write_npz(out_path: str, params: dict, meta: dict) -> None:
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                flat[f"{k}/{kk}"] = np.asarray(vv, dtype=np.float32)
        else:
            flat[k] = np.asarray(v, dtype=np.float32)
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez(out_path, **flat)


def convert(pt_path: str, out_path: str, device=None) -> dict:
    try:
        module = torch.jit.load(pt_path, map_location="cpu").eval()
        sd = extract_tensors(module)
    except RuntimeError:
        obj = torch.load(pt_path, map_location="cpu")
        module = None
        sd = extract_tensors(obj if isinstance(obj, dict)
                             else obj.state_dict())
    params = map_params(sd)

    if module is not None:
        best = calibrate(module, params, device=device)
        params = best.pop("_params")
        meta = dict(best, pretrained=True, source=os.path.basename(pt_path))
    else:
        meta = {"resize_to": 256, "antialias": True, "pretrained": True,
                "calibration_err": None, "whitening": "preprocess" in params,
                "source": os.path.basename(pt_path),
                "note": "state_dict input: preprocessing NOT calibrated"}
    write_npz(out_path, params, meta)
    print(json.dumps({k: v for k, v in meta.items()}, indent=2))
    return meta


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pt", required=True, help="vgg16.pt (torchscript) or "
                    "a torch state_dict .pt")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--device", default=None,
                    help="torch device of the calibration; default CUDA")
    args = ap.parse_args(argv)
    convert(args.pt, args.out, args.device)


if __name__ == "__main__":
    main()
