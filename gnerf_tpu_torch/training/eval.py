"""Evaluation CLI: reconstruction or generative metrics of a snapshot.

Port of `gnerf_tpu/training/eval.py`. A snapshot with an encoder `E` is
evaluated by reconstruction: each held-out identity is encoded, re-rendered
at its own camera and scored by PSNR / SSIM / LPIPS (per batch lines and
their means). A snapshot without `E` (EG3D pretraining: G_ema, G, D) is
evaluated generatively: z sampled, poses from the dataset's labels, and the
Frechet distance to the real images over pooled VGG features (not canonical
FID, with a warning), or FID over InceptionV3 features when
`--inception-weights` names converted weights.

The generative route's z for the batch at item `start` come from
`fold_in(PRNGKey(0), start)` (`utils.prng`) and the random-VGG fallback from
PRNGKey(1), as in the JAX CLI, so both CLIs score a snapshot alike. A
snapshot without a `generator` config gets the JAX CLI's fallback G:
128^2 through `SuperresolutionHybrid2X`, 12 + 12 samples per ray
(`_eval_fallback_g`).

    python -m gnerf_tpu_torch.training.eval --network snap.npz --max_items 64 \\
        [--inception-weights inception.npz] [--device cpu]
"""

from __future__ import annotations

import json

import click
import numpy as np
import torch


def _eval_fallback_g() -> dict:
    from ..models.triplane import DEFAULT_RENDERING_KWARGS

    return dict(img_resolution=128, rendering_kwargs=dict(
        DEFAULT_RENDERING_KWARGS, superresolution_module="SuperresolutionHybrid2X",
        depth_resolution=12, depth_resolution_importance=12))


def generative_z(start: int, batch: int, z_dim: int, device=None) -> torch.Tensor:
    """The generative route's z for the batch at item `start`: JAX's
    normal(fold_in(PRNGKey(0), start), (batch, z_dim))."""
    from ..utils import prng

    return prng.normal(prng.fold_in(prng.PRNGKey(0, device=device), start), (batch, z_dim))


def _dataset(dataset_name: str, real_data: str, max_items: int, resolution: int):
    from . import dataset as ds

    if dataset_name == "synthetic":
        return ds.SyntheticDataset(resolution=resolution, size=max_items)
    if dataset_name == "afhqv2":
        return ds.Afhqv2TestDataset(real_path=real_data, max_size=max_items,
                                    resolution=resolution)
    if dataset_name == "shapenet":
        return ds.ShapeNetTestDataset(real_path=real_data, max_size=max_items,
                                      resolution=resolution)
    return ds.TestDataset(real_path=real_data, max_size=max_items, resolution=resolution)


def run_eval(network: str, real_data: str = "", dataset_name: str = "synthetic",
             max_items: int = 64, batch: int = 4, out: str = "", lpips_weights: str = "",
             inception_weights: str = "", device=None) -> dict:
    """Evaluate `network` on the first `max_items` held-out items (whole
    batches only) and return the summary (also printed as JSON, and
    written with the per-batch lines to `out` when given)."""
    from ..infer.gen_videos import load_networks
    from ..utils import checkpoint as ckpt_lib
    from ..utils.device import resolve_device
    from .dataset import collate
    from .losses import lpips_from_checkpoint
    from .metrics import frechet_feature_distance, reconstruction_metrics

    device = resolve_device(device)
    trees, _ = ckpt_lib.load_checkpoint(network)
    g, enc = load_networks(network, device=device, double_sampling=False,
                           fallback_config=_eval_fallback_g())
    vgg = lpips_from_checkpoint(trees, lpips_weights, device)
    generative = enc is None
    dataset = _dataset(dataset_name, real_data, max_items, g.output_resolution())

    def to_device(bd, key):
        return torch.from_numpy(np.asarray(bd[key], np.float32)).to(device)

    results, real_frames, fake_frames = [], [], []
    collect_frames = bool(inception_weights) or generative
    n = min(max_items, len(dataset))
    with torch.no_grad():
        for start in range(0, n - n % batch, batch):
            bd = collate([dataset[i] for i in range(start, start + batch)])
            c = to_device(bd, "loss_c")
            real = to_device(bd, "loss_image") / 127.5 - 1.0
            if generative:
                # Unconditional samples at psi = 1 (the fid50k convention).
                ws = g.mapping(generative_z(start, batch, g.z_dim, device), c)
            else:
                ws = g.mapping(enc.apply(to_device(bd, "condition_image") / 127.5 - 1.0), c)
            fake = g.synthesis(ws, c, noise_mode="none")["image"]
            if collect_frames:
                real_frames.append(real.cpu())
                fake_frames.append(fake.float().cpu())
            if generative:
                print(f"[{start + batch}/{n}] sampled")
                continue
            results.append({k: float(v) for k, v in
                            reconstruction_metrics(vgg, real, fake).items()})
            print(f"[{start + batch}/{n}] "
                  + " ".join(f"{k}={v:.4f}" for k, v in results[-1].items()))

    summary = {k: float(np.mean([r[k] for r in results])) for k in (results[0] if results else ())}
    summary["num_items"] = max(len(results), len(real_frames)) * batch
    if inception_weights:
        from .inception import load_inception
        from .metrics import make_inception_feature_fn

        feature_fn = make_inception_feature_fn(load_inception(inception_weights, device=device))
        summary["fid"] = frechet_feature_distance(feature_fn, real_frames, fake_frames)
    elif generative:
        from .metrics import make_vgg_feature_fn

        print("WARNING: generative eval without --inception-weights — reporting Frechet "
              "distance over VGG features (frechet_vgg), NOT canonical FID")
        summary["frechet_vgg"] = frechet_feature_distance(make_vgg_feature_fn(vgg),
                                                          real_frames, fake_frames)
    print(json.dumps(summary))
    if out:
        with open(out, "w") as f:
            for r in results:
                f.write(json.dumps(r) + "\n")
            f.write(json.dumps(summary) + "\n")
    return summary


@click.command()
@click.option("--network", required=True)
@click.option("--real_data", default="")
@click.option("--dataset_name", default="synthetic")
@click.option("--max_items", type=int, default=64)
@click.option("--batch", type=int, default=4)
@click.option("--out", default="")
@click.option("--lpips-weights", "lpips_weights", default="",
              help="converted vgg16.pt npz (tools/convert_vgg16_lpips.py)")
@click.option("--inception-weights", "inception_weights", default="",
              help="converted inception_v3 npz (tools/convert_inception.py); "
                   "enables FID over the held-out set")
@click.option("--device", type=str, default=None,
              help="torch device; default CUDA (refuses to run without a card)")
def main(**kwargs):
    run_eval(**kwargs)


if __name__ == "__main__":
    main()
