"""Evaluation metrics: PSNR / SSIM / LPIPS and the Frechet feature distance.

Port of `gnerf_tpu/training/metrics.py`: reconstruction metrics (PSNR, SSIM,
LPIPS) for the paired-view evaluation, and a Frechet distance between two
image streams over any feature extractor: pooled InceptionV3 features
(canonical FID, from converted weights) or pooled VGG16-LPIPS features. The
Gaussians' distance is computed on the host in float64 with scipy's `sqrtm`,
as the JAX package does.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..ops.interpolate import interpolate_bilinear
from .losses import VGG16LPIPS, lpips_distance, ssim


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Per-sample PSNR of [N, C, H, W] images ([-1, 1] by default)."""
    mse = (a - b).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))


def reconstruction_metrics(vgg: VGG16LPIPS, real: torch.Tensor, fake: torch.Tensor) -> dict:
    """PSNR / SSIM / LPIPS means over a batch of [-1, 1] images."""
    return {
        "psnr": psnr(real, fake).mean(),
        "ssim": ssim(real * 0.5 + 0.5, fake * 0.5 + 0.5, data_range=1.0),
        "lpips": lpips_distance(vgg, real, fake).mean(),
    }


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (host-side numpy / scipy)."""
    import scipy.linalg

    mu1, mu2 = np.asarray(mu1), np.asarray(mu2)
    sigma1, sigma2 = np.asarray(sigma1), np.asarray(sigma2)
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def feature_statistics(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of an [N, D] feature matrix, in float64."""
    features = np.asarray(features, dtype=np.float64)
    return features.mean(axis=0), np.cov(features, rowvar=False)


def frechet_feature_distance(
    feature_fn: Callable[[torch.Tensor], torch.Tensor],
    real_batches: Iterable,
    fake_batches: Iterable,
    max_items: Optional[int] = None,
) -> float:
    """FID-style metric: the Frechet distance between the feature
    distributions of a real and a generated stream of [-1, 1] NCHW batches
    (tensors or numpy arrays; numpy batches go to the extractor's device)."""

    def collect(batches):
        feats, n = [], 0
        for b in batches:
            f = feature_fn(b).detach().cpu().numpy()
            feats.append(f)
            n += f.shape[0]
            if max_items is not None and n >= max_items:
                break
        return np.concatenate(feats)[: max_items or None]

    mu_r, sig_r = feature_statistics(collect(real_batches))
    mu_f, sig_f = feature_statistics(collect(fake_batches))
    return frechet_distance(mu_r, sig_r, mu_f, sig_f)


def _as_tensor(images, device) -> torch.Tensor:
    if isinstance(images, torch.Tensor):
        return images.to(device)
    return torch.from_numpy(np.asarray(images, np.float32)).to(device)


def make_inception_feature_fn(net, batch_dtype=torch.float32) -> Callable:
    """Canonical-FID feature extractor: pool-3 (2048-d) features of an
    `inception.InceptionV3Features` (pretrained weights from
    `inception.load_inception`; it resizes to its `resize_to`, 299 for the
    published protocol)."""
    device = next(net.parameters()).device

    @torch.no_grad()
    def feature_fn(images):
        return net.features(_as_tensor(images, device).to(batch_dtype))

    return feature_fn


def make_vgg_feature_fn(vgg: VGG16LPIPS) -> Callable:
    """The default extractor for `frechet_feature_distance`: each LPIPS
    layer's VGG features pooled over space (64+128+256+512+512 = 1472 dims),
    after an antialiased resize to the net's `resize_to`. Pooling keeps the
    covariance tractable, as canonical FID's 2048-d pooled features do."""
    device = next(vgg.parameters()).device

    @torch.no_grad()
    def feature_fn(images):
        x = _as_tensor(images, device)
        if x.shape[-1] != vgg.resize_to:
            x = interpolate_bilinear(x, vgg.resize_to, vgg.resize_to, antialias=True)
        return torch.cat([f.mean(dim=(2, 3)) for f in vgg.features(x)], dim=1)

    return feature_fn
