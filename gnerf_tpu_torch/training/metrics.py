"""Reconstruction metrics. Port of `gnerf_tpu/training/metrics.py::psnr`;
FID, KID and the Inception features are not ported yet."""

from __future__ import annotations

import torch


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """Per-sample PSNR of [N, C, H, W] images ([-1, 1] by default)."""
    mse = (a - b).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp_min(mse, 1e-12))
