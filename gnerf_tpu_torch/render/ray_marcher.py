"""Midpoint alpha-compositing ray marcher (MipNeRF-style), always in fp32.

Port of `gnerf_tpu/render/ray_marcher.py`.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch
import torch.nn.functional as F


def march_rays(colors: torch.Tensor, densities: torch.Tensor, depths: torch.Tensor,
               options: Mapping[str, Any]) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """colors [N, R, S, C], densities / depths [N, R, S, 1] (depths sorted) ->
    (rgb [N, R, C], depth [N, R, 1], weights [N, R, S-1, 1])."""
    if options.get("clamp_mode", "softplus") != "softplus":
        raise ValueError("march_rays only supports clamp_mode='softplus'")
    # Compositing is precision sensitive: march in fp32 whatever the
    # feature dtype.
    colors = colors.float()
    densities = densities.float()
    depths = depths.float()
    deltas = depths[:, :, 1:] - depths[:, :, :-1]
    colors_mid = (colors[:, :, :-1] + colors[:, :, 1:]) / 2
    densities_mid = (densities[:, :, :-1] + densities[:, :, 1:]) / 2
    depths_mid = (depths[:, :, :-1] + depths[:, :, 1:]) / 2

    densities_mid = F.softplus(densities_mid - 1.0)
    alpha = 1.0 - torch.exp(-densities_mid * deltas)
    alpha_shifted = torch.cat([torch.ones_like(alpha[:, :, :1]), 1.0 - alpha + 1e-10], dim=-2)
    weights = alpha * torch.cumprod(alpha_shifted, dim=-2)[:, :, :-1]

    composite_rgb = torch.sum(weights * colors_mid, dim=-2)
    weight_total = weights.sum(dim=2)
    composite_depth = torch.sum(weights * depths_mid, dim=-2) / weight_total
    # Clip to the global depth range of the whole batch (NaN -> +inf first).
    composite_depth = torch.nan_to_num(composite_depth, nan=float("inf"))
    composite_depth = torch.clamp(composite_depth, depths.min(), depths.max())

    if options.get("white_back", False):
        composite_rgb = composite_rgb + 1.0 - weight_total
    composite_rgb = composite_rgb * 2.0 - 1.0
    return composite_rgb, composite_depth, weights
