"""Bilinear and trilinear grid sampling (align_corners=False, zeros outside).

Port of `gnerf_tpu/ops/grid_sample.py` onto `F.grid_sample`, with the JAX
package's layouts: features channels-first in, samples channels-last out.
The JAX package's TPU gather layouts (`lane_pack`, `cell_pack`) are
accepted and ignored.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def grid_sample_2d(features: torch.Tensor, coords: torch.Tensor,
                   lane_pack: Optional[bool] = None, cell_pack: bool = False) -> torch.Tensor:
    """features [B, C, H, W] sampled at coords [B, M, 2] in [-1, 1]
    (coords[..., 0] indexes W, coords[..., 1] indexes H) -> [B, M, C]."""
    out = F.grid_sample(features, coords[:, :, None, :].to(features.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=False)  # [B, C, M, 1]
    return out[..., 0].transpose(1, 2)


def grid_sample_3d(grid: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """grid [B, C, D, H, W] sampled at coords [B, M, 3] in [-1, 1]
    (x indexes W, y H, z D) -> [B, M, C]."""
    out = F.grid_sample(grid, coords[:, :, None, None, :].to(grid.dtype), mode="bilinear",
                        padding_mode="zeros", align_corners=False)  # [B, C, M, 1, 1]
    return out[..., 0, 0].transpose(1, 2)
