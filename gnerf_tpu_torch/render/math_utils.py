"""Ray geometry math: normalization, ray-AABB intersection, batched linspace.

Port of `gnerf_tpu/render/math_utils.py`.
"""

from __future__ import annotations

import torch


def normalize_vecs(vectors: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return vectors / (torch.linalg.norm(vectors, dim=-1, keepdim=True) + eps)


def get_ray_limits_box(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       box_side_length: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Slab-method intersection of rays with the centered cube of side
    `box_side_length`. Returns (t_min, t_max) with trailing dim 1; rays that
    miss get (-1, -2)."""
    lead_shape = rays_o.shape[:-1]
    o = rays_o.reshape(-1, 3)
    d = rays_d.reshape(-1, 3)
    half = box_side_length / 2
    invdir = 1.0 / d
    t_lo = (-half - o) * invdir
    t_hi = (half - o) * invdir
    t_near = torch.minimum(t_lo, t_hi)
    t_far = torch.maximum(t_lo, t_hi)

    # A ray is invalid as soon as the running [tmin, tmax] interval and the
    # next axis slab are disjoint (checked before folding that axis in).
    tmin = t_near[:, 0]
    tmax = t_far[:, 0]
    is_valid = torch.ones_like(tmin, dtype=torch.bool)
    for axis in (1, 2):
        is_valid &= ~((tmin > t_far[:, axis]) | (t_near[:, axis] > tmax))
        tmin = torch.maximum(tmin, t_near[:, axis])
        tmax = torch.minimum(tmax, t_far[:, axis])
    tmin = torch.where(is_valid, tmin, torch.full_like(tmin, -1.0))
    tmax = torch.where(is_valid, tmax, torch.full_like(tmax, -2.0))
    return tmin.reshape(*lead_shape, 1), tmax.reshape(*lead_shape, 1)


def linspace_batched(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """[num, *start.shape] evenly spaced values from start to stop inclusive."""
    steps = torch.arange(num, dtype=torch.float32, device=start.device) / (num - 1)
    steps = steps.reshape((num,) + (1,) * start.dim())
    return start[None] + steps * (stop - start)[None]
