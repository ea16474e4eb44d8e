"""Stratified + importance (inverse-CDF) depth sampling.

Port of `gnerf_tpu/render/importance.py`. The comparison-count searchsorted
and one-hot gathers of the TPU version are `torch.searchsorted(right=True)`
and `torch.gather` here (same values). Randomness comes from an explicit
`torch.Generator`; `rng=None` is the deterministic path inference takes.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.sharding import draw
from .math_utils import linspace_batched


def sample_stratified(
    rng: Optional[torch.Generator],
    ray_origins: torch.Tensor,
    ray_start,
    ray_end,
    depth_resolution: int,
    disparity_space_sampling: bool = False,
    ray_mesh=None,
) -> torch.Tensor:
    """[N, R, depth_resolution, 1] depths; ray_start/ray_end are scalars or
    [N, R, 1] tensors (the 'auto' ray-box path). rng=None: no jitter.
    `ray_mesh`: the rays are this rank's shard of that mesh's ray axis (the
    jitter is then its part of the draw for all rays)."""
    n, r, _ = ray_origins.shape
    s = depth_resolution
    dev = ray_origins.device

    def jitter(shape):
        return draw(torch.rand, shape, rng, ray_mesh=ray_mesh, ray_dim=1, device=dev)

    if disparity_space_sampling:
        depths = torch.linspace(0.0, 1.0, s, device=dev).reshape(1, 1, s, 1).expand(n, r, s, 1)
        if rng is not None:
            depths = depths + jitter((n, r, s, 1)) * (1.0 / (s - 1))
        return 1.0 / (1.0 / ray_start * (1.0 - depths) + 1.0 / ray_end * depths)

    if isinstance(ray_start, torch.Tensor) and ray_start.dim() > 0:
        depths = linspace_batched(ray_start, ray_end, s).permute(1, 2, 0, 3)  # [N, R, S, 1]
        if rng is not None:
            delta = (ray_end - ray_start) / (s - 1)
            depths = depths + jitter(depths.shape) * delta[..., None]
        return depths

    depths = torch.linspace(float(ray_start), float(ray_end), s, device=dev)
    depths = depths.reshape(1, 1, s, 1).expand(n, r, s, 1)
    if rng is not None:
        depths = depths + jitter((n, r, s, 1)) * ((float(ray_end) - float(ray_start)) / (s - 1))
    return depths


def smooth_weights(weights: torch.Tensor) -> torch.Tensor:
    """max-pool(k=2, s=1, pad=1) then avg-pool(k=2, s=1) along the last axis."""
    mid = torch.maximum(weights[..., :-1], weights[..., 1:])
    m = torch.cat([weights[..., :1], mid, weights[..., -1:]], dim=-1)
    return (m[..., :-1] + m[..., 1:]) / 2.0


def sample_pdf(
    rng: Optional[torch.Generator],
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_importance: int,
    det: bool = False,
    eps: float = 1e-5,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`n_importance` depths per ray from the piecewise-constant PDF given by
    `weights` [Nr, n_w] over `bins` [Nr, >= n_w + 1]. Returns [Nr, n_importance].
    `u` [Nr, n_importance]: the uniform draws, when the caller made them."""
    n_rays, n_w = weights.shape
    weights = weights + eps
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1).contiguous()  # [Nr, n_w+1]

    if det or rng is None:
        u = torch.linspace(0.0, 1.0, n_importance, device=weights.device)
        u = u.expand(n_rays, n_importance).contiguous()
    elif u is None:
        u = torch.rand((n_rays, n_importance), generator=rng, device=weights.device)

    inds = torch.searchsorted(cdf, u, right=True)
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, n_w)
    k = n_w + 1
    edges = bins[:, :k]
    cdf_lo, cdf_hi = cdf.gather(1, below), cdf.gather(1, above)
    bins_lo, bins_hi = edges.gather(1, below), edges.gather(1, above)

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bins_lo + (u - cdf_lo) / denom * (bins_hi - bins_lo)


@torch.no_grad()
def sample_importance(
    rng: Optional[torch.Generator],
    z_vals: torch.Tensor,
    weights: torch.Tensor,
    n_importance: int,
    det: bool = False,
    ray_mesh=None,
) -> torch.Tensor:
    """Importance depths [N, R, n_importance, 1] from coarse depths
    [N, R, S, 1] and marcher weights [N, R, S-1, 1]; no gradient, as in the
    reference. `ray_mesh` as for `sample_stratified`."""
    n, r, s, _ = z_vals.shape
    z_flat = z_vals.reshape(n * r, s)
    w = smooth_weights(weights.reshape(n * r, -1)) + 0.01
    z_mid = (z_flat[:, :-1] + z_flat[:, 1:]) / 2.0
    u = None
    if rng is not None and not det:
        u = draw(torch.rand, (n, r, n_importance), rng, ray_mesh=ray_mesh, ray_dim=1,
                 device=z_vals.device).reshape(n * r, n_importance)
    out = sample_pdf(rng, z_mid, w[:, 1:-1], n_importance, det=det, u=u)
    return out.reshape(n, r, n_importance, 1)
