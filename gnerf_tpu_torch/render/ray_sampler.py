"""Pinhole-camera ray generation (OpenCV convention).

Port of `gnerf_tpu/render/ray_sampler.py`.
"""

from __future__ import annotations

import torch


def sample_rays(cam2world: torch.Tensor, intrinsics: torch.Tensor,
                resolution: int) -> tuple[torch.Tensor, torch.Tensor]:
    """cam2world [N, 4, 4], intrinsics [N, 3, 3] normalized by image size ->
    (ray_origins, ray_dirs), each [N, res*res, 3], row-major pixel order.

    The world transform is an fp32 product; TF32 stays off (see
    `utils.device.resolve_device`)."""
    cam2world = cam2world.float()
    intrinsics = intrinsics.float()
    n = cam2world.shape[0]
    m = resolution * resolution
    dev = cam2world.device
    cam_pos = cam2world[:, :3, 3]
    fx = intrinsics[:, 0, 0][:, None]
    fy = intrinsics[:, 1, 1][:, None]
    cx = intrinsics[:, 0, 2][:, None]
    cy = intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]

    centers = (torch.arange(resolution, dtype=torch.float32, device=dev) + 0.5) / resolution
    yy, xx = torch.meshgrid(centers, centers, indexing="ij")
    x_cam = xx.reshape(1, m).expand(n, m)
    y_cam = yy.reshape(1, m).expand(n, m)
    z_cam = torch.ones((n, m), dtype=torch.float32, device=dev)

    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z_cam
    y_lift = (y_cam - cy) / fy * z_cam
    cam_rel = torch.stack([x_lift, y_lift, z_cam, torch.ones_like(z_cam)], dim=-1)
    world = torch.einsum("nij,nmj->nmi", cam2world, cam_rel)[..., :3]

    ray_dirs = world - cam_pos[:, None, :]
    ray_dirs = ray_dirs / torch.linalg.norm(ray_dirs, dim=2, keepdim=True)
    ray_origins = cam_pos[:, None, :].expand_as(ray_dirs)
    return ray_origins, ray_dirs
