"""Camera pose helpers (look-at orbits, intrinsics, 25-dim labels).

Port of the deterministic part of `gnerf_tpu/utils/camera.py`: float32 CPU
tensors; callers move them to their device.
"""

from __future__ import annotations

import math

import torch

from ..render.math_utils import normalize_vecs


def _cam2world(forward_vector: torch.Tensor, origin: torch.Tensor,
               up_axis: tuple) -> torch.Tensor:
    forward_vector = normalize_vecs(forward_vector)
    up = torch.tensor(up_axis, dtype=forward_vector.dtype).expand_as(forward_vector)
    right = -normalize_vecs(torch.linalg.cross(up, forward_vector, dim=-1))
    up2 = normalize_vecs(torch.linalg.cross(forward_vector, right, dim=-1))
    m = torch.eye(4, dtype=forward_vector.dtype).repeat(origin.shape[0], 1, 1)
    m[:, :3, :3] = torch.stack([right, up2, forward_vector], dim=-1)
    m[:, :3, 3] = origin
    return m


def create_cam2world_matrix(forward_vector: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """cam2world [B, 4, 4] from viewing direction + position; y-up, no roll."""
    return _cam2world(forward_vector, origin, (0.0, 1.0, 0.0))


def create_cam2world_matrix_srn(forward_vector: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """SRN (ShapeNet) variant: z-up world."""
    return _cam2world(forward_vector, origin, (0.0, 0.0, 1.0))


def lookat_sample(horizontal_mean: float, vertical_mean: float, radius: float = 1.0,
                  batch_size: int = 1) -> torch.Tensor:
    """Mean orbit pose looking at the origin; theta = azimuth, phi = polar
    angle, used directly."""
    h = torch.full((batch_size,), float(horizontal_mean))
    v = torch.full((batch_size,), float(vertical_mean))
    origins = torch.stack([
        radius * torch.sin(v) * torch.cos(math.pi - h),
        radius * torch.cos(v),
        radius * torch.sin(v) * torch.sin(math.pi - h),
    ], dim=-1)
    return create_cam2world_matrix(normalize_vecs(-origins), origins)


def lookat_sample_srn(horizontal_mean: float, vertical_mean: float, radius: float = 1.0,
                      batch_size: int = 1) -> torch.Tensor:
    """z-up mean orbit pose for ShapeNet."""
    theta = torch.full((batch_size,), float(horizontal_mean))
    phi = torch.full((batch_size,), float(vertical_mean))
    origins = torch.stack([
        radius * torch.sin(phi) * torch.sin(theta),
        radius * torch.sin(phi) * torch.cos(theta),
        radius * torch.cos(phi),
    ], dim=-1)
    return create_cam2world_matrix_srn(normalize_vecs(-origins), origins)


def fov_to_intrinsics(fov_degrees: float) -> torch.Tensor:
    """Normalized 3x3 intrinsics from the field of view in degrees."""
    focal = 1.0 / (math.tan(fov_degrees * 3.14159 / 360) * 1.414)
    return torch.tensor([[focal, 0.0, 0.5], [0.0, focal, 0.5], [0.0, 0.0, 1.0]])


FFHQ_INTRINSICS = torch.tensor([[4.2647, 0.0, 0.5], [0.0, 4.2647, 0.5], [0.0, 0.0, 1.0]])
SHAPENET_INTRINSICS = torch.tensor(
    [[1.025390625, 0.0, 0.5], [0.0, 1.025390625, 0.5], [0.0, 0.0, 1.0]])


def pose_to_label(cam2world: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """(cam2world [B, 4, 4], intrinsics [3, 3] or [B, 3, 3]) -> [B, 25] label."""
    b = cam2world.shape[0]
    if intrinsics.dim() == 2:
        intrinsics = intrinsics[None].expand(b, 3, 3)
    return torch.cat([cam2world.reshape(b, 16), intrinsics.reshape(b, 9)], dim=1)
