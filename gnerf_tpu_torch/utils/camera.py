"""Camera pose helpers (look-at orbits, intrinsics, 25-dim labels).

Port of `gnerf_tpu/utils/camera.py`: float32 CPU tensors; callers move them
to their device. The pose samplers draw their angles from a threefry key
(`rng`, `utils.prng`) split into h and v as in JAX, so a key gives JAX's
poses; with no key, or no stddev, they give the mean pose.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..render.math_utils import normalize_vecs
from . import prng


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


def _orbit_origin(theta: torch.Tensor, phi: torch.Tensor, radius: float) -> torch.Tensor:
    """Camera position [B, 3] on the y-up orbit sphere."""
    return torch.stack([
        radius * torch.sin(phi) * torch.cos(math.pi - theta),
        radius * torch.cos(phi),
        radius * torch.sin(phi) * torch.sin(math.pi - theta),
    ], dim=-1)


def lookat_sample(horizontal_mean: float, vertical_mean: float, radius: float = 1.0,
                  batch_size: int = 1) -> torch.Tensor:
    """Mean orbit pose looking at the origin; theta = azimuth, phi = polar
    angle, used directly."""
    h = torch.full((batch_size,), float(horizontal_mean))
    v = torch.full((batch_size,), float(vertical_mean))
    origins = _orbit_origin(h, v, radius)
    return create_cam2world_matrix(normalize_vecs(-origins), origins)


def _warped_origins(horizontal_mean, vertical_mean, horizontal_stddev, vertical_stddev,
                    radius, batch_size, rng, uniform: bool) -> torch.Tensor:
    """Orbit origins [B, 3] at angles drawn around the means (normal, or
    uniform in +-stddev), the polar angle through the arccos warp."""
    if rng is not None and (horizontal_stddev or vertical_stddev):
        def draw(key):  # on the key's device; the poses are CPU tensors
            u = prng.uniform(key, batch_size) * 2 - 1 if uniform else prng.normal(key, batch_size)
            return u.cpu()
        kh, kv = prng.split(rng)
        h = draw(kh) * horizontal_stddev + horizontal_mean
        v = draw(kv) * vertical_stddev + vertical_mean
    else:
        h = torch.full((batch_size,), float(horizontal_mean))
        v = torch.full((batch_size,), float(vertical_mean))
    v = v.clamp(1e-5, math.pi - 1e-5)
    return _orbit_origin(h, torch.arccos(1 - 2 * (v / math.pi)), radius)


def lookat_sample_origin(horizontal_mean: float, vertical_mean: float, lookat_position,
                         horizontal_stddev: float = 0.0, vertical_stddev: float = 0.0,
                         radius: float = 1.0, batch_size: int = 1,
                         rng: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gaussian angles through the arccos warp, looking at `lookat_position`."""
    origins = _warped_origins(horizontal_mean, vertical_mean, horizontal_stddev,
                              vertical_stddev, radius, batch_size, rng, uniform=False)
    target = torch.as_tensor(lookat_position, dtype=torch.float32)
    return create_cam2world_matrix(normalize_vecs(target[None] - origins), origins)


def gaussian_pose_sample(horizontal_mean: float, vertical_mean: float,
                         horizontal_stddev: float = 0.0, vertical_stddev: float = 0.0,
                         radius: float = 1.0, batch_size: int = 1,
                         rng: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gaussian angles through the arccos warp, looking at the origin."""
    origins = _warped_origins(horizontal_mean, vertical_mean, horizontal_stddev,
                              vertical_stddev, radius, batch_size, rng, uniform=False)
    return create_cam2world_matrix(normalize_vecs(-origins), origins)


def uniform_pose_sample(horizontal_mean: float, vertical_mean: float,
                        horizontal_stddev: float = 0.0, vertical_stddev: float = 0.0,
                        radius: float = 1.0, batch_size: int = 1,
                        rng: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Angles uniform in mean +- stddev through the arccos warp, looking at
    the origin."""
    origins = _warped_origins(horizontal_mean, vertical_mean, horizontal_stddev,
                              vertical_stddev, radius, batch_size, rng, uniform=True)
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
