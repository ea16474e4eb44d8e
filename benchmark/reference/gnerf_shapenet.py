"""Plain PyTorch reference of G-NeRF's ShapeNet Cars inference at 128^2:
the generator of `gnerf.py` with `SuperresolutionHybrid2X`, MipRayMarcher2's
white background and the SRN z-up orbit, as the video CLI renders it.

Sources: llrtt/G-NeRF `train.py` rendering options for `shapenet`
(64+64 samples, `white_back`, rays 0.1-2.6, `box_warp` 1.6,
`SuperresolutionHybrid2X` to 128^2) and `gen_videos.py --dataset shapenet`
(samples doubled; yaw a full turn over `frames - 1` steps, pitch pi/3,
radius 1.3 for cars; uint8 frames as `x * 127.5 + 128`, clipped, truncated),
both on NVlabs EG3D `--cfg=shapenet`. It imports only the frozen `gnerf.py`
beside it, and nothing of the program.

Departures from the source, each of which leaves the values it computes:
- `SuperresolutionHybrid2X.forward` hands `block0` the raw image that
  `block64` returns, where the source passes `rgb`: the source's in-place
  ToRGB add (`img.add_(y)`) has made the two one tensor by then.
- The superresolution draws no noise (`superresolution_noise_mode` "none"),
  and E, the mapping and the planes are `gnerf.py`'s.
- The march composites the white background into every feature channel,
  as MipRayMarcher2 does (`rgb + 1 - weight_total`, before the scaling to
  (-1, 1)); only the first three reach the superresolution as its image.

Precision follows `dtype` as in `gnerf.py` (`gnerf.FP8` is the control);
ray geometry and compositing stay in fp32. TF32 is set off by `frame`'s
callers (`check_frames` in the video driver).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import gnerf as ref

SHAPENET_INTRINSICS = torch.tensor([[1.025390625, 0.0, 0.5], [0.0, 1.025390625, 0.5],
                                    [0.0, 0.0, 1.0]])


class SR2X(nn.Module):
    """SuperresolutionHybrid2X (G-NeRF's block list): block64 at 64^2, up 1;
    block0 32 -> 256 channels, up 2 to 128^2; block1 256 -> 128 at 128^2,
    up 1. 64^2 features -> (128^2 image, 64^2 raw image)."""

    def __init__(self, channels=32, w_dim=512):
        super().__init__()
        kw = dict(conv_clamp=None, const_noise=False)
        self.block64 = ref.SynthesisBlock(channels, channels, w_dim, 64, 3, up=1, **kw)
        self.block0 = ref.SynthesisBlock(channels, 256, w_dim, 128, 3, up=2, **kw)
        self.block1 = ref.SynthesisBlock(256, 128, w_dim, 128, 3, up=1, **kw)

    def forward(self, rgb, x, ws, dtype):
        ws = ws[:, -1:, :].repeat(1, 3, 1)
        x_raw, image_raw = self.block64(x, rgb, ws, dtype)
        x, rgb = self.block0(x_raw, image_raw, ws, dtype)
        _, rgb = self.block1(x, rgb, ws, dtype)
        return rgb, image_raw


def march_rays(colors, densities, depths, white_back: bool):
    """`gnerf.march_rays` with MipRayMarcher2's white background: (features
    in (-1, 1), depth, weights)."""
    colors, densities, depths = colors.float(), densities.float(), depths.float()
    deltas = depths[:, :, 1:] - depths[:, :, :-1]
    colors_mid = (colors[:, :, :-1] + colors[:, :, 1:]) / 2
    densities_mid = F.softplus((densities[:, :, :-1] + densities[:, :, 1:]) / 2 - 1.0)
    depths_mid = (depths[:, :, :-1] + depths[:, :, 1:]) / 2
    alpha = 1.0 - torch.exp(-densities_mid * deltas)
    shifted = torch.cat([torch.ones_like(alpha[:, :, :1]), 1.0 - alpha + 1e-10], dim=-2)
    weights = alpha * torch.cumprod(shifted, dim=-2)[:, :, :-1]
    rgb = torch.sum(weights * colors_mid, dim=-2)
    total = weights.sum(dim=2)
    depth = torch.nan_to_num(torch.sum(weights * depths_mid, dim=-2) / total, nan=float("inf"))
    depth = torch.clamp(depth, depths.min(), depths.max())
    if white_back:
        rgb = rgb + 1.0 - total
    return rgb * 2.0 - 1.0, depth, weights


class Generator(ref.Generator):
    """TriPlaneGenerator at G-NeRF's ShapeNet recipe: `gnerf.Generator`'s
    backbone and decoder, SR2X, the white background."""

    def __init__(self, white_back=True, **kwargs):
        super().__init__(**kwargs)
        self.white_back = white_back
        self.superresolution = SR2X(32, kwargs.get("w_dim", 512))

    def render(self, planes, c, ws, dtype):
        """Planes [N, ...] under labels c [N, 25] -> (image, raw image),
        sampled deterministically, as the video CLI does."""
        res = self.neural_res
        origins, dirs = ref.sample_rays(c[:, :16].reshape(-1, 4, 4),
                                        c[:, 16:25].reshape(-1, 3, 3), res)
        n, r = origins.shape[:2]
        s = self.depth_resolution
        depths = torch.linspace(self.ray_start, self.ray_end, s, device=c.device)
        depths = depths.reshape(1, 1, s, 1).expand(n, r, s, 1)
        colors, dens = self._eval(planes, origins, dirs, depths)
        _, _, weights = march_rays(colors, dens, depths, self.white_back)
        fine = ref.importance_depths(depths, weights, self.depth_resolution_importance)
        colors_f, dens_f = self._eval(planes, origins, dirs, fine)
        all_d = torch.cat([depths, fine], dim=-2)
        all_c = torch.cat([colors, colors_f], dim=-2)
        all_s = torch.cat([dens, dens_f], dim=-2)
        d_sorted, perm = torch.sort(all_d[..., 0], dim=-1, stable=True)
        perm = perm[..., None]
        all_c = all_c.gather(-2, perm.expand(-1, -1, -1, all_c.shape[-1]))
        all_s = all_s.gather(-2, perm)
        feats, _, _ = march_rays(all_c, all_s, d_sorted[..., None], self.white_back)
        img = feats.permute(0, 2, 1).reshape(n, -1, res, res)
        return self.superresolution(img[:, :3], img, ws, dtype)


def label(yaw: float, pitch: float, radius: float = 1.3) -> torch.Tensor:
    """[1, 25] label of the SRN look-at pose: the camera on the z-up sphere
    at azimuth `yaw` and polar angle `pitch`, looking at the origin, with
    the ShapeNet intrinsics."""
    h, v = torch.tensor([float(yaw)]), torch.tensor([float(pitch)])
    origin = torch.stack([radius * torch.sin(v) * torch.sin(h), radius * torch.sin(v) * torch.cos(h),
                          radius * torch.cos(v)], dim=-1)
    fwd = ref._unit(ref._unit(-origin))
    up = torch.tensor([0.0, 0.0, 1.0]).expand_as(fwd)
    right = -ref._unit(torch.linalg.cross(up, fwd, dim=-1))
    up2 = ref._unit(torch.linalg.cross(fwd, right, dim=-1))
    m = torch.eye(4).repeat(1, 1, 1)
    m[:, :3, :3] = torch.stack([right, up2, fwd], dim=-1)
    m[:, :3, 3] = origin
    return torch.cat([m.reshape(1, 16), SHAPENET_INTRINSICS.reshape(1, 9)], dim=1)


def orbit_pose(i: int, frames: int) -> tuple[float, float]:
    """(yaw, pitch) of frame i of the CLI's `frames`-frame ShapeNet orbit."""
    return 2 * math.pi * i / (frames - 1), math.pi / 3


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """[1, 3, H, W] in (-1, 1) -> uint8 [H, W, 3]: `x * 127.5 + 128`,
    clipped, truncated, as the video CLI writes frames."""
    return (img.float() * 127.5 + 128).clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0)


@torch.no_grad()
def frame(g: Generator, ws, planes, yaw, pitch, dtype, radius=1.3):
    """(image [H, W, 3], raw image [h, w, 3]) as uint8 on the device."""
    c = label(yaw, pitch, radius).to(planes.device)
    image, raw = g.render(planes, c, ws, dtype)
    return to_u8(image), to_u8(raw)
