"""Superresolution: neural-render features -> final RGB image.

Port of `SuperresolutionHybrid8XDC` from `gnerf_tpu/models/superresolution.py`
(the FFHQ 512^2 module of the shipped checkpoints). The other variants come
in a later slice; `make_superresolution` raises for them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.interpolate import interpolate_bilinear
from .stylegan2 import SynthesisBlock


def _block_ws(ws: torch.Tensor) -> torch.Tensor:
    """Last w broadcast to the 3 (conv0, conv1, torgb) slots of each block."""
    return ws[:, -1:, :].repeat(1, 3, 1)


class _SRBase(nn.Module):
    def __init__(self, channels: int, img_resolution: int, sr_num_fp16_res: int = 0,
                 sr_antialias: bool = True, w_dim: int = 512, use_noise: bool = True):
        super().__init__()
        self.channels = channels
        self.img_resolution = img_resolution
        self.sr_antialias = sr_antialias
        self.w_dim = w_dim
        self.use_noise = use_noise
        self.conv_clamp = 256 if sr_num_fp16_res > 0 else None

    def _blk(self, in_ch, out_ch, res, is_last, up, generator) -> SynthesisBlock:
        return SynthesisBlock(in_ch, out_ch, self.w_dim, res, img_channels=3, is_last=is_last,
                              conv_clamp=self.conv_clamp, up=up, use_noise=self.use_noise,
                              generator=generator)


class SuperresolutionHybrid8XDC(_SRBase):
    """64^2 feature/rgb -> (512^2 image, 64^2 image_raw); 'DC' = dual
    conditioning via the raw branch."""

    def __init__(self, channels: int, img_resolution: int, sr_num_fp16_res: int = 0,
                 sr_antialias: bool = True, w_dim: int = 512, use_noise: bool = True,
                 input_resolution: int = 128, generator: Optional[torch.Generator] = None):
        super().__init__(channels, img_resolution, sr_num_fp16_res, sr_antialias, w_dim,
                         use_noise)
        if img_resolution != 512:
            raise ValueError("SuperresolutionHybrid8XDC produces 512^2 images")
        self.input_resolution = input_resolution
        c = channels
        self.block64 = self._blk(c, c, 64, True, 1, generator)
        self.block0 = self._blk(c, 256, 256, False, 2, generator)
        self.block1 = self._blk(256, 128, 512, True, 2, generator)

    def forward(self, rgb, x, ws, noise_mode="random", rng=None, dtype=torch.float32):
        ws = _block_ws(ws)
        x_raw, image_raw = self.block64(x, rgb, ws, noise_mode=noise_mode, rng=rng, dtype=dtype)
        if x.shape[-1] != self.input_resolution:
            r = self.input_resolution
            x = interpolate_bilinear(x_raw, r, r, antialias=self.sr_antialias)
            rgb = interpolate_bilinear(image_raw, r, r, antialias=self.sr_antialias)
        else:
            # Shipped quirk, mirrored: the no-interpolate branch keeps the
            # ORIGINAL x (not x_raw), while rgb aliases image_raw.
            rgb = image_raw
        x, rgb = self.block0(x, rgb, ws, noise_mode=noise_mode, rng=rng, dtype=dtype)
        x, rgb = self.block1(x, rgb, ws, noise_mode=noise_mode, rng=rng, dtype=dtype)
        return rgb, image_raw


def make_superresolution(name: str, **kwargs) -> nn.Module:
    if name == "SuperresolutionHybrid8XDC":
        return SuperresolutionHybrid8XDC(**kwargs)
    raise NotImplementedError(
        f"superresolution module {name!r} is not ported yet; only "
        "SuperresolutionHybrid8XDC is")
