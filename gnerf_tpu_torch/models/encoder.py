"""ResNeXt50-32x4d identity encoder (network E).

Port of `gnerf_tpu/models/encoder.py`: torchvision-style ResNeXt50
(Bottleneck [3, 4, 6, 3], groups=32, width_per_group=4), a 2x2 adaptive
average pool and a dense projection 8192 -> z_dim. Input is a [-1, 1] RGB
image. BatchNorm keeps `mean` / `var` buffers beside the `scale` / `bias`
parameters (the JAX package's names): eval mode normalizes with them, train
mode with the batch moments, and updates them in place.
The grouped 3x3 is a native `groups=32` convolution; the JAX package's
`groups_as_dense` TPU layout is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device


def _kaiming(shape, generator) -> nn.Parameter:
    fan_in = shape[1] * shape[2] * shape[3]
    return nn.Parameter(torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in))


class _BatchNorm(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, train: bool = False,
                momentum: float = 0.1) -> torch.Tensor:
        # Statistics in fp32; the normalization itself in x's dtype. Train
        # mode takes the batch moments as E[x^2] - E[x]^2 and moves the
        # running mean and unbiased variance toward them.
        if train:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = xf.square().mean(dim=(0, 2, 3)) - mean.square()
            n = x.shape[0] * x.shape[2] * x.shape[3]
            with torch.no_grad():
                self.mean.copy_((1 - momentum) * self.mean + momentum * mean)
                self.var.copy_((1 - momentum) * self.var + momentum * (var * n / max(n - 1, 1)))
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        shape = (1, -1, 1, 1)
        return ((x - mean.to(x.dtype).reshape(shape)) * inv.to(x.dtype).reshape(shape)
                + self.bias.to(x.dtype).reshape(shape))


def _conv(x, w, stride=1, padding=0, groups=1):
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding, groups=groups)


class _Bottleneck(nn.Module):
    def __init__(self, in_c: int, planes: int, stride: int, groups: int,
                 width_per_group: int, generator: torch.Generator):
        super().__init__()
        width = int(planes * (width_per_group / 64.0)) * groups
        out_c = planes * 4
        self.stride = stride
        self.groups = groups
        self.conv1 = _kaiming((width, in_c, 1, 1), generator)
        self.bn1 = _BatchNorm(width)
        self.conv2 = _kaiming((width, width // groups, 3, 3), generator)
        self.bn2 = _BatchNorm(width)
        self.conv3 = _kaiming((out_c, width, 1, 1), generator)
        self.bn3 = _BatchNorm(out_c)
        if stride != 1 or in_c != out_c:
            self.downsample_conv = _kaiming((out_c, in_c, 1, 1), generator)
            self.downsample_bn = _BatchNorm(out_c)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(_conv(x, self.conv1), train))
        out = F.relu(self.bn2(_conv(out, self.conv2, stride=self.stride, padding=1,
                                    groups=self.groups), train))
        out = self.bn3(_conv(out, self.conv3), train)
        identity = x
        if hasattr(self, "downsample_conv"):
            identity = self.downsample_bn(_conv(x, self.downsample_conv, stride=self.stride),
                                          train)
        return F.relu(out + identity)


class ResNeXt50Encoder(nn.Module):
    """Identity encoder E: image [N, 3, H, W] in [-1, 1] -> z [N, out_dim]."""

    _planes = (64, 128, 256, 512)

    def __init__(self, out_dim: int = 512, groups: int = 32, width_per_group: int = 4,
                 layers: tuple = (3, 4, 6, 3), device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.layers = tuple(layers)
        self.conv1 = _kaiming((64, 3, 7, 7), generator)
        self.bn1 = _BatchNorm(64)
        in_c = 64
        for stage, (planes, blocks) in enumerate(zip(self._planes, self.layers)):
            for b in range(blocks):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                setattr(self, f"layer{stage + 1}_{b}", _Bottleneck(
                    in_c, planes, stride, groups, width_per_group, generator))
                in_c = planes * 4
        fan_in = 2048 * 4
        bound = 1.0 / math.sqrt(fan_in)
        self.fc = nn.Linear(fan_in, out_dim)
        with torch.no_grad():
            self.fc.weight.uniform_(-bound, bound, generator=generator)
            self.fc.bias.uniform_(-bound, bound, generator=generator)
        self.to(device)

    def forward(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(self.bn1(_conv(images, self.conv1, stride=2, padding=3), train))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)  # pads with -inf
        for stage, blocks in enumerate(self.layers):
            for b in range(blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x, train)
        x = F.adaptive_avg_pool2d(x, 2)  # region i spans [floor(iS/2), ceil((i+1)S/2))
        x = x.reshape(x.shape[0], -1)
        return F.linear(x, self.fc.weight.to(x.dtype), self.fc.bias.to(x.dtype))

    def apply(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Encode, the JAX package's `apply(params, state, images, train)`:
        z, with the BN buffers updated in place when `train`. (Shadows
        `nn.Module.apply`, to keep that name.)"""
        return self.forward(images, train)
