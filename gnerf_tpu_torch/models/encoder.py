"""ResNeXt50-32x4d identity encoder (network E).

Port of `gnerf_tpu/models/encoder.py`: torchvision-style ResNeXt50
(Bottleneck [3, 4, 6, 3], groups=32, width_per_group=4), a 2x2 adaptive
average pool and a dense projection 8192 -> z_dim. Input is a [-1, 1] RGB
image. BatchNorm keeps `mean` / `var` buffers beside the `scale` / `bias`
parameters (the JAX package's names): eval mode normalizes with them, train
mode with the batch moments, and updates them in place. Under a mesh
(`parallel.use_mesh`) the batch is the global one: SyncBatchNorm, as the
JAX package's global-batch step computes it.
The grouped 3x3 is a native `groups=32` convolution; the JAX package's
`groups_as_dense` TPU layout is not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import active_mesh
from ..parallel.sharding import data_mean
from ..utils import prng
from ..utils.device import place, resolve_device
from ..utils.profiling import profiled_function


def _kaiming(shape, key: torch.Tensor) -> nn.Parameter:
    fan_in = shape[1] * shape[2] * shape[3]
    return nn.Parameter(prng.normal(key, shape) * math.sqrt(2.0 / fan_in))


class _BatchNorm(nn.Module):
    def __init__(self, c: int, device: Optional[torch.device] = None, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x: torch.Tensor, train: bool = False,
                momentum: float = 0.1) -> torch.Tensor:
        # Statistics in fp32; the normalization itself in x's dtype. Train
        # mode takes the batch moments as E[x^2] - E[x]^2 and moves the
        # running mean and unbiased variance toward them. Under a mesh the
        # moments are those of the global batch (the data shards' means,
        # averaged with gradient), and every rank moves its buffers by them.
        if train:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            mean_sq = xf.square().mean(dim=(0, 2, 3))
            mesh = active_mesh()
            if mesh is not None:
                mean, mean_sq = data_mean(torch.stack([mean, mean_sq])).unbind(0)
            var = mean_sq - mean.square()
            n = x.shape[0] * x.shape[2] * x.shape[3] * (mesh.data if mesh is not None else 1)
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
                 width_per_group: int, key: torch.Tensor):
        super().__init__()
        width = int(planes * (width_per_group / 64.0)) * groups
        out_c = planes * 4
        self.stride = stride
        self.groups = groups
        k = prng.split(key, 4)
        self.conv1 = _kaiming((width, in_c, 1, 1), k[0])
        self.bn1 = _BatchNorm(width, key.device)
        self.conv2 = _kaiming((width, width // groups, 3, 3), k[1])
        self.bn2 = _BatchNorm(width, key.device)
        self.conv3 = _kaiming((out_c, width, 1, 1), k[2])
        self.bn3 = _BatchNorm(out_c, key.device)
        if stride != 1 or in_c != out_c:
            self.downsample_conv = _kaiming((out_c, in_c, 1, 1), k[3])
            self.downsample_bn = _BatchNorm(out_c, key.device)

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
    """Identity encoder E: image [N, 3, H, W] in [-1, 1] -> z [N, out_dim].
    Constructed on CUDA unless `device` names another device, from `key`
    (PRNGKey(0) when None) split as the JAX `init` splits it; on `meta`
    nothing is drawn."""

    _planes = (64, 128, 256, 512)

    def __init__(self, out_dim: int = 512, groups: int = 32, width_per_group: int = 4,
                 layers: tuple = (3, 4, 6, 3), device=None, key: Optional[torch.Tensor] = None):
        super().__init__()
        device = resolve_device(device)
        keys = prng.split((prng.PRNGKey(0) if key is None else key).to(device), 7)
        self.layers = tuple(layers)
        self.conv1 = _kaiming((64, 3, 7, 7), keys[0])
        self.bn1 = _BatchNorm(64, device)
        in_c = 64
        for stage, (planes, blocks) in enumerate(zip(self._planes, self.layers)):
            for b, bkey in enumerate(prng.split(keys[1 + stage], blocks)):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                setattr(self, f"layer{stage + 1}_{b}", _Bottleneck(
                    in_c, planes, stride, groups, width_per_group, bkey))
                in_c = planes * 4
        fan_in = 2048 * 4
        bound = 1.0 / math.sqrt(fan_in)
        kw, kb = prng.split(keys[5])
        self.fc = nn.Module()
        self.fc.weight = nn.Parameter(prng.uniform(kw, (out_dim, fan_in), -bound, bound))
        self.fc.bias = nn.Parameter(prng.uniform(kb, (out_dim,), -bound, bound))
        place(self, device)

    def forward(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(self.bn1(_conv(images, self.conv1, stride=2, padding=3), train))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)  # pads with -inf
        for stage, blocks in enumerate(self.layers):
            for b in range(blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x, train)
        x = F.adaptive_avg_pool2d(x, 2)  # region i spans [floor(iS/2), ceil((i+1)S/2))
        x = x.reshape(x.shape[0], -1)
        return F.linear(x, self.fc.weight.to(x.dtype), self.fc.bias.to(x.dtype))

    @profiled_function("encoder")
    def apply(self, images: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Encode, the JAX package's `apply(params, state, images, train)`:
        z, with the BN buffers updated in place when `train`. (Shadows
        `nn.Module.apply`, to keep that name.)"""
        return self.forward(images, train)
