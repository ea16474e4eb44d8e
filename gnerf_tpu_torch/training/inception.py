"""InceptionV3 feature extractor (torchvision layout) for canonical FID.

Port of `gnerf_tpu/training/inception.py`: the InceptionV3 trunk (Szegedy et
al., CVPR 2016) whose parameter names are torchvision `inception_v3`'s
state_dict names (`Conv2d_1a_3x3.conv.weight`, `Mixed_5b.branch1x1.bn.
running_var`, ...; BN eps 1e-3, no aux head, no fc), so the npz of
`python -m gnerf_tpu_torch.tools.convert_inception` (the same file the JAX
package's `tools/convert_inception.py` writes) loads as it does there. The
BN is folded into a per-channel affine at every call (inference only); the
weights are frozen.

`features()` takes [-1, 1] NCHW images, resizes them to `resize_to`
(bilinear, no antialias), maps them to [0, 1], normalizes with the ImageNet
mean and std (the torchvision eval transform) and returns the [N, 2048]
pooled features.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interpolate import interpolate_bilinear
from ..utils import prng
from ..utils.device import place, resolve_device

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)
_BN_EPS = 1e-3
FEATURE_DIM = 2048


def _cb(d, name, co, ci, kh, kw):
    d[name] = (co, ci, kh, kw)


def inception_conv_shapes() -> dict:
    """Every BasicConv2d in torchvision inception_v3 (aux head excluded):
    path -> (out, in, kh, kw)."""
    s: dict = {}
    _cb(s, "Conv2d_1a_3x3", 32, 3, 3, 3)
    _cb(s, "Conv2d_2a_3x3", 32, 32, 3, 3)
    _cb(s, "Conv2d_2b_3x3", 64, 32, 3, 3)
    _cb(s, "Conv2d_3b_1x1", 80, 64, 1, 1)
    _cb(s, "Conv2d_4a_3x3", 192, 80, 3, 3)
    # Mixed_5b/5c/5d: InceptionA(in, pool_features)
    for name, cin, pf in (("Mixed_5b", 192, 32), ("Mixed_5c", 256, 64),
                          ("Mixed_5d", 288, 64)):
        _cb(s, f"{name}.branch1x1", 64, cin, 1, 1)
        _cb(s, f"{name}.branch5x5_1", 48, cin, 1, 1)
        _cb(s, f"{name}.branch5x5_2", 64, 48, 5, 5)
        _cb(s, f"{name}.branch3x3dbl_1", 64, cin, 1, 1)
        _cb(s, f"{name}.branch3x3dbl_2", 96, 64, 3, 3)
        _cb(s, f"{name}.branch3x3dbl_3", 96, 96, 3, 3)
        _cb(s, f"{name}.branch_pool", pf, cin, 1, 1)
    # Mixed_6a: InceptionB(288)
    _cb(s, "Mixed_6a.branch3x3", 384, 288, 3, 3)
    _cb(s, "Mixed_6a.branch3x3dbl_1", 64, 288, 1, 1)
    _cb(s, "Mixed_6a.branch3x3dbl_2", 96, 64, 3, 3)
    _cb(s, "Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3)
    # Mixed_6b..6e: InceptionC(768, c7)
    for name, c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160),
                     ("Mixed_6e", 192)):
        _cb(s, f"{name}.branch1x1", 192, 768, 1, 1)
        _cb(s, f"{name}.branch7x7_1", c7, 768, 1, 1)
        _cb(s, f"{name}.branch7x7_2", c7, c7, 1, 7)
        _cb(s, f"{name}.branch7x7_3", 192, c7, 7, 1)
        _cb(s, f"{name}.branch7x7dbl_1", c7, 768, 1, 1)
        _cb(s, f"{name}.branch7x7dbl_2", c7, c7, 7, 1)
        _cb(s, f"{name}.branch7x7dbl_3", c7, c7, 1, 7)
        _cb(s, f"{name}.branch7x7dbl_4", c7, c7, 7, 1)
        _cb(s, f"{name}.branch7x7dbl_5", 192, c7, 1, 7)
        _cb(s, f"{name}.branch_pool", 192, 768, 1, 1)
    # Mixed_7a: InceptionD(768)
    _cb(s, "Mixed_7a.branch3x3_1", 192, 768, 1, 1)
    _cb(s, "Mixed_7a.branch3x3_2", 320, 192, 3, 3)
    _cb(s, "Mixed_7a.branch7x7x3_1", 192, 768, 1, 1)
    _cb(s, "Mixed_7a.branch7x7x3_2", 192, 192, 1, 7)
    _cb(s, "Mixed_7a.branch7x7x3_3", 192, 192, 7, 1)
    _cb(s, "Mixed_7a.branch7x7x3_4", 192, 192, 3, 3)
    # Mixed_7b/7c: InceptionE(1280 / 2048)
    for name, cin in (("Mixed_7b", 1280), ("Mixed_7c", 2048)):
        _cb(s, f"{name}.branch1x1", 320, cin, 1, 1)
        _cb(s, f"{name}.branch3x3_1", 384, cin, 1, 1)
        _cb(s, f"{name}.branch3x3_2a", 384, 384, 1, 3)
        _cb(s, f"{name}.branch3x3_2b", 384, 384, 3, 1)
        _cb(s, f"{name}.branch3x3dbl_1", 448, cin, 1, 1)
        _cb(s, f"{name}.branch3x3dbl_2", 384, 448, 3, 3)
        _cb(s, f"{name}.branch3x3dbl_3a", 384, 384, 1, 3)
        _cb(s, f"{name}.branch3x3dbl_3b", 384, 384, 3, 1)
        _cb(s, f"{name}.branch_pool", 192, cin, 1, 1)
    return s


class _Conv(nn.Module):
    def __init__(self, shape, key: torch.Tensor):
        super().__init__()
        co, ci, kh, kw = shape
        self.weight = nn.Parameter(prng.normal(key, shape) * math.sqrt(2.0 / (ci * kh * kw)))


class _BN(nn.Module):
    def __init__(self, c: int, device: torch.device):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))
        self.running_mean = nn.Parameter(torch.zeros(c, device=device))
        self.running_var = nn.Parameter(torch.ones(c, device=device))


class _BasicConv2d(nn.Module):
    """conv (no bias) + BN (eps 1e-3) + relu, with torchvision's names:
    He-normal weights from `key`, identity BN."""

    def __init__(self, shape, key: torch.Tensor):
        super().__init__()
        self.conv = _Conv(shape, key)
        self.bn = _BN(shape[0], key.device)

    def forward(self, x, stride=1, padding=0):
        x = F.conv2d(x, self.conv.weight.to(x.dtype), stride=stride, padding=padding)
        bn = self.bn
        scale = bn.weight / torch.sqrt(bn.running_var + _BN_EPS)
        bias = bn.bias - bn.running_mean * scale
        return F.relu(x * scale.to(x.dtype)[None, :, None, None]
                      + bias.to(x.dtype)[None, :, None, None])


def _avg_pool3(x):
    """3x3 stride-1 average pool, pad 1, zeros counted (torch's default)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool3s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionV3Features(nn.Module):
    """Pool-3 (2048-d) InceptionV3 features for FID. Constructed on CUDA
    unless `device` names another device, with the JAX `init`'s random
    weights (tests, and the card's smoke run) from `key` (PRNGKey(0) when
    None); on `meta` nothing is drawn. `load_inception` loads converted
    pretrained weights."""

    def __init__(self, resize_to: int = 299, device=None, key: Optional[torch.Tensor] = None):
        super().__init__()
        device = resolve_device(device)
        self.resize_to = resize_to
        shapes = inception_conv_shapes()
        keys = prng.split((prng.PRNGKey(0) if key is None else key).to(device), len(shapes))
        for (path, shape), k in zip(shapes.items(), keys):
            node = self
            for part in path.split(".")[:-1]:
                if not hasattr(node, part):
                    node.add_module(part, nn.Module())
                node = getattr(node, part)
            node.add_module(path.split(".")[-1], _BasicConv2d(shape, k))
        self.requires_grad_(False)
        place(self, device)

    def _block_a(self, p, x):
        b1 = p.branch1x1(x)
        b5 = p.branch5x5_2(p.branch5x5_1(x), padding=2)
        b3 = p.branch3x3dbl_3(p.branch3x3dbl_2(p.branch3x3dbl_1(x), padding=1), padding=1)
        bp = p.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b5, b3, bp], dim=1)

    def _block_b(self, p, x):
        b3 = p.branch3x3(x, stride=2)
        bd = p.branch3x3dbl_2(p.branch3x3dbl_1(x), padding=1)
        bd = p.branch3x3dbl_3(bd, stride=2)
        return torch.cat([b3, bd, _max_pool3s2(x)], dim=1)

    def _block_c(self, p, x):
        b1 = p.branch1x1(x)
        b7 = p.branch7x7_1(x)
        b7 = p.branch7x7_2(b7, padding=(0, 3))
        b7 = p.branch7x7_3(b7, padding=(3, 0))
        bd = p.branch7x7dbl_1(x)
        bd = p.branch7x7dbl_2(bd, padding=(3, 0))
        bd = p.branch7x7dbl_3(bd, padding=(0, 3))
        bd = p.branch7x7dbl_4(bd, padding=(3, 0))
        bd = p.branch7x7dbl_5(bd, padding=(0, 3))
        bp = p.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b7, bd, bp], dim=1)

    def _block_d(self, p, x):
        b3 = p.branch3x3_2(p.branch3x3_1(x), stride=2)
        b7 = p.branch7x7x3_1(x)
        b7 = p.branch7x7x3_2(b7, padding=(0, 3))
        b7 = p.branch7x7x3_3(b7, padding=(3, 0))
        b7 = p.branch7x7x3_4(b7, stride=2)
        return torch.cat([b3, b7, _max_pool3s2(x)], dim=1)

    def _block_e(self, p, x):
        b1 = p.branch1x1(x)
        b3 = p.branch3x3_1(x)
        b3 = torch.cat([p.branch3x3_2a(b3, padding=(0, 1)),
                        p.branch3x3_2b(b3, padding=(1, 0))], dim=1)
        bd = p.branch3x3dbl_2(p.branch3x3dbl_1(x), padding=1)
        bd = torch.cat([p.branch3x3dbl_3a(bd, padding=(0, 1)),
                        p.branch3x3dbl_3b(bd, padding=(1, 0))], dim=1)
        bp = p.branch_pool(_avg_pool3(x))
        return torch.cat([b1, b3, bd, bp], dim=1)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """[-1, 1] NCHW -> [N, 2048] pooled features (fp32 input)."""
        x = images.float()
        if x.shape[-1] != self.resize_to or x.shape[-2] != self.resize_to:
            x = interpolate_bilinear(x, self.resize_to, self.resize_to, antialias=False)
        x = (x + 1.0) * 0.5
        mean = torch.tensor(_IMAGENET_MEAN, device=x.device)[None, :, None, None]
        std = torch.tensor(_IMAGENET_STD, device=x.device)[None, :, None, None]
        x = (x - mean) / std

        x = self.Conv2d_1a_3x3(x, stride=2)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x, padding=1)
        x = _max_pool3s2(x)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = _max_pool3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._block_a(getattr(self, name), x)
        x = self._block_b(self.Mixed_6a, x)
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._block_c(getattr(self, name), x)
        x = self._block_d(self.Mixed_7a, x)
        x = self._block_e(self.Mixed_7b, x)
        x = self._block_e(self.Mixed_7c, x)
        return x.mean(dim=(2, 3))

    forward = features


def convert_torch_inception(state: Mapping[str, np.ndarray]) -> dict:
    """torchvision `inception_v3` state_dict (numpy values) -> the param
    tree both packages store under `inception` (numpy, fp32). The aux head
    (`AuxLogits.*`) and `fc.*` are dropped: FID needs pool-3 only."""
    params: dict = {}
    for path, shape in inception_conv_shapes().items():
        node = params
        for part in path.split(".")[:-1]:
            node = node.setdefault(part, {})
        w = np.asarray(state[f"{path}.conv.weight"], dtype=np.float32)
        if w.shape != shape:
            raise ValueError(f"{path}.conv.weight has {w.shape}, want {shape}")
        node[path.split(".")[-1]] = {
            "conv": {"weight": w},
            "bn": {k: np.asarray(state[f"{path}.bn.{k}"], np.float32)
                   for k in ("weight", "bias", "running_mean", "running_var")},
        }
    return params


def load_inception(path: str, device=None, resize_to: int = 299) -> InceptionV3Features:
    """The net with the weights of a `gnerf_tpu_torch.tools.convert_inception` npz (its
    `inception` tree), on CUDA unless `device` names another device."""
    from ..utils import checkpoint as ckpt_lib

    trees, _ = ckpt_lib.load_checkpoint(path)
    net = InceptionV3Features(resize_to=resize_to, device="meta")
    return ckpt_lib.load_jax_params(net, trees["inception"], device=resolve_device(device))
