"""Training losses: SSIM, VGG16-LPIPS, the depth GAN losses and R1.

Port of `gnerf_tpu/training/losses.py`:

  * SSIM with pytorch_msssim semantics (11x11 gaussian window, sigma 1.5,
    valid padding, K1=0.01 / K2=0.03, per-sample average); the window
    shrinks to an odd size for images smaller than it.
  * LPIPS through a VGG16 feature net (per-layer unit-normalized features
    times learned per-channel weights; the squared distance of two
    embeddings is their LPIPS distance). Weights come from the npz that
    `python -m gnerf_tpu_torch.tools.convert_vgg16_lpips` writes, or are random
    with a loud warning.
  * Non-saturating softplus GAN losses, and the R1 penalty through
    `torch.autograd.grad(create_graph=True)`.
"""

from __future__ import annotations

import json
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interpolate import interpolate_bilinear
from ..utils import prng
from ..utils.device import place, resolve_device
from ..utils.profiling import profiled_function

# ---------------------------------------------------------------------------
# SSIM


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return g.astype(np.float32)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         size_average: bool = True, win_size: int = 11, win_sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Structural similarity of [N, C, H, W] images; per-sample values [N]
    when `size_average` is False."""
    smaller = min(x.shape[2], x.shape[3])
    if smaller < win_size:
        win_size = smaller if smaller % 2 == 1 else smaller - 1
    win = torch.from_numpy(_gaussian_window(win_size, win_sigma)).to(x.device)
    c = x.shape[1]

    def blur(img):  # separable gaussian, valid padding, per channel
        kh = win.to(img.dtype).reshape(1, 1, -1, 1).expand(c, 1, win_size, 1)
        kw = win.to(img.dtype).reshape(1, 1, 1, -1).expand(c, 1, 1, win_size)
        return F.conv2d(F.conv2d(img, kh, groups=c), kw, groups=c)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x, mu_y = blur(x), blur(y)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = blur(x * x) - mu_xx
    sigma_y = blur(y * y) - mu_yy
    sigma_xy = blur(x * y) - mu_xy
    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    per_sample = ssim_map.mean(dim=(1, 2, 3))
    return per_sample.mean() if size_average else per_sample


# ---------------------------------------------------------------------------
# VGG16 LPIPS

_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
            512, 512, 512)
# Convs (0-based over the 13) whose post-relu outputs feed LPIPS:
# relu1_2, relu2_2, relu3_3, relu4_3, relu5_3.
_LPIPS_LAYERS = (1, 3, 6, 9, 12)
_LPIPS_DIMS = (64, 128, 256, 512, 512)


class _Conv3x3(nn.Module):
    def __init__(self, in_c: int, out_c: int, key: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(prng.normal(key, (out_c, in_c, 3, 3))
                                   * math.sqrt(2.0 / (in_c * 9)))
        self.bias = nn.Parameter(torch.zeros(out_c, device=key.device))

    def forward(self, x):
        # The bias is cast too: an fp32 bias must not promote a bf16 chain.
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), padding=1)


class _Preprocess(nn.Module):
    """The LPIPS ScalingLayer, (x - shift) / scale on [-1, 1] input."""

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.zeros(3))
        self.register_buffer("scale", torch.ones(3))


class VGG16LPIPS(nn.Module):
    """VGG16 feature extractor producing LPIPS embedding vectors.

    `apply(images)` takes [N, 3, H, W] in [0, 255], resizes to `resize_to`
    (bilinear, antialiased by default) and returns [N, D] vectors whose
    squared euclidean distance is the LPIPS distance. The weights are frozen
    (`requires_grad` False); names follow the JAX tree (`conv0/weight`,
    `lin0`, optional `preprocess/shift`). Constructed on CUDA unless `device`
    names another device, from `key` (PRNGKey(0) when None) split as the
    JAX `init` splits it; on `meta` nothing is drawn."""

    def __init__(self, resize_to: int = 256, antialias: bool = True, preprocess: bool = False,
                 device=None, key: Optional[torch.Tensor] = None):
        super().__init__()
        device = resolve_device(device)
        keys = prng.split((prng.PRNGKey(0) if key is None else key).to(device),
                          len(_VGG_CFG) + len(_LPIPS_LAYERS))
        self.resize_to = resize_to
        self.antialias = antialias
        in_c, conv_i = 3, 0
        for v in _VGG_CFG:
            if v != "M":
                setattr(self, f"conv{conv_i}", _Conv3x3(in_c, v, keys[conv_i]))
                in_c, conv_i = v, conv_i + 1
        self.n_convs = conv_i
        for i, d in enumerate(_LPIPS_DIMS):
            setattr(self, f"lin{i}", nn.Parameter(torch.ones(d, device=device) / d))
        if preprocess:
            self.preprocess = _Preprocess()
        self.requires_grad_(False)
        place(self, device)

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        conv_i = 0
        for v in _VGG_CFG:
            if v == "M":
                x = F.max_pool2d(x, kernel_size=2, stride=2)
                continue
            x = F.relu(getattr(self, f"conv{conv_i}")(x))
            if conv_i in _LPIPS_LAYERS:
                feats.append(x)
            conv_i += 1
        return feats

    @profiled_function("lpips")
    def apply(self, images: torch.Tensor) -> torch.Tensor:
        """[N, 3, H, W] in [0, 255] -> [N, D] embeddings. (Shadows
        `nn.Module.apply`, to keep the JAX package's name.)"""
        x = images
        if x.shape[-1] != self.resize_to:
            x = interpolate_bilinear(x, self.resize_to, self.resize_to, antialias=self.antialias)
        x = x / 255.0 * 2.0 - 1.0
        pre = getattr(self, "preprocess", None)
        if pre is not None:
            x = ((x - pre.shift.to(x.dtype)[None, :, None, None])
                 / pre.scale.to(x.dtype)[None, :, None, None])
        out = []
        for i, f in enumerate(self.features(x)):
            # Channel norms accumulate in fp32 and are cast back, so a bf16
            # chain stays bf16; 1/sqrt(HW) makes the squared distance the
            # mean over positions.
            norm = torch.sqrt(f.float().square().sum(dim=1, keepdim=True) + 1e-10)
            f = f / norm.to(f.dtype)
            f = f * getattr(self, f"lin{i}").to(f.dtype)[None, :, None, None]
            n, _, h, w = f.shape
            out.append((f / math.sqrt(h * w)).reshape(n, -1))
        return torch.cat(out, dim=1)

    forward = apply


def lpips_embed(vgg: VGG16LPIPS, images: torch.Tensor) -> torch.Tensor:
    """LPIPS embedding of [-1, 1] images. The training step embeds the
    targets (no gradient) and the fakes as separate batches, so no conv
    backward ever runs over the constant half."""
    return vgg.apply((images + 1) * 255 * 0.5)


def lpips_training_distance(vgg: VGG16LPIPS, target: torch.Tensor,
                            pred: torch.Tensor) -> torch.Tensor:
    """Per-sample LPIPS with gradients through `pred` only."""
    with torch.no_grad():
        emb_t = lpips_embed(vgg, target)
    emb_p = lpips_embed(vgg, pred)
    return (emb_t - emb_p).float().square().sum(dim=1)


def lpips_distance(vgg: VGG16LPIPS, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-sample LPIPS distance of [-1, 1] images, for forward-only
    callers: one VGG pass over [a; b]; the sum accumulates in fp32."""
    fa, fb = lpips_embed(vgg, torch.cat([a, b], dim=0)).chunk(2, dim=0)
    return (fa - fb).float().square().sum(dim=1)


def load_lpips(path: str, device=None) -> tuple[VGG16LPIPS, dict]:
    """Converted LPIPS weights (the npz of `python -m
    gnerf_tpu_torch.tools.convert_vgg16_lpips`, as the JAX package reads it)
    -> (net, meta). The net takes the resize and antialias settings the
    converter calibrated; meta["pretrained"] is True."""
    from ..utils.checkpoint import load_jax_params

    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(flat.pop("__meta__").tobytes().decode("utf-8"))
    net = VGG16LPIPS(resize_to=int(meta.get("resize_to", 256)),
                     antialias=bool(meta.get("antialias", True)),
                     preprocess=any(k.startswith("preprocess/") for k in flat), device="meta")
    load_jax_params(net, flat, device=resolve_device(device))
    meta.setdefault("pretrained", True)
    return net, meta


def lpips_params_or_warn(path: Optional[str] = None, device=None,
                         key: Optional[torch.Tensor] = None) -> tuple[VGG16LPIPS, bool]:
    """The training loop's LPIPS: converted weights when `path` is given,
    otherwise RANDOM VGG16 features from `key` with a loud warning. Returns
    (net, pretrained)."""
    if path:
        net, meta = load_lpips(path, device=device)
        print(f"LPIPS: loaded pretrained VGG16 weights from {path} "
              f"(resize {net.resize_to}, antialias={net.antialias}, "
              f"calibration err {meta.get('calibration_err', 'n/a')})")
        return net, True
    print("WARNING: LPIPS is running on RANDOM VGG16 weights — the "
          "perceptual term will NOT match the reference objective. Convert "
          "NVIDIA's vgg16.pt with `python -m gnerf_tpu_torch.tools.convert_vgg16_lpips` and pass "
          "--lpips-weights to fix this.")
    return VGG16LPIPS(device=device, key=key), False


def lpips_from_checkpoint(trees: dict, lpips_weights: str = "", device=None,
                          warn: bool = False) -> VGG16LPIPS:
    """The LPIPS net of the PTI and eval CLIs: converted weights when
    `lpips_weights` is given, else the checkpoint's `VGG` tree, else random
    weights from PRNGKey(1), as the JAX CLIs draw them (with a warning when
    `warn`)."""
    from ..utils.checkpoint import load_jax_params

    if lpips_weights:
        return load_lpips(lpips_weights, device=device)[0]
    device = resolve_device(device)
    if "VGG" in trees:
        return load_jax_params(VGG16LPIPS(device="meta"), trees["VGG"], device=device)
    if warn:
        print("WARNING: no pretrained LPIPS weights — PTI will optimize a random-VGG "
              "perceptual objective (pass --lpips-weights)")
    return VGG16LPIPS(device=device, key=prng.PRNGKey(1))


# ---------------------------------------------------------------------------
# GAN losses


def g_nonsaturating_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """softplus(-D(G(z))), the generator side."""
    return F.softplus(-fake_logits).mean()


def d_logistic_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    return (F.softplus(fake_logits) + F.softplus(-real_logits)).mean()


def r1_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor],
               real_images: torch.Tensor) -> torch.Tensor:
    """Per-sample R1 penalty sum_i ||dD/dx_i||^2, differentiable with
    respect to D's parameters (the gradient is taken with create_graph)."""
    x = real_images.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(x).sum(), x, create_graph=True)
    return grads.square().sum(dim=(1, 2, 3))


def masked_mean(values: torch.Tensor, factor: torch.Tensor, eps: float = 1e-6,
                factor_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum(values * factor) / (sum(factor) + eps): the `factor`-weighted
    reconstruction normalization. `factor_sum` stands in for sum(factor)
    (a data shard passes the global batch's)."""
    if factor_sum is None:
        factor_sum = factor.sum()
    return (values * factor).sum() / (factor_sum + eps)
