"""StyleGAN2 networks as PyTorch modules: generator and discriminator.

Port of `gnerf_tpu/models/stylegan2.py`. Parameter
names and layouts are the JAX package's (which mirror the reference
state_dict: `fc0`, `b4.conv1.affine.weight`, OIHW conv weights, `[out, in]`
dense weights), so `utils.checkpoint.load_jax_params` is a rename. Weights
stay fp32 and are cast to the activation dtype at use; `dtype=bf16` runs the
blocks in bf16 while the ToRGB skip accumulates in fp32, as in the JAX
package. Random init draws from an explicit `torch.Generator`, and so does
`noise_mode="random"`. Every op is plain PyTorch, so the discriminator is
twice differentiable, as the R1 penalty needs.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.conv2d_resample import conv2d_resample
from ..ops.upfirdn2d import downsample2d, setup_filter, upsample2d
from ..parallel.collectives import all_gather
from ..parallel.mesh import active_mesh
from ..parallel.sharding import draw, local_rows
from ..utils.device import resolve_device


def normalize_2nd_moment(x: torch.Tensor, dim: int = 1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def modulated_conv2d(
    x: torch.Tensor,                   # [N, C_in, H, W]
    weight: torch.Tensor,              # [C_out, C_in, kh, kw]
    styles: torch.Tensor,              # [N, C_in]
    noise: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding: int = 0,
    resample_filter: Optional[torch.Tensor] = None,
    demodulate: bool = True,
    flip_weight: bool = True,
) -> torch.Tensor:
    """Style-modulated convolution, scale-activations form: scale the input
    channels by the styles, convolve once, rescale the output channels by
    the demodulation coefficients (computed in fp32)."""
    dcoefs = None
    if demodulate:
        w = weight[None] * styles[:, None, :, None, None]  # [N, O, I, kh, kw]
        dcoefs = torch.rsqrt(w.square().sum(dim=(2, 3, 4)) + 1e-8)  # [N, O]
    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up, down=down,
                        padding=padding, flip_weight=flip_weight)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x


class FullyConnectedLayer(nn.Module):
    """Equalized-LR dense layer."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 activation: str = "linear", lr_multiplier: float = 1.0,
                 bias_init: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight = nn.Parameter(
            torch.randn((out_features, in_features), generator=generator) / lr_multiplier)
        self.bias = (nn.Parameter(torch.full((out_features,), float(bias_init)))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gain = self.lr_multiplier / math.sqrt(self.in_features)
        x = x @ (self.weight.to(x.dtype) * gain).t()
        b = self.bias * self.lr_multiplier if self.bias is not None else None
        return bias_act(x, b, act=self.activation)


class Conv2dLayer(nn.Module):
    """Non-modulated conv with optional resampling."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias: bool = True, activation: str = "linear", up: int = 1, down: int = 1,
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_channels = in_channels
        self.kernel_size = kernel_size
        self.activation = activation
        self.up, self.down = up, down
        self.conv_clamp = conv_clamp
        self.weight = nn.Parameter(
            torch.randn((out_channels, in_channels, kernel_size, kernel_size), generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.register_buffer("resample_filter", setup_filter(list(resample_filter)),
                             persistent=False)

    def forward(self, x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
        w = self.weight * (1 / math.sqrt(self.in_channels * self.kernel_size ** 2))
        f = self.resample_filter if (self.up > 1 or self.down > 1) else None
        x = conv2d_resample(x, w.to(x.dtype), f=f, up=self.up, down=self.down,
                            padding=self.kernel_size // 2, flip_weight=self.up == 1)
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)


class MappingNetwork(nn.Module):
    """z (+ embedded c) -> broadcast ws, with truncation toward `w_avg`."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, num_ws: Optional[int],
                 num_layers: int = 8, embed_features: Optional[int] = None,
                 layer_features: Optional[int] = None, activation: str = "lrelu",
                 lr_multiplier: float = 0.01, w_avg_beta: Optional[float] = 0.998,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.z_dim, self.c_dim, self.w_dim, self.num_ws = z_dim, c_dim, w_dim, num_ws
        self.num_layers = num_layers
        embed = embed_features if embed_features is not None else w_dim
        if c_dim == 0:
            embed = 0
        layer = layer_features if layer_features is not None else w_dim
        feats = [z_dim + embed] + [layer] * (num_layers - 1) + [w_dim]
        for i in range(num_layers):
            setattr(self, f"fc{i}", FullyConnectedLayer(
                feats[i], feats[i + 1], activation=activation,
                lr_multiplier=lr_multiplier, generator=generator))
        if c_dim > 0:
            self.embed = FullyConnectedLayer(c_dim, embed, generator=generator)
        if num_ws is not None and w_avg_beta is not None:
            self.register_buffer("w_avg", torch.zeros(w_dim))

    def forward(self, z: Optional[torch.Tensor], c: Optional[torch.Tensor],
                truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None) -> torch.Tensor:
        x = None
        if self.z_dim > 0:
            x = normalize_2nd_moment(z.float())
        if self.c_dim > 0:
            y = normalize_2nd_moment(self.embed(c.float()))
            x = torch.cat([x, y], dim=1) if x is not None else y
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        if self.num_ws is not None:
            x = x[:, None, :].repeat(1, self.num_ws, 1)
        if truncation_psi != 1:
            w_avg = self.w_avg
            if self.num_ws is None or truncation_cutoff is None:
                x = w_avg + (x - w_avg) * truncation_psi
            else:
                head = w_avg + (x[:, :truncation_cutoff] - w_avg) * truncation_psi
                x = torch.cat([head, x[:, truncation_cutoff:]], dim=1)
        return x


class SynthesisLayer(nn.Module):
    """Modulated conv + per-pixel noise + biased activation."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 kernel_size: int = 3, up: int = 1, use_noise: bool = True,
                 activation: str = "lrelu", resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.resolution = resolution
        self.kernel_size = kernel_size
        self.up = up
        self.use_noise = use_noise
        self.activation = activation
        self.conv_clamp = conv_clamp
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1, generator=generator)
        self.weight = nn.Parameter(
            torch.randn((out_channels, in_channels, kernel_size, kernel_size), generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        if use_noise:
            self.noise_const = nn.Parameter(torch.randn((resolution, resolution), generator=generator))
            self.noise_strength = nn.Parameter(torch.zeros(()))
        self.register_buffer("resample_filter", setup_filter(list(resample_filter)),
                             persistent=False)

    def forward(self, x: torch.Tensor, w: torch.Tensor, noise_mode: str = "random",
                gain: float = 1.0, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if noise_mode not in ("random", "const", "none"):
            raise ValueError(f"unknown noise_mode {noise_mode!r}")
        styles = self.affine(w)
        noise = None
        if self.use_noise and noise_mode == "random":
            if rng is None:
                raise ValueError("noise_mode='random' needs an explicit torch.Generator (rng)")
            noise = draw(torch.randn, (x.shape[0], 1, self.resolution, self.resolution),
                         rng, device=x.device) * self.noise_strength
        if self.use_noise and noise_mode == "const":
            noise = self.noise_const * self.noise_strength
        f = self.resample_filter if self.up > 1 else None
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up,
                             padding=self.kernel_size // 2, resample_filter=f,
                             flip_weight=self.up == 1)
        act_gain = activation_funcs[self.activation].def_gain * gain
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)


class ToRGBLayer(nn.Module):
    """1x1 modulated conv to image channels, no demodulation."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 kernel_size: int = 1, conv_clamp: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight_gain = 1 / math.sqrt(in_channels * kernel_size ** 2)
        self.conv_clamp = conv_clamp
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1, generator=generator)
        self.weight = nn.Parameter(
            torch.randn((out_channels, in_channels, kernel_size, kernel_size), generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        styles = self.affine(w) * self.weight_gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False)
        return bias_act(x, self.bias, clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """One resolution stage: [conv0 (up)] + conv1 + skip-accumulated ToRGB.
    `up=1` is the no-upsample variant the superresolution stack uses."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 img_channels: int, is_last: bool, architecture: str = "skip",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = 256, up: int = 2, use_noise: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if architecture not in ("orig", "skip", "resnet"):
            raise ValueError(f"unknown architecture {architecture!r}")
        self.in_channels = in_channels
        self.architecture = architecture
        self.up = up
        self.num_conv = 1 if in_channels == 0 else 2
        self.num_torgb = 1 if (is_last or architecture == "skip") else 0
        g = generator
        if in_channels == 0:
            self.const = nn.Parameter(torch.randn((out_channels, resolution, resolution), generator=g))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim, resolution, up=up,
                                        resample_filter=resample_filter,
                                        conv_clamp=conv_clamp, use_noise=use_noise, generator=g)
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim, resolution,
                                    conv_clamp=conv_clamp, use_noise=use_noise, generator=g)
        if self.num_torgb:
            self.torgb = ToRGBLayer(out_channels, img_channels, w_dim,
                                    conv_clamp=conv_clamp, generator=g)
        if in_channels != 0 and architecture == "resnet":
            self.skip = Conv2dLayer(in_channels, out_channels, kernel_size=1, bias=False,
                                    up=2, resample_filter=resample_filter, generator=g)
        self.register_buffer("resample_filter", setup_filter(list(resample_filter)),
                             persistent=False)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                ws: torch.Tensor, noise_mode: str = "random",
                rng: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.float32):
        """ws: [N, num_conv + num_torgb, w_dim]. Returns (x, img)."""
        w_iter = iter(ws.unbind(dim=1))
        if self.in_channels == 0:
            x = self.const.to(dtype)[None].expand(ws.shape[0], *self.const.shape)
            x = self.conv1(x, next(w_iter), noise_mode=noise_mode, rng=rng)
        elif self.architecture == "resnet":
            x = x.to(dtype)
            y = self.skip(x, gain=math.sqrt(0.5))
            x = self.conv0(x, next(w_iter), noise_mode=noise_mode, rng=rng)
            x = self.conv1(x, next(w_iter), noise_mode=noise_mode, gain=math.sqrt(0.5), rng=rng)
            x = y + x
        else:
            x = x.to(dtype)
            x = self.conv0(x, next(w_iter), noise_mode=noise_mode, rng=rng)
            x = self.conv1(x, next(w_iter), noise_mode=noise_mode, rng=rng)
        if img is not None and self.up == 2:
            img = upsample2d(img, self.resample_filter)
        if self.num_torgb:
            y = self.torgb(x, next(w_iter)).float()
            img = img + y if img is not None else y
        return x, img


class SynthesisNetwork(nn.Module):
    """Progressive 4x4 -> img_resolution stack of SynthesisBlocks."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512, num_fp16_res: int = 4,
                 conv_clamp: Optional[float] = 256, architecture: str = "skip",
                 use_noise: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        log2 = int(math.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(2, log2 + 1)]
        self.num_ws = 0
        for res in self.block_resolutions:
            in_ch = min(channel_base // (res // 2), channel_max) if res > 4 else 0
            block = SynthesisBlock(in_ch, min(channel_base // res, channel_max), w_dim, res,
                                   img_channels, is_last=res == img_resolution,
                                   conv_clamp=conv_clamp, architecture=architecture,
                                   use_noise=use_noise, generator=generator)
            setattr(self, f"b{res}", block)
            self.num_ws += block.num_conv + (block.num_torgb if res == img_resolution else 0)

    def forward(self, ws: torch.Tensor, noise_mode: str = "random",
                rng: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        ws = ws.float()
        x = img = None
        w_idx = 0
        for res in self.block_resolutions:
            block = getattr(self, f"b{res}")
            cur_ws = ws[:, w_idx: w_idx + block.num_conv + block.num_torgb]
            x, img = block(x, img, cur_ws, noise_mode=noise_mode, rng=rng, dtype=dtype)
            w_idx += block.num_conv
        return img


class Generator(nn.Module):
    """Mapping + synthesis."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, img_resolution: int,
                 img_channels: int, mapping_layers: int = 8, channel_base: int = 32768,
                 channel_max: int = 512, conv_clamp: Optional[float] = 256,
                 use_noise: bool = True, architecture: str = "skip",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.synthesis = SynthesisNetwork(w_dim, img_resolution, img_channels,
                                          channel_base=channel_base, channel_max=channel_max,
                                          conv_clamp=conv_clamp, architecture=architecture,
                                          use_noise=use_noise, generator=generator)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim, c_dim, w_dim, num_ws=self.num_ws,
                                      num_layers=mapping_layers, generator=generator)

    def forward(self, z, c, truncation_psi=1.0, truncation_cutoff=None,
                noise_mode="random", rng=None, dtype=torch.float32) -> torch.Tensor:
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, noise_mode=noise_mode, rng=rng, dtype=dtype)


# ---------------------------------------------------------------------------
# Discriminator


class DiscriminatorBlock(nn.Module):
    """Downsampling block, resnet or skip architecture."""

    def __init__(self, in_channels: int, tmp_channels: int, out_channels: int,
                 resolution: int, img_channels: int, architecture: str = "resnet",
                 activation: str = "lrelu", resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if architecture not in ("orig", "skip", "resnet"):
            raise ValueError(f"unknown architecture {architecture!r}")
        self.in_channels = in_channels
        self.architecture = architecture
        g = generator
        if in_channels == 0 or architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, kernel_size=1,
                                       activation=activation, conv_clamp=conv_clamp, generator=g)
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, kernel_size=3,
                                 activation=activation, conv_clamp=conv_clamp, generator=g)
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, kernel_size=3,
                                 activation=activation, down=2, resample_filter=resample_filter,
                                 conv_clamp=conv_clamp, generator=g)
        if architecture == "resnet":
            self.skip = Conv2dLayer(tmp_channels, out_channels, kernel_size=1, bias=False,
                                    down=2, resample_filter=resample_filter, generator=g)
        self.register_buffer("resample_filter", setup_filter(list(resample_filter)),
                             persistent=False)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                dtype: torch.dtype = torch.float32):
        if x is not None:
            x = x.to(dtype)
        if self.in_channels == 0 or self.architecture == "skip":
            img = img.to(dtype)
            y = self.fromrgb(img)
            x = x + y if x is not None else y
            img = (downsample2d(img, self.resample_filter)
                   if self.architecture == "skip" else None)
        if self.architecture == "resnet":
            y = self.skip(x, gain=math.sqrt(0.5))
            x = self.conv0(x)
            x = self.conv1(x, gain=math.sqrt(0.5))
            x = y + x
        else:
            x = self.conv0(x)
            x = self.conv1(x)
        return x, img


def minibatch_std(x: torch.Tensor, group_size: Optional[int],
                  num_channels: int = 1) -> torch.Tensor:
    """Append cross-sample standard-deviation channels, over groups of
    `min(group_size, N)` samples: group j holds rows j, j + N/G, j + 2N/G, ...

    N is the global batch: under a mesh x is gathered over the data shards
    (with gradient), so a group may span ranks, and each rank keeps its own
    rows of the channels."""
    mesh = active_mesh()
    xg = x if mesh is None else all_gather(x, mesh.data_group)
    n, c, h, w = xg.shape
    g = min(group_size, n) if group_size is not None else n
    f = num_channels
    y = xg.reshape(g, -1, f, c // f, h, w)
    y = y - y.mean(dim=0)
    y = y.square().mean(dim=0)
    y = (y + 1e-8).sqrt()
    y = y.mean(dim=(2, 3, 4))
    y = y.reshape(-1, f, 1, 1).repeat(g, 1, h, w)
    if mesh is not None:
        y = local_rows(y, mesh)
    return torch.cat([x, y], dim=1)


class DiscriminatorEpilogue(nn.Module):
    """4x4 head: minibatch std, conv, fc, out, and the projection onto the
    conditioning map."""

    def __init__(self, in_channels: int, cmap_dim: int, resolution: int, img_channels: int,
                 architecture: str = "resnet", mbstd_group_size: Optional[int] = 4,
                 mbstd_num_channels: int = 1, activation: str = "lrelu",
                 conv_clamp: Optional[float] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cmap_dim = cmap_dim
        self.architecture = architecture
        self.mbstd_group_size = mbstd_group_size
        self.mbstd_num_channels = mbstd_num_channels
        g = generator
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels, kernel_size=3,
                                activation=activation, conv_clamp=conv_clamp, generator=g)
        self.fc = FullyConnectedLayer(in_channels * resolution ** 2, in_channels,
                                      activation=activation, generator=g)
        self.out = FullyConnectedLayer(in_channels, 1 if cmap_dim == 0 else cmap_dim, generator=g)
        if architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, in_channels, kernel_size=1,
                                       activation=activation, generator=g)

    def forward(self, x, img, cmap):
        x = x.float()
        if self.architecture == "skip":
            x = x + self.fromrgb(img.float())
        if self.mbstd_num_channels > 0:
            x = minibatch_std(x, self.mbstd_group_size, self.mbstd_num_channels)
        x = self.conv(x)
        x = self.fc(x.reshape(x.shape[0], -1))
        x = self.out(x)
        if self.cmap_dim > 0:
            x = (x * cmap).sum(dim=1, keepdim=True) * (1 / math.sqrt(self.cmap_dim))
        return x


class Discriminator(nn.Module):
    """StyleGAN2 discriminator, conditioned on the camera label through a
    mapping network. G-NeRF's depth discriminator takes one-channel 64^2
    depth maps. Constructed on CUDA unless `device` names another device;
    parameters are drawn on the CPU from `generator` (seed 0 when None)."""

    def __init__(self, c_dim: int, img_resolution: int, img_channels: int,
                 architecture: str = "resnet", channel_base: int = 32768,
                 channel_max: int = 512, conv_clamp: Optional[float] = 256,
                 cmap_dim: Optional[int] = None, mbstd_group_size: Optional[int] = 4,
                 mapping_layers: int = 8, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        log2 = int(math.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(log2, 2, -1)]
        self.c_dim = c_dim

        def channels(res):
            return min(channel_base // res, channel_max)

        cmap = cmap_dim if cmap_dim is not None else channels(4)
        cmap = 0 if c_dim == 0 else cmap
        for res in self.block_resolutions:
            setattr(self, f"b{res}", DiscriminatorBlock(
                channels(res) if res < img_resolution else 0, channels(res), channels(res // 2),
                res, img_channels, architecture=architecture, conv_clamp=conv_clamp,
                generator=generator))
        if c_dim > 0:
            self.mapping = MappingNetwork(z_dim=0, c_dim=c_dim, w_dim=cmap, num_ws=None,
                                          w_avg_beta=None, num_layers=mapping_layers,
                                          generator=generator)
        self.b4 = DiscriminatorEpilogue(channels(4), cmap_dim=cmap, resolution=4,
                                        img_channels=img_channels, architecture=architecture,
                                        mbstd_group_size=mbstd_group_size, conv_clamp=conv_clamp,
                                        generator=generator)
        self.to(device)

    def forward(self, img: torch.Tensor, c: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[N, img_channels, R, R] images (+ labels [N, c_dim]) -> logits [N, 1]."""
        x = None
        for res in self.block_resolutions:
            x, img = getattr(self, f"b{res}")(x, img, dtype=dtype)
        cmap = self.mapping(None, c) if self.c_dim > 0 else None
        return self.b4(x, img, cmap)

    def apply(self, img, c=None, dtype=torch.float32) -> torch.Tensor:
        """The JAX package's name for the forward pass. (Shadows
        `nn.Module.apply`.)"""
        return self.forward(img, c, dtype=dtype)
