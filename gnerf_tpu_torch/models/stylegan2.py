"""StyleGAN2 networks as PyTorch modules: generator and discriminator.

Port of `gnerf_tpu/models/stylegan2.py`. Parameter
names and layouts are the JAX package's (which mirror the reference
state_dict: `fc0`, `b4.conv1.affine.weight`, OIHW conv weights, `[out, in]`
dense weights), so `utils.checkpoint.load_jax_params` is a rename. Weights
stay fp32 and are cast to the activation dtype at use; `dtype=bf16` runs the
blocks in bf16 while the ToRGB skip accumulates in fp32, as in the JAX
package. Every constructor takes a threefry `key` (`utils.prng`) and splits
it as the JAX `init` does, so a key gives JAX's parameters; they are made on
the key's device (nothing is drawn on `meta`). `noise_mode="random"` draws
from the call's key (`rng`), split per block and layer as the JAX `apply`
splits it, so a key gives JAX's noise; a network's noise layers are drawn
together in one launch (`draw_noise`). Every op is plain PyTorch, so the
discriminator is twice differentiable, as the R1 penalty needs.

The channels-last route. A synthesis block whose activations are bf16 on
CUDA, in a call that autograd would not record (inference: the orbit, the
server's batches, `generate_videos`), runs its modulated convolutions
channels last (`channels_last_route`): cuDNN's NHWC convolutions with no
layout transposes, each followed by one launch of `ops.modconv_epilogue`
(demodulation, noise, bias, activation, gain, clamp and, inside a block,
conv1's input styles, or ToRGB's in a stack's last block), the up layers'
input styles applied inside the channels-last `upfirdn2d`, and ToRGB as one
product over the channels.
Every other call (fp32, a gradient, the CPU) runs the NCHW chain below.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.bias_act import activation_funcs, bias_act
from ..ops.conv2d_resample import conv2d_resample
from ..ops.modconv_epilogue import modconv_epilogue
from ..ops.upfirdn2d import downsample2d, setup_filter, upfirdn2d_channels_last, upsample2d
from ..parallel.collectives import all_gather
from ..parallel.mesh import active_mesh
from ..parallel.sharding import draw_many, local_rows
from ..utils import prng
from ..utils.device import place, resolve_device
from ..utils.profiling import profiled_function


def root_key(key: Optional[torch.Tensor]) -> torch.Tensor:
    """`key`, or PRNGKey(0) on the CPU when None."""
    return prng.PRNGKey(0) if key is None else key


def zeros(shape, key: torch.Tensor) -> torch.Tensor:
    """A constant leaf on the key's device (`meta` while a load builds)."""
    return torch.zeros(shape, device=key.device)


def normalize_2nd_moment(x: torch.Tensor, dim: int = 1, eps: float = 1e-8) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=dim, keepdim=True) + eps)


def demodulation(weight: torch.Tensor, styles: torch.Tensor) -> torch.Tensor:
    """The demodulation coefficients [N, O] of weight [O, I, kh, kw] under
    styles [N, I], in fp32."""
    w = weight[None] * styles[:, None, :, None, None]  # [N, O, I, kh, kw]
    return torch.rsqrt(w.square().sum(dim=(2, 3, 4)) + 1e-8)


def channels_last_route(dtype: torch.dtype, device: torch.device, *inputs) -> bool:
    """Whether a synthesis block takes the channels-last route: bf16
    activations on CUDA, in a call that autograd would not record (grad mode
    off, or none of `inputs`, the block's input, ws and parameters, needs a
    gradient)."""
    return (dtype == torch.bfloat16 and torch.device(device).type == "cuda"
            and not (torch.is_grad_enabled()
                     and any(t is not None and t.requires_grad for t in inputs)))


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
    dcoefs = demodulation(weight, styles) if demodulate else None
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
                 bias_init: float = 0.0, key: Optional[torch.Tensor] = None):
        super().__init__()
        key = root_key(key)
        self.in_features = in_features
        self.activation = activation
        self.lr_multiplier = lr_multiplier
        self.weight = nn.Parameter(prng.normal(key, (out_features, in_features)) / lr_multiplier)
        self.bias = (nn.Parameter(zeros((out_features,), key) + float(bias_init))
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
                 conv_clamp: Optional[float] = None, key: Optional[torch.Tensor] = None):
        super().__init__()
        key = root_key(key)
        self.in_channels = in_channels
        self.kernel_size = kernel_size
        self.activation = activation
        self.up, self.down = up, down
        self.conv_clamp = conv_clamp
        self.weight = nn.Parameter(
            prng.normal(key, (out_channels, in_channels, kernel_size, kernel_size)))
        self.bias = nn.Parameter(zeros(out_channels, key)) if bias else None
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
                 key: Optional[torch.Tensor] = None):
        super().__init__()
        keys = prng.split(root_key(key), num_layers + 1)
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
                lr_multiplier=lr_multiplier, key=keys[i]))
        if c_dim > 0:
            self.embed = FullyConnectedLayer(c_dim, embed, key=keys[-1])
        if num_ws is not None and w_avg_beta is not None:
            self.register_buffer("w_avg", zeros(w_dim, keys))

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
                 conv_clamp: Optional[float] = None, key: Optional[torch.Tensor] = None):
        super().__init__()
        k_affine, k_weight, k_noise = prng.split(root_key(key), 3)
        self.resolution = resolution
        self.kernel_size = kernel_size
        self.up = up
        self.use_noise = use_noise
        self.activation = activation
        self.conv_clamp = conv_clamp
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1, key=k_affine)
        self.weight = nn.Parameter(
            prng.normal(k_weight, (out_channels, in_channels, kernel_size, kernel_size)))
        self.bias = nn.Parameter(zeros(out_channels, k_weight))
        if use_noise:
            self.noise_const = nn.Parameter(prng.normal(k_noise, (resolution, resolution)))
            self.noise_strength = nn.Parameter(zeros((), k_noise))
        self.register_buffer("resample_filter", setup_filter(list(resample_filter)),
                             persistent=False)

    def forward(self, x: torch.Tensor, w: torch.Tensor, noise_mode: str = "random",
                gain: float = 1.0, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`noise`: this layer's standard normal draw [N, 1, r, r] for
        `noise_mode="random"` (`draw_noise`)."""
        styles = self.affine(w)
        noise = self._noise(noise_mode, noise)
        f = self.resample_filter if self.up > 1 else None
        x = modulated_conv2d(x, self.weight, styles, noise=noise, up=self.up,
                             padding=self.kernel_size // 2, resample_filter=f,
                             flip_weight=self.up == 1)
        act_gain, act_clamp = self._act(gain)
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=act_clamp)

    def _noise(self, noise_mode: str, noise: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """The noise to add, times its strength (fp32), or None."""
        if noise_mode not in ("random", "const", "none"):
            raise ValueError(f"unknown noise_mode {noise_mode!r}")
        if not self.use_noise or noise_mode == "none":
            return None
        if noise_mode == "const":
            return self.noise_const * self.noise_strength
        if noise is None:
            raise ValueError("noise_mode='random' needs a key (rng)")
        return noise * self.noise_strength

    def _act(self, gain: float) -> tuple:
        """(gain, clamp) of the activation."""
        act_clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return activation_funcs[self.activation].def_gain * gain, act_clamp

    def forward_channels_last(self, x: torch.Tensor, styles: torch.Tensor,
                              next_styles: Optional[torch.Tensor] = None,
                              noise_mode: str = "random",
                              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The layer on the channels-last route: x [N, C, H, W] channels-last
        bf16, already scaled by `styles` where the layer does not upsample
        (the up layers scale it inside `upfirdn2d_channels_last`). The
        convolution is cuDNN's NHWC one; `modconv_epilogue` then applies the
        rest of the layer and, where given, the next layer's input styles."""
        noise = self._noise(noise_mode, noise)
        dcoefs = demodulation(self.weight, styles)
        weight = self.weight.to(x.dtype)
        padding = self.kernel_size // 2
        if self.up > 1:  # conv2d_resample's up path: FIR upsampling, then a true convolution
            fw = self.resample_filter.shape[-1]
            p0, p1 = padding + (fw + self.up - 1) // 2, padding + (fw - self.up) // 2
            x = upfirdn2d_channels_last(x, self.resample_filter, padding=(p0, p1, p0, p1),
                                        gain=self.up ** 2, styles=styles)
            weight, padding = weight.flip([2, 3]), 0
        x = torch.nn.functional.conv2d(
            x, weight.contiguous(memory_format=torch.channels_last), padding=padding)
        act_gain, act_clamp = self._act(1.0)
        return modconv_epilogue(x, dcoefs, noise, self.bias, act=self.activation, gain=act_gain,
                                clamp=act_clamp, styles=next_styles)


class ToRGBLayer(nn.Module):
    """1x1 modulated conv to image channels, no demodulation."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int,
                 kernel_size: int = 1, conv_clamp: Optional[float] = None,
                 key: Optional[torch.Tensor] = None):
        super().__init__()
        k_affine, k_weight = prng.split(root_key(key))
        self.weight_gain = 1 / math.sqrt(in_channels * kernel_size ** 2)
        self.conv_clamp = conv_clamp
        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1, key=k_affine)
        self.weight = nn.Parameter(
            prng.normal(k_weight, (out_channels, in_channels, kernel_size, kernel_size)))
        self.bias = nn.Parameter(zeros(out_channels, k_weight))

    def styles(self, w: torch.Tensor) -> torch.Tensor:
        """The layer's input styles [N, C] (fp32): the affine of w, times the
        weight gain."""
        return self.affine(w) * self.weight_gain

    def forward(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = modulated_conv2d(x, self.weight, self.styles(w), demodulate=False)
        return bias_act(x, self.bias, clamp=self.conv_clamp)

    def forward_channels_last(self, x: torch.Tensor, styles: torch.Tensor,
                              scaled: bool = False) -> torch.Tensor:
        """The layer on the channels-last route (a 1x1 kernel): x [N, C, H, W]
        channels-last, multiplied by `styles` here unless `scaled` (conv1's
        epilogue did it), then one batched product over the channels with the
        bf16 weight, as the NCHW chain's 1x1 convolution takes x * styles,
        into an NCHW result: [O, C] x [C, H * W] a sample."""
        if not scaled:
            x = x * styles.to(x.dtype)[:, :, None, None]
        n, c, h, w = x.shape
        weight = self.weight[:, :, 0, 0].to(x.dtype).expand(n, -1, -1)
        y = torch.bmm(weight, x.permute(0, 2, 3, 1).reshape(n, h * w, c).transpose(1, 2))
        return bias_act(y.reshape(n, -1, h, w), self.bias, clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """One resolution stage: [conv0 (up)] + conv1 + skip-accumulated ToRGB.
    `up=1` is the no-upsample variant the superresolution stack uses."""

    def __init__(self, in_channels: int, out_channels: int, w_dim: int, resolution: int,
                 img_channels: int, is_last: bool, architecture: str = "skip",
                 resample_filter: Sequence[int] = (1, 3, 3, 1),
                 conv_clamp: Optional[float] = 256, up: int = 2, use_noise: bool = True,
                 key: Optional[torch.Tensor] = None):
        super().__init__()
        if architecture not in ("orig", "skip", "resnet"):
            raise ValueError(f"unknown architecture {architecture!r}")
        self.in_channels = in_channels
        self.architecture = architecture
        self.up = up
        self.num_conv = 1 if in_channels == 0 else 2
        self.num_torgb = 1 if (is_last or architecture == "skip") else 0
        keys = prng.split(root_key(key), 5)
        if in_channels == 0:
            self.const = nn.Parameter(prng.normal(keys[0], (out_channels, resolution, resolution)))
        else:
            self.conv0 = SynthesisLayer(in_channels, out_channels, w_dim, resolution, up=up,
                                        resample_filter=resample_filter, conv_clamp=conv_clamp,
                                        use_noise=use_noise, key=keys[0])
        self.conv1 = SynthesisLayer(out_channels, out_channels, w_dim, resolution,
                                    conv_clamp=conv_clamp, use_noise=use_noise, key=keys[1])
        if self.num_torgb:
            self.torgb = ToRGBLayer(out_channels, img_channels, w_dim,
                                    conv_clamp=conv_clamp, key=keys[2])
        if in_channels != 0 and architecture == "resnet":
            self.skip = Conv2dLayer(in_channels, out_channels, kernel_size=1, bias=False,
                                    up=2, resample_filter=resample_filter, key=keys[3])
        self.register_buffer("resample_filter", setup_filter(list(resample_filter)),
                             persistent=False)

    def forward(self, x: Optional[torch.Tensor], img: Optional[torch.Tensor],
                ws: torch.Tensor, noise_mode: str = "random",
                noise: Optional[dict] = None,
                dtype: torch.dtype = torch.float32, need_x: bool = True):
        """ws: [N, num_conv + num_torgb, w_dim]. Returns (x, img). `noise`:
        this block's entry of `draw_noise` for `noise_mode="random"`.
        `need_x=False`: the caller discards x (a stack's last block); the
        channels-last route then returns None for it."""
        noise = noise or {}
        if self.architecture != "resnet" and channels_last_route(
                dtype, ws.device, x, ws, *self.parameters()):
            return self._forward_channels_last(x, img, ws, noise_mode, noise, need_x)
        w_iter = iter(ws.unbind(dim=1))
        if self.in_channels == 0:
            x = self.const.to(dtype)[None].expand(ws.shape[0], *self.const.shape)
            x = self.conv1(x, next(w_iter), noise_mode=noise_mode, noise=noise.get("conv1"))
        elif self.architecture == "resnet":
            x = x.to(dtype)
            y = self.skip(x, gain=math.sqrt(0.5))
            x = self.conv0(x, next(w_iter), noise_mode=noise_mode, noise=noise.get("conv0"))
            x = self.conv1(x, next(w_iter), noise_mode=noise_mode, gain=math.sqrt(0.5),
                           noise=noise.get("conv1"))
            x = y + x
        else:
            x = x.to(dtype)
            x = self.conv0(x, next(w_iter), noise_mode=noise_mode, noise=noise.get("conv0"))
            x = self.conv1(x, next(w_iter), noise_mode=noise_mode, noise=noise.get("conv1"))
        if img is not None and self.up == 2:
            img = upsample2d(img, self.resample_filter)
        if self.num_torgb:
            y = self.torgb(x, next(w_iter)).float()
            img = img + y if img is not None else y
        return x, img

    def _forward_channels_last(self, x, img, ws, noise_mode, noise, need_x):
        """`forward` on the channels-last route (`channels_last_route`): x
        comes back channels-last bf16. conv0's epilogue applies conv1's input
        styles, and where x is not needed, conv1's applies ToRGB's (else
        ToRGB scales x in a pass of its own); the block's first input is
        scaled by one small pass where its layer does not upsample (the 4x4
        constant, the 64^2 SR block)."""
        w_iter = iter(ws.unbind(dim=1))
        layers = [self.conv1] if self.in_channels == 0 else [self.conv0, self.conv1]
        styles = [layer.affine(next(w_iter)) for layer in layers]
        rgb_styles = self.torgb.styles(next(w_iter)) if self.num_torgb else None
        fold = rgb_styles is not None and not need_x
        styles.append(rgb_styles if fold else None)
        if self.in_channels == 0:
            x = self.const.to(torch.bfloat16)[None].expand(ws.shape[0], *self.const.shape)
        else:
            x = x.to(torch.bfloat16)
        if layers[0].up == 1:
            x = x * styles[0].to(x.dtype)[:, :, None, None]
        x = x.contiguous(memory_format=torch.channels_last)
        for i, (name, layer) in enumerate(zip(("conv0", "conv1")[-len(layers):], layers)):
            x = layer.forward_channels_last(x, styles[i], styles[i + 1], noise_mode=noise_mode,
                                            noise=noise.get(name))
        if img is not None and self.up == 2:
            img = upsample2d(img, self.resample_filter)
        if self.num_torgb:
            y = self.torgb.forward_channels_last(x, rgb_styles, scaled=fold).float()
            img = img + y if img is not None else y
        return (None if fold else x), img


def draw_noise(blocks: Sequence[SynthesisBlock], rng: Optional[torch.Tensor], n: int,
               device) -> list:
    """The random noise of every layer of `blocks` for a batch of n (this
    rank's rows), as the JAX `apply` draws it: `rng` splits into one key per
    block and each block's key in two (conv0 takes the first, conv1 the
    second; the 4x4 block's lone conv1 the first). All of it is drawn in one
    launch. Per block {"conv0": .., "conv1": ..}, each a standard normal
    [n, 1, r, r]; a None per block without a key."""
    if rng is None:
        return [None] * len(blocks)
    slots = []
    for i, (block, key) in enumerate(zip(blocks, prng.split(rng, len(blocks)))):
        names = ("conv1",) if block.in_channels == 0 else ("conv0", "conv1")
        for name, k in zip(names, prng.split(key)):
            layer = getattr(block, name)
            if layer.use_noise:
                r = layer.resolution
                slots.append((i, name, prng.Draw("normal", k, (n, 1, r, r))))
    noises = [{} for _ in blocks]
    for (i, name, _), value in zip(slots, draw_many([d for *_, d in slots], device)):
        noises[i][name] = value
    return noises


class SynthesisNetwork(nn.Module):
    """Progressive 4x4 -> img_resolution stack of SynthesisBlocks."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512, num_fp16_res: int = 4,
                 conv_clamp: Optional[float] = 256, architecture: str = "skip",
                 use_noise: bool = True, key: Optional[torch.Tensor] = None):
        super().__init__()
        log2 = int(math.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(2, log2 + 1)]
        self.num_ws = 0
        keys = prng.split(root_key(key), len(self.block_resolutions))
        for res, k in zip(self.block_resolutions, keys):
            in_ch = min(channel_base // (res // 2), channel_max) if res > 4 else 0
            block = SynthesisBlock(in_ch, min(channel_base // res, channel_max), w_dim, res,
                                   img_channels, is_last=res == img_resolution,
                                   conv_clamp=conv_clamp, architecture=architecture,
                                   use_noise=use_noise, key=k)
            setattr(self, f"b{res}", block)
            self.num_ws += block.num_conv + (block.num_torgb if res == img_resolution else 0)

    def forward(self, ws: torch.Tensor, noise_mode: str = "random",
                rng: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """`rng` splits into one key per block (for random noise)."""
        ws = ws.float()
        x = img = None
        w_idx = 0
        blocks = [getattr(self, f"b{res}") for res in self.block_resolutions]
        noises = draw_noise(blocks, rng if noise_mode == "random" else None, ws.shape[0],
                            ws.device)
        for block, noise in zip(blocks, noises):
            cur_ws = ws[:, w_idx: w_idx + block.num_conv + block.num_torgb]
            x, img = block(x, img, cur_ws, noise_mode=noise_mode, noise=noise, dtype=dtype,
                           need_x=block is not blocks[-1])
            w_idx += block.num_conv
        return img


class Generator(nn.Module):
    """Mapping + synthesis."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, img_resolution: int,
                 img_channels: int, mapping_layers: int = 8, channel_base: int = 32768,
                 channel_max: int = 512, conv_clamp: Optional[float] = 256,
                 use_noise: bool = True, architecture: str = "skip",
                 key: Optional[torch.Tensor] = None):
        super().__init__()
        k_map, k_syn = prng.split(root_key(key))
        self.synthesis = SynthesisNetwork(w_dim, img_resolution, img_channels,
                                          channel_base=channel_base, channel_max=channel_max,
                                          conv_clamp=conv_clamp, architecture=architecture,
                                          use_noise=use_noise, key=k_syn)
        self.num_ws = self.synthesis.num_ws
        self.mapping = MappingNetwork(z_dim, c_dim, w_dim, num_ws=self.num_ws,
                                      num_layers=mapping_layers, key=k_map)

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
                 conv_clamp: Optional[float] = None, key: Optional[torch.Tensor] = None):
        super().__init__()
        if architecture not in ("orig", "skip", "resnet"):
            raise ValueError(f"unknown architecture {architecture!r}")
        self.in_channels = in_channels
        self.architecture = architecture
        keys = prng.split(root_key(key), 4)
        if in_channels == 0 or architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, tmp_channels, kernel_size=1,
                                       activation=activation, conv_clamp=conv_clamp, key=keys[0])
        self.conv0 = Conv2dLayer(tmp_channels, tmp_channels, kernel_size=3,
                                 activation=activation, conv_clamp=conv_clamp, key=keys[1])
        self.conv1 = Conv2dLayer(tmp_channels, out_channels, kernel_size=3,
                                 activation=activation, down=2, resample_filter=resample_filter,
                                 conv_clamp=conv_clamp, key=keys[2])
        if architecture == "resnet":
            self.skip = Conv2dLayer(tmp_channels, out_channels, kernel_size=1, bias=False,
                                    down=2, resample_filter=resample_filter, key=keys[3])
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
                 conv_clamp: Optional[float] = None, key: Optional[torch.Tensor] = None):
        super().__init__()
        self.cmap_dim = cmap_dim
        self.architecture = architecture
        self.mbstd_group_size = mbstd_group_size
        self.mbstd_num_channels = mbstd_num_channels
        keys = prng.split(root_key(key), 4)
        self.conv = Conv2dLayer(in_channels + mbstd_num_channels, in_channels, kernel_size=3,
                                activation=activation, conv_clamp=conv_clamp, key=keys[0])
        self.fc = FullyConnectedLayer(in_channels * resolution ** 2, in_channels,
                                      activation=activation, key=keys[1])
        self.out = FullyConnectedLayer(in_channels, 1 if cmap_dim == 0 else cmap_dim, key=keys[2])
        if architecture == "skip":
            self.fromrgb = Conv2dLayer(img_channels, in_channels, kernel_size=1,
                                       activation=activation, key=keys[3])

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
    depth maps. Constructed on CUDA unless `device` names another device,
    from `key` (PRNGKey(0) when None) split as the JAX `init` splits it, on
    that device; on `meta` nothing is drawn (`load_jax_params` fills it)."""

    def __init__(self, c_dim: int, img_resolution: int, img_channels: int,
                 architecture: str = "resnet", channel_base: int = 32768,
                 channel_max: int = 512, conv_clamp: Optional[float] = 256,
                 cmap_dim: Optional[int] = None, mbstd_group_size: Optional[int] = 4,
                 mapping_layers: int = 8, device=None, key: Optional[torch.Tensor] = None):
        super().__init__()
        device = resolve_device(device)
        log2 = int(math.log2(img_resolution))
        self.block_resolutions = [2 ** i for i in range(log2, 2, -1)]
        self.c_dim = c_dim

        def channels(res):
            return min(channel_base // res, channel_max)

        cmap = cmap_dim if cmap_dim is not None else channels(4)
        cmap = 0 if c_dim == 0 else cmap
        keys = prng.split(root_key(key).to(device), len(self.block_resolutions) + 2)
        for res, k in zip(self.block_resolutions, keys):
            setattr(self, f"b{res}", DiscriminatorBlock(
                channels(res) if res < img_resolution else 0, channels(res), channels(res // 2),
                res, img_channels, architecture=architecture, conv_clamp=conv_clamp, key=k))
        if c_dim > 0:
            self.mapping = MappingNetwork(z_dim=0, c_dim=c_dim, w_dim=cmap, num_ws=None,
                                          w_avg_beta=None, num_layers=mapping_layers,
                                          key=keys[-2])
        self.b4 = DiscriminatorEpilogue(channels(4), cmap_dim=cmap, resolution=4,
                                        img_channels=img_channels, architecture=architecture,
                                        mbstd_group_size=mbstd_group_size, conv_clamp=conv_clamp,
                                        key=keys[-1])
        place(self, device)

    def forward(self, img: torch.Tensor, c: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[N, img_channels, R, R] images (+ labels [N, c_dim]) -> logits [N, 1]."""
        x = None
        for res in self.block_resolutions:
            x, img = getattr(self, f"b{res}")(x, img, dtype=dtype)
        cmap = self.mapping(None, c) if self.c_dim > 0 else None
        return self.b4(x, img, cmap)

    @profiled_function("disc")
    def apply(self, img, c=None, dtype=torch.float32) -> torch.Tensor:
        """The JAX package's name for the forward pass. (Shadows
        `nn.Module.apply`.)"""
        return self.forward(img, c, dtype=dtype)
