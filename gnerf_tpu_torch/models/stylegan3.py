"""StyleGAN3 alias-free generator (the T configuration) as PyTorch modules.

Port of `gnerf_tpu/models/stylegan3.py`: a Fourier-feature `SynthesisInput`
with a learned affine transform, alias-free `SynthesisLayer`s (Kaiser low-pass
filter design + modulated conv + filtered leaky ReLU) on the geometric
cutoff / stopband schedule, and the `Generator` on the StyleGAN2
`MappingNetwork`. Parameter and buffer names are the JAX tree's
(`synthesis/input/{weight,affine,transform,freqs,phases}`,
`synthesis/L{idx}_{size}_{channels}/{affine,weight,bias,magnitude_ema}`), so
`utils.checkpoint.load_jax_params` loads a JAX StyleGAN3 tree. The FIR
filters are designed at construction (numpy / scipy) and kept out of the
state_dict. Like the JAX package, the layers use 3x3 convolutions and
separable filters only (no R configuration). Every op is plain PyTorch;
`filtered_lrelu` is the `upfirdn2d` / `bias_act` composition.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..ops.conv2d_resample import _conv2d
from ..ops.filtered_lrelu import filtered_lrelu
from ..utils import prng
from ..utils.device import place, resolve_device
from .stylegan2 import FullyConnectedLayer, MappingNetwork, root_key, zeros


def sg3_modulated_conv2d(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
                         demodulate: bool = True, padding: int = 0,
                         input_gain: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The StyleGAN3 modulated conv (weights and styles normalised first),
    in the scale-activations form: x [N, I, H, W], w [O, I, k, k], s [N, I]."""
    if demodulate:
        w = w * torch.rsqrt(w.square().mean(dim=(1, 2, 3), keepdim=True))
        s = s * torch.rsqrt(s.square().mean())
    dcoefs = None
    if demodulate:
        wmod = w[None] * s[:, None, :, None, None]
        dcoefs = torch.rsqrt(wmod.square().sum(dim=(2, 3, 4)) + 1e-8)
    gain = s
    if input_gain is not None:
        gain = gain * input_gain.expand_as(s)
    x = x * gain.to(x.dtype)[:, :, None, None]
    x = _conv2d(x, w.to(x.dtype), padding=padding)
    if dcoefs is not None:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    return x


def design_lowpass_filter(numtaps: int, cutoff: float, width: float, fs: float,
                          radial: bool = False) -> Optional[np.ndarray]:
    """Kaiser (separable, [numtaps]) or jinc (radial, [numtaps, numtaps])
    low-pass filter, float32; None for a single tap."""
    if numtaps < 1:
        raise ValueError(f"numtaps must be >= 1, got {numtaps}")
    if numtaps == 1:
        return None
    import scipy.signal
    import scipy.special

    if not radial:
        return scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width,
                                   fs=fs).astype(np.float32)
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    with np.errstate(divide="ignore", invalid="ignore"):
        f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    f[r == 0] = cutoff  # lim_{r->0} j1(2*pi*c*r)/(pi*r) = c (even taps never hit it)
    beta = scipy.signal.kaiser_beta(scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    win = np.kaiser(numtaps, beta)
    f *= np.outer(win, win)
    f /= np.sum(f)
    return f.astype(np.float32)


class SynthesisInput(nn.Module):
    """Fourier features [N, channels, size, size] under a rotation and
    translation predicted from w."""

    def __init__(self, w_dim: int, channels: int, size: int, sampling_rate: float,
                 bandwidth: float, key: Optional[torch.Tensor] = None):
        super().__init__()
        k_f, k_p, k_w, k_a = prng.split(root_key(key), 4)
        self.w_dim, self.channels, self.size = w_dim, channels, size
        self.sampling_rate, self.bandwidth = sampling_rate, bandwidth
        freqs = prng.normal(k_f, (channels, 2))
        radii = freqs.square().sum(dim=1, keepdim=True).sqrt()
        freqs = freqs / (radii * radii.square().exp() ** 0.25) * bandwidth
        phases = prng.uniform(k_p, (channels,)) - 0.5
        self.weight = nn.Parameter(prng.normal(k_w, (channels, channels)))
        # Drawn, then set to the identity transform (weight 0, bias [1, 0, 0, 0]).
        self.affine = FullyConnectedLayer(w_dim, 4, bias_init=0.0, key=k_a)
        self.affine.weight = nn.Parameter(zeros((4, w_dim), k_a))
        self.affine.bias = nn.Parameter(torch.tensor([1.0, 0.0, 0.0, 0.0], device=k_a.device))
        self.register_buffer("transform", torch.eye(3, device=k_a.device))
        self.register_buffer("freqs", freqs)
        self.register_buffer("phases", phases)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        t = self.affine(w)  # (r_c, r_s, t_x, t_y)
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        one, zero = torch.ones_like(t[:, 0]), torch.zeros_like(t[:, 0])
        m_r = torch.stack([torch.stack([t[:, 0], -t[:, 1], zero], -1),
                           torch.stack([t[:, 1], t[:, 0], zero], -1),
                           torch.stack([zero, zero, one], -1)], dim=1)
        m_t = torch.stack([torch.stack([one, zero, -t[:, 2]], -1),
                           torch.stack([zero, one, -t[:, 3]], -1),
                           torch.stack([zero, zero, one], -1)], dim=1)
        transforms = m_r @ m_t @ self.transform[None]

        freqs0 = self.freqs[None]
        phases = self.phases[None] + torch.einsum(
            "bcf,bfi->bci", freqs0, transforms[:, :2, 2:])[..., 0]
        freqs = torch.einsum("bcf,bfg->bcg", freqs0, transforms[:, :2, :2])
        amplitudes = (1 - (freqs.norm(dim=2) - self.bandwidth)
                      / (self.sampling_rate / 2 - self.bandwidth)).clamp(0, 1)

        # Sampling grid: align_corners=False pixel centres, scaled extent.
        span = 0.5 * self.size / self.sampling_rate
        xs = ((torch.arange(self.size, device=w.device, dtype=torch.float32) + 0.5)
              / self.size * 2 - 1) * span
        gy, gx = torch.meshgrid(xs, xs, indexing="ij")
        grid = torch.stack([gx, gy], dim=-1)  # [H, W, 2]

        x = torch.einsum("hwf,bcf->bhwc", grid, freqs) + phases[:, None, None, :]
        x = torch.sin(x * (2 * math.pi)) * amplitudes[:, None, None, :]
        x = torch.einsum("bhwc,dc->bhwd", x, self.weight / math.sqrt(self.channels))
        return x.permute(0, 3, 1, 2)


class SynthesisLayer(nn.Module):
    """Alias-free layer: modulated conv, then the filtered leaky ReLU at a
    temporarily oversampled rate."""

    def __init__(self, w_dim: int, is_torgb: bool, is_critically_sampled: bool,
                 in_channels: int, out_channels: int, in_size: int, out_size: int,
                 in_sampling_rate: float, out_sampling_rate: float, in_cutoff: float,
                 out_cutoff: float, in_half_width: float, out_half_width: float,
                 filter_size: int = 6, lrelu_upsampling: int = 2,
                 conv_clamp: Optional[float] = 256, magnitude_ema_beta: float = 0.999,
                 key: Optional[torch.Tensor] = None):
        super().__init__()
        k_a, k_w = prng.split(root_key(key))
        self.is_torgb, self.is_critically_sampled = is_torgb, is_critically_sampled
        self.in_channels, self.out_channels = in_channels, out_channels
        self.in_size, self.out_size = in_size, out_size
        self.conv_clamp, self.magnitude_ema_beta = conv_clamp, magnitude_ema_beta
        self.kernel = 1 if is_torgb else 3
        tmp_rate = max(in_sampling_rate, out_sampling_rate) * (1 if is_torgb else lrelu_upsampling)
        self.up_factor = int(round(tmp_rate / in_sampling_rate))
        self.down_factor = int(round(tmp_rate / out_sampling_rate))
        up_taps = filter_size * self.up_factor if self.up_factor > 1 and not is_torgb else 1
        down_taps = filter_size * self.down_factor if self.down_factor > 1 and not is_torgb else 1
        fu = design_lowpass_filter(up_taps, in_cutoff, in_half_width * 2, tmp_rate)
        fd = design_lowpass_filter(down_taps, out_cutoff, out_half_width * 2, tmp_rate)
        self.register_buffer("fu", None if fu is None else torch.from_numpy(fu), persistent=False)
        self.register_buffer("fd", None if fd is None else torch.from_numpy(fd), persistent=False)
        pad_total = ((out_size - 1) * self.down_factor + 1
                     - (in_size + self.kernel - 1) * self.up_factor + up_taps + down_taps - 2)
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = (int(pad_lo), int(pad_hi), int(pad_lo), int(pad_hi))

        self.affine = FullyConnectedLayer(w_dim, in_channels, bias_init=1, key=k_a)
        self.weight = nn.Parameter(
            prng.normal(k_w, (out_channels, in_channels, self.kernel, self.kernel)))
        self.bias = nn.Parameter(zeros(out_channels, k_w))
        self.register_buffer("magnitude_ema", torch.ones((), device=k_w.device))

    def forward(self, x: torch.Tensor, w: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        styles = self.affine(w)
        if self.is_torgb:
            styles = styles * (1 / math.sqrt(self.in_channels * self.kernel ** 2))
        x = sg3_modulated_conv2d(x.to(dtype), self.weight, styles,
                                 demodulate=not self.is_torgb, padding=self.kernel - 1,
                                 input_gain=torch.rsqrt(self.magnitude_ema))
        return filtered_lrelu(x, self.fu, self.fd, self.bias.to(x.dtype), up=self.up_factor,
                              down=self.down_factor, padding=self.padding,
                              gain=1.0 if self.is_torgb else math.sqrt(2),
                              slope=1.0 if self.is_torgb else 0.2, clamp=self.conv_clamp)

    def updated_magnitude_ema(self, x: torch.Tensor) -> torch.Tensor:
        """The magnitude EMA after one training step on input x (the new
        value; the caller stores it)."""
        cur = x.detach().float().square().mean()
        return cur + (self.magnitude_ema - cur) * self.magnitude_ema_beta


class SynthesisNetwork(nn.Module):
    """Fourier input, then `num_layers + 1` alias-free layers on the
    geometric cutoff schedule (the last `num_critical` critically sampled,
    the last one ToRGB)."""

    def __init__(self, w_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512, num_layers: int = 14,
                 num_critical: int = 2, first_cutoff: float = 2.0,
                 first_stopband: float = 2 ** 2.1, last_stopband_rel: float = 2 ** 0.3,
                 margin_size: int = 10, output_scale: float = 0.25,
                 key: Optional[torch.Tensor] = None):
        super().__init__()
        keys = prng.split(root_key(key), num_layers + 2)
        self.num_layers, self.output_scale = num_layers, output_scale
        last_cutoff = img_resolution / 2
        last_stopband = last_cutoff * last_stopband_rel
        exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
        cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
        stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
        sampling_rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, img_resolution))))
        half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
        sizes = sampling_rates + margin_size * 2
        sizes[-2:] = img_resolution
        channels = np.rint(np.minimum((channel_base / 2) / cutoffs, channel_max))
        channels[-1] = img_channels

        self.input = SynthesisInput(w_dim, int(channels[0]), int(sizes[0]),
                                    float(sampling_rates[0]), float(cutoffs[0]), key=keys[0])
        self.layer_names = []
        for idx in range(num_layers + 1):
            prev = max(idx - 1, 0)
            layer = SynthesisLayer(
                w_dim, is_torgb=idx == num_layers,
                is_critically_sampled=idx >= num_layers - num_critical,
                in_channels=int(channels[prev]), out_channels=int(channels[idx]),
                in_size=int(sizes[prev]), out_size=int(sizes[idx]),
                in_sampling_rate=float(sampling_rates[prev]),
                out_sampling_rate=float(sampling_rates[idx]),
                in_cutoff=float(cutoffs[prev]), out_cutoff=float(cutoffs[idx]),
                in_half_width=float(half_widths[prev]), out_half_width=float(half_widths[idx]),
                key=keys[idx + 1])
            name = f"L{idx}_{layer.out_size}_{layer.out_channels}"
            setattr(self, name, layer)
            self.layer_names.append(name)

    @property
    def num_ws(self) -> int:
        return self.num_layers + 2

    def forward(self, ws: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        ws = ws.float()
        x = self.input(ws[:, 0])
        for idx, name in enumerate(self.layer_names):
            x = getattr(self, name)(x, ws[:, idx + 1], dtype=dtype)
        if self.output_scale != 1:
            x = x * self.output_scale
        return x.float()


class Generator(nn.Module):
    """The StyleGAN3 generator: mapping, then alias-free synthesis.
    Constructed on CUDA unless `device` names another device, from `key`
    (PRNGKey(0) when None) split as the JAX `init` splits it; on `meta`
    nothing is drawn."""

    def __init__(self, z_dim: int, c_dim: int, w_dim: int, img_resolution: int,
                 img_channels: int, mapping_layers: int = 2, channel_base: int = 32768,
                 channel_max: int = 512, num_layers: int = 14, device=None,
                 key: Optional[torch.Tensor] = None):
        super().__init__()
        device = resolve_device(device)
        k_m, k_s = prng.split(root_key(key).to(device))
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.img_resolution, self.img_channels = img_resolution, img_channels
        self.synthesis = SynthesisNetwork(w_dim, img_resolution, img_channels,
                                          channel_base=channel_base, channel_max=channel_max,
                                          num_layers=num_layers, key=k_s)
        self.mapping = MappingNetwork(z_dim, c_dim, w_dim, num_ws=self.synthesis.num_ws,
                                      num_layers=mapping_layers, key=k_m)
        place(self, device)

    @property
    def num_ws(self) -> int:
        return self.synthesis.num_ws

    def forward(self, z: torch.Tensor, c: Optional[torch.Tensor], truncation_psi: float = 1.0,
                truncation_cutoff: Optional[int] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        ws = self.mapping(z, c, truncation_psi=truncation_psi,
                          truncation_cutoff=truncation_cutoff)
        return self.synthesis(ws, dtype=dtype)

    apply = forward  # the JAX package's name (shadows `nn.Module.apply`, as TriPlaneGenerator)
