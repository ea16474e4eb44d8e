"""The StyleGAN2-ADA augmentation pipeline ("Training GANs with Limited Data").

Port of `gnerf_tpu/training/augment.py`: pixel blitting (x-flip, 90-degree
rotations, integer translation), general geometric transforms (isotropic and
anisotropic scale, rotation, fractional translation) executed as one
wavelet-filtered affine resampling, colour transforms as homogeneous 4x4
matrices, per-band image filtering, additive noise and cutout. Each
augmentation is gated per sample with probability `p * multiplier`.

As in the JAX package, the geometric step pads by a static reflect margin
(`pad_fraction` of the image plus the filter support) instead of the
reference's data-dependent one; the margin decides which source pixels
exist, so it is kept as JAX has it. The reflection is index-based, as
`jnp.pad(mode="reflect")` is, so it also reflects pads wider than the image
(which `F.pad` refuses). The warp is `F.grid_sample` (bilinear, zeros
outside, align_corners=False: JAX's `grid_sample_2d` convention) through
`_Warp`, whose derivatives of every order are warps and transposed warps.
Every FIR convolution goes through `ops/upfirdn2d.py::conv2d`, so R1
differentiates through the pipe without PyTorch's convolution double
backward.

Draws come from an explicit `torch.Generator` on the images' device (not
JAX's threefry, so the draws differ from the JAX package's); the steps that
follow the draws are split out (`_execute_geometric`, `_execute_color`,
`_execute_imgfilter_gains`) so they can be fed the JAX package's matrices.
`debug_percentile` gives the reference's deterministic debugging mode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.upfirdn2d import conv2d, downsample2d, setup_filter, upsample2d
from ..parallel.sharding import draw

# Wavelet low-pass filters (public coefficients; only the ones used).
WAVELETS = {
    "sym2": [-0.12940952255092145, 0.22414386804185735, 0.836516303737469,
             0.48296291314469025],
    "sym6": [0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
             -0.048311742585633, 0.4910559419267466, 0.787641141030194,
             0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
             0.04472490177066578, 0.0017677118642428036, -0.007800708325034148],
}


def _mat(rows) -> torch.Tensor:
    """[N, k, k] from k rows of k [N] tensors."""
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _translate2d(tx, ty):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return _mat([[o, z, tx], [z, o, ty], [z, z, o]])


def _scale2d(sx, sy):
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return _mat([[sx, z, z], [z, sy, z], [z, z, o]])


def _rotate2d(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _mat([[c, -s, z], [s, c, z], [z, z, o]])


def _translate3d(tx, ty, tz):
    z, o = torch.zeros_like(tx), torch.ones_like(tx)
    return _mat([[o, z, z, tx], [z, o, z, ty], [z, z, o, tz], [z, z, z, o]])


def _scale3d(sx, sy, sz):
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    return _mat([[sx, z, z, z], [z, sy, z, z], [z, z, sz, z], [z, z, z, o]])


def _rotate3d_axis(v: np.ndarray, theta):
    vx, vy, vz = float(v[0]), float(v[1]), float(v[2])
    s, c = torch.sin(theta), torch.cos(theta)
    cc = 1 - c
    z, o = torch.zeros_like(theta), torch.ones_like(theta)
    return _mat([
        [vx * vx * cc + c, vx * vy * cc - vz * s, vx * vz * cc + vy * s, z],
        [vy * vx * cc + vz * s, vy * vy * cc + c, vy * vz * cc - vx * s, z],
        [vz * vx * cc - vy * s, vz * vy * cc + vx * s, vz * vz * cc + c, z],
        [z, z, z, o],
    ])


def _erfinv(x: float) -> float:
    return float(torch.erfinv(torch.tensor(x, dtype=torch.float64)))


def _filter_bank() -> np.ndarray:
    """4-band wavelet filter bank [4, taps] (reference `augment.py:177-187`);
    each row convolution is `scipy.signal.convolve` with a [1, K] kernel."""
    hz_lo = np.asarray(WAVELETS["sym2"])
    hz_hi = hz_lo * ((-1) ** np.arange(hz_lo.size))
    hz_lo2 = np.convolve(hz_lo, hz_lo[::-1]) / 2
    hz_hi2 = np.convolve(hz_hi, hz_hi[::-1]) / 2
    fbank = np.eye(4, 1)
    for i in range(1, fbank.shape[0]):
        fbank = np.dstack([fbank, np.zeros_like(fbank)]).reshape(fbank.shape[0], -1)[:, :-1]
        fbank = np.stack([np.convolve(row, hz_lo2) for row in fbank])
        fbank[i, (fbank.shape[1] - hz_hi2.size) // 2:(fbank.shape[1] + hz_hi2.size) // 2] += hz_hi2
    return fbank.astype(np.float32)


class _Warp(torch.autograd.Function):
    """`F.grid_sample` (bilinear, zeros outside, align_corners=False) at a
    constant grid, differentiable in its input to any order: its backward
    is the transposed warp `_WarpT`, whose backward is the warp again. R1
    differentiates the pipe twice, and PyTorch's own `grid_sampler_2d_backward`
    has no derivative in some versions (2.11 among them)."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.save_for_backward(grid)
        ctx.shape = x.shape
        return F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                             align_corners=False)

    @staticmethod
    def backward(ctx, gy):
        (grid,) = ctx.saved_tensors
        return _WarpT.apply(gy, grid, ctx.shape), None


class _WarpT(torch.autograd.Function):
    """The warp's transpose: scatters [N, C, Ho, Wo] back onto the input
    grid [N, C, H, W] (`grid_sampler_2d_backward`'s input gradient; the
    input tensor it is given only carries the shape)."""

    @staticmethod
    def forward(ctx, gy, grid, shape):
        ctx.save_for_backward(grid)
        return torch.ops.aten.grid_sampler_2d_backward(
            gy, gy.new_empty(shape), grid, 0, 0, False, [True, False])[0]

    @staticmethod
    def backward(ctx, ggx):
        (grid,) = ctx.saved_tensors
        return _Warp.apply(ggx, grid), None, None


def warp(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of [N, C, H, W] at the constant `grid` [N, Ho, Wo, 2]
    in [-1, 1] (x indexes W, y indexes H): JAX's `grid_sample_2d` as NCHW."""
    if grid.requires_grad:
        raise ValueError("warp differentiates with respect to its input only")
    return _Warp.apply(x, grid)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """`jnp.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)), mode="reflect")`
    on [N, C, H, W]: indices reflect about the edges (edge not repeated)
    with period 2 (size - 1), so a pad of any width is defined."""
    for dim in (2, 3):
        n = x.shape[dim]
        idx = np.arange(-pad, n + pad)
        if n > 1:
            idx = np.mod(idx, 2 * (n - 1))
            idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
        else:
            idx = np.zeros_like(idx)
        x = x.index_select(dim, torch.from_numpy(idx).to(x.device))
    return x


@dataclasses.dataclass(frozen=True)
class AugmentPipe:
    """The JAX package's fields and defaults. `warp_cell_pack` is a TPU
    gather layout with no meaning here, kept so stored configs load."""

    # Pixel blitting.
    xflip: float = 0.0
    rotate90: float = 0.0
    xint: float = 0.0
    xint_max: float = 0.125
    # General geometric.
    scale: float = 0.0
    rotate: float = 0.0
    aniso: float = 0.0
    xfrac: float = 0.0
    scale_std: float = 0.2
    rotate_max: float = 1.0
    aniso_std: float = 0.2
    xfrac_std: float = 0.125
    # Color.
    brightness: float = 0.0
    contrast: float = 0.0
    lumaflip: float = 0.0
    hue: float = 0.0
    saturation: float = 0.0
    brightness_std: float = 0.2
    contrast_std: float = 0.5
    hue_max: float = 1.0
    saturation_std: float = 1.0
    # Image-space filtering.
    imgfilter: float = 0.0
    imgfilter_bands: Sequence[float] = (1, 1, 1, 1)
    imgfilter_std: float = 1.0
    # Corruptions.
    noise: float = 0.0
    cutout: float = 0.0
    noise_std: float = 0.1
    cutout_size: float = 0.5
    # Static geometric padding margin (fraction of the image size).
    pad_fraction: float = 0.6
    warp_cell_pack: bool = False

    @property
    def _has_geom(self):
        return any(x > 0 for x in (self.xflip, self.rotate90, self.xint,
                                   self.scale, self.rotate, self.aniso, self.xfrac))

    @property
    def _has_color(self):
        return any(x > 0 for x in (self.brightness, self.contrast, self.lumaflip,
                                   self.hue, self.saturation))

    def __call__(self, images: torch.Tensor, p: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 debug_percentile: Optional[float] = None) -> torch.Tensor:
        """Augment a batch [N, C, H, W]; `p` is the ADA strength. Under a
        mesh each draw is this rank's rows of the global batch's draw."""
        N, C, H, W = images.shape
        dev = images.device
        f32 = dict(dtype=torch.float32, device=dev)

        def uniform(*shape):
            return draw(torch.rand, (N,) + shape, generator, **f32)

        def normal(*shape):
            return draw(torch.randn, (N,) + shape, generator, **f32)

        def gate(value, fallback, prob):
            u = uniform(*(1,) * (value.dim() - 1))
            return torch.where(u < prob * p, value, fallback)

        dp = debug_percentile

        def full(like, value):
            return torch.full_like(like, float(value))

        # ----- Geometric (inverse transform G_inv: out-pixel -> in-pixel) ---
        G_inv = torch.eye(3, **f32).expand(N, 3, 3)
        if self.xflip > 0:
            i = torch.floor(uniform() * 2)
            i = gate(i, torch.zeros_like(i), self.xflip)
            if dp is not None:
                i = full(i, np.floor(dp * 2))
            G_inv = G_inv @ _scale2d(1 / (1 - 2 * i), torch.ones_like(i))
        if self.rotate90 > 0:
            i = torch.floor(uniform() * 4)
            i = gate(i, torch.zeros_like(i), self.rotate90)
            if dp is not None:
                i = full(i, np.floor(dp * 4))
            G_inv = G_inv @ _rotate2d(-(-np.pi / 2 * i))
        if self.xint > 0:
            t = (uniform(2) * 2 - 1) * self.xint_max
            t = gate(t, torch.zeros_like(t), self.xint)
            if dp is not None:
                t = full(t, (dp * 2 - 1) * self.xint_max)
            G_inv = G_inv @ _translate2d(-torch.round(t[:, 0] * W), -torch.round(t[:, 1] * H))
        if self.scale > 0:
            s = torch.exp2(normal() * self.scale_std)
            s = gate(s, torch.ones_like(s), self.scale)
            if dp is not None:
                s = full(s, 2 ** (_erfinv(dp * 2 - 1) * self.scale_std))
            G_inv = G_inv @ _scale2d(1 / s, 1 / s)
        p_rot = 1 - math.sqrt(max(1 - self.rotate * p, 0.0))
        if self.rotate > 0:
            theta = (uniform() * 2 - 1) * np.pi * self.rotate_max
            theta = torch.where(uniform() < p_rot, theta, torch.zeros_like(theta))
            if dp is not None:
                theta = full(theta, (dp * 2 - 1) * np.pi * self.rotate_max)
            G_inv = G_inv @ _rotate2d(theta)
        if self.aniso > 0:
            s = torch.exp2(normal() * self.aniso_std)
            s = gate(s, torch.ones_like(s), self.aniso)
            if dp is not None:
                s = full(s, 2 ** (_erfinv(dp * 2 - 1) * self.aniso_std))
            G_inv = G_inv @ _scale2d(1 / s, s)
        if self.rotate > 0:
            theta = (uniform() * 2 - 1) * np.pi * self.rotate_max
            theta = torch.where(uniform() < p_rot, theta, torch.zeros_like(theta))
            if dp is not None:
                theta = torch.zeros_like(theta)
            G_inv = G_inv @ _rotate2d(theta)
        if self.xfrac > 0:
            t = normal(2) * self.xfrac_std
            t = gate(t, torch.zeros_like(t), self.xfrac)
            if dp is not None:
                t = full(t, _erfinv(dp * 2 - 1) * self.xfrac_std)
            G_inv = G_inv @ _translate2d(-t[:, 0] * W, -t[:, 1] * H)

        if self._has_geom:
            images = self._execute_geometric(images, G_inv)

        # ----- Color (C: color_in -> color_out, homogeneous 4x4) -----------
        Cmat = torch.eye(4, **f32).expand(N, 4, 4)
        v = np.asarray([1, 1, 1, 0]) / np.sqrt(3)
        vv = torch.tensor(np.outer(v, v), **f32)
        if self.brightness > 0:
            b = normal() * self.brightness_std
            b = gate(b, torch.zeros_like(b), self.brightness)
            if dp is not None:
                b = full(b, _erfinv(dp * 2 - 1) * self.brightness_std)
            Cmat = _translate3d(b, b, b) @ Cmat
        if self.contrast > 0:
            c = torch.exp2(normal() * self.contrast_std)
            c = gate(c, torch.ones_like(c), self.contrast)
            if dp is not None:
                c = full(c, 2 ** (_erfinv(dp * 2 - 1) * self.contrast_std))
            Cmat = _scale3d(c, c, c) @ Cmat
        if self.lumaflip > 0:
            i = torch.floor(uniform() * 2)
            i = gate(i, torch.zeros_like(i), self.lumaflip)
            if dp is not None:
                i = full(i, np.floor(dp * 2))
            Cmat = (torch.eye(4, **f32) - 2 * vv * i[:, None, None]) @ Cmat
        if self.hue > 0 and C > 1:
            theta = (uniform() * 2 - 1) * np.pi * self.hue_max
            theta = gate(theta, torch.zeros_like(theta), self.hue)
            if dp is not None:
                theta = full(theta, (dp * 2 - 1) * np.pi * self.hue_max)
            Cmat = _rotate3d_axis(v, theta) @ Cmat
        if self.saturation > 0 and C > 1:
            s = torch.exp2(normal() * self.saturation_std)
            s = gate(s, torch.ones_like(s), self.saturation)
            if dp is not None:
                s = full(s, 2 ** (_erfinv(dp * 2 - 1) * self.saturation_std))
            Cmat = (vv + (torch.eye(4, **f32) - vv) * s[:, None, None]) @ Cmat

        if self._has_color:
            images = self._execute_color(images, Cmat)

        # ----- Image-space filtering ---------------------------------------
        if self.imgfilter > 0:
            images = self._execute_imgfilter(images, p, dp, uniform, normal)

        # ----- Corruptions --------------------------------------------------
        if self.noise > 0:
            sigma = normal(1, 1, 1).abs() * self.noise_std
            sigma = gate(sigma, torch.zeros_like(sigma), self.noise)
            if dp is not None:
                sigma = full(sigma, _erfinv(dp) * self.noise_std)
            noise = draw(torch.randn, images.shape, generator, **f32)
            images = images + (noise * sigma).to(images.dtype)
        if self.cutout > 0:
            size = torch.full((N, 2, 1, 1, 1), self.cutout_size, **f32)
            size = gate(size, torch.zeros_like(size), self.cutout)
            center = uniform(2, 1, 1, 1)
            if dp is not None:
                size = full(size, self.cutout_size)
                center = full(center, dp)
            coord_x = torch.arange(W, **f32).reshape(1, 1, 1, -1)
            coord_y = torch.arange(H, **f32).reshape(1, 1, -1, 1)
            mask_x = ((coord_x + 0.5) / W - center[:, 0]).abs() >= size[:, 0] / 2
            mask_y = ((coord_y + 0.5) / H - center[:, 1]).abs() >= size[:, 1] / 2
            images = images * (mask_x | mask_y).to(images.dtype)
        return images

    # ------------------------------------------------------------------

    def _execute_geometric(self, images: torch.Tensor, G_inv: torch.Tensor) -> torch.Tensor:
        """Wavelet-filtered affine resampling (reference `augment.py:275-312`)
        with the static pad margin; `G_inv` [N, 3, 3] maps output to input
        pixels. bf16 images are warped in fp32 (the grid's coordinates need
        more than bf16's 8 bits) and cast back."""
        N, C, H, W = images.shape
        dev = images.device
        hz = setup_filter(WAVELETS["sym6"], device=dev)
        hz_pad = hz.shape[0] // 4
        m = int(np.ceil(self.pad_fraction * max(H, W))) + hz_pad * 2
        images = reflect_pad(images, m)
        images = upsample2d(images, hz, up=2)

        def const(a, b):
            return torch.full((N,), a, dtype=torch.float32, device=dev), \
                torch.full((N,), b, dtype=torch.float32, device=dev)

        G = _scale2d(*const(2.0, 2.0)) @ G_inv.float() @ _scale2d(*const(0.5, 0.5))
        G = _translate2d(*const(-0.5, -0.5)) @ G @ _translate2d(*const(0.5, 0.5))

        # Normalized-coordinate version of affine_grid(align_corners=False).
        in_h, in_w = images.shape[2], images.shape[3]
        out_h, out_w = (H + hz_pad * 2) * 2, (W + hz_pad * 2) * 2
        G = (_scale2d(*const(2.0 / in_w, 2.0 / in_h)) @ G
             @ _scale2d(*const(out_w / 2.0, out_h / 2.0)))
        ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) / out_h * 2 - 1
        xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) / out_w * 2 - 1
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).reshape(-1, 3)
        src = torch.einsum("nij,mj->nmi", G, grid)[..., :2].reshape(N, out_h, out_w, 2)
        dtype = images.dtype
        images = warp(images.float(), src).to(dtype)

        # Downsample, then crop the static margin back to the input size.
        images = downsample2d(images, hz, down=2, padding=-hz_pad * 2, flip_filter=True)
        y0 = (images.shape[2] - H) // 2
        x0 = (images.shape[3] - W) // 2
        return images[:, :, y0:y0 + H, x0:x0 + W]

    def _execute_color(self, images: torch.Tensor, Cmat: torch.Tensor) -> torch.Tensor:
        """Apply the homogeneous colour matrices [N, 4, 4] to 1, 3 or 6
        channels (6: the same matrix on both halves)."""
        N, C, H, W = images.shape
        flat = images.reshape(N, C, H * W)
        Cm = Cmat.to(images.dtype)
        if C == 3:
            flat = torch.einsum("nij,njm->nim", Cm[:, :3, :3], flat) + Cm[:, :3, 3:]
        elif C == 1:
            Cm = Cm[:, :3, :].mean(dim=1, keepdim=True)
            flat = flat * Cm[:, :, :3].sum(dim=2, keepdim=True) + Cm[:, :, 3:]
        elif C == 6:
            a = torch.einsum("nij,njm->nim", Cm[:, :3, :3], flat[:, :3]) + Cm[:, :3, 3:]
            b = torch.einsum("nij,njm->nim", Cm[:, :3, :3], flat[:, 3:]) + Cm[:, :3, 3:]
            flat = torch.cat([a, b], dim=1)
        else:
            raise ValueError("images must have 1, 3 or 6 channels")
        return flat.reshape(N, C, H, W)

    def _execute_imgfilter(self, images, p, dp, uniform, normal):
        """Draw the per-band gains, then filter."""
        N = images.shape[0]
        num_bands = len(self.imgfilter_bands)
        expected_power = torch.tensor(np.array([10, 1, 1, 1]) / 13, dtype=torch.float32,
                                      device=images.device)
        g = torch.ones((N, num_bands), dtype=torch.float32, device=images.device)
        for i, band_strength in enumerate(self.imgfilter_bands):
            t_i = torch.exp2(normal() * self.imgfilter_std)
            t_i = torch.where(uniform() < self.imgfilter * p * band_strength, t_i,
                              torch.ones_like(t_i))
            if dp is not None:
                t_i = (torch.full_like(t_i, 2 ** (_erfinv(dp * 2 - 1) * self.imgfilter_std))
                       if band_strength > 0 else torch.ones_like(t_i))
            t = torch.ones((N, num_bands), dtype=torch.float32, device=images.device)
            t[:, i] = t_i
            t = t / torch.sqrt((expected_power * t.square()).sum(dim=-1, keepdim=True))
            g = g * t
        return self._execute_imgfilter_gains(images, g)

    def _execute_imgfilter_gains(self, images: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """Filter each image with the bank's rows mixed by its gains g
        [N, 4]: a separable FIR on the reflect-padded image."""
        N, C, H, W = images.shape
        fbank = torch.from_numpy(_filter_bank()).to(images.device)
        if len(self.imgfilter_bands) != fbank.shape[0]:
            raise ValueError(f"imgfilter_bands needs {fbank.shape[0]} entries")
        hz_prime = g.float() @ fbank  # [N, taps]
        taps = hz_prime.shape[-1]
        pad = fbank.shape[1] // 2
        x = reflect_pad(images.reshape(1, N * C, H, W), pad)
        w_rows = hz_prime[:, None, :].repeat_interleave(C, dim=0).reshape(N * C, 1, 1, taps)
        w_rows = w_rows.to(x.dtype)
        x = conv2d(x, w_rows, groups=N * C)
        x = conv2d(x, w_rows.reshape(N * C, 1, taps, 1), groups=N * C)
        return x.reshape(N, C, H, W)
