"""Plain PyTorch reference of G-NeRF inference: E -> mapping -> tri-plane
StyleGAN2 backbone -> two-pass volume render -> SuperresolutionHybrid8XDC.

A frozen copy of the plain paths of `gnerf_tpu_torch` (models/encoder.py,
models/stylegan2.py, models/superresolution.py, models/triplane.py,
render/*, ops/{bias_act,upfirdn2d,conv2d_resample,interpolate}.py and
`osg_decode_ref`), kept here so that no later change to the program moves
it. It imports nothing of the program. Parameter and buffer names are the
JAX param layout's, so the benchmark hands one flat dict of weights to both
sides. Every module is built on `meta` and filled with `load_state`.

Precision follows `dtype` as the program's does: the backbone, the planes
and the superresolution in `dtype`, E, the mapping, ray geometry and
compositing in fp32. `FP8` as `dtype` is the control: every convolution
and its weight are rounded to float8 e4m3 (scaled per tensor) and computed
in bf16, one precision below the configuration's bf16.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

FP8 = torch.float8_e4m3fn
_FP8_MAX = 448.0


def q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale, returned in bf16."""
    amax = x.detach().abs().amax().float().clamp_min(1e-12)
    scale = _FP8_MAX / amax
    return ((x.float() * scale).to(FP8).float() / scale).to(torch.bfloat16)


def cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """x in the compute type of `dtype` (FP8 computes in bf16)."""
    return q8(x) if dtype is FP8 else x.to(dtype)


# ---------------------------------------------------------------------------
# ops


def _lrelu(x, alpha):
    return F.leaky_relu(x, alpha)


ACT = {"linear": (lambda x, a: x, 0.0, 1.0), "lrelu": (_lrelu, 0.2, math.sqrt(2)),
       "relu": (lambda x, a: F.relu(x), 0.0, math.sqrt(2))}


def bias_act(x, b=None, act="linear", gain=None, clamp=None):
    fn, alpha, def_gain = ACT[act]
    gain = def_gain if gain is None else gain
    if b is not None:
        shape = [1] * x.dim()
        shape[1] = -1
        x = x + b.to(x.dtype).reshape(shape)
    x = fn(x, alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x


def setup_filter(f) -> torch.Tensor:
    f = torch.as_tensor(f, dtype=torch.float32)
    f = torch.outer(f, f)
    return f / f.sum()


def conv2d(x, w, stride=1, padding=0, groups=1, fp8=False):
    if fp8:
        x, w = q8(x), q8(w)
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding, groups=groups)


def upfirdn2d(x, f, up=1, down=1, padding=(0, 0, 0, 0), gain=1.0):
    if f is None:
        f = torch.ones([1, 1], dtype=torch.float32, device=x.device)
    px0, px1, py0, py1 = padding
    n, c, h, w = x.shape
    x = x.reshape(n, c, h, 1, w, 1)
    x = F.pad(x, [0, up - 1, 0, 0, 0, up - 1])
    x = x.reshape(n, c, h * up, w * up)
    x = F.pad(x, [max(px0, 0), max(px1, 0), max(py0, 0), max(py1, 0)])
    x = x[:, :, max(-py0, 0): x.shape[2] - max(-py1, 0), max(-px0, 0): x.shape[3] - max(-px1, 0)]
    f = (f.to(x.device) * (gain ** (f.dim() / 2))).to(x.dtype).flip([0, 1])
    f = f[None, None].repeat([c, 1, 1, 1])
    x = F.conv2d(x, f, groups=c)
    return x[:, :, ::down, ::down]


def upsample2d(x, f, up=2):
    fw = f.shape[-1]
    p = ((fw + up - 1) // 2, (fw - up) // 2, (fw + up - 1) // 2, (fw - up) // 2)
    return upfirdn2d(x, f, up=up, padding=p, gain=up * up)


def conv2d_resample(x, w, f=None, up=1, padding=0, flip_weight=True, fp8=False):
    """Only the cases G uses: up 1 or 2, no down, groups 1."""
    kh = w.shape[2]
    if not flip_weight and kh > 1:
        w = w.flip([2, 3])
    if up > 1:
        fw = f.shape[-1]
        p0 = padding + (fw + up - 1) // 2
        p1 = padding + (fw - up) // 2
        x = upfirdn2d(x, f, up=up, padding=(p0, p1, p0, p1), gain=up ** 2)
        return conv2d(x, w, fp8=fp8)
    return conv2d(x, w, padding=padding, fp8=fp8)


def _resize_weights(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    scale = in_size / out_size
    filter_scale = scale if (antialias and scale > 1.0) else 1.0
    out = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale - 0.5
        js = np.arange(int(np.ceil(center - filter_scale)), int(np.floor(center + filter_scale)) + 1)
        wts = np.maximum(0.0, 1.0 - np.abs(js - center) / filter_scale)
        valid = (js >= 0) & (js < in_size)
        np.add.at(out[i], js[valid], wts[valid])
        if out[i].sum() > 0:
            out[i] /= out[i].sum()
    return out.astype(np.float32)


def interpolate_bilinear(x, out_h, out_w, antialias=False):
    _, _, h, w = x.shape
    if h == out_h and w == out_w:
        return x
    mh = torch.tensor(_resize_weights(h, out_h, antialias), dtype=x.dtype, device=x.device)
    mw = torch.tensor(_resize_weights(w, out_w, antialias), dtype=x.dtype, device=x.device)
    x = torch.einsum("oh,nchw->ncow", mh, x)
    return torch.einsum("pw,ncow->ncop", mw, x)


def osg_decode_ref(feats, w1e, b1e, w2e, b2e):
    """[N, 3, M, C] features -> [N, M, 33] fp32 [sigma | rgb]."""
    f = feats.float()
    w1 = w1e.float()
    x = (f[:, 0] @ w1 + f[:, 1] @ w1 + f[:, 2] @ w1) / 3.0 + b1e.float()
    o = F.softplus(x) @ w2e.float() + b2e.float()
    rgb = torch.sigmoid(o[..., 1:]) * (1 + 2 * 0.001) - 0.001
    return torch.cat([o[..., :1], rgb], dim=-1)


# ---------------------------------------------------------------------------
# StyleGAN2 parts


def _param(*shape):
    return nn.Parameter(torch.empty(shape, device="meta"))


class FC(nn.Module):
    def __init__(self, cin, cout, activation="linear", lr_multiplier=1.0):
        super().__init__()
        self.cin, self.activation, self.lr = cin, activation, lr_multiplier
        self.weight = _param(cout, cin)
        self.bias = _param(cout)

    def forward(self, x):
        x = x @ (self.weight.to(x.dtype) * (self.lr / math.sqrt(self.cin))).t()
        return bias_act(x, self.bias * self.lr, act=self.activation)


def normalize_2nd_moment(x, eps=1e-8):
    return x * torch.rsqrt(x.square().mean(dim=1, keepdim=True) + eps)


class Mapping(nn.Module):
    def __init__(self, z_dim, c_dim, w_dim, num_ws, num_layers):
        super().__init__()
        self.num_ws, self.num_layers = num_ws, num_layers
        feats = [z_dim + w_dim] + [w_dim] * num_layers
        for i in range(num_layers):
            setattr(self, f"fc{i}", FC(feats[i], feats[i + 1], "lrelu", 0.01))
        self.embed = FC(c_dim, w_dim)
        self.register_buffer("w_avg", torch.empty(w_dim, device="meta"))

    def forward(self, z, c):
        x = torch.cat([normalize_2nd_moment(z.float()),
                       normalize_2nd_moment(self.embed(c.float()))], dim=1)
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        return x[:, None, :].repeat(1, self.num_ws, 1)


def modulated_conv2d(x, weight, styles, noise=None, up=1, padding=0, resample_filter=None,
                     demodulate=True, flip_weight=True, fp8=False):
    dcoefs = None
    if demodulate:
        w = weight[None] * styles[:, None, :, None, None]
        dcoefs = torch.rsqrt(w.square().sum(dim=(2, 3, 4)) + 1e-8)
    x = x * styles.to(x.dtype)[:, :, None, None]
    x = conv2d_resample(x, weight.to(x.dtype), f=resample_filter, up=up, padding=padding,
                        flip_weight=flip_weight, fp8=fp8)
    if demodulate:
        x = x * dcoefs.to(x.dtype)[:, :, None, None]
    if noise is not None:
        x = x + noise.to(x.dtype)
    return x


class SynthesisLayer(nn.Module):
    def __init__(self, cin, cout, w_dim, resolution, up=1, conv_clamp=None):
        super().__init__()
        self.up, self.conv_clamp, self.cout = up, conv_clamp, cout
        self.affine = FC(w_dim, cin)
        self.weight = _param(cout, cin, 3, 3)
        self.bias = _param(cout)
        self.noise_const = _param(resolution, resolution)
        self.noise_strength = _param()
        self.register_buffer("resample_filter", setup_filter([1, 3, 3, 1]), persistent=False)

    def forward(self, x, w, gain=1.0, fp8=False, const_noise=True, noise=None):
        """`noise`: this layer's N(0, 1) draw [N, 1, r, r] (random noise), else
        the constant noise when `const_noise`, else none."""
        styles = self.affine(w)
        if noise is not None:
            noise = noise * self.noise_strength
        elif const_noise:
            noise = self.noise_const * self.noise_strength
        x = modulated_conv2d(x, self.weight, styles, noise=noise,
                             up=self.up, padding=1,
                             resample_filter=self.resample_filter if self.up > 1 else None,
                             flip_weight=self.up == 1, fp8=fp8)
        clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act="lrelu", gain=math.sqrt(2) * gain, clamp=clamp)


class ToRGB(nn.Module):
    def __init__(self, cin, cout, w_dim, conv_clamp=None):
        super().__init__()
        self.weight_gain = 1 / math.sqrt(cin)
        self.conv_clamp = conv_clamp
        self.affine = FC(w_dim, cin)
        self.weight = _param(cout, cin, 1, 1)
        self.bias = _param(cout)

    def forward(self, x, w, fp8=False):
        styles = self.affine(w) * self.weight_gain
        x = modulated_conv2d(x, self.weight, styles, demodulate=False, fp8=fp8)
        return bias_act(x, self.bias, clamp=self.conv_clamp)


class SynthesisBlock(nn.Module):
    """Skip architecture; `up=1` is the superresolution's first block."""

    def __init__(self, cin, cout, w_dim, resolution, img_channels, conv_clamp, up=2,
                 const_noise=True):
        super().__init__()
        self.cin, self.up, self.const_noise = cin, up, const_noise
        self.num_conv = 1 if cin == 0 else 2
        if cin == 0:
            self.const = _param(cout, resolution, resolution)
        else:
            self.conv0 = SynthesisLayer(cin, cout, w_dim, resolution, up=up, conv_clamp=conv_clamp)
        self.conv1 = SynthesisLayer(cout, cout, w_dim, resolution, conv_clamp=conv_clamp)
        self.torgb = ToRGB(cout, img_channels, w_dim, conv_clamp=conv_clamp)
        self.register_buffer("resample_filter", setup_filter([1, 3, 3, 1]), persistent=False)

    def forward(self, x, img, ws, dtype, noise=None):
        """`noise`: {"conv0": .., "conv1": ..} random draws, or None."""
        kw = dict(fp8=dtype is FP8, const_noise=self.const_noise)
        noise = noise or {}
        w_iter = iter(ws.unbind(dim=1))
        if self.cin == 0:
            x = cast(self.const, dtype)[None].expand(ws.shape[0], *self.const.shape)
            x = self.conv1(x, next(w_iter), noise=noise.get("conv1"), **kw)
        else:
            x = cast(x, dtype)
            x = self.conv0(x, next(w_iter), noise=noise.get("conv0"), **kw)
            x = self.conv1(x, next(w_iter), noise=noise.get("conv1"), **kw)
        if img is not None and self.up == 2:
            img = upsample2d(img, self.resample_filter)
        y = self.torgb(x, next(w_iter), fp8=kw["fp8"]).float()
        return x, (img + y if img is not None else y)


class Backbone(nn.Module):
    """Mapping + the 4^2 -> 256^2 synthesis stack (`backbone` in the tree)."""

    def __init__(self, z_dim, c_dim, w_dim, resolution, img_channels, mapping_layers,
                 channel_base, channel_max):
        super().__init__()
        self.synthesis = nn.Module()
        self.block_resolutions = [2 ** i for i in range(2, int(math.log2(resolution)) + 1)]
        num_ws = 0
        for res in self.block_resolutions:
            cin = min(channel_base // (res // 2), channel_max) if res > 4 else 0
            block = SynthesisBlock(cin, min(channel_base // res, channel_max), w_dim, res,
                                   img_channels, conv_clamp=256)
            setattr(self.synthesis, f"b{res}", block)
            num_ws += block.num_conv
        self.num_ws = num_ws + 1
        self.mapping = Mapping(z_dim, c_dim, w_dim, self.num_ws, mapping_layers)

    def synthesize(self, ws, dtype, noises=None):
        """`noises`: per block, its random draws (`noise_draws`), or None."""
        ws = ws.float()
        x = img = None
        w_idx = 0
        for i, res in enumerate(self.block_resolutions):
            block = getattr(self.synthesis, f"b{res}")
            x, img = block(x, img, ws[:, w_idx: w_idx + block.num_conv + 1], dtype,
                           noises[i] if noises else None)
            w_idx += block.num_conv
        return img


class SR8XDC(nn.Module):
    """SuperresolutionHybrid8XDC: 64^2 features -> (512^2 image, 64^2 raw),
    without noise (`superresolution_noise_mode` "none")."""

    def __init__(self, channels=32, w_dim=512):
        super().__init__()
        kw = dict(conv_clamp=None, const_noise=False)
        self.block64 = SynthesisBlock(channels, channels, w_dim, 64, 3, up=1, **kw)
        self.block0 = SynthesisBlock(channels, 256, w_dim, 256, 3, up=2, **kw)
        self.block1 = SynthesisBlock(256, 128, w_dim, 512, 3, up=2, **kw)

    def forward(self, rgb, x, ws, dtype):
        ws = ws[:, -1:, :].repeat(1, 3, 1)
        x_raw, image_raw = self.block64(x, rgb, ws, dtype)
        x = interpolate_bilinear(x_raw, 128, 128, antialias=True)
        rgb = interpolate_bilinear(image_raw, 128, 128, antialias=True)
        x, rgb = self.block0(x, rgb, ws, dtype)
        _, rgb = self.block1(x, rgb, ws, dtype)
        return rgb, image_raw


# ---------------------------------------------------------------------------
# Encoder


class BatchNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.momentum = 0.1  # 1.0 sets the running statistics to a batch's (weights.fit_bn)
        self.scale = _param(c)
        self.bias = _param(c)
        self.register_buffer("mean", torch.empty(c, device="meta"))
        self.register_buffer("var", torch.empty(c, device="meta"))

    def forward(self, x, train=False):
        momentum = self.momentum
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
        inv = torch.rsqrt(var + 1e-5) * self.scale
        shape = (1, -1, 1, 1)
        return ((x - mean.to(x.dtype).reshape(shape)) * inv.to(x.dtype).reshape(shape)
                + self.bias.to(x.dtype).reshape(shape))


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride, groups=32, width_per_group=4):
        super().__init__()
        width = int(planes * (width_per_group / 64.0)) * groups
        self.stride, self.groups = stride, groups
        self.conv1, self.bn1 = _param(width, cin, 1, 1), BatchNorm(width)
        self.conv2, self.bn2 = _param(width, width // groups, 3, 3), BatchNorm(width)
        self.conv3, self.bn3 = _param(planes * 4, width, 1, 1), BatchNorm(planes * 4)
        self.down = stride != 1 or cin != planes * 4
        if self.down:
            self.downsample_conv = _param(planes * 4, cin, 1, 1)
            self.downsample_bn = BatchNorm(planes * 4)

    def forward(self, x, train=False):
        out = F.relu(self.bn1(F.conv2d(x, self.conv1), train))
        out = F.relu(self.bn2(F.conv2d(out, self.conv2, stride=self.stride, padding=1,
                                       groups=self.groups), train))
        out = self.bn3(F.conv2d(out, self.conv3), train)
        identity = x
        if self.down:
            identity = self.downsample_bn(F.conv2d(x, self.downsample_conv, stride=self.stride),
                                          train)
        return F.relu(out + identity)


class Encoder(nn.Module):
    """ResNeXt50 (32x4d) image [N, 3, H, W] in [-1, 1] -> z [N, out_dim], fp32."""

    def __init__(self, out_dim=512, layers=(3, 4, 6, 3)):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1, self.bn1 = _param(64, 3, 7, 7), BatchNorm(64)
        cin = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512), self.layers)):
            for b in range(blocks):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                setattr(self, f"layer{stage + 1}_{b}", Bottleneck(cin, planes, stride))
                cin = planes * 4
        self.fc = nn.Module()
        self.fc.weight = _param(out_dim, 2048 * 4)
        self.fc.bias = _param(out_dim)

    def forward(self, images, train=False):
        x = F.relu(self.bn1(F.conv2d(images, self.conv1, stride=2, padding=3), train))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for stage, blocks in enumerate(self.layers):
            for b in range(blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x, train)
        x = F.adaptive_avg_pool2d(x, 2).reshape(x.shape[0], -1)
        return F.linear(x, self.fc.weight, self.fc.bias)


# ---------------------------------------------------------------------------
# Rendering


def sample_rays(cam2world, intrinsics, resolution):
    cam2world, intrinsics = cam2world.float(), intrinsics.float()
    n, m, dev = cam2world.shape[0], resolution * resolution, cam2world.device
    cam_pos = cam2world[:, :3, 3]
    fx, fy = intrinsics[:, 0, 0][:, None], intrinsics[:, 1, 1][:, None]
    cx, cy = intrinsics[:, 0, 2][:, None], intrinsics[:, 1, 2][:, None]
    sk = intrinsics[:, 0, 1][:, None]
    centers = (torch.arange(resolution, dtype=torch.float32, device=dev) + 0.5) / resolution
    yy, xx = torch.meshgrid(centers, centers, indexing="ij")
    x_cam, y_cam = xx.reshape(1, m).expand(n, m), yy.reshape(1, m).expand(n, m)
    z_cam = torch.ones((n, m), dtype=torch.float32, device=dev)
    x_lift = (x_cam - cx + cy * sk / fy - sk * y_cam / fy) / fx * z_cam
    y_lift = (y_cam - cy) / fy * z_cam
    cam_rel = torch.stack([x_lift, y_lift, z_cam, torch.ones_like(z_cam)], dim=-1)
    world = torch.einsum("nij,nmj->nmi", cam2world, cam_rel)[..., :3]
    dirs = world - cam_pos[:, None, :]
    dirs = dirs / torch.linalg.norm(dirs, dim=2, keepdim=True)
    return cam_pos[:, None, :].expand_as(dirs), dirs


def sample_from_planes(planes, coords, box_warp):
    """Planes [N, 3, C, H, W] at points [N, M, 3] -> [N, 3, M, C] in the planes' dtype."""
    n, _, c, h, w = planes.shape
    m = coords.shape[1]
    x, y, z = ((2.0 / box_warp) * coords.float()).unbind(-1)
    uv = torch.stack([torch.stack([x, y], -1), torch.stack([x, z], -1),
                      torch.stack([z, x], -1)], dim=1)
    out = F.grid_sample(planes.reshape(n * 3, c, h, w).float(), uv.reshape(n * 3, m, 1, 2),
                        mode="bilinear", padding_mode="zeros", align_corners=False)
    return out.reshape(n, 3, c, m).transpose(2, 3).to(planes.dtype).contiguous()


def march_rays(colors, densities, depths):
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
    return rgb * 2.0 - 1.0, depth, weights


def importance_depths(z_vals, weights, n_importance, eps=1e-5, u=None):
    """Inverse-CDF depths [N, R, n, 1] at the uniforms `u` [N * R, n], or
    evenly spaced ones when None (inference: no key)."""
    n, r, s, _ = z_vals.shape
    z = z_vals.reshape(n * r, s)
    w = weights.reshape(n * r, -1)
    mid = torch.maximum(w[..., :-1], w[..., 1:])
    mx = torch.cat([w[..., :1], mid, w[..., -1:]], dim=-1)
    w = (mx[..., :-1] + mx[..., 1:]) / 2.0 + 0.01
    bins = (z[:, :-1] + z[:, 1:]) / 2.0
    w = w[:, 1:-1] + eps
    pdf = w / w.sum(dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[:, :1]), torch.cumsum(pdf, dim=-1)], dim=-1).contiguous()
    n_w = w.shape[1]
    if u is None:
        u = torch.linspace(0.0, 1.0, n_importance, device=z.device).expand(n * r, n_importance)
    inds = torch.searchsorted(cdf, u.contiguous(), right=True)
    below, above = torch.clamp_min(inds - 1, 0), torch.clamp_max(inds, n_w)
    edges = bins[:, :n_w + 1]
    cdf_lo, cdf_hi = cdf.gather(1, below), cdf.gather(1, above)
    b_lo, b_hi = edges.gather(1, below), edges.gather(1, above)
    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return (b_lo + (u - cdf_lo) / denom * (b_hi - b_lo)).reshape(n, r, n_importance, 1)


class Decoder(nn.Module):
    def __init__(self, n_features=32, hidden=64, out=32):
        super().__init__()
        self.n_features, self.hidden = n_features, hidden
        self.fc0 = FC(n_features, hidden)
        self.fc1 = FC(hidden, 1 + out)

    def forward(self, feats):
        w1e = (self.fc0.weight * (1.0 / math.sqrt(self.n_features))).t().to(feats.dtype)
        w2e = (self.fc1.weight * (1.0 / math.sqrt(self.hidden))).t().float()
        return osg_decode_ref(feats, w1e, self.fc0.bias.float(), w2e, self.fc1.bias.float())


class Generator(nn.Module):
    """TriPlaneGenerator at the FFHQ 512 recipe (8XDC, 256^2 x 96 planes)."""

    def __init__(self, z_dim=512, c_dim=25, w_dim=512, plane_resolution=256, plane_channels=32,
                 mapping_layers=2, channel_base=32768, channel_max=512, neural_res=64,
                 depth_resolution=96, depth_resolution_importance=96, ray_start=2.25,
                 ray_end=3.3, box_warp=1.0):
        super().__init__()
        self.plane_channels, self.neural_res, self.box_warp = plane_channels, neural_res, box_warp
        self.depth_resolution = depth_resolution
        self.depth_resolution_importance = depth_resolution_importance
        self.ray_start, self.ray_end = ray_start, ray_end
        self.backbone = Backbone(z_dim, c_dim, w_dim, plane_resolution, plane_channels * 3,
                                 mapping_layers, channel_base, channel_max)
        self.decoder = Decoder(plane_channels)
        self.superresolution = SR8XDC(32, w_dim)

    def mapping(self, z):
        c = torch.zeros((z.shape[0], 25), device=z.device)
        return self.backbone.mapping(z, c)

    def planes(self, ws, dtype, noises=None):
        p = cast(self.backbone.synthesize(ws, dtype, noises), dtype)
        return p.reshape(p.shape[0], 3, self.plane_channels, p.shape[-2], p.shape[-1])

    def _eval(self, planes, origins, dirs, depths):
        n, r, s, _ = depths.shape
        pts = (origins[:, :, None, :] + depths * dirs[:, :, None, :]).reshape(n, -1, 3)
        out = self.decoder(sample_from_planes(planes, pts, self.box_warp))
        return out[..., 1:].reshape(n, r, s, -1), out[..., :1].reshape(n, r, s, 1)

    def render(self, planes, c, ws, dtype, jitter=None, u=None, all_outputs=False):
        """Planes [N, ...] under labels c [N, 25] -> 512^2 image [N, 3, H, W]
        (with `all_outputs`: image, 64^2 raw image, 64^2 depth). `jitter`
        [N, R, S, 1] and `u` [N * R, n_importance]: the stratified and
        importance draws of a training step; None samples deterministically."""
        res = self.neural_res
        origins, dirs = sample_rays(c[:, :16].reshape(-1, 4, 4), c[:, 16:25].reshape(-1, 3, 3), res)
        n, r = origins.shape[:2]
        s = self.depth_resolution
        depths = torch.linspace(self.ray_start, self.ray_end, s, device=c.device)
        depths = depths.reshape(1, 1, s, 1).expand(n, r, s, 1)
        if jitter is not None:
            depths = depths + jitter * ((float(self.ray_end) - float(self.ray_start)) / (s - 1))
        colors, dens = self._eval(planes, origins, dirs, depths)
        _, _, weights = march_rays(colors, dens, depths)
        with torch.no_grad():
            fine = importance_depths(depths, weights, self.depth_resolution_importance, u=u)
        colors_f, dens_f = self._eval(planes, origins, dirs, fine)
        all_d = torch.cat([depths, fine], dim=-2)
        all_c = torch.cat([colors, colors_f], dim=-2)
        all_s = torch.cat([dens, dens_f], dim=-2)
        d_sorted, perm = torch.sort(all_d[..., 0], dim=-1, stable=True)
        perm = perm[..., None]
        all_c = all_c.gather(-2, perm.expand(-1, -1, -1, all_c.shape[-1]))
        all_s = all_s.gather(-2, perm)
        feats, depth, _ = march_rays(all_c, all_s, d_sorted[..., None])
        img = feats.permute(0, 2, 1).reshape(n, -1, res, res)
        image, raw = self.superresolution(img[:, :3], img, ws, dtype)
        if all_outputs:
            return image, raw, depth.permute(0, 2, 1).reshape(n, 1, res, res)
        return image


# ---------------------------------------------------------------------------
# Cameras


FFHQ_INTRINSICS = torch.tensor([[4.2647, 0.0, 0.5], [0.0, 4.2647, 0.5], [0.0, 0.0, 1.0]])


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def label(yaw: float, pitch: float, radius: float = 2.7) -> torch.Tensor:
    """[1, 25] label of the look-at pose at (yaw, pitch) on the orbit sphere."""
    h, v = torch.tensor([float(yaw)]), torch.tensor([float(pitch)])
    origin = torch.stack([radius * torch.sin(v) * torch.cos(math.pi - h), radius * torch.cos(v),
                          radius * torch.sin(v) * torch.sin(math.pi - h)], dim=-1)
    fwd = _unit(_unit(-origin))
    up = torch.tensor([0.0, 1.0, 0.0]).expand_as(fwd)
    right = -_unit(torch.linalg.cross(up, fwd, dim=-1))
    up2 = _unit(torch.linalg.cross(fwd, right, dim=-1))
    m = torch.eye(4).repeat(1, 1, 1)
    m[:, :3, :3] = torch.stack([right, up2, fwd], dim=-1)
    m[:, :3, 3] = origin
    return torch.cat([m.reshape(1, 16), FFHQ_INTRINSICS.reshape(1, 9)], dim=1)


def orbit_pose(i: int, frames: int) -> tuple[float, float]:
    """(yaw, pitch) of frame i of a `frames`-frame orbit, as the service sweeps it."""
    return (math.pi / 2 + 0.7 * math.sin(2 * math.pi * i / frames),
            math.pi / 2 - 0.05 + 0.3 * math.cos(2 * math.pi * i / frames))


# ---------------------------------------------------------------------------
# Loading and the frame


def load_state(module: nn.Module, flat: dict, device) -> nn.Module:
    """Fill a module built on `meta` from {jax/path: tensor}; every key must match."""
    state = module.state_dict()
    keys = {k.replace(".", "/") for k in state}
    if keys != set(flat):
        raise KeyError(f"weights do not fit: missing {sorted(keys - set(flat))[:4]}, "
                       f"extra {sorted(set(flat) - keys)[:4]}")
    kept = {n: b for n, b in module.named_buffers() if not b.is_meta}
    module.to_empty(device=device)
    with torch.no_grad():
        for name, value in kept.items():
            module.get_buffer(name).copy_(value)
        for k, v in module.state_dict().items():
            v.copy_(torch.as_tensor(flat[k.replace(".", "/")]).to(device))
    return module.requires_grad_(False).eval()


@torch.no_grad()
def identity(g: Generator, enc: Encoder, photo_u8: torch.Tensor, dtype):
    """uint8 photo [3, H, W] -> (ws, planes), as the service prepares one."""
    x = photo_u8[None].to(next(g.parameters()).device).float() / 127.5 - 1.0
    ws = g.mapping(enc(x))
    return ws, g.planes(ws, dtype)


@torch.no_grad()
def frame(g: Generator, ws, planes, yaw, pitch, dtype, radius=2.7) -> torch.Tensor:
    """One uint8 frame [H, W, 3] on the device."""
    c = label(yaw, pitch, radius).to(planes.device)
    img = g.render(planes, c, ws, dtype)
    return ((img.float() + 1) * 127.5).clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0)
