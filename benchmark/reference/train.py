"""Plain PyTorch reference of the G-NeRF training step (`training/train.py
--preset ffhq`): E trained with BatchNorm in train mode, G frozen, 48+48
samples with random noise, jitter and importance draws from the step's
threefry key, L1 + SSIM + VGG16-LPIPS on the 64^2 raw and the 512^2 image,
the 64^2 depth D with R1, Adam for E and D.

A frozen copy of the plain paths of `gnerf_tpu_torch` (training/
train_loop.py `make_train_step`, training/losses.py, models/stylegan2.py's
discriminator, training/dataset.py's `SyntheticDataset` and
utils/misc.py's `InfiniteSampler`), in fp32; the caller turns TF32 off
(on for the control). It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import threefry as tf
from .gnerf import (FC, Encoder, Generator, _param, bias_act, interpolate_bilinear,
                    normalize_2nd_moment, setup_filter, upfirdn2d)

# ---------------------------------------------------------------------------
# Data: SyntheticDataset and InfiniteSampler


def _label(rnd) -> np.ndarray:
    theta = np.pi / 2 + 0.7 * (rnd.rand() * 2 - 1)
    phi = np.pi / 2 - 0.05 + 0.3 * (rnd.rand() * 2 - 1)
    r = 2.7
    origin = np.array([r * np.sin(phi) * np.cos(np.pi - theta), r * np.cos(phi),
                       r * np.sin(phi) * np.sin(np.pi - theta)])
    forward = -origin / np.linalg.norm(origin)
    right = -np.cross(np.array([0.0, 1.0, 0.0]), forward)
    right /= np.linalg.norm(right)
    up2 = np.cross(forward, right)
    up2 /= np.linalg.norm(up2)
    m = np.eye(4)
    m[:3, :3] = np.stack([right, up2, forward], axis=-1)
    m[:3, 3] = origin
    intr = np.array([[4.2647, 0, 0.5], [0, 4.2647, 0.5], [0, 0, 1]])
    return np.concatenate([m.reshape(16), intr.reshape(9)]).astype(np.float32)


def item(seed: int, idx: int, res: int, depth_res: int) -> dict:
    rnd = np.random.RandomState(seed * 100003 + idx)
    img = rnd.randint(0, 256, (3, res, res), dtype=np.uint8)
    depth = (2.25 + rnd.rand(1, depth_res, depth_res) * (3.3 - 2.25)).astype(np.float32)
    c = _label(rnd)
    return {"condition_image": img, "condition_c": c, "loss_image": img, "loss_c": _label(rnd),
            "c_depth_image": depth, "factor": np.float32(1.0)}


def sampler(size: int, seed: int, window_size: float = 0.5):
    order = np.arange(size)
    rnd = np.random.RandomState(seed)
    rnd.shuffle(order)
    window = int(np.rint(order.size * window_size))
    idx = 0
    while True:
        i = idx % order.size
        yield int(order[i])
        if window >= 2:
            j = (i - rnd.randint(window)) % order.size
            order[i], order[j] = order[j], order[i]
        idx += 1


def batches(data_seed: int, order_seed: int, batch: int, size: int, res: int, depth_res: int):
    """The collated host batches of `data_iterator(SyntheticDataset(...))`."""
    it = sampler(size, order_seed)
    while True:
        items = [item(data_seed, next(it), res, depth_res) for _ in range(batch)]
        yield {k: np.stack([np.asarray(x[k]) for x in items]) for k in items[0]}


# ---------------------------------------------------------------------------
# The depth discriminator


def conv2d_down(x, w, f, down, padding):
    """The `down > 1` case of conv2d_resample."""
    fw = f.shape[-1]
    p0 = padding + (fw - down + 1) // 2
    p1 = padding + (fw - down) // 2
    if w.shape[2] == 1 and w.shape[3] == 1:
        x = upfirdn2d(x, f, down=down, padding=(p0, p1, p0, p1))
        return F.conv2d(x, w.to(x.dtype))
    x = upfirdn2d(x, f, padding=(p0, p1, p0, p1))
    return F.conv2d(x, w.to(x.dtype), stride=down)


class Conv(nn.Module):
    def __init__(self, cin, cout, k, bias=True, activation="linear", down=1, conv_clamp=None):
        super().__init__()
        self.cin, self.k, self.activation, self.down, self.conv_clamp = cin, k, activation, down, conv_clamp
        self.weight = _param(cout, cin, k, k)
        self.bias = _param(cout) if bias else None
        self.register_buffer("resample_filter", setup_filter([1, 3, 3, 1]), persistent=False)

    def forward(self, x, gain=1.0):
        w = self.weight * (1 / math.sqrt(self.cin * self.k ** 2))
        if self.down > 1:
            x = conv2d_down(x, w, self.resample_filter, self.down, self.k // 2)
        else:
            x = F.conv2d(x, w.to(x.dtype), padding=self.k // 2)
        act_gain = (math.sqrt(2) if self.activation == "lrelu" else 1.0) * gain
        clamp = self.conv_clamp * gain if self.conv_clamp is not None else None
        return bias_act(x, self.bias, act=self.activation, gain=act_gain, clamp=clamp)


class DBlock(nn.Module):
    def __init__(self, cin, tmp, cout):
        super().__init__()
        self.cin = cin
        if cin == 0:
            self.fromrgb = Conv(1, tmp, 1, activation="lrelu", conv_clamp=256)
        self.conv0 = Conv(tmp, tmp, 3, activation="lrelu", conv_clamp=256)
        self.conv1 = Conv(tmp, cout, 3, activation="lrelu", down=2, conv_clamp=256)
        self.skip = Conv(tmp, cout, 1, bias=False, down=2)

    def forward(self, x, img):
        if self.cin == 0:
            x = self.fromrgb(img)
        y = self.skip(x, gain=math.sqrt(0.5))
        x = self.conv0(x)
        x = self.conv1(x, gain=math.sqrt(0.5))
        return y + x


def minibatch_std(x, group_size=4):
    n, c, h, w = x.shape
    g = min(group_size, n)
    y = x.reshape(g, -1, 1, c, h, w)
    y = (y - y.mean(dim=0)).square().mean(dim=0)
    y = (y + 1e-8).sqrt().mean(dim=(2, 3, 4))
    y = y.reshape(-1, 1, 1, 1).repeat(g, 1, h, w)
    return torch.cat([x, y], dim=1)


class DMapping(nn.Module):
    def __init__(self, c_dim=25, w_dim=512, num_layers=8):
        super().__init__()
        self.num_layers = num_layers
        self.embed = FC(c_dim, w_dim)
        for i in range(num_layers):
            setattr(self, f"fc{i}", FC(w_dim, w_dim, "lrelu", 0.01))

    def forward(self, c):
        x = normalize_2nd_moment(self.embed(c.float()))
        for i in range(self.num_layers):
            x = getattr(self, f"fc{i}")(x)
        return x


class Epilogue(nn.Module):
    def __init__(self, c=512, cmap=512):
        super().__init__()
        self.cmap = cmap
        self.conv = Conv(c + 1, c, 3, activation="lrelu", conv_clamp=256)
        self.fc = FC(c * 16, c, "lrelu")
        self.out = FC(c, cmap)

    def forward(self, x, cmap):
        x = self.conv(minibatch_std(x.float()))
        x = self.out(self.fc(x.reshape(x.shape[0], -1)))
        return (x * cmap).sum(dim=1, keepdim=True) * (1 / math.sqrt(self.cmap))


class DepthD(nn.Module):
    """StyleGAN2 resnet discriminator of 1-channel 64^2 depth, conditioned
    on the 25-dim camera label (G-NeRF's depth D at the full widths)."""

    def __init__(self, res=64, channel_base=32768, channel_max=512, c_dim=25):
        super().__init__()
        ch = lambda r: min(channel_base // r, channel_max)  # noqa: E731
        self.block_resolutions = [2 ** i for i in range(int(math.log2(res)), 2, -1)]
        for r in self.block_resolutions:
            setattr(self, f"b{r}", DBlock(ch(r) if r < res else 0, ch(r), ch(r // 2)))
        self.mapping = DMapping(c_dim, ch(4))
        self.b4 = Epilogue(ch(4), ch(4))

    def forward(self, img, c):
        x = None
        for r in self.block_resolutions:
            x = getattr(self, f"b{r}")(x, img)
        return self.b4(x, self.mapping(c))


# ---------------------------------------------------------------------------
# LPIPS and SSIM

_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)
_LPIPS_LAYERS = (1, 3, 6, 9, 12)
_LPIPS_DIMS = (64, 128, 256, 512, 512)


class VGG(nn.Module):
    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for v in _VGG_CFG:
            if v != "M":
                conv = nn.Module()
                conv.weight, conv.bias = _param(v, cin, 3, 3), _param(v)
                setattr(self, f"conv{i}", conv)
                cin, i = v, i + 1
        for j, d in enumerate(_LPIPS_DIMS):
            setattr(self, f"lin{j}", _param(d))

    def embed(self, images):
        """[-1, 1] images at 256^2 -> LPIPS embeddings [N, D]."""
        x = ((images + 1) * 255 * 0.5) / 255.0 * 2.0 - 1.0
        out, i = [], 0
        for v in _VGG_CFG:
            if v == "M":
                x = F.max_pool2d(x, kernel_size=2, stride=2)
                continue
            conv = getattr(self, f"conv{i}")
            x = F.relu(F.conv2d(x, conv.weight, conv.bias, padding=1))
            if i in _LPIPS_LAYERS:
                f = x / torch.sqrt(x.square().sum(dim=1, keepdim=True) + 1e-10)
                f = f * getattr(self, f"lin{len(out)}")[None, :, None, None]
                n, _, h, w = f.shape
                out.append((f / math.sqrt(h * w)).reshape(n, -1))
            i += 1
        return torch.cat(out, dim=1)


def _gauss(size=11, sigma=1.5):
    c = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(c ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def ssim(x, y, win_size=11):
    """Per-sample SSIM of [N, C, H, W] images in [0, 1] (data range 1)."""
    smaller = min(x.shape[2], x.shape[3])
    if smaller < win_size:
        win_size = smaller if smaller % 2 == 1 else smaller - 1
    win = torch.from_numpy(_gauss(win_size)).to(x.device)
    c = x.shape[1]

    def blur(img):
        kh = win.reshape(1, 1, -1, 1).expand(c, 1, win_size, 1)
        kw = win.reshape(1, 1, 1, -1).expand(c, 1, 1, win_size)
        return F.conv2d(F.conv2d(img, kh, groups=c), kw, groups=c)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_x, mu_y = blur(x), blur(y)
    sx = blur(x * x) - mu_x * mu_x
    sy = blur(y * y) - mu_y * mu_y
    sxy = blur(x * y) - mu_x * mu_y
    m = ((2 * mu_x * mu_y + c1) / (mu_x * mu_x + mu_y * mu_y + c1)) * (2 * sxy + c2) / (sx + sy + c2)
    return m.mean(dim=(1, 2, 3))


# ---------------------------------------------------------------------------
# The step


def noise_draws(g: Generator, key, n: int, device) -> list:
    """Each backbone block's random noise, split from `key` as the program's
    `draw_noise` splits it: one key per block, two per block (conv0, conv1;
    the 4^2 block's conv1 takes the first)."""
    out = []
    blocks = [getattr(g.backbone.synthesis, f"b{r}") for r in g.backbone.block_resolutions]
    for block, k in zip(blocks, tf.split(key, len(blocks))):
        names = ("conv1",) if block.cin == 0 else ("conv0", "conv1")
        out.append({name: tf.normal(kk, (n, 1, getattr(block, name).noise_const.shape[0],
                                         getattr(block, name).noise_const.shape[0]), device)
                    for name, kk in zip(names, tf.split(k))})
    return out


def step_key(seed: int, cur_nimg: int):
    return tf.fold_in(tf.PRNGKey(seed + 1), cur_nimg)


class Step:
    """The G-NeRF step over (E, G, D, VGG) with Adam for E and D."""

    def __init__(self, g: Generator, enc: Encoder, disc: DepthD, vgg: VGG, batch: int,
                 glr=1e-3, dlr=8e-6, r1_gamma=1.0):
        self.g, self.enc, self.disc, self.vgg = g, enc, disc, vgg
        self.r1_gamma = r1_gamma
        g.requires_grad_(False)
        vgg.requires_grad_(False)
        enc.requires_grad_(True).train()
        disc.requires_grad_(True)
        self.e_params = list(enc.parameters())
        self.d_params = list(disc.parameters())
        self.opt_e = torch.optim.Adam(self.e_params, lr=glr, betas=(0.9, 0.999), eps=1e-8)
        self.opt_d = torch.optim.Adam(self.d_params, lr=dlr, betas=(0.0, 0.999), eps=1e-8)

    def losses(self, batch: dict, key, device):
        """(G loss, depth of the fakes, stats) of one batch under the step key."""
        g, res = self.g, self.g.neural_res
        n = batch["condition_image"].shape[0]
        z = self.enc(batch["condition_image"].float() / 127.5 - 1.0, train=True)
        loss_c = batch["loss_c"].float()
        ws = g.mapping(z)
        k_noise = tf.split(key)[0]
        k_bb, k_rest = tf.split(k_noise)
        planes = g.planes(ws, torch.float32, noise_draws(g, k_bb, n, device))
        k_render = tf.split(k_rest)[0]
        keys = tf.split(k_render, 4)
        r, s, s_imp = res * res, g.depth_resolution, g.depth_resolution_importance
        jitter = tf.uniform(keys[0], (n, r, s, 1), device)
        u = tf.uniform(keys[2], (n, r, s_imp), device).reshape(n * r, s_imp)
        image, image_raw, depth = g.render(planes, loss_c, ws, torch.float32, jitter=jitter, u=u,
                                           all_outputs=True)
        loss_image = batch["loss_image"].float()
        real_img = loss_image / 127.5 - 1.0
        real_raw = interpolate_bilinear(loss_image, res, res, antialias=True) / 127.5 - 1.0
        factor = batch["factor"].float()

        def masked_mean(v):
            return (v * factor).sum() / (factor.sum() + 1e-6)

        def recon(real, fake):
            return (real - fake).abs().mean(dim=(1, 2, 3)), 1.0 - ssim(real * 0.5 + 0.5, fake * 0.5 + 0.5)

        def to_vgg(x):
            return interpolate_bilinear(x, 256, 256, antialias=True) if x.shape[-1] != 256 else x

        l1_raw, ssim_raw = recon(real_raw, image_raw)
        l1_full, ssim_full = recon(real_img, image)
        with torch.no_grad():
            emb_t = self.vgg.embed(torch.cat([to_vgg(real_raw), to_vgg(real_img)]))
        emb_f = self.vgg.embed(torch.cat([to_vgg(image_raw), to_vgg(image)]))
        lp_raw, lp_full = (emb_t - emb_f).square().sum(dim=1).chunk(2)
        total = masked_mean(l1_raw + ssim_raw + lp_raw + l1_full + ssim_full + lp_full)
        total = total + 1.2 * F.softplus(-self.disc(depth, loss_c)).mean()
        return total, depth.detach()

    def d_loss(self, batch, depth_fake):
        res = self.g.neural_res
        loss_c, cond_c = batch["loss_c"].float(), batch["condition_c"].float()
        depth_real = interpolate_bilinear(batch["c_depth_image"].float(), res, res, antialias=True)
        loss = F.softplus(self.disc(depth_fake, loss_c)).mean()
        loss = loss + F.softplus(-self.disc(depth_real, cond_c)).mean()
        x = depth_real.detach().requires_grad_(True)
        (grads,) = torch.autograd.grad(self.disc(x, cond_c).sum(), x, create_graph=True)
        return loss + (grads.square().sum(dim=(1, 2, 3)) * (self.r1_gamma / 2)).mean()

    def __call__(self, batch: dict, key, device) -> dict:
        """One step, in place. Returns the losses and both gradients."""
        total, depth_fake = self.losses(batch, key, device)
        e_grads = torch.autograd.grad(total, self.e_params, materialize_grads=True)
        loss_d = self.d_loss(batch, depth_fake)
        d_grads = torch.autograd.grad(loss_d, self.d_params, materialize_grads=True)
        for opt, params, grads in ((self.opt_d, self.d_params, d_grads),
                                   (self.opt_e, self.e_params, e_grads)):
            for p, gr in zip(params, grads):
                p.grad = gr
            opt.step()
            opt.zero_grad(set_to_none=True)
        return {"loss_g": float(total.detach()), "loss_d": float(loss_d.detach()),
                "grads": [gr.detach() for gr in e_grads + d_grads]}
