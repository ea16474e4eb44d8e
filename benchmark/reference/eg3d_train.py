"""Plain PyTorch reference of EG3D's adversarial training step at the FFHQ
512 recipe (`train.py --cfg=ffhq --gen_pose_cond=True`): all of the
tri-plane generator G trained against the 512^2 dual discriminator D, with
lazy regularization (Gmain + Dmain every step, Greg every
`g_interval` and Dreg every `d_interval` steps).

- Gmain: G's non-saturating loss softplus(-D(G(z, c'))) on fresh fakes,
  c' the labels rolled by one with the pose-swap probability; an Adam step
  of G, then the mapping's w_avg update.
- Dmain: softplus(D(fake)) + softplus(-D(real)), the fakes regenerated from
  the updated G without a graph; an Adam step of D. Then G_ema tracks G
  with beta 0.5^(batch / 10k) and the clock advances.
- Greg: the density TV, |sigma(p) - sigma(p + N(0, p_dist))| at random
  points under a fresh mapping, times density_reg and the lazy gain.
- Dreg: R1, (gamma / 2) |dD/d(image, image_raw)|^2 on the reals, through
  the blur and the raw image's resize inside D, times the lazy gain.
- D sees the image beside the raw 64^2 render resized to 512^2
  (`filtered_resizing`, antialiased bilinear), 6 channels, with
  minibatch std over groups of 4; both optimizers are Adam(betas (0,
  0.99), eps 1e-8) with lr and betas scaled by interval / (interval + 1).

Every draw comes from the step's threefry key, split as the program's
`eg3d_loop_step` splits it. A frozen copy of the plain paths of
`gnerf_tpu_torch` (training/eg3d_loss.py, models/dual_discriminator.py,
training/train.py `eg3d_loop_step`), in fp32; the caller turns TF32 off (on
for the control). It imports nothing of the program.

Departures from the published EG3D (NVlabs/eg3d, training/loss.py), as the
program departs: G_ema's beta is 0.5^(batch / 10k) with no ramp-up (EG3D:
ema_kimg = batch * 10 / 32, ramp-up 0.05); the density TV draws its 1000
points a sample in [-1, 1]^3 and reads sigma from the planes under the
constant noise; the raw image is resized antialiased (EG3D's default
filter_mode 'antialiased'); all of G and D in fp32 (EG3D runs SR and D's
top four resolutions in fp16); no ADA and no style mixing (the recipe's
--aug noaug, --style_mixing_prob 0 at FFHQ's gpc); no pose noise on D's
labels (disc_c_noise 0).
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn.functional as F
from torch import nn

from . import threefry as tf
from .gnerf import Generator, interpolate_bilinear, sample_from_planes, upfirdn2d
from .train import Conv, DMapping, Epilogue, noise_draws

# ---------------------------------------------------------------------------
# The dual discriminator


class DualBlock(nn.Module):
    """Resnet block of the StyleGAN2 discriminator; the first takes
    `img_channels` through its fromrgb."""

    def __init__(self, cin, tmp, cout, img_channels):
        super().__init__()
        self.cin = cin
        if cin == 0:
            self.fromrgb = Conv(img_channels, tmp, 1, activation="lrelu", conv_clamp=256)
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


class DualD(nn.Module):
    """EG3D's DualDiscriminator: concat(image, raw image resized to the
    image's size) -> a StyleGAN2 resnet D over 6 channels, conditioned on the
    25-dim camera label through an 8-layer mapping."""

    def __init__(self, res=512, channel_base=32768, channel_max=512, c_dim=25, img_channels=3):
        super().__init__()
        ch = lambda r: min(channel_base // r, channel_max)  # noqa: E731
        self.block_resolutions = [2 ** i for i in range(int(math.log2(res)), 2, -1)]
        for r in self.block_resolutions:
            setattr(self, f"b{r}", DualBlock(ch(r) if r < res else 0, ch(r), ch(r // 2),
                                             img_channels * 2))
        self.mapping = DMapping(c_dim, ch(4))
        self.b4 = Epilogue(ch(4), ch(4))

    def forward(self, image, image_raw, c):
        raw = interpolate_bilinear(image_raw, image.shape[-1], image.shape[-1], antialias=True)
        img, x = torch.cat([image, raw], dim=1), None
        for r in self.block_resolutions:
            x = getattr(self, f"b{r}")(x, img)
        return self.b4(x, self.mapping(c))


# ---------------------------------------------------------------------------
# Schedules and pieces


def blur_sigma(cur_nimg: int, init_sigma: float, fade_kimg: float) -> float:
    if fade_kimg <= 0 or init_sigma <= 0:
        return 0.0
    return max(1 - cur_nimg / (fade_kimg * 1e3), 0.0) * init_sigma


def blur(img, sigma: float, size: int):
    """The 2^-x^2 taps over [-size, size] / sigma, as one 2-D FIR."""
    if size <= 0:
        return img
    x = torch.arange(-size, size + 1, device=img.device, dtype=torch.float32)
    f = torch.exp2(-(x / sigma).square())
    f = f / f.sum()
    return upfirdn2d(img, torch.outer(f, f), padding=(size, size, size, size))


def swap_prob(cur_nimg: int, prob: float, fade_kimg: float) -> float:
    alpha = min(cur_nimg / max(fade_kimg * 1e3, 1e-8), 1.0)
    return (1 - alpha) * 1.0 + alpha * prob


def lazy_adam(params, lr: float, interval: int) -> torch.optim.Adam:
    mb = interval / (interval + 1) if interval > 1 else 1.0
    return torch.optim.Adam(params, lr=lr * mb, betas=(0.0 ** mb, 0.99 ** mb), eps=1e-8)


def step_key(seed: int, cur_nimg: int):
    return tf.fold_in(tf.PRNGKey(seed + 1), cur_nimg)


# ---------------------------------------------------------------------------
# The step


class Step:
    """EG3D's lazy-regularized step over (G, D), in place."""

    def __init__(self, g: Generator, disc: DualD, batch: int, z_dim: int, *, glr, dlr, r1_gamma,
                 density_reg, p_dist, points, g_interval, d_interval, gpc_prob, gpc_fade_kimg,
                 blur_init_sigma, blur_fade_kimg, ema_kimg=10.0):
        self.g, self.disc, self.batch, self.z_dim = g, disc, batch, z_dim
        self.g_ema = copy.deepcopy(g).requires_grad_(False)
        g.requires_grad_(True)
        disc.requires_grad_(True)
        self.g_params, self.d_params = list(g.parameters()), list(disc.parameters())
        self.opt_g = lazy_adam(self.g_params, glr, g_interval if density_reg > 0 else 0)
        self.opt_d = lazy_adam(self.d_params, dlr, d_interval if r1_gamma > 0 else 0)
        self.r1_gamma, self.density_reg, self.p_dist, self.points = (r1_gamma, density_reg,
                                                                     p_dist, points)
        self.g_interval, self.d_interval = g_interval, d_interval
        self.gpc_prob, self.gpc_fade_kimg = gpc_prob, gpc_fade_kimg
        self.blur_init_sigma, self.blur_fade_kimg = blur_init_sigma, blur_fade_kimg
        self.ema_kimg = ema_kimg
        self.cur_nimg = 0
        self.teacher = None

    # -- forwards -----------------------------------------------------------

    def _swap(self, key, c):
        prob = swap_prob(self.cur_nimg, self.gpc_prob, self.gpc_fade_kimg)
        pick = tf.uniform(key, (c.shape[0], 1), c.device) < float(torch.tensor(prob).float())
        return torch.where(pick, torch.roll(c, 1, dims=0), c)

    def _g(self, z, c, key):
        """G's (image, raw image, ws) under the step's draws."""
        g, n, dev = self.g, z.shape[0], z.device
        k_swap, _, k_noise = tf.split(key, 3)
        ws = g.backbone.mapping(z, self._swap(k_swap, c))
        k_bb, k_rest = tf.split(k_noise)
        planes = g.planes(ws, torch.float32, noise_draws(g, k_bb, n, dev))
        keys = tf.split(tf.split(k_rest)[0], 4)
        r, s, s_imp = g.neural_res ** 2, g.depth_resolution, g.depth_resolution_importance
        jitter = tf.uniform(keys[0], (n, r, s, 1), dev)
        u = tf.uniform(keys[2], (n, r, s_imp), dev).reshape(n * r, s_imp)
        image, raw, _ = g.render(planes, c, ws, torch.float32, jitter=jitter, u=u,
                                 all_outputs=True)
        return image, raw, ws

    def _d(self, image, raw, c, sigma, size):
        return self.disc(blur(image, sigma, size), raw, c)

    def _adam(self, opt, params, loss, phase):
        grads = [gr.detach() for gr in
                 torch.autograd.grad(loss, params, materialize_grads=True)]
        step_with = self.teacher.gradient(phase, grads) if self.teacher else grads
        for p, gr in zip(params, step_with):
            p.grad = gr
        opt.step()
        opt.zero_grad(set_to_none=True)
        return grads

    # -- phases -------------------------------------------------------------

    def gmain(self, b, key, sigma, size):
        k_gen, _ = tf.split(key)
        image, raw, ws = self._g(b["z"], b["c"], k_gen)
        loss = F.softplus(-self._d(image, raw, b["c"], sigma, size)).mean()
        grads = self._adam(self.opt_g, self.g_params, loss, "gmain")
        with torch.no_grad():
            w_avg = self.g.backbone.mapping.w_avg
            mean = ws[:, 0].detach().mean(dim=0)
            w_avg.copy_(mean + (w_avg - mean) * 0.998)
        return float(loss.detach()), grads

    def dmain(self, b, key, sigma, size):
        k_gen, _, _ = tf.split(key, 3)
        with torch.no_grad():
            image, raw, _ = self._g(b["z"], b["c"], k_gen)
        res = self.g.neural_res
        real_raw = interpolate_bilinear(b["real"], res, res, antialias=True)
        loss = (F.softplus(self._d(image, raw, b["c"], sigma, size)).mean()
                + F.softplus(-self._d(b["real"], real_raw, b["c"], sigma, size)).mean())
        return float(loss.detach()), self._adam(self.opt_d, self.d_params, loss, "dmain")

    def finish(self):
        beta = 0.5 ** (self.batch / (self.ema_kimg * 1000.0))
        with torch.no_grad():
            new = self.g.state_dict()
            for k, e in self.g_ema.state_dict().items():
                e.copy_(e * beta + new[k] * (1 - beta))
        self.cur_nimg += self.batch

    def greg(self, b, key):
        g, n, dev = self.g, b["z"].shape[0], b["z"].device
        k_swap, k_reg = tf.split(key)
        ws = g.backbone.mapping(b["z"], self._swap(k_swap, b["c"]))
        k1, k2, _ = tf.split(k_reg, 3)
        initial = tf.uniform(k1, (n, self.points, 3), dev) * 2 - 1
        perturbed = initial + tf.normal(k2, initial.shape, dev) * self.p_dist
        coords = torch.cat([initial, perturbed], dim=1)
        planes = g.planes(ws, torch.float32)
        sigma = g.decoder(sample_from_planes(planes, coords, g.box_warp))[..., :1]
        tv = (sigma[:, :self.points] - sigma[:, self.points:]).abs().mean() * self.density_reg
        return float(tv.detach()), self._adam(self.opt_g, self.g_params,
                                              tv * float(max(self.g_interval, 1)), "greg")

    def dreg(self, b, sigma, size):
        res = self.g.neural_res
        img = b["real"].detach().requires_grad_(True)
        raw = interpolate_bilinear(b["real"], res, res, antialias=True).detach()
        raw.requires_grad_(True)
        logits = self._d(img, raw, b["c"], sigma, size)
        g_img, g_raw = torch.autograd.grad(logits.sum(), [img, raw], create_graph=True)
        r1 = g_img.square().sum(dim=(1, 2, 3)) + g_raw.square().sum(dim=(1, 2, 3))
        loss = (r1 * (self.r1_gamma / 2)).mean()
        return float(loss.detach()), self._adam(self.opt_d, self.d_params,
                                                loss * float(max(self.d_interval, 1)), "dreg")

    # -- the loop's step ----------------------------------------------------

    def __call__(self, host: dict, seed: int, device, count=None, teacher=None) -> dict:
        """One loop step on a collated host batch at self.cur_nimg. Returns
        {phase: (loss, grads)} of the phases run. `count(fn, *args)`, when
        given, runs each phase (it counts its operations). `teacher`, when
        given, is called around each phase, "finish" (G_ema and the clock)
        included: `before(phase)` may set the modules' and optimizers'
        state, `gradient(phase, grads)` gives the gradient the optimizer
        steps with, `after(phase, out)` reads the result."""
        run = count or (lambda fn, *a: fn(*a))
        self.teacher = teacher

        def phase(name, fn, *args):
            if teacher:
                teacher.before(name)
            out = run(fn, *args) if name != "finish" else fn(*args)
            if teacher:
                teacher.after(name, out)
            return out

        kz, ks = tf.split(step_key(seed, self.cur_nimg))
        c = torch.as_tensor(host["loss_c"]).float().to(device)
        real = torch.as_tensor(host["loss_image"]).to(device).float() / 127.5 - 1.0
        z = tf.normal(tf.fold_in(kz, 0), (self.batch, self.z_dim), device)
        b = {"z": z, "c": c, "real": real}
        sigma = blur_sigma(self.cur_nimg, self.blur_init_sigma, self.blur_fade_kimg)
        size = int(math.floor(sigma * 3))
        sigma = max(sigma, 1e-8)
        sched_idx = self.cur_nimg // self.batch
        k_g, k_d = tf.split(ks)
        out = {"gmain": phase("gmain", self.gmain, b, k_g, sigma, size),
               "dmain": phase("dmain", self.dmain, b, k_d, sigma, size)}
        phase("finish", self.finish)
        if self.density_reg > 0 and sched_idx % max(self.g_interval, 1) == 0:
            out["greg"] = phase("greg", self.greg, b, tf.fold_in(ks, 1))
        if self.r1_gamma > 0 and sched_idx % max(self.d_interval, 1) == 0:
            out["dreg"] = phase("dreg", self.dreg, b, sigma, size)
        self.teacher = None
        return out
