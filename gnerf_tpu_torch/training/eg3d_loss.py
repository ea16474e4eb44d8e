"""The EG3D GAN objective: dual discrimination, R1, density regularization
and pose-swapped conditioning, fused or with lazy regularization.

Port of `gnerf_tpu/training/eg3d_loss.py` (without the chained relay
cycles). It adversarially trains all of the tri-plane generator G against a
dual discriminator D: the stage that produces the generator G-NeRF
fine-tunes. Under `aug='ada'` or `'fixed'` every D call sees its input
through the bgc ADA pipe (`training/augment.py`), R1 included.

  G loss  = softplus(-D(G(z, c'))).mean()            c' = c rolled by one
                                                      with prob. swapping_prob
  Greg    = L1 between sigma at random points and at points nudged by
            N(0, density_reg_p_dist), times density_reg
  D loss  = softplus(D(fake)) + softplus(-D(real))
  Dreg    = (r1_gamma / 2) * (|dD/dimage|^2 + |dD/dimage_raw|^2), through
            the blur and the raw image's resize inside D

`make_eg3d_train_step` is the fused form (every term every step);
`make_eg3d_phase_steps` the lazy one (Gmain + Dmain every step, Greg every
`g_reg_interval`, Dreg every `d_reg_interval` steps, each with gain = its
interval and Adam's lr and betas scaled by interval / (interval + 1)). The
steps mutate the modules and optimizers of an `EG3DState` in place. Each
loss is differentiated with `torch.autograd.grad` with respect to its own
trainable set; the D phase regenerates its fakes from the updated G under
`torch.no_grad()`.

Every random draw of a step (the swap, style mixing, synthesis noise, the
render's jitter and importance samples, the density points, each D call's
augmentation) comes from the step's key (`utils.prng`, kept on the CPU),
split in the JAX package's order, so a key gives JAX's draws. `rng=None`
gives constant noise and deterministic sampling; it is meant for steps
whose remaining draws do not matter (no pose swap or a certain one, no
style mixing, no augmentation), and draws those from fixed keys.

Given a `parallel.Mesh`, each step is the JAX package's global-batch step:
each rank holds its rows of the batch, every draw is its part of the
world-1 draw for the global batch (`parallel.draw`), the pose swap rolls
the global batch, D's minibatch-std groups and the w_avg update see the
global batch, the gradients are averaged over every rank before Adam, the
stats are global means and cur_nimg counts the global batch.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.dual_discriminator import DualDiscriminator
from ..models.triplane import TriPlaneGenerator
from ..ops.interpolate import interpolate_bilinear
from ..ops.upfirdn2d import filter2d
from ..parallel.collectives import pmean_grads
from ..parallel.mesh import Mesh, active_mesh, use_mesh
from ..parallel.sharding import data_mean, draw, global_rows, local_rows, mean_stats
from ..utils import prng
from ..utils.misc import ema_update
from ..utils.profiling import profiled_function, span
from .train_loop import checkpointed, ray_overrides

@dataclasses.dataclass(frozen=True)
class EG3DLossConfig:
    """The JAX package's fields and defaults. `aug_cell_pack` is a TPU
    memory layout with no meaning here, kept so stored configs load.
    `aug`: 'noaug', 'ada' (the bgc pipe with the r_t-feedback controller
    `ada_update_p`, driven by the training loop from `aug_p`) or 'fixed'
    (the pipe at the constant p = `aug_p`)."""

    r1_gamma: float = 1.0
    blur_init_sigma: float = 0.0
    blur_fade_kimg: float = 0.0
    gpc_reg_prob: Optional[float] = 0.5
    gpc_reg_fade_kimg: float = 1000.0
    density_reg: float = 0.25
    density_reg_p_dist: float = 0.004
    density_reg_points: int = 1000
    neural_rendering_resolution: int = 64
    neural_rendering_resolution_final: Optional[int] = None
    neural_rendering_resolution_fade_kimg: float = 1000.0
    res_bucket: int = 8
    style_mixing_prob: float = 0.0
    r1_gamma_init: float = 0.0
    r1_gamma_fade_kimg: float = 0.0
    dual_discrimination: bool = True
    filter_mode: Any = "antialiased"
    glr: float = 0.0025
    dlr: float = 0.002
    aug: str = "noaug"
    aug_p: float = 0.0
    ada_target: float = 0.6
    ada_interval: int = 4
    ada_kimg: float = 500.0
    freeze_d_layers: int = 0
    g_reg_interval: int = 4
    d_reg_interval: int = 16
    # Compute dtype of G's synthesis and both D stacks; losses, R1 and the
    # optimizers stay fp32.
    dtype: Any = torch.float32
    aug_cell_pack: bool = True
    # Recompute G's synthesis in the backward pass instead of keeping its
    # activations. Off: the full-width fp32 step at batch 4 fits an 80 GB
    # H100 without it, and recomputing costs time (PERF.md, the eg3d cell).
    remat_synthesis: bool = False


@dataclasses.dataclass
class EG3DState:
    """Everything one EG3D run updates. `g_ema` is a frozen copy of `g`;
    `opt_g` steps all of G, `opt_d` D's trainable (not frozen) weights."""

    g: TriPlaneGenerator
    g_ema: TriPlaneGenerator
    disc: DualDiscriminator
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    cur_nimg: int = 0


# The 'bgc' augmentation preset (blit + geometric + colour): the standard
# StyleGAN2-ADA recipe EG3D-class face GANs train with.
BGC_SPEC = dict(xflip=1.0, rotate90=1.0, xint=1.0, scale=1.0, rotate=1.0,
                aniso=1.0, xfrac=1.0, brightness=1.0, contrast=1.0,
                lumaflip=1.0, hue=1.0, saturation=1.0)


def make_augment_pipe(cfg: EG3DLossConfig):
    """The AugmentPipe of the configured mode (bgc, static margin 0.55 of
    the image, as the JAX package pads), or None for 'noaug'."""
    if cfg.aug == "noaug":
        return None
    from .augment import AugmentPipe

    return AugmentPipe(**BGC_SPEC, pad_fraction=0.55, warp_cell_pack=cfg.aug_cell_pack)


def ada_update_p(p: float, rt: float, batch_size: int, cfg: EG3DLossConfig) -> float:
    """One step of the r_t-feedback controller: nudge p toward keeping
    E[sign(D(real))] at ada_target, a full 0 -> 1 sweep taking ada_kimg
    kimg. Called every ada_interval batches with the interval's mean of the
    'Loss/signs/real' stat."""
    adjust = np.sign(rt - cfg.ada_target) * (
        batch_size * cfg.ada_interval / (cfg.ada_kimg * 1000.0))
    return float(np.clip(p + adjust, 0.0, 1.0))


class AdaController:
    """The ADA strength p of a run: under aug='ada' every `ada_interval`
    reported 'Loss/signs/real' values are averaged and p moves by
    `ada_update_p`; under 'fixed' (and 'noaug') p stays where it started."""

    def __init__(self, cfg: EG3DLossConfig, batch_size: int, p: float):
        self.cfg, self.batch_size, self.p = cfg, batch_size, float(p)
        self._window: list = []

    def report(self, signs_real: torch.Tensor) -> float:
        """Record one step's 'Loss/signs/real' (a step under a mesh returns
        it as the mean over the global batch); returns the p for the next."""
        if self.cfg.aug == "ada":
            self._window.append(signs_real)
            if len(self._window) == self.cfg.ada_interval:
                rt = float(torch.stack(self._window).mean())
                self.p = ada_update_p(self.p, rt, self.batch_size, self.cfg)
                self._window.clear()
        return self.p


# ---------------------------------------------------------------------------
# Host schedules


def blur_sigma_schedule(cur_nimg: float, cfg: EG3DLossConfig) -> float:
    """The blur on D's input fades from blur_init_sigma to 0 over blur_fade_kimg."""
    if cfg.blur_fade_kimg <= 0 or cfg.blur_init_sigma <= 0:
        return 0.0
    return max(1 - cur_nimg / (cfg.blur_fade_kimg * 1e3), 0.0) * cfg.blur_init_sigma


def blur_kernel_size(blur_sigma: float) -> int:
    """FIR half-extent for a given sigma."""
    return int(np.floor(float(blur_sigma) * 3))


def neural_resolution_schedule(cur_nimg: float, cfg: EG3DLossConfig) -> int:
    """Render resolution: a linear blend from the initial to the final one
    over fade_kimg, rounded to `res_bucket` multiples (the endpoints exact)."""
    initial = cfg.neural_rendering_resolution
    final = cfg.neural_rendering_resolution_final
    if final is None or final == initial:
        return initial
    fade = max(cfg.neural_rendering_resolution_fade_kimg, 1e-8) * 1e3
    alpha = min(float(cur_nimg) / fade, 1.0)
    if alpha >= 1.0:
        return int(final)
    res = int(np.rint(initial * (1 - alpha) + final * alpha))
    b = max(int(cfg.res_bucket), 1)
    res = int(np.rint(res / b)) * b
    lo, hi = min(initial, final), max(initial, final)
    return int(np.clip(res, lo, hi))


def r1_gamma_schedule(cur_nimg: float, cfg: EG3DLossConfig) -> float:
    """R1 gamma warm-up: r1_gamma_init -> r1_gamma over r1_gamma_fade_kimg."""
    if cfg.r1_gamma_fade_kimg <= 0:
        return cfg.r1_gamma
    alpha = min(cur_nimg / (cfg.r1_gamma_fade_kimg * 1e3), 1.0)
    return cfg.r1_gamma_init * (1 - alpha) + cfg.r1_gamma * alpha


def swapping_prob_schedule(cur_nimg: float, cfg: EG3DLossConfig) -> Optional[float]:
    """Probability of the pose swap: 1 -> gpc_reg_prob over gpc_reg_fade_kimg
    (None: G is conditioned on zeros)."""
    if cfg.gpc_reg_prob is None:
        return None
    alpha = min(cur_nimg / max(cfg.gpc_reg_fade_kimg * 1e3, 1e-8), 1.0)
    return (1 - alpha) * 1.0 + alpha * cfg.gpc_reg_prob


# ---------------------------------------------------------------------------
# Pieces of the loss


def swapped_conditioning(rng: torch.Tensor, c: torch.Tensor,
                         swapping_prob: Optional[float]) -> torch.Tensor:
    """G's conditioning: each label replaced by its batch neighbour's
    (a roll by one over the global batch) with probability `swapping_prob`;
    None -> zeros."""
    if swapping_prob is None:
        return torch.zeros_like(c)
    pick = draw(prng.uniform, rng, (c.shape[0], 1), device=c.device) < _f32(swapping_prob)
    return torch.where(pick, local_rows(torch.roll(global_rows(c), 1, dims=0)), c)


def _f32(x: float) -> float:
    """x rounded to float32, as the JAX package holds its traced scalars."""
    return float(np.float32(x))


def apply_style_mixing(mapping: Callable, ws: torch.Tensor, z_dim: int, c_cond: torch.Tensor,
                       rng: torch.Tensor, prob: float) -> torch.Tensor:
    """With probability `prob`, ws[:, cutoff:] becomes the mapping of a fresh
    z, at one cutoff for the batch drawn uniformly from [1, num_ws). Index 0
    is never mixed. `rng` splits into the cutoff's, the coin's and z's keys;
    the draws stay on the device (no host round trip)."""
    if prob <= 0:
        return ws
    num_ws, dev = ws.shape[1], ws.device
    k_cut, k_apply, k_z = prng.split(rng, 3)
    cutoff = prng.randint(k_cut, (), 1, num_ws, device=dev)
    cutoff = torch.where(prng.uniform(k_apply, (), device=dev) < prob, cutoff, num_ws)
    z2 = draw(prng.normal, k_z, (ws.shape[0], z_dim), device=dev).to(ws.dtype)
    keep = torch.arange(num_ws, device=dev)[None, :, None] < cutoff
    return torch.where(keep, ws, mapping(z2, c_cond))


def blur_image(img: torch.Tensor, blur_sigma: float, blur_size: int) -> torch.Tensor:
    """Blur with the 2^-x^2 taps over [-blur_size, blur_size] / blur_sigma."""
    if blur_size <= 0:
        return img
    x = torch.arange(-blur_size, blur_size + 1, device=img.device, dtype=torch.float32)
    f = torch.exp2(-(x / blur_sigma).square())
    return filter2d(img, f / f.sum())


def density_reg_points(n: int, cfg: EG3DLossConfig, rng: torch.Tensor,
                       device) -> tuple[torch.Tensor, torch.Tensor]:
    """The density regularizer's draws: (coordinates [n, 2P, 3], directions):
    P uniform points in [-1, 1]^3, then the same points nudged by
    N(0, density_reg_p_dist); directions are standard normal. `rng` splits
    in three, one key each."""
    k1, k2, k3 = prng.split(rng, 3)
    p = cfg.density_reg_points
    initial = draw(prng.uniform, k1, (n, p, 3), device=device) * 2 - 1
    perturbed = initial + draw(prng.normal, k2, initial.shape,
                               device=device) * cfg.density_reg_p_dist
    coords = torch.cat([initial, perturbed], dim=1)
    return coords, draw(prng.normal, k3, coords.shape, device=device)


def density_tv(g: TriPlaneGenerator, ws: torch.Tensor, coords: torch.Tensor,
               dirs: torch.Tensor, cfg: EG3DLossConfig) -> torch.Tensor:
    """L1 between sigma at the first and the second half of `coords`, times
    density_reg."""
    sigma = g.sample_mixed(coords, dirs, ws, dtype=cfg.dtype)["sigma"].float()
    p = coords.shape[1] // 2
    return (sigma[:, :p] - sigma[:, p:]).abs().mean() * cfg.density_reg


def density_regularization(g: TriPlaneGenerator, ws: torch.Tensor,
                           rng: torch.Tensor, cfg: EG3DLossConfig) -> torch.Tensor:
    coords, dirs = density_reg_points(ws.shape[0], cfg, rng, ws.device)
    return density_tv(g, ws, coords, dirs, cfg)


def freeze_d_trainable_mask(disc, freeze_layers: int) -> dict[str, bool]:
    """Freeze-D: {parameter path: trainable}. D's conv layers count in
    forward order, per block from the highest resolution: fromrgb (where
    present), conv0, conv1, skip; the first `freeze_layers` are frozen. The
    epilogue and the mapping never are."""
    frozen = set()
    idx = 0
    for res in disc.block_resolutions:
        block = getattr(disc, f"b{res}")
        for name in ("fromrgb", "conv0", "conv1", "skip"):
            if hasattr(block, name):
                if idx < freeze_layers:
                    frozen.add(f"b{res}.{name}.")
                idx += 1
    return {n.replace(".", "/"): not any(n.startswith(f) for f in frozen)
            for n, _ in disc.named_parameters()}


def _make_adam(params, lr: float, reg_interval: int = 0) -> torch.optim.Adam:
    """Adam(betas (0, 0.99), eps 1e-8); for lazy regularization
    (reg_interval > 1) lr and both betas scaled by interval / (interval + 1)."""
    b1, b2 = 0.0, 0.99
    if reg_interval and reg_interval > 1:
        mb = reg_interval / (reg_interval + 1)
        lr = lr * mb
        b1, b2 = b1 ** mb, b2 ** mb
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)


def init_eg3d_state(g: TriPlaneGenerator, disc: DualDiscriminator, cfg: EG3DLossConfig,
                    lazy: bool = True) -> EG3DState:
    """An EG3DState around freshly built modules: G_ema a frozen copy of G,
    all of G trainable, D's first `freeze_d_layers` conv layers frozen
    (`requires_grad_(False)`, out of the optimizer: they never move, while
    R1's input gradient still flows through them). `lazy` picks the Adam
    scaling of `make_eg3d_phase_steps` (else `make_eg3d_train_step`'s). The
    JAX `init_eg3d_state(..., rng)` draws G and D from split(rng);
    `train.eg3d_networks` builds the modules from those keys."""
    g.requires_grad_(True)
    disc.requires_grad_(True)
    if cfg.freeze_d_layers > 0:
        mask = freeze_d_trainable_mask(disc, cfg.freeze_d_layers)
        for name, p in disc.named_parameters():
            p.requires_grad_(mask[name.replace(".", "/")])
    g_ema = copy.deepcopy(g).requires_grad_(False).eval()
    g_int = cfg.g_reg_interval if lazy and cfg.density_reg > 0 else 0
    d_int = cfg.d_reg_interval if lazy and cfg.r1_gamma > 0 else 0
    opt_g = _make_adam(list(g.parameters()), cfg.glr, g_int)
    opt_d = _make_adam([p for p in disc.parameters() if p.requires_grad], cfg.dlr, d_int)
    return EG3DState(g=g, g_ema=g_ema, disc=disc, opt_g=opt_g, opt_d=opt_d)


# ---------------------------------------------------------------------------
# Steps


def _opt_params(opt: torch.optim.Adam) -> list:
    return [p for grp in opt.param_groups for p in grp["params"]]


def _adam_step(opt: torch.optim.Adam, loss: torch.Tensor) -> None:
    """One Adam step on d(loss)/d(the optimizer's parameters), averaged over
    the ranks of the active mesh. A parameter the loss does not reach gets
    a zero gradient, as in optax: its second moment decays and its step
    count advances with the others'."""
    params = _opt_params(opt)
    grads = torch.autograd.grad(loss, params, materialize_grads=True)
    mesh = active_mesh()
    grads = pmean_grads(grads, mesh.group if mesh is not None else None)
    with span("eg3d.optimizer"):
        for p, gr in zip(params, grads):
            p.grad = gr
        opt.step()
        opt.zero_grad(set_to_none=True)


@torch.no_grad()
def _update_w_avg(g: TriPlaneGenerator, w_batch: torch.Tensor) -> None:
    """The mapping's w_avg EMA (beta 0.998) over the global batch's ws[:, 0]."""
    w_avg = getattr(g.backbone.mapping, "w_avg", None)
    if w_avg is not None:
        batch_mean = data_mean(w_batch.mean(dim=0))
        w_avg.copy_(batch_mean + (w_avg - batch_mean) * 0.998)


def _finish_main(state: EG3DState, n: int) -> None:
    """G_ema tracks G with beta 0.5^(batch / 10k); the clock advances. `n`
    is this rank's rows; the batch is the global one."""
    mesh = active_mesh()
    n *= mesh.data if mesh is not None else 1
    with span("eg3d.ema"):
        ema_update(state.g_ema.state_dict(), state.g.state_dict(), 0.5 ** (n / (10 * 1000.0)))
    state.cur_nimg += n


# The key of a step called with rng=None: its swap, style mixing, density
# points and augmentation draw from it, while G's synthesis gets no key.
_NO_KEY = prng.PRNGKey(0)


def _make_runners(cfg: EG3DLossConfig, rendering_overrides: Optional[dict] = None):
    """The G and D forwards the steps compose from."""
    pipe = make_augment_pipe(cfg)

    def run_g(g: TriPlaneGenerator, z, c, rng, cur_nimg, res, noise: bool = True):
        """G's images and ws; `rng` splits into the swap's, the style
        mixing's and the synthesis's keys. `noise` False: constant noise and
        deterministic sampling."""
        k_swap, k_mix, k_noise = prng.split(rng, 3)
        c_cond = swapped_conditioning(k_swap, c, swapping_prob_schedule(cur_nimg, cfg))
        mapping = g.backbone.mapping
        ws = mapping(z, c_cond)
        ws = apply_style_mixing(mapping, ws, g.z_dim, c_cond, k_mix, cfg.style_mixing_prob)
        noise_mode, k_noise = ("random", k_noise) if noise else ("const", None)

        def synth(ws_, c_):
            out = g.synthesis(ws_, c_, neural_rendering_resolution=res, noise_mode=noise_mode,
                              rng=k_noise, dtype=cfg.dtype,
                              rendering_kwargs=rendering_overrides)
            return out["image"], out["image_raw"]

        if cfg.remat_synthesis and torch.is_grad_enabled():
            image, image_raw = checkpointed(synth, ws, c)
        else:
            image, image_raw = synth(ws, c)
        # D and the losses take fp32 whatever the synthesis dtype.
        return {"image": image.float(), "image_raw": image_raw.float()}, ws

    def run_d(disc, img, c, rng, blur_sigma=0.0, blur_size: int = 0, aug_p: float = 0.0):
        """D's logits, after the blur and, with a pipe, the augmentation at
        strength `aug_p` from the key `rng`: the raw image upsampled to full
        size, both augmented by the same per-sample transform as one
        6-channel batch in cfg.dtype, the raw half resized back to its own
        size."""
        if blur_size > 0:
            img = dict(img, image=blur_image(img["image"], blur_sigma, blur_size))
        if pipe is not None:
            full, res = img["image"].shape[-1], img["image_raw"].shape[-1]
            raw_up = interpolate_bilinear(img["image_raw"], full, full, antialias=True)
            pair = torch.cat([img["image"], raw_up], dim=1).to(cfg.dtype)
            pair = pipe(rng, pair, p=aug_p)
            img = {"image": pair[:, :3],
                   "image_raw": interpolate_bilinear(pair[:, 3:], res, res, antialias=True)}
        return disc.apply(img, c, dtype=cfg.dtype)

    return run_g, run_d


def _r1(run_d, disc, real_img, real_raw, real_c, blur_sigma, blur_size, cur_nimg, cfg,
        k_aug: Optional[torch.Tensor] = None, aug_p: float = 0.0):
    """Mean (gamma / 2) * R1 through both D inputs, taken at the pre-blur,
    pre-augmentation image and the raw image, with a graph for D's weight
    gradient; the augmentation draws from `k_aug` (needed with a pipe)."""
    img = real_img.detach().requires_grad_(True)
    raw = real_raw.detach().requires_grad_(True)
    logits = run_d(disc, {"image": img, "image_raw": raw}, real_c, k_aug, blur_sigma, blur_size,
                   aug_p)
    g_img, g_raw = torch.autograd.grad(logits.sum(), [img, raw], create_graph=True)
    r1 = g_img.square().sum(dim=(1, 2, 3)) + g_raw.square().sum(dim=(1, 2, 3))
    return (r1 * (r1_gamma_schedule(cur_nimg, cfg) / 2)).mean()


def _d_main(run_g, run_d, state, batch, keys, noise, blur_sigma, blur_size, res, aug_p=0.0):
    """D's logistic loss on fakes regenerated from the (updated) G without
    a graph, and on the reals: (loss, the reals' raw image, stats). `keys`:
    G's, and the augmentation's on the fakes and on the reals."""
    k_gen, k_aug_f, k_aug_r = keys
    with torch.no_grad():
        gen_img, _ = run_g(state.g, batch["z"], batch["c"], k_gen, state.cur_nimg, res, noise)
    gen_logits = run_d(state.disc, gen_img, batch["c"], k_aug_f, blur_sigma, blur_size, aug_p)
    real_img = batch["real_image"]
    real_raw = interpolate_bilinear(real_img, res, res, antialias=True)
    real_logits = run_d(state.disc, {"image": real_img, "image_raw": real_raw},
                        batch["real_c"], k_aug_r, blur_sigma, blur_size, aug_p)
    loss = F.softplus(gen_logits).mean() + F.softplus(-real_logits).mean()
    stats = {"Loss/D/loss": loss.detach(), "Loss/scores/real": real_logits.mean().detach(),
             "Loss/signs/real": torch.sign(real_logits).mean().detach()}
    return loss, real_raw, stats


def _g_main(run_g, run_d, state, batch, k_g, k_aug, noise, blur_sigma, blur_size, res,
            aug_p=0.0):
    """G's non-saturating loss: (loss, ws, stats)."""
    gen_img, ws = run_g(state.g, batch["z"], batch["c"], k_g, state.cur_nimg, res, noise)
    gen_logits = run_d(state.disc, gen_img, batch["c"], k_aug, blur_sigma, blur_size, aug_p)
    loss = F.softplus(-gen_logits).mean()
    stats = {"Loss/G/gan_loss": loss.detach(), "Loss/scores/fake": gen_logits.mean().detach()}
    return loss, ws, stats


def _on_mesh(step: Callable, mesh: Optional[Mesh]) -> Callable:
    """`step` run under `mesh`, its stats averaged over the mesh's ranks."""
    if step is None:
        return None

    def run(*args, **kwargs):
        with use_mesh(mesh):
            state, stats = step(*args, **kwargs)
            return state, mean_stats(stats, mesh)

    return run


@profiled_function("eg3d.gmain")
def gmain_phase(run_g, run_d, state: EG3DState, batch, k_g, noise, blur_sigma, blur_size, res,
                aug_p=0.0):
    """Gmain of the lazy step: G's loss on fresh fakes, one Adam step of G
    and the w_avg update; `k_g` splits into G's and the augmentation's
    keys. Returns (the loss, stats)."""
    k_gen, k_aug = prng.split(k_g)
    loss_g, ws, stats = _g_main(run_g, run_d, state, batch, k_gen, k_aug, noise, blur_sigma,
                                blur_size, res, aug_p)
    _adam_step(state.opt_g, loss_g)
    _update_w_avg(state.g, ws[:, 0].detach())
    return loss_g.detach(), stats


@profiled_function("eg3d.dmain")
def dmain_phase(run_g, run_d, state: EG3DState, batch, k_d, noise, blur_sigma, blur_size, res,
                aug_p=0.0):
    """Dmain of the lazy step: D's loss on fakes of the updated G and on the
    reals, and one Adam step of D; `k_d` splits into G's and the fakes' and
    the reals' augmentation keys. Returns (the loss, stats)."""
    loss_d, _, stats = _d_main(run_g, run_d, state, batch, prng.split(k_d, 3), noise,
                               blur_sigma, blur_size, res, aug_p)
    _adam_step(state.opt_d, loss_d)
    return loss_d.detach(), stats


def make_eg3d_train_step(cfg: EG3DLossConfig, rendering_overrides: Optional[dict] = None,
                         mesh: Optional[Mesh] = None) -> Callable:
    """The fused step (density reg and R1 in every step, no lazy scaling):
    `train_step(state, batch, rng=None, blur_sigma=0.0, aug_p=0.0, *,
    blur_size=0, res=None) -> (state, stats)`.

    `batch`: {'z': [N, z_dim], 'c': [N, 25], 'real_image': [N, 3, R, R] in
    [-1, 1], 'real_c': [N, 25]} on G's device. `blur_sigma` and `blur_size`
    come from `blur_sigma_schedule` / `blur_kernel_size`, `aug_p` is the
    augmentation strength (unused under aug='noaug'), `res` comes from
    `neural_resolution_schedule` (None: the initial resolution). State from
    `init_eg3d_state(..., lazy=False)`. `rng` is the step's key, split as
    the JAX step splits it (G's side into G, the density points and the
    augmentation; D's into G, the fakes', the reals' and R1's
    augmentation). Under `mesh` the batch holds this rank's rows of the
    global batch and every rank passes the same key."""
    run_g, run_d = _make_runners(cfg, ray_overrides(rendering_overrides, mesh))

    def train_step(state: EG3DState, batch, rng: Optional[torch.Tensor] = None,
                   blur_sigma: float = 0.0, aug_p: float = 0.0, *, blur_size: int = 0,
                   res: Optional[int] = None):
        res = res or cfg.neural_rendering_resolution
        noise = rng is not None
        k_g, k_d = prng.split(rng if noise else _NO_KEY)
        k_gen, k_reg, k_aug = prng.split(k_g, 3)
        k_gen_d, k_aug_f, k_aug_r, k_aug_r1 = prng.split(k_d, 4)
        loss_g, ws, stats = _g_main(run_g, run_d, state, batch, k_gen, k_aug, noise, blur_sigma,
                                    blur_size, res, aug_p)
        if cfg.density_reg > 0:
            tv = density_regularization(state.g, ws, k_reg, cfg)
            loss_g = loss_g + tv
            stats["Loss/G/density_reg"] = tv.detach()
        _adam_step(state.opt_g, loss_g)
        _update_w_avg(state.g, ws[:, 0].detach())
        del ws

        loss_d, real_raw, d_stats = _d_main(run_g, run_d, state, batch,
                                            (k_gen_d, k_aug_f, k_aug_r), noise, blur_sigma,
                                            blur_size, res, aug_p)
        loss_dr1 = _r1(run_d, state.disc, batch["real_image"], real_raw, batch["real_c"],
                       blur_sigma, blur_size, state.cur_nimg, cfg, k_aug_r1, aug_p)
        d_stats["Loss/D/reg"] = loss_dr1.detach()
        loss_d = loss_d + loss_dr1
        _adam_step(state.opt_d, loss_d)
        _finish_main(state, int(batch["z"].shape[0]))
        stats.update(d_stats)
        stats["Loss/G/total"] = loss_g.detach()
        stats["Loss/D/total"] = loss_d.detach()
        return state, stats

    return _on_mesh(train_step, mesh)


def make_eg3d_phase_steps(cfg: EG3DLossConfig, rendering_overrides: Optional[dict] = None,
                          mesh: Optional[Mesh] = None
                          ) -> tuple[Callable, Optional[Callable], Optional[Callable]]:
    """Lazy regularization: (main_step, greg_step, dreg_step), the last two
    None when density_reg or r1_gamma is 0. State from
    `init_eg3d_state(..., lazy=True)`; only main_step advances cur_nimg and
    the EMAs.

      main_step(state, batch, rng=None, blur_sigma=0.0, aug_p=0.0, *, blur_size=0, res=None)
      greg_step(state, batch, rng=None)
      dreg_step(state, batch, rng=None, blur_sigma=0.0, aug_p=0.0, *, blur_size=0, res=None)

    The keys split as the JAX phases split them: main into G's side (G and
    the augmentation) and D's (G, the fakes' and the reals' augmentation);
    Greg into the swap's and the density points'; Dreg's key is R1's
    augmentation. The CLI gives Greg fold_in(key, 1) and Dreg fold_in(key, 2)
    of the step's key. `mesh` as for `make_eg3d_train_step`.
    """
    run_g, run_d = _make_runners(cfg, ray_overrides(rendering_overrides, mesh))

    def main_step(state: EG3DState, batch, rng: Optional[torch.Tensor] = None,
                  blur_sigma: float = 0.0, aug_p: float = 0.0, *, blur_size: int = 0,
                  res: Optional[int] = None):
        res = res or cfg.neural_rendering_resolution
        noise = rng is not None
        k_g, k_d = prng.split(rng if noise else _NO_KEY)
        loss_g, stats = gmain_phase(run_g, run_d, state, batch, k_g, noise, blur_sigma,
                                    blur_size, res, aug_p)
        loss_d, d_stats = dmain_phase(run_g, run_d, state, batch, k_d, noise, blur_sigma,
                                      blur_size, res, aug_p)
        _finish_main(state, int(batch["z"].shape[0]))
        stats.update(d_stats)
        stats["Loss/G/total"] = loss_g
        stats["Loss/D/total"] = loss_d
        return state, stats

    greg_step = dreg_step = None
    if cfg.density_reg > 0:
        gain_g = float(max(cfg.g_reg_interval, 1))

        @profiled_function("eg3d.greg")
        def greg_step(state: EG3DState, batch, rng: Optional[torch.Tensor] = None):
            """Fresh mapping under the swapped conditioning, no synthesis:
            the density TV at random points, times the lazy gain."""
            k_swap, k_reg = prng.split(_NO_KEY if rng is None else rng)
            c_cond = swapped_conditioning(k_swap, batch["c"],
                                          swapping_prob_schedule(state.cur_nimg, cfg))
            ws = state.g.backbone.mapping(batch["z"], c_cond)
            tv = density_regularization(state.g, ws, k_reg, cfg)
            _adam_step(state.opt_g, tv * gain_g)
            return state, {"Loss/G/density_reg": tv.detach()}

    if cfg.r1_gamma > 0:
        gain_d = float(max(cfg.d_reg_interval, 1))

        @profiled_function("eg3d.dreg")
        def dreg_step(state: EG3DState, batch, rng: Optional[torch.Tensor] = None,
                      blur_sigma: float = 0.0, aug_p: float = 0.0, *, blur_size: int = 0,
                      res: Optional[int] = None):
            """R1 through both dual-discrimination inputs (and the pipe),
            times the lazy gain."""
            res = res or cfg.neural_rendering_resolution
            real_raw = interpolate_bilinear(batch["real_image"], res, res, antialias=True)
            loss = _r1(run_d, state.disc, batch["real_image"], real_raw, batch["real_c"],
                       blur_sigma, blur_size, state.cur_nimg, cfg,
                       _NO_KEY if rng is None else rng, aug_p)
            _adam_step(state.opt_d, loss * gain_d)
            return state, {"Loss/D/reg": loss.detach()}

    return _on_mesh(main_step, mesh), _on_mesh(greg_step, mesh), _on_mesh(dreg_step, mesh)
