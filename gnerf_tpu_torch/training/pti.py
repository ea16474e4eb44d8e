"""Pivotal Tuning Inversion (PTI): per-identity generator fine-tuning.

Port of `gnerf_tpu/training/pti.py`. The superresolution module is frozen
(`requires_grad_(False)`, out of Adam) and the rest of G is tuned against an
LPIPS (+ optional L1) reconstruction of the target image(s) at a fixed pivot
latent, optionally with the "ball holder" locality regularizer that keeps
the tuned G close to the original one near the pivot. The pivot comes from
the identity encoder (the G-NeRF way), from the caller's ws, or from
`project_w`, a w-space projector (Adam with the StyleGAN2 projector's lr and
noise schedule). Single- and multi-image coaching are the shape of the batch.

Draws (the locality regularizer's z, the projector's w_avg samples and
noise) come from threefry keys (`utils.prng`) split as the JAX package
splits them, so a seed gives JAX's draws.

    python -m gnerf_tpu_torch.training.pti --network snap.npz --outdir runs/pti \\
        [--pivot encoder|project] [--align_lm LANDMARKS] [--device cpu]
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional

import torch

from ..models.triplane import TriPlaneGenerator
from ..utils import prng
from . import losses as L


@dataclasses.dataclass(frozen=True)
class PTIConfig:
    lr: float = 3e-4
    l1_lambda: float = 0.0
    lpips_lambda: float = 1.0
    # Ball-holder locality regularizer.
    use_locality_reg: bool = False
    regulizer_alpha: float = 30.0
    regulizer_l2_lambda: float = 0.1
    regulizer_lpips_lambda: float = 0.1
    latent_ball_num_of_samples: int = 1
    locality_truncation: float = 0.5
    neural_rendering_resolution: int = 64


@dataclasses.dataclass
class PTIState:
    """`g` is tuned in place by Adam (`opt`, every parameter but the SR
    module's); `g_original` is the frozen G it started from."""

    g: TriPlaneGenerator
    g_original: TriPlaneGenerator
    vgg: L.VGG16LPIPS
    opt: torch.optim.Adam


def morphed_w_code(new_w: torch.Tensor, fixed_w: torch.Tensor, alpha: float) -> torch.Tensor:
    """Move alpha units from the pivot toward a sampled latent (the norm is
    over the whole difference)."""
    direction = new_w - fixed_w
    return fixed_w + alpha * direction / (torch.linalg.norm(direction) + 1e-8)


def init_pti_state(g: TriPlaneGenerator, vgg: L.VGG16LPIPS, cfg: PTIConfig) -> PTIState:
    """A tuned copy of `g` (SR frozen) with Adam(lr, betas (0.9, 0.999),
    eps 1e-8) over the rest; `g` itself is kept as the original, unchanged."""
    tuned = copy.deepcopy(g).requires_grad_(True)
    tuned.superresolution.requires_grad_(False)
    opt = torch.optim.Adam([p for p in tuned.parameters() if p.requires_grad], lr=cfg.lr,
                           betas=(0.9, 0.999), eps=1e-8)
    return PTIState(g=tuned, g_original=g, vgg=vgg, opt=opt)


def make_pti_step(cfg: PTIConfig):
    """Returns `pti_step(state, batch, rng) -> (state, stats)`.

    batch: {ws [N, num_ws, w], loss_image [-1, 1] [N, 3, R, R], loss_c [N, 25]}.
    `rng` is the step's threefry key; the locality regularizer's z
    [samples, z_dim] is drawn from its second half, as in JAX."""
    res = cfg.neural_rendering_resolution

    def pti_step(state: PTIState, batch, rng: torch.Tensor):
        g, vgg = state.g, state.vgg
        synth = g.synthesis(batch["ws"], batch["loss_c"], neural_rendering_resolution=res,
                            noise_mode="none")["image"]
        real = batch["loss_image"]
        lp = L.lpips_training_distance(vgg, real, synth).mean()
        loss = cfg.lpips_lambda * lp
        stats = {"Loss/pti/lpips": lp.detach()}
        if cfg.l1_lambda > 0:
            l1 = (real - synth).abs().mean()
            loss = loss + cfg.l1_lambda * l1
            stats["Loss/pti/l1"] = l1.detach()

        if cfg.use_locality_reg:
            n = cfg.latent_ball_num_of_samples
            z = prng.normal(prng.split(rng.to(real.device))[1], (n, g.z_dim))
            orig = state.g_original
            with torch.no_grad():
                w_samples = orig.mapping(z, torch.zeros((n, g.c_dim), device=real.device),
                                         truncation_psi=cfg.locality_truncation)
            reg = 0.0
            for i in range(n):
                w_moved = morphed_w_code(w_samples[i:i + 1], batch["ws"], cfg.regulizer_alpha)
                new_img = g.synthesis(w_moved, batch["loss_c"], neural_rendering_resolution=res,
                                      noise_mode="none")["image"]
                with torch.no_grad():
                    old_img = orig.synthesis(w_moved, batch["loss_c"],
                                             neural_rendering_resolution=res,
                                             noise_mode="none")["image"]
                if cfg.regulizer_l2_lambda > 0:
                    reg = reg + cfg.regulizer_l2_lambda * (old_img - new_img).square().mean()
                if cfg.regulizer_lpips_lambda > 0:
                    reg = reg + cfg.regulizer_lpips_lambda * L.lpips_training_distance(
                        vgg, old_img, new_img).mean()
            reg = reg / n
            loss = loss + reg
            stats["Loss/pti/locality"] = reg.detach()

        stats["Loss/pti/total"] = loss.detach()
        params = [p for grp in state.opt.param_groups for p in grp["params"]]
        grads = torch.autograd.grad(loss, params, materialize_grads=True)
        for p, gr in zip(params, grads):
            p.grad = gr
        state.opt.step()
        state.opt.zero_grad(set_to_none=True)
        return state, stats

    return pti_step


def run_pti(g: TriPlaneGenerator, vgg: L.VGG16LPIPS, ws: torch.Tensor,
            loss_image: torch.Tensor, loss_c: torch.Tensor, num_steps: int = 350,
            cfg: Optional[PTIConfig] = None, seed: int = 0
            ) -> tuple[TriPlaneGenerator, list]:
    """Tune G on one pivot batch (single- or multi-id coach): (the tuned G,
    the per-step total losses). Step i's key is split from PRNGKey(seed) as
    the JAX `run_pti` splits it."""
    cfg = cfg or PTIConfig()
    state = init_pti_state(g, vgg, cfg)
    step = make_pti_step(cfg)
    rng = prng.PRNGKey(seed, device=ws.device)
    batch = {"ws": ws, "loss_image": loss_image, "loss_c": loss_c}
    history = []
    for _ in range(num_steps):
        rng, k = prng.split(rng)
        _, stats = step(state, batch, k)
        history.append(float(stats["Loss/pti/total"]))
    return state.g, history


def project_w(
    g: TriPlaneGenerator,
    vgg: L.VGG16LPIPS,
    target_image: torch.Tensor,   # [N, 3, R, R] in [-1, 1]
    target_c: torch.Tensor,       # [N, 25]
    num_steps: int = 500,
    w_avg_samples: int = 600,
    initial_lr: float = 0.01,
    initial_noise_factor: float = 0.05,
    lr_rampup_frac: float = 0.05,
    lr_rampdown_frac: float = 0.25,
    noise_ramp_frac: float = 0.75,
    l2_lambda: float = 0.0,
    start_ws: Optional[torch.Tensor] = None,
    neural_rendering_resolution: Optional[int] = None,
    seed: int = 0,
) -> tuple[torch.Tensor, list]:
    """w-space projector: one w per image (broadcast to all num_ws layers)
    optimized so G(w) reconstructs the target, PTI's first inversion. It
    starts at `start_ws[:, :1]` (e.g. the encoder's) or at w_avg over
    `w_avg_samples` mapping draws; Adam (no weight decay) with a linear lr
    rampup and cosine rampdown, and gaussian w noise decaying quadratically,
    scaled by the measured w std. G's weights are not trained. The draws
    come from PRNGKey(seed), split as the JAX `project_w` splits its key.

    Returns (ws [N, num_ws, w_dim], loss history)."""
    dev = target_image.device
    n = target_image.shape[0]
    res = neural_rendering_resolution or g.neural_rendering_resolution
    k_avg, rng = prng.split(prng.PRNGKey(seed, device=dev))
    with torch.no_grad():
        z_samples = prng.normal(k_avg, (w_avg_samples, g.z_dim))
        w_samples = g.mapping(z_samples, torch.zeros((w_avg_samples, g.c_dim), device=dev))
        w_samples = w_samples[:, :1, :]
        w_avg = w_samples.mean(dim=0, keepdim=True)
        w_std = float(torch.sqrt((w_samples - w_avg).square().sum(dim=-1).mean()))
    w_opt = (start_ws[:, :1, :] if start_ws is not None else w_avg.expand(n, 1, g.w_dim))
    w_opt = w_opt.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([w_opt], lr=0.0, betas=(0.9, 0.999), eps=1e-8)

    history = []
    for i in range(num_steps):
        t = i / max(num_steps, 1)
        noise_scale = w_std * initial_noise_factor * max(0.0, 1.0 - t / noise_ramp_frac) ** 2
        lr_ramp = min(1.0, (1.0 - t) / lr_rampdown_frac)
        lr_ramp = 0.5 - 0.5 * math.cos(lr_ramp * math.pi)
        if lr_rampup_frac:
            lr_ramp = lr_ramp * min(1.0, t / lr_rampup_frac)
        opt.param_groups[0]["lr"] = initial_lr * lr_ramp
        rng, k = prng.split(rng)
        noise = prng.normal(k, w_opt.shape)
        ws = (w_opt + noise_scale * noise).expand(n, g.num_ws, g.w_dim)
        synth = g.synthesis(ws, target_c, neural_rendering_resolution=res,
                            noise_mode="none")["image"]
        loss = L.lpips_training_distance(vgg, target_image, synth).mean()
        if l2_lambda > 0:
            loss = loss + l2_lambda * (target_image - synth).square().mean()
        (w_opt.grad,) = torch.autograd.grad(loss, [w_opt])
        opt.step()
        opt.zero_grad(set_to_none=True)
        history.append(float(loss.detach()))
    return w_opt.detach().expand(n, g.num_ws, g.w_dim).contiguous(), history


def run_pti_cli(network: str, data: str = "", dataset_name: str = "synthetic",
                outdir: str = "runs/pti", steps: int = 350, max_items: int = 4,
                lpips_weights: str = "", locality: bool = False, seed: int = 0,
                pivot: str = "encoder", project_steps: int = 500, align_lm: str = "",
                device=None):
    """The CLI: load a checkpoint, take the first `max_items` held-out
    identities as one coaching batch, tune G with the SR module frozen and
    write `network-pti.npz` (G_ema = the tuned G, E, E_state) in the JAX
    layout. Pivots come from the identity encoder, or with `--pivot project`
    from `project_w` (started at the encoder's ws when the checkpoint has an
    encoder). `--align_lm` FFHQ-aligns raw photos first. Returns (the npz
    path, the loss history)."""
    import os

    import numpy as np

    from ..infer.gen_videos import load_networks
    from ..models import ResNeXt50Encoder
    from ..utils import checkpoint as ckpt_lib
    from ..utils.device import resolve_device
    from .dataset import SyntheticDataset, TestDataset, collate

    device = resolve_device(device)
    trees, config = ckpt_lib.load_checkpoint(network)
    if "E" not in trees and pivot == "encoder":
        raise ValueError("PTI with --pivot encoder needs an encoder for the pivot latents; "
                         "the checkpoint has no 'E' tree (use --pivot project to optimize "
                         "the pivot directly)")
    g, enc = load_networks(network, device=device, double_sampling=False)
    vgg = L.lpips_from_checkpoint(trees, lpips_weights, device, warn=True)
    out_res = g.output_resolution()

    if align_lm:
        from ..utils.alignment import align_folder

        if dataset_name == "synthetic" or not data:
            raise ValueError("--align_lm needs --data (a raw-photo folder)")
        aligned_dir = os.path.join(outdir, "aligned")
        written = align_folder(data, align_lm, aligned_dir, output_size=max(out_res, 512))
        if not written:
            raise ValueError(f"no (image, landmark) pairs matched between {data} and "
                             f"{align_lm}")
        print(f"aligned {len(written)} image(s) -> {aligned_dir}")
        data = aligned_dir

    if dataset_name == "synthetic":
        ds = SyntheticDataset(resolution=out_res, size=max_items)
    else:
        ds = TestDataset(real_path=data, max_size=max_items, resolution=out_res)
    items = [ds[i] for i in range(min(max_items, len(ds)))]
    bd = collate(items)

    def on_device(key):
        return torch.from_numpy(np.asarray(bd[key], np.float32)).to(device)

    imgs = on_device("condition_image") / 127.5 - 1.0
    loss_image = on_device("loss_image") / 127.5 - 1.0
    loss_c = on_device("loss_c")

    with torch.no_grad():
        start = g.mapping(enc.apply(imgs, train=False), loss_c) if enc is not None else None
    if pivot == "project":
        ws, proj_hist = project_w(g, vgg, loss_image, loss_c, num_steps=project_steps,
                                  start_ws=start, seed=seed + 1)
        print(f"project_w: loss {proj_hist[0]:.4f} -> {proj_hist[-1]:.4f} over "
              f"{project_steps} steps")
    else:
        ws = start

    cfg = PTIConfig(neural_rendering_resolution=g.neural_rendering_resolution,
                    use_locality_reg=locality)
    tuned, history = run_pti(g, vgg, ws, loss_image, loss_c, num_steps=steps, cfg=cfg,
                             seed=seed)
    if enc is None:  # the JAX CLI stores a fresh encoder when the checkpoint has none
        enc = ResNeXt50Encoder(out_dim=g.z_dim, device="cpu")
    os.makedirs(outdir, exist_ok=True)
    out_path = os.path.join(outdir, "network-pti.npz")
    ckpt_lib.save_checkpoint(
        out_path, {"G_ema": tuned, **ckpt_lib.encoder_trees(enc)},
        config=dict(config or {}, pti={"steps": steps, "num_items": len(items),
                                       "locality": locality}))
    print(f"PTI: loss {history[0]:.4f} -> {history[-1]:.4f} over {steps} steps on "
          f"{len(items)} image(s); saved {out_path}")
    return out_path, history


def main():  # pragma: no cover - thin click wrapper over run_pti_cli
    import click

    @click.command()
    @click.option("--network", required=True, help="checkpoint with G_ema + E (npz)")
    @click.option("--data", default="", help="held-out image folder")
    @click.option("--dataset_name", default="synthetic")
    @click.option("--outdir", default="runs/pti")
    @click.option("--steps", type=int, default=350, help="PTI steps")
    @click.option("--max_items", type=int, default=4,
                  help="images in the multi-id coaching batch")
    @click.option("--lpips-weights", "lpips_weights", default="")
    @click.option("--locality", type=bool, default=False,
                  help="ball-holder locality regularizer")
    @click.option("--seed", type=int, default=0)
    @click.option("--pivot", type=click.Choice(["encoder", "project"]), default="encoder",
                  help="pivot latents: identity encoder (G-NeRF) or w-space projection")
    @click.option("--project_steps", type=int, default=500,
                  help="w-projector steps when --pivot project")
    @click.option("--align_lm", default="",
                  help="folder of 68-point landmark files (json/npy/txt, same stems as "
                       "--data images): FFHQ-align raw photos before encoding")
    @click.option("--device", type=str, default=None,
                  help="torch device; default CUDA (refuses to run without a card)")
    def _cli(**kw):
        run_pti_cli(**kw)

    _cli()


if __name__ == "__main__":  # pragma: no cover
    main()
