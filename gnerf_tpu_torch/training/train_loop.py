"""Joint E (+G) (+depth-D) training step.

Port of `gnerf_tpu/training/train_loop.py`. One step runs the encoder in
train mode (BatchNorm batch statistics), G's mapping and synthesis with
random noise, the 48+48 render and the superresolution, the reconstruction
and depth-GAN losses, both Adam updates, the R1 penalty and the G_ema
update:

  recon = sum over {image_raw 64^2, image 512^2} of (L1 + (1 - SSIM) + LPIPS),
          each per sample, masked by `factor`, normalized by factor.sum()
  G     = recon + 1.2 * softplus(-D(depth_fake, loss_c)).mean()   [gan_depth]
  D     = softplus(D(depth_fake, loss_c)) + softplus(-D(depth_real, cond_c))
          + (r1_gamma / 2) * R1(depth_real)

Frozen parameters get `requires_grad_(False)`, so no weight gradient is
computed for them (the JAX package's `freeze_untrained`); gradients still
flow through G into ws and z. Both losses are differentiated with
`torch.autograd.grad` with respect to their own trainable set, so D collects
no gradient from the G loss. The step mutates the modules and optimizers of
a `TrainState` in place and returns the stats.

Given a `parallel.Mesh`, the step is the JAX package's global-batch step:
each rank holds its rows of the batch (and, with a ray axis, renders its
share of the rays), BatchNorm and minibatch std see the global batch,
`factor` is normalized by its global sum, the gradients are averaged over
every rank (`pmean_grads`) before Adam, the stats are global means and
cur_nimg counts the global batch.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models.encoder import ResNeXt50Encoder
from ..models.stylegan2 import Discriminator
from ..models.triplane import TriPlaneGenerator
from ..ops.interpolate import interpolate_bilinear
from ..parallel.collectives import pmean_grads
from ..parallel.mesh import Mesh, active_mesh, use_mesh
from ..parallel.sharding import data_sum, mean_stats
from ..utils import checkpoint as ckpt_lib
from ..utils import prng
from ..utils.misc import ema_update
from ..utils.profiling import span
from . import jax_state
from . import losses as L


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_kimg: int = 4000
    kimg_per_tick: int = 2
    batch_size: int = 32
    glr: float = 1e-3
    dlr: float = 8e-6
    r1_gamma: float = 1.0
    gan_depth: bool = True
    train_en: bool = True
    train_gen: bool = False
    neural_rendering_resolution: int = 64
    snapshot_ticks: int = 500
    ema_kimg: float = 10.0
    run_dir: str = "training-runs/run0"
    random_seed: int = 0
    dtype: Any = torch.float32
    # Recompute the synthesis (backbone, render, SR) and the fakes' VGG
    # forward in the backward pass instead of keeping their activations.
    # Off by default: the full-width fp32 step at batch 4 fits an 80 GB H100
    # without it, and recomputing costs time (PERF.md, the train cell).
    remat_synthesis: bool = False
    remat_lpips: bool = False


@dataclasses.dataclass
class TrainState:
    """Everything one training run updates. `g_ema` is a frozen copy of `g`;
    `opt_g` steps the trainable E and G parameters, `opt_d` D's (either is
    None when it has nothing to step)."""

    g: TriPlaneGenerator
    g_ema: TriPlaneGenerator
    enc: ResNeXt50Encoder
    disc: Optional[Discriminator]
    vgg: L.VGG16LPIPS
    opt_g: Optional[torch.optim.Adam]
    opt_d: Optional[torch.optim.Adam]
    cur_nimg: int = 0


def config_dict(cfg: TrainConfig) -> dict:
    """TrainConfig as JSON-ready values, dtype by its numpy name."""
    return dataclasses.asdict(dataclasses.replace(
        cfg, dtype=str(cfg.dtype).replace("torch.", "")))


def make_optimizers(g: TriPlaneGenerator, enc: ResNeXt50Encoder,
                    disc: Optional[Discriminator], cfg: TrainConfig):
    """(opt_g, opt_d): Adam(glr, betas (0.9, 0.999)) over the trainable set
    and Adam(dlr, betas (0, 0.999)) over D, eps 1e-8 (where optax puts it).
    The trainable set is E if train_en; G's mapping when z_dim != 512 and G
    is frozen; all of G if train_gen. Everything else gets
    `requires_grad_(False)`, so no weight gradient is computed for it."""
    enc.requires_grad_(bool(cfg.train_en))
    g.requires_grad_(bool(cfg.train_gen))
    if cfg.train_en and g.z_dim != 512 and not cfg.train_gen:
        g.backbone.mapping.requires_grad_(True)
    params = [p for m in (enc, g) for p in m.parameters() if p.requires_grad]
    opt_g = (torch.optim.Adam(params, lr=cfg.glr, betas=(0.9, 0.999), eps=1e-8)
             if params else None)
    opt_d = None
    if disc is not None:
        disc.requires_grad_(True)
        opt_d = torch.optim.Adam(disc.parameters(), lr=cfg.dlr, betas=(0.0, 0.999), eps=1e-8)
    return opt_g, opt_d


def init_train_state(g: TriPlaneGenerator, enc: ResNeXt50Encoder,
                     disc: Optional[Discriminator], vgg: L.VGG16LPIPS,
                     cfg: TrainConfig) -> TrainState:
    """A TrainState around freshly built modules: G_ema is a frozen copy of
    G, the optimizers come from `make_optimizers`, cur_nimg is 0. The JAX
    `init_train_state(..., rng)` draws E, G, D and the VGG from
    split(rng, 4); `train.gnerf_networks` builds the modules from those keys."""
    import copy

    g_ema = copy.deepcopy(g).requires_grad_(False).eval()
    opt_g, opt_d = make_optimizers(g, enc, disc, cfg)
    vgg.requires_grad_(False)
    return TrainState(g=g, g_ema=g_ema, enc=enc, disc=disc, vgg=vgg, opt_g=opt_g, opt_d=opt_d)


def checkpointed(fn: Callable, *args):
    """`fn(*args)` under `torch.utils.checkpoint`, recomputed in the backward
    pass under the forward's mesh: on CUDA the autograd engine runs the
    recompute on a thread of its own, which does not see the step's
    `use_mesh`. The step's draws come from keys among `args` (or closed
    over), so the recompute draws what the forward drew."""
    mesh = active_mesh()

    def body(*a):
        with use_mesh(mesh):
            return fn(*a)

    return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False)


def ray_overrides(rendering_overrides: Optional[dict], mesh: Optional[Mesh]) -> Optional[dict]:
    """The per-call rendering options of a step: `rendering_overrides`, plus
    the mesh as `ray_sharding` when it has a ray axis."""
    if mesh is None or mesh.rays == 1:
        return rendering_overrides
    return {**(rendering_overrides or {}), "ray_sharding": mesh}


def make_train_step(cfg: TrainConfig, rendering_overrides: Optional[dict] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """The step `train_step(state, batch, rng=None) -> (state, stats)`.

    `batch` holds the collated dataset tensors on G's device (uint8 images,
    fp32 labels, depths and factor): under `mesh`, this rank's rows of the
    global batch. `rng` is the step's key (`utils.prng`, best kept on the
    CPU), split as the JAX step splits it: the first half is the synthesis
    noise, the stratified jitter and the importance samples, the second is
    unused, as there. None gives deterministic sampling (constant noise, no
    jitter, evenly spaced importance samples). Under a mesh every rank
    passes the same key and draws its part of the global draw."""
    res = cfg.neural_rendering_resolution
    rendering_overrides = ray_overrides(rendering_overrides, mesh)
    data = mesh.data if mesh is not None else 1

    def to_vgg_res(x, vgg):
        # The resize vgg.apply would do, hoisted so both tiers share one
        # batch (resize and the 0..255 affine commute: weights sum to 1).
        x = x.to(cfg.dtype)
        if x.shape[-1] != vgg.resize_to:
            x = interpolate_bilinear(x, vgg.resize_to, vgg.resize_to, antialias=vgg.antialias)
        return x

    def lpips_pair_terms(vgg, real_raw, fake_raw, real_full, fake_full):
        """LPIPS of both tiers: the 2N targets in one batch without gradient,
        the 2N fakes in another."""
        def embed(x):
            return L.lpips_embed(vgg, x)

        with torch.no_grad():
            emb_t = embed(torch.cat([to_vgg_res(real_raw, vgg), to_vgg_res(real_full, vgg)]))
        fak = torch.cat([to_vgg_res(fake_raw, vgg), to_vgg_res(fake_full, vgg)])
        emb_f = checkpointed(embed, fak) if cfg.remat_lpips else embed(fak)
        d = (emb_t - emb_f).float().square().sum(dim=1)
        return d.chunk(2)

    def recon_terms(real, fake):
        l1 = (real - fake).abs().mean(dim=(1, 2, 3))
        ssim_val = 1.0 - L.ssim(real * 0.5 + 0.5, fake * 0.5 + 0.5, data_range=1.0,
                                size_average=False)
        return l1, ssim_val

    def g_loss(st: TrainState, batch, rng):
        g = st.g
        id_images = batch["condition_image"].to(cfg.dtype) / 127.5 - 1.0
        z = st.enc.apply(id_images, train=cfg.train_en)
        loss_c = batch["loss_c"].float()
        ws = g.mapping(z, loss_c)
        noise_mode = "random" if rng is not None else "const"
        k_noise = prng.split(rng)[0] if rng is not None else None

        def synth(ws_, c_):
            out = g.synthesis(ws_, c_, neural_rendering_resolution=res, noise_mode=noise_mode,
                              rng=k_noise, dtype=cfg.dtype,
                              rendering_kwargs=rendering_overrides)
            return out["image"], out["image_raw"], out["image_depth"]

        if cfg.remat_synthesis:
            image, image_raw, depth = checkpointed(synth, ws, loss_c)
        else:
            image, image_raw, depth = synth(ws, loss_c)

        loss_image = batch["loss_image"].float()
        real_img = loss_image / 127.5 - 1.0
        # Antialiased 64^2 target, as the JAX package chose (PARITY.md).
        real_raw = interpolate_bilinear(loss_image, res, res, antialias=True) / 127.5 - 1.0
        factor = batch["factor"].float()
        # The masked mean over the global batch, scaled so that its mean over
        # the data shards is the global value (at data=1, the masked mean).
        factor_sum = data_sum(factor.sum())

        def masked_mean(values):
            return data * L.masked_mean(values, factor, factor_sum=factor_sum)

        l1_raw, ssim_raw = recon_terms(real_raw, image_raw)
        l1_full, ssim_full = recon_terms(real_img, image)
        lp_raw, lp_full = lpips_pair_terms(st.vgg, real_raw, image_raw, real_img, image)
        total = masked_mean(l1_raw + ssim_raw + lp_raw + l1_full + ssim_full + lp_full)
        stats = {
            "Loss/G/l1_loss": masked_mean(l1_full),
            "Loss/G/l_ssim_val": masked_mean(ssim_full),
            "Loss/G/p_loss": masked_mean(lp_full),
            "Loss/G/l1_loss_raw": masked_mean(l1_raw),
            "Loss/G/ssim_val_raw": masked_mean(ssim_raw),
            "Loss/G/p_loss_raw": masked_mean(lp_raw),
        }
        if cfg.gan_depth and st.disc is not None:
            loss_gmain = L.g_nonsaturating_loss(st.disc.apply(depth, loss_c))
            total = total + 1.2 * loss_gmain
            stats["Loss/G/main"] = loss_gmain
        return total, stats, depth.detach()

    def d_loss(disc, batch, depth_fake):
        loss_c = batch["loss_c"].float()
        cond_c = batch["condition_c"].float()
        depth_real = interpolate_bilinear(batch["c_depth_image"].float(), res, res,
                                          antialias=True)
        fake_logits = disc.apply(depth_fake, loss_c)
        loss_dgen = F.softplus(fake_logits).mean()
        real_logits = disc.apply(depth_real, cond_c)
        loss_dreal = F.softplus(-real_logits).mean()
        r1 = L.r1_penalty(lambda x: disc.apply(x, cond_c), depth_real)
        loss_dr1 = (r1 * (cfg.r1_gamma / 2)).mean()
        stats = {
            "Loss/scores/fake": fake_logits.mean(),
            "Loss/scores/real": real_logits.mean(),
            "Loss/D/real": loss_dreal,
            "Loss/D/r1": loss_dr1,
        }
        return loss_dgen + loss_dreal + loss_dr1, stats

    def apply_grads(opt, params, grads):
        """One Adam step. A trainable parameter the loss does not reach (G's
        noise_const under random noise) has a zero gradient, as in optax:
        its step advances with the others', since JAX's Adam keeps one
        count for the whole tree (`jax_state`)."""
        grads = pmean_grads(grads, mesh.group if mesh is not None else None)
        for p, gr in zip(params, grads):
            p.grad = gr
        opt.step()
        opt.zero_grad(set_to_none=True)

    def train_step(state: TrainState, batch, rng: Optional[torch.Tensor] = None):
        with use_mesh(mesh):
            return step(state, batch, rng)

    def step(state: TrainState, batch, rng: Optional[torch.Tensor]):
        with span("train.step"):
            return parts(state, batch, rng)

    def parts(state: TrainState, batch, rng: Optional[torch.Tensor]):
        g_params = [p for grp in state.opt_g.param_groups for p in grp["params"]] \
            if state.opt_g is not None else []
        with span("train.g_forward"):
            total, stats, depth_fake = g_loss(state, batch, rng)
        stats["Loss/G/total"] = total.detach()
        with span("train.g_backward"):
            if g_params:
                g_grads = torch.autograd.grad(total, g_params, materialize_grads=True)
            del total
        with_d = cfg.gan_depth and state.disc is not None
        if with_d:
            d_params = [p for grp in state.opt_d.param_groups for p in grp["params"]]
            with span("train.d_forward"):
                loss_d, d_stats = d_loss(state.disc, batch, depth_fake)
            with span("train.d_backward"):
                d_grads = torch.autograd.grad(loss_d, d_params, materialize_grads=True)
            stats.update(d_stats)
            stats["Loss/D/total"] = loss_d.detach()
        with span("train.optimizer"):
            if with_d:
                apply_grads(state.opt_d, d_params, d_grads)
            if g_params:
                apply_grads(state.opt_g, g_params, g_grads)
        with span("train.ema"):
            beta = 0.5 ** (cfg.batch_size / max(cfg.ema_kimg * 1000.0, 1e-8))
            ema_update(state.g_ema.state_dict(), state.g.state_dict(), beta)
        state.cur_nimg += int(batch["condition_image"].shape[0]) * data
        return state, mean_stats({k: v.detach() for k, v in stats.items()}, mesh)

    return train_step


def _snapshot_trees(state: TrainState) -> dict:
    return {
        "G_ema": ckpt_lib.module_params(state.g_ema),
        "G": ckpt_lib.module_params(state.g),
        **ckpt_lib.encoder_trees(state.enc),
        "D": ckpt_lib.module_params(state.disc) if state.disc is not None else {},
    }


def save_snapshot(path: str, state: TrainState, config: Optional[dict] = None) -> None:
    """Network snapshot in the JAX package's key layout (`G_ema`, `G`, `E`,
    `E_state`, `D`), readable by either package."""
    ckpt_lib.save_checkpoint(path, _snapshot_trees(state), config=config)


def save_train_state(path: str, state, config: Optional[dict] = None,
                     best_ssim: Optional[float] = None) -> None:
    """Full-state checkpoint of a TrainState or an EG3DState in the JAX
    package's layout (`gnerf_tpu/training/train_loop.py::save_train_state`):
    every leaf of JAX's state of the same config under `train_state/{i:05d}`
    in JAX's flatten order (`jax_state.leaf_plan`: parameters, BN statistics,
    both Adam states as count, mu, nu, cur_nimg), the options as
    `__config__`, with `best_ssim` in them when given, as the JAX CLI puts
    it. Either package resumes from it; the port continues bit for bit on
    the CPU. Raises if an optimizer's parameters disagree on their step."""
    if best_ssim is not None:
        config = {**(config or {}), "best_ssim": best_ssim}
    ckpt_lib.save_checkpoint(path, {"train_state": jax_state.state_leaves(state)}, config=config)


def load_train_state(path: str, state) -> tuple[Any, Optional[dict], float]:
    """Restore a full-state checkpoint into a TrainState or EG3DState built
    with the same config, in place: the JAX layout that either package
    writes (checked as the JAX `load_train_state` checks it: leaf count and
    shapes raise, naming the leaf; a dtype is cast with a WARNING line), or
    the port's earlier `train_state_torch` layout. Returns (state, config,
    best_ssim), best_ssim from the config (-100 without one)."""
    trees, config = ckpt_lib.load_checkpoint(path)
    if "train_state_torch" in trees:
        return state, config, _load_torch_layout(trees["train_state_torch"], state)
    if "train_state" not in trees:
        raise ValueError(f"{path} is not a full-state checkpoint (roots {sorted(trees)}); "
                         "resume from a network snapshot instead")
    jax_state.restore_leaves(state, trees["train_state"])
    return state, config, float((config or {}).get("best_ssim", -100.0))


def _load_torch_layout(tree: dict, state) -> float:
    """The port's earlier layout (`train_state_torch`: state_dicts, torch
    optimizer states, cur_nimg, best_ssim), in place; returns best_ssim."""
    for name in ("g", "g_ema", "enc", "disc", "vgg"):
        module = getattr(state, name, None)
        if module is None:
            if name in tree:
                raise ValueError(f"checkpoint has {name}, the state has none")
            continue
        flat = ckpt_lib.flatten_tree(tree.get(name, {}))
        want = {k.replace(".", ckpt_lib.SEP): (k, v) for k, v in module.state_dict().items()}
        if set(flat) != set(want):
            raise ValueError(f"{name}: checkpoint and module keys differ: "
                             f"{sorted(set(flat) ^ set(want))[:8]}")
        module.load_state_dict({k: torch.from_numpy(np.array(flat[jk]))
                                for jk, (k, _) in want.items()})
    for name in ("opt_g", "opt_d"):
        opt = getattr(state, name)
        if (opt is None) != (name not in tree):
            raise ValueError(f"optimizer {name}: checkpoint and state disagree on its presence")
        if opt is None:
            continue
        groups = json.loads(bytes(tree[name]["param_groups"]).decode())
        st = {int(i): {k: torch.from_numpy(np.array(v)) for k, v in s.items()}
              for i, s in tree[name].get("state", {}).items()}
        opt.load_state_dict({"state": st, "param_groups": groups})
        _align_steps(opt)
    state.cur_nimg = int(tree["cur_nimg"])
    return float(tree["best_ssim"])


def _align_steps(opt: torch.optim.Optimizer) -> None:
    """Give every parameter of `opt` the step of the furthest one, as JAX's
    one count holds it. Before the port wrote JAX's layout, Adam skipped a
    parameter the loss did not reach (G's noise_const under random noise):
    such a parameter has no state, or an earlier step. Its moments become
    what optax holds after zero gradients since: zero without state, else
    decayed by beta ** (the steps it missed)."""
    params = [(p, grp["betas"]) for grp in opt.param_groups for p in grp["params"]]
    common = max((int(opt.state[p]["step"]) for p, _ in params if p in opt.state), default=0)
    for p, (beta1, beta2) in params:
        st = opt.state[p] if p in opt.state else None
        missed = common - (int(st["step"]) if st else 0)
        if missed == 0:
            continue
        if not st:
            opt.state[p] = {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
        else:
            st["exp_avg"].mul_(beta1 ** missed)
            st["exp_avg_sq"].mul_(beta2 ** missed)
        opt.state[p]["step"] = jax_state.adam_step(common)
