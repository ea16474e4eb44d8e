"""Training CLI: G-NeRF encoder-inversion training, or EG3D adversarial
pretraining, on one CUDA card or on several under torchrun.

Port of `gnerf_tpu/training/train.py`: builds the rendering recipe (dataset
preset, SR module, knobs), writes the run directory and drives the tick and
snapshot loop. `--objective gnerf` writes `training_options.json`,
`log.txt`, `stats.jsonl`, `id_images.png`, `fakes-*.png`,
`network-snapshot-{best,latest,final,NNNNNN}.npz` and
`training-state-latest.npz` (the JAX package's full-state layout, so a run
moves between the packages in either direction); `--resume` continues from
either package's full state (bit for bit from the port's own), or starts
from a network snapshot of either package. `--objective eg3d`
trains all of G against the dual discriminator with lazy regularization
(Greg every `--density_reg_every`, Dreg every `--d_reg_interval` steps),
with `--aug ada` (the bgc ADA pipe in front of D, its p driven by the
r_t-feedback controller from `--aug_p`) or `--aug fixed` (p stays `--aug_p`),
and writes the same layout without the validation files (snapshots hold
G_ema, G and D); `--resume` continues from its full state with the live ADA
p. SIGTERM and SIGINT finish the step, save the full state and exit.

    python -m gnerf_tpu_torch.training.train --outdir runs --dataset_name synthetic \\
        --preset ffhq --batch 4 --kimg 1 --tick 1 [--objective eg3d] [--device cpu]

Runs on CUDA unless `--device` names another device. Under `torchrun
--nproc_per_node=K` each rank trains on its card (NCCL; gloo with `--device
cpu`) and the ranks compute the JAX package's global-batch step on a
K-device mesh: `--batch` is the global batch, each of the K / ray_shards
data shards feeds batch / (K / ray_shards) rows, and `--ray_shards k` splits
every render's rays over k ranks that hold the same rows. Rank 0 alone
writes the run directory; every rank reads `--resume`. Not ported (it
raises): `--chain` > 1.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
from typing import Optional

import click
import numpy as np
import torch

from ..utils.profiling import profiled_function

RENDERING_PRESETS = {
    "ffhq": dict(depth_resolution=48, depth_resolution_importance=48,
                 ray_start=2.25, ray_end=3.3, box_warp=1.0,
                 avg_camera_radius=2.7, avg_camera_pivot=(0, 0, 0.2),
                 superresolution_module="SuperresolutionHybrid8XDC",
                 image_resolution=512),
    "afhqv2": dict(depth_resolution=48, depth_resolution_importance=48,
                   ray_start=2.25, ray_end=3.3, box_warp=1.0,
                   avg_camera_radius=2.7, avg_camera_pivot=(0, 0, -0.06),
                   superresolution_module="SuperresolutionHybrid8XDC",
                   image_resolution=512),
    "shapenet": dict(depth_resolution=64, depth_resolution_importance=64,
                     ray_start=0.1, ray_end=2.6, box_warp=1.6, white_back=True,
                     avg_camera_radius=1.7, avg_camera_pivot=(0, 0, 0),
                     superresolution_module="SuperresolutionHybrid2X",
                     image_resolution=128),
    # EG3D-format folder or zip data (ImageFolderDataset): FFHQ optics.
    "folder": dict(depth_resolution=48, depth_resolution_importance=48,
                   ray_start=2.25, ray_end=3.3, box_warp=1.0,
                   avg_camera_radius=2.7, avg_camera_pivot=(0, 0, 0.2),
                   superresolution_module="SuperresolutionHybrid8XDC",
                   image_resolution=512),
    "synthetic": dict(depth_resolution=12, depth_resolution_importance=12,
                      ray_start=2.25, ray_end=3.3, box_warp=1.0,
                      avg_camera_radius=2.7, avg_camera_pivot=(0, 0, 0.2),
                      superresolution_module="SuperresolutionHybrid2X",
                      image_resolution=128),
}


def save_image_grid(images: np.ndarray, path: str, drange=(-1, 1),
                    grid_w: Optional[int] = None) -> None:
    """Tile [N, C, H, W] into one PNG."""
    from PIL import Image

    lo, hi = drange
    img = (np.asarray(images, np.float32) - lo) * (255 / (hi - lo))
    img = np.rint(img).clip(0, 255).astype(np.uint8)
    n, c, h, w = img.shape
    gw = grid_w or int(np.ceil(np.sqrt(n)))
    gh = int(np.ceil(n / gw))
    pad = gw * gh - n
    if pad:
        img = np.concatenate([img, np.zeros((pad, c, h, w), np.uint8)])
    img = img.reshape(gh, gw, c, h, w).transpose(0, 3, 1, 4, 2)
    img = img.reshape(gh * h, gw * w, c)
    if c == 1:
        img = img[..., 0]
    Image.fromarray(img).save(path)


def make_validator(g, enc, vgg=None, lpips_pretrained: bool = True):
    """validate_batch(batch) -> (ssim, psnr, lpips, images) on the held-out
    grid: E in eval mode, G without noise. SSIM gates the best snapshot;
    the perceptual distance is computed only with pretrained VGG weights (a
    random-VGG curve would look like a real metric) and is 0 otherwise."""
    from .losses import lpips_distance, ssim as ssim_fn
    from .metrics import psnr as psnr_fn

    vgg = vgg if lpips_pretrained else None

    @torch.no_grad()
    def validate_batch(batch):
        id_images = batch["condition_image"].float() / 127.5 - 1.0
        z = enc.apply(id_images, train=False)
        c = batch["loss_c"].float()
        ws = g.mapping(z, c)
        out = g.synthesis(ws, c, noise_mode="none")
        real = batch["loss_image"].float() / 127.5 - 1.0
        val = ssim_fn(real * 0.5 + 0.5, out["image"] * 0.5 + 0.5, data_range=1.0)
        psnr = psnr_fn(real * 0.5 + 0.5, out["image"] * 0.5 + 0.5, data_range=1.0).mean()
        lp = (lpips_distance(vgg, real, out["image"]).mean() if vgg is not None
              else torch.zeros((), device=real.device))
        return val, psnr, lp, out["image"]

    return validate_batch


def _paired_dataset(dataset_name, data, real_data, img_resolution):
    """dataset_name -> the paired dataset of that family."""
    from .dataset import Afhqv2Dataset, FFHQGenDataset, ShapeNetDataset

    cls = {"ffhq": FFHQGenDataset, "afhqv2": Afhqv2Dataset,
           "shapenet": ShapeNetDataset}.get(dataset_name)
    if cls is None:
        raise ValueError(f"unknown --dataset_name {dataset_name!r} "
                         "(expected ffhq/afhqv2/shapenet/folder/synthetic)")
    return cls(path=data, real_path=real_data or None, resolution=img_resolution)


def pick_run_dir(outdir: str, desc: str) -> str:
    os.makedirs(outdir, exist_ok=True)
    prev = [int(m.group(1)) for d in os.listdir(outdir) if (m := re.match(r"^(\d+)-", d))]
    run_id = max(prev, default=-1) + 1
    run_dir = os.path.join(outdir, f"{run_id:05d}-{desc}")
    os.makedirs(run_dir, exist_ok=False)
    return run_dir


@profiled_function("train.step_key")
def step_key(seed: int, cur_nimg: int) -> torch.Tensor:
    """The step's key, on the CPU: fold_in(PRNGKey(seed + 1), cur_nimg), as
    the JAX loops key their steps, so a resumed run continues the stream
    instead of replaying it from step 0."""
    from ..utils import prng

    return prng.fold_in(prng.PRNGKey(seed + 1), cur_nimg)


def check_fade_sr_compat(g, cfg, img_resolution: int) -> None:
    """Fail fast when the render-resolution fade can visit a resolution at
    which G's `image` is not img_resolution (D's fixed input): the FFHQ-style
    SR variants resize off-size inputs to their fixed input resolution, the
    2X one does not. Runs the SR module alone on zeros, batch 1, at each
    bucket the fade can visit."""
    if cfg.neural_rendering_resolution_final is None:
        return
    lo = min(cfg.neural_rendering_resolution, cfg.neural_rendering_resolution_final)
    hi = max(cfg.neural_rendering_resolution, cfg.neural_rendering_resolution_final)
    b = max(int(cfg.res_bucket), 1)
    buckets = {cfg.neural_rendering_resolution, cfg.neural_rendering_resolution_final}
    buckets |= {r for r in range(lo, hi + 1) if r % b == 0}
    dev = next(g.parameters()).device
    ws = torch.zeros((1, g.num_ws, g.w_dim), device=dev)
    for r in sorted(buckets):
        # The rendered feature image has the decoder's 32 rgb-feature channels.
        x = torch.zeros((1, 32, r, r), device=dev)
        with torch.no_grad():
            image, _ = g.superresolution(x[:, :3], x, ws, noise_mode="none")
        if image.shape[-1] != img_resolution:
            raise ValueError(
                f"render-resolution fade visits res={r} at which the configured SR module "
                f"emits a {image.shape[-1]}^2 image instead of {img_resolution}^2 — use an SR "
                "variant with the fixed-input resize guard (8XDC/8X/4X family) or set "
                "rendering_kwargs['sr_input_resolution']")


def _dataset(dataset_name, data, real_data, img_resolution, **synthetic_kw):
    from .dataset import ImageFolderDataset, SyntheticDataset

    if dataset_name == "synthetic":
        return SyntheticDataset(resolution=img_resolution, **synthetic_kw)
    if dataset_name == "folder" or data.endswith(".zip"):
        return ImageFolderDataset(path=data, resolution=img_resolution)
    return _paired_dataset(dataset_name, data, real_data, img_resolution)


@contextlib.contextmanager
def _stop_on_signals():
    """Within the block, SIGTERM and SIGINT set the yielded flag (the loop
    finishes its step, checkpoints and exits) instead of killing the run."""
    import signal

    stop_requested = {"flag": False}

    def _request_stop(signum, frame):
        stop_requested["flag"] = True
        print(f"signal {signum}: finishing step, checkpointing, exiting...")

    prev = {s: signal.signal(s, _request_stop) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield stop_requested
    finally:
        for s, h in prev.items():
            signal.signal(s, h)


def _tb_writer(run_dir):
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(run_dir)
    except Exception as err:  # noqa: BLE001 - TensorBoard is optional
        print("Skipping tfevents export:", err)
        return None


def _rendering_kwargs(preset_cfg, gen_pose_cond, c_scale, sr_noise_mode, density_reg,
                      decoder_lr_mul, sr_module):
    from ..models.triplane import DEFAULT_RENDERING_KWARGS

    rk = dict(DEFAULT_RENDERING_KWARGS)
    rk.update(preset_cfg)
    rk.update(c_gen_conditioning_zero=not gen_pose_cond, c_scale=c_scale,
              superresolution_noise_mode=sr_noise_mode, density_reg=density_reg,
              decoder_lr_mul=decoder_lr_mul)
    if sr_module:
        rk["superresolution_module"] = sr_module
    return rk


def _resume(state, path, disc):
    """Load a full-state checkpoint of either package (`training-state-
    latest.npz`: every module, both Adam states and cur_nimg), or a network
    snapshot of either package as the JAX CLI resumes one: G_ema into G and
    G_ema, E's parameters (its BN statistics stay at init) and D, each leaf
    that the snapshot has at the same shape (`checkpoint.copy_params`: the
    others keep their init values, so an EG3D snapshot, whose D is the dual
    D, starts G-NeRF training). Returns the best SSIM the full state's
    config recorded (-100 without one), else None."""
    from ..utils import checkpoint as ckpt_lib
    from .train_loop import load_train_state

    trees, _ = ckpt_lib.load_checkpoint(path)
    if "train_state" in trees or "train_state_torch" in trees:
        _, _, best = load_train_state(path, state)
        return best
    if "G_ema" in trees:
        ckpt_lib.copy_params(state.g, trees["G_ema"])
        ckpt_lib.copy_params(state.g_ema, trees["G_ema"])
    if "E" in trees:
        ckpt_lib.copy_params(state.enc, trees["E"], keys=ckpt_lib.encoder_trees(state.enc)["E"])
    if "D" in trees and disc is not None:
        ckpt_lib.copy_params(disc, trees["D"])
    return None


def run_training(
    outdir: str,
    dataset_name: str = "synthetic",
    data: str = "",
    real_data: str = "",
    batch: int = 8,
    glr: float = 1e-3,
    dlr: float = 8e-6,
    gamma: float = 1.0,
    kimg: int = 4000,
    tick: int = 2,
    snap: int = 50,
    seed: int = 0,
    z_dim: int = 512,
    w_dim: int = 512,
    train_gen: bool = False,
    train_en: bool = True,
    gan_depth: bool = True,
    resume: str = "",
    dry_run: bool = False,
    gen_pose_cond: bool = False,
    c_scale: float = 1.0,
    sr_module: str = "",
    sr_noise_mode: str = "none",
    density_reg: float = 0.25,
    decoder_lr_mul: float = 1.0,
    objective: str = "gnerf",
    lpips_weights: str = "",
    dtype: str = "fp32",
    aug: str = "noaug",
    aug_p: float = 0.0,
    ada_target: float = 0.6,
    ada_kimg: float = 500.0,
    ray_shards: int = 1,
    freezed: int = 0,
    neural_rendering_resolution_final: int = 0,
    neural_rendering_resolution_fade_kimg: float = 1000.0,
    style_mixing_prob: float = 0.0,
    preset: str = "",
    density_reg_every: int = 4,
    d_reg_interval: int = 16,
    chain: int = 1,
    chain_dreg_split: bool = False,
    device=None,
):
    """The training run of `objective` (gnerf or eg3d); the JAX CLI's
    options plus `device`. Returns the run directory (None for a dry run
    and on ranks other than 0)."""
    from ..parallel import init_distributed, make_mesh, process_info
    from ..utils.device import resolve_device
    from .train_loop import TrainConfig, config_dict

    if objective not in ("gnerf", "eg3d"):
        raise ValueError(f"unknown --objective {objective!r} (expected gnerf or eg3d)")
    if aug not in ("noaug", "ada", "fixed"):
        raise ValueError(f"unknown --aug {aug!r} (expected noaug, ada or fixed)")
    if int(chain) != 1:
        raise ValueError("--chain > 1 is the JAX package's dispatch workaround and is not "
                         "ported: one step is one Python call here")
    device = resolve_device(device)
    init_distributed(device)
    rank, world = process_info()
    ray_shards = int(ray_shards)
    if ray_shards < 1 or world % ray_shards:
        raise ValueError(f"--ray_shards {ray_shards} must divide device count {world}")
    if batch % (world // ray_shards):
        raise ValueError(f"batch {batch} not divisible by {world // ray_shards} data shards")

    preset_cfg = RENDERING_PRESETS[preset or dataset_name]
    rendering_kwargs = _rendering_kwargs(preset_cfg, gen_pose_cond, c_scale, sr_noise_mode,
                                         density_reg, decoder_lr_mul, sr_module)
    img_resolution = preset_cfg["image_resolution"]
    cfg = TrainConfig(total_kimg=kimg, kimg_per_tick=tick, batch_size=batch, glr=glr,
                      dlr=dlr, r1_gamma=gamma, gan_depth=gan_depth, train_en=train_en,
                      train_gen=train_gen, snapshot_ticks=snap, random_seed=seed,
                      dtype=torch.bfloat16 if dtype == "bf16" else torch.float32)
    rk_json = {k: (list(v) if isinstance(v, tuple) else v) for k, v in rendering_kwargs.items()}
    options = {
        "dataset_name": dataset_name,
        "preset": preset or dataset_name,
        "config": config_dict(cfg),
        "generator": {"z_dim": z_dim, "w_dim": w_dim, "img_resolution": img_resolution,
                      "rendering_kwargs": rk_json},
        "rendering_kwargs": rk_json,
        "num_devices": world,
        "ray_shards": ray_shards,
        "lpips_pretrained": bool(lpips_weights),
        "aug": {"mode": aug, "p0": aug_p, "ada_target": ada_target, "ada_kimg": ada_kimg},
        "neural_rendering_resolution_final": neural_rendering_resolution_final or None,
        "neural_rendering_resolution_fade_kimg": neural_rendering_resolution_fade_kimg,
        "style_mixing_prob": style_mixing_prob,
        "held_out_scheme": "md5-basename-v1",
        "num_processes": world,
    }
    if rank == 0:
        print(json.dumps(options, indent=2))
    if dry_run:
        if rank == 0:
            print("Dry run -- exiting.")
        return None

    mesh = make_mesh(data=world // ray_shards, rays=ray_shards)
    # Rank-gated I/O (the reference gates on rank 0, `training_loop.py:152,161`).
    run_dir, logger = None, None
    if rank == 0:
        from ..utils.logger import Logger

        run_dir = pick_run_dir(outdir, dataset_name)
        with open(os.path.join(run_dir, "training_options.json"), "w") as f:
            json.dump(options, f, indent=2)
        logger = Logger(os.path.join(run_dir, "log.txt"))  # tee stdout / stderr
    try:
        if objective == "eg3d":
            eg3d = dict(freezed=freezed, style_mixing_prob=style_mixing_prob,
                        neural_rendering_resolution_final=neural_rendering_resolution_final,
                        neural_rendering_resolution_fade_kimg=(
                            neural_rendering_resolution_fade_kimg),
                        density_reg_every=density_reg_every, d_reg_interval=d_reg_interval,
                        aug=aug, aug_p=aug_p, ada_target=ada_target, ada_kimg=ada_kimg)
            run_dir = _train_eg3d(run_dir, options, cfg, rendering_kwargs, img_resolution,
                                  dataset_name, data, real_data, z_dim, w_dim, resume, eg3d,
                                  device, mesh)
        else:
            run_dir = _train(run_dir, options, cfg, rendering_kwargs, img_resolution,
                             dataset_name, data, real_data, z_dim, w_dim, lpips_weights,
                             resume, device, mesh)
    finally:
        if logger is not None:
            logger.close()
    _any_rank(False, mesh, device)  # the ranks leave once rank 0 has written
    return run_dir


def _shard_batches(dataset, batch: int, seed: int, mesh):
    """This rank's batches: its data shard's rows of each global batch
    (reference `batch_gpu = batch // gpus`, train.py:273); the ranks of a
    ray group read the same rows."""
    from .dataset import data_iterator

    data, data_rank = (mesh.data, mesh.data_rank) if mesh is not None else (1, 0)
    return data_iterator(dataset, batch_size=batch // data, rank=data_rank,
                         num_replicas=data, seed=seed)


def _any_rank(flag: bool, mesh, device) -> bool:
    """Whether `flag` is set on any rank of the mesh: a collective, so every
    rank waits here for the others (a stop asked for on one rank stops all
    after the same step)."""
    if mesh is None:
        return flag
    import torch.distributed as dist

    flags = torch.tensor([float(flag)], device=device)
    dist.all_reduce(flags, group=mesh.group)
    return bool(flags.item() > 0)


def _is_full_state(path: str) -> bool:
    """Whether `path` is a full-state checkpoint of either package (which
    fills every module of the run), read from its key names alone."""
    with np.load(path) as data:
        return any(k.startswith(("train_state/", "train_state_torch/")) for k in data.files)


def _build(make, device, draw: bool):
    """`make(device)` when `draw`; else the module built on `meta` (nothing
    drawn) with uninitialised storage on `device`, for a full-state resume
    to fill."""
    from ..utils.checkpoint import materialize

    return make(device) if draw else materialize(make(torch.device("meta")), device)


def gnerf_networks(seed: int, cfg, z_dim: int, w_dim: int, img_resolution: int,
                   rendering_kwargs: dict, lpips_weights: str = "", device=None,
                   draw: bool = True):
    """(G, E, the depth D or None, the LPIPS VGG, pretrained) of a G-NeRF
    run, from the keys of the JAX `init_train_state(..., PRNGKey(seed))`:
    split(PRNGKey(seed), 4) into E, G, D and the VGG (random unless
    `lpips_weights`). With `draw` False nothing is drawn (`_build`)."""
    from .. import models
    from ..utils import prng
    from . import losses

    k_e, k_g, k_d, k_v = prng.split(prng.PRNGKey(seed), 4)
    g = _build(lambda dev: models.TriPlaneGenerator(
        z_dim=z_dim, w_dim=w_dim, img_resolution=img_resolution,
        rendering_kwargs=rendering_kwargs, device=dev, key=k_g), device, draw)
    enc = _build(lambda dev: models.ResNeXt50Encoder(out_dim=z_dim, device=dev, key=k_e),
                 device, draw)
    disc = (_build(lambda dev: models.Discriminator(
        c_dim=25, img_resolution=cfg.neural_rendering_resolution, img_channels=1, device=dev,
        key=k_d), device, draw) if cfg.gan_depth else None)
    if lpips_weights:
        vgg, pretrained = losses.lpips_params_or_warn(lpips_weights, device=device)
    else:
        vgg, pretrained = _build(lambda dev: losses.lpips_params_or_warn(
            None, device=dev, key=k_v)[0], device, draw), False
    return g, enc, disc, vgg, pretrained


def eg3d_networks(seed: int, z_dim: int, w_dim: int, img_resolution: int,
                  rendering_kwargs: dict, device=None, draw: bool = True):
    """(G, the dual D) of an EG3D run, from the keys of the JAX
    `init_eg3d_state(..., PRNGKey(seed))`: split(PRNGKey(seed)) into G and
    D. With `draw` False nothing is drawn (`_build`)."""
    from .. import models
    from ..utils import prng

    k_g, k_d = prng.split(prng.PRNGKey(seed))
    g = _build(lambda dev: models.TriPlaneGenerator(
        z_dim=z_dim, w_dim=w_dim, img_resolution=img_resolution,
        rendering_kwargs=rendering_kwargs, device=dev, key=k_g), device, draw)
    disc = _build(lambda dev: models.DualDiscriminator(
        c_dim=25, img_resolution=img_resolution, img_channels=3, device=dev, key=k_d),
        device, draw)
    return g, disc


def _train(run_dir, options, cfg, rendering_kwargs, img_resolution, dataset_name, data,
           real_data, z_dim, w_dim, lpips_weights, resume, device, mesh):
    from ..parallel import put_replicated
    from ..utils.stats import Collector
    from .dataset import collate
    from .train_loop import init_train_state, make_train_step, save_snapshot, save_train_state

    seed, batch = cfg.random_seed, cfg.batch_size
    # kimg and tick may be fractions when called from Python (a test's
    # one-step run); the loop counts whole images.
    total_nimg = int(round(cfg.total_kimg * 1000))
    tick_nimg = max(int(round(cfg.kimg_per_tick * 1000)), 1)
    g, enc, disc, vgg, lpips_pretrained = gnerf_networks(
        seed, cfg, z_dim, w_dim, img_resolution, rendering_kwargs, lpips_weights, device,
        draw=not (resume and _is_full_state(resume)))
    state = init_train_state(g, enc, disc, vgg, cfg)
    best_ssim = -100.0
    lead = run_dir is not None
    if resume:
        resumed = _resume(state, resume, disc)
        if resumed is not None:
            best_ssim = resumed
        if lead:
            print(f"Resumed from {resume} at kimg {state.cur_nimg / 1000:.1f}")
    put_replicated((state.g, state.g_ema, state.enc, state.disc, state.vgg), mesh)
    train_step = make_train_step(cfg, mesh=mesh)

    dataset = _dataset(dataset_name, data, real_data, img_resolution,
                       depth_resolution=cfg.neural_rendering_resolution)
    # Seeded from the resume position: a resumed run walks a fresh order.
    batches = _shard_batches(dataset, batch, seed + state.cur_nimg, mesh)

    def to_device(host):
        return {k: torch.from_numpy(np.asarray(v)).to(device, non_blocking=True)
                for k, v in host.items()}

    tb_writer = None
    if lead:  # validation, logs and snapshots: rank 0's alone
        validate_batch = make_validator(state.g_ema, state.enc, vgg=vgg,
                                        lpips_pretrained=lpips_pretrained)
        val_items = [dataset[i] for i in range(min(4, len(dataset)))]
        val_batch = to_device({k: v for k, v in collate(val_items).items()
                               if k in ("condition_image", "loss_image", "loss_c")})
        save_image_grid(val_batch["condition_image"].float().cpu().numpy(),
                        os.path.join(run_dir, "id_images.png"), drange=(0, 255))
        tb_writer = _tb_writer(run_dir)
    collector = Collector()
    cur_nimg = state.cur_nimg
    tick_idx = cur_nimg // tick_nimg
    tick_start = start = time.time()
    pending = next(batches)
    if lead:
        print(f"Training for {cfg.total_kimg} kimg in {run_dir} ...")
    try:
        with _stop_on_signals() as stop_requested:
            while cur_nimg < total_nimg and not _any_rank(stop_requested["flag"], mesh, device):
                _, stats = train_step(state, to_device(pending), step_key(seed, cur_nimg))
                pending = next(batches)
                cur_nimg = state.cur_nimg
                for name, value in stats.items():
                    collector.report(name, value)
                if cur_nimg >= (tick_idx + 1) * tick_nimg or cur_nimg >= total_nimg:
                    tick_idx = max(tick_idx + 1, cur_nimg // tick_nimg)
                    if not lead:
                        continue
                    now = time.time()
                    fields = collector.update()
                    msg = " ".join(f"{k.split('/')[-1]} {v['mean']:.4f}" for k, v in fields.items())
                    val_ssim, val_psnr, val_lpips, val_images = validate_batch(val_batch)
                    val_ssim, val_psnr = float(val_ssim), float(val_psnr)
                    val_metrics = {"Metrics/val_ssim": val_ssim, "Metrics/val_psnr": val_psnr}
                    if lpips_pretrained:  # never log a random-VGG "perceptual" curve
                        val_metrics["Metrics/val_lpips"] = float(val_lpips)
                    print(f"tick {tick_idx:<5d} kimg {cur_nimg / 1000:<8.1f} "
                          f"sec/tick {now - tick_start:<7.1f} val_ssim {val_ssim:.4f} "
                          f"val_psnr {val_psnr:.2f} {msg}")
                    collector.write_jsonl(os.path.join(run_dir, "stats.jsonl"),
                                          extra={"kimg": cur_nimg / 1000, **val_metrics})
                    if tb_writer is not None:
                        for name, v in fields.items():
                            tb_writer.add_scalar(name, v["mean"], global_step=cur_nimg)
                        for name, v in val_metrics.items():
                            tb_writer.add_scalar(name, v, global_step=cur_nimg)
                        tb_writer.flush()
                    is_best = val_ssim > best_ssim
                    best_ssim = max(best_ssim, val_ssim)
                    try:  # a full disk costs snapshots, not the run
                        if is_best:
                            save_snapshot(os.path.join(run_dir, "network-snapshot-best.npz"),
                                          state, config=options)
                        save_snapshot(os.path.join(run_dir, "network-snapshot-latest.npz"),
                                      state, config=options)
                        save_train_state(os.path.join(run_dir, "training-state-latest.npz"), state,
                                         config=options, best_ssim=best_ssim)
                        save_image_grid(val_images.float().cpu().numpy(),
                                        os.path.join(run_dir, f"fakes-{cur_nimg // 1000:06d}.png"))
                        if tick_idx % cfg.snapshot_ticks == 0:
                            save_snapshot(os.path.join(
                                run_dir, f"network-snapshot-{cur_nimg // 1000:06d}.npz"),
                                state, config=options)
                    except OSError as err:
                        print(f"WARNING: snapshot write failed: {err}")
                    tick_start = now
    finally:
        if tb_writer is not None:
            tb_writer.close()
    if not lead:
        return None
    try:
        save_snapshot(os.path.join(run_dir, "network-snapshot-final.npz"), state,
                      config=options)
        save_train_state(os.path.join(run_dir, "training-state-latest.npz"), state,
                         config=options, best_ssim=best_ssim)
    except OSError as err:
        print(f"WARNING: final snapshot failed: {err}")
    if cur_nimg < total_nimg:
        print(f"preempted at {cur_nimg / 1000:.1f} kimg — full state saved; resume with "
              f"--resume {os.path.join(run_dir, 'training-state-latest.npz')}")
    print(f"done in {time.time() - start:.1f}s")
    return run_dir


def eg3d_loss_config(rendering_kwargs, train_cfg, neural_rendering_resolution: int,
                     aug_p: float = 0.0, freezed: int = 0, style_mixing_prob: float = 0.0,
                     neural_rendering_resolution_final: int = 0,
                     neural_rendering_resolution_fade_kimg: float = 1000.0,
                     density_reg_every: int = 4, d_reg_interval: int = 16,
                     aug: str = "noaug", ada_target: float = 0.6, ada_kimg: float = 500.0):
    """The EG3DLossConfig the CLI trains with, built as the JAX CLI builds
    it: the regularizer and blur knobs from the rendering kwargs, gamma,
    batch and dtype from the G-NeRF TrainConfig, the rest from the flags.
    As in the JAX CLI, --glr and --dlr do not reach it (it keeps 0.0025 and
    0.002)."""
    from .eg3d_loss import EG3DLossConfig

    rk = rendering_kwargs
    return EG3DLossConfig(
        r1_gamma=train_cfg.r1_gamma, neural_rendering_resolution=neural_rendering_resolution,
        density_reg=rk.get("density_reg", 0.25), gpc_reg_prob=rk.get("gpc_reg_prob", 0.5),
        gpc_reg_fade_kimg=rk.get("gpc_reg_fade_kimg", 1000.0),
        blur_init_sigma=rk.get("blur_init_sigma", 0.0),
        blur_fade_kimg=rk.get("blur_fade_kimg", train_cfg.batch_size * 200 / 32),
        aug=aug, aug_p=aug_p, ada_target=ada_target, ada_kimg=ada_kimg,
        freeze_d_layers=freezed,
        neural_rendering_resolution_final=neural_rendering_resolution_final or None,
        neural_rendering_resolution_fade_kimg=neural_rendering_resolution_fade_kimg,
        style_mixing_prob=style_mixing_prob, dtype=train_cfg.dtype,
        g_reg_interval=int(density_reg_every), d_reg_interval=int(d_reg_interval))


def eg3d_loop_step(state, phases, cfg, host_batch: dict, seed: int, aug_p: float, ada, *,
                   batch: int, device, mesh=None) -> tuple[dict, float]:
    """One step of the EG3D loop at `state.cur_nimg`, as the CLI takes it:
    Gmain + Dmain every step, Greg when sched_idx = cur_nimg // batch is a
    multiple of g_reg_interval, Dreg when it is one of d_reg_interval.

    `phases` is (main, greg, dreg) of `make_eg3d_phase_steps` (greg and
    dreg None: the fused `make_eg3d_train_step` as main). `host_batch` is a
    collated dataset batch (this rank's rows under `mesh`) and `batch` the
    global batch. The step's key `step_key(seed, cur_nimg)` splits into z's
    and the phases' (kz, ks); z is normal(fold_in(kz, 0)) at the global
    batch, each rank keeping its rows (the JAX single-process mesh run,
    whose process index is 0); Gmain + Dmain run on ks, Greg on
    fold_in(ks, 1), Dreg on fold_in(ks, 2), under the blur and render
    resolution of the schedules at cur_nimg and the ADA strength `aug_p`.
    Returns (the phases' stats, the p the ADA controller `ada` gives the
    next step)."""
    from ..parallel import local_rows
    from ..utils import prng
    from .eg3d_loss import blur_kernel_size, blur_sigma_schedule, neural_resolution_schedule

    main_fn, greg_fn, dreg_fn = phases
    cur_nimg = state.cur_nimg
    kz, ks = prng.split(step_key(seed, cur_nimg))
    c = torch.from_numpy(np.asarray(host_batch["loss_c"], np.float32)).to(device)
    real = torch.from_numpy(np.asarray(host_batch["loss_image"])).to(device)
    # z for the global batch, as world 1 draws it; this rank's rows.
    z = local_rows(prng.normal(prng.fold_in(kz, 0), (batch, state.g.z_dim), device=device),
                   mesh)
    gan_batch = {"z": z, "c": c, "real_image": real.float() / 127.5 - 1.0, "real_c": c}
    sigma = blur_sigma_schedule(cur_nimg, cfg)
    size = blur_kernel_size(sigma)
    sigma = max(sigma, 1e-8)
    res = neural_resolution_schedule(cur_nimg, cfg)
    sched_idx = cur_nimg // batch
    _, stats = main_fn(state, gan_batch, ks, sigma, aug_p, blur_size=size, res=res)
    if greg_fn is not None and sched_idx % max(cfg.g_reg_interval, 1) == 0:
        stats.update(greg_fn(state, gan_batch, prng.fold_in(ks, 1))[1])
    if dreg_fn is not None and sched_idx % max(cfg.d_reg_interval, 1) == 0:
        stats.update(dreg_fn(state, gan_batch, prng.fold_in(ks, 2), sigma, aug_p,
                             blur_size=size, res=res)[1])
    return stats, ada.report(stats["Loss/signs/real"])


def _train_eg3d(run_dir, options, train_cfg, rendering_kwargs, img_resolution, dataset_name,
                data, real_data, z_dim, w_dim, resume, eg3d, device, mesh):
    """EG3D adversarial pretraining (z, c) -> image at the JAX loop's
    cadence, one `eg3d_loop_step` a step. Under `--aug ada` the controller
    averages 'Loss/signs/real' over each window of ada_interval steps and
    moves p with `ada_update_p` (a resumed run starts a fresh window, as
    the JAX loop does). Each tick writes
    `network-snapshot-latest.npz` (G_ema, G, D), every `--snap` ticks
    `network-snapshot-NNNNNN.npz`, and the full state with the live ADA p
    (`aug_p_live`) in its config; `--resume` restores both."""
    from ..parallel import put_replicated
    from ..utils import checkpoint as ckpt_lib
    from ..utils.stats import Collector
    from .eg3d_loss import (AdaController, init_eg3d_state, make_eg3d_phase_steps,
                            make_eg3d_train_step)
    from .train_loop import load_train_state, save_train_state

    seed, batch = train_cfg.random_seed, train_cfg.batch_size
    total_nimg = int(round(train_cfg.total_kimg * 1000))
    tick_nimg = max(int(round(train_cfg.kimg_per_tick * 1000)), 1)
    g, disc = eg3d_networks(seed, z_dim, w_dim, img_resolution, rendering_kwargs, device,
                            draw=not resume)
    cfg = eg3d_loss_config(rendering_kwargs, train_cfg, g.neural_rendering_resolution, **eg3d)
    # An interval <= 1 on both sides fuses the regularizers into every step.
    lazy = cfg.g_reg_interval > 1 or cfg.d_reg_interval > 1
    if lazy:
        main_fn, greg_fn, dreg_fn = make_eg3d_phase_steps(cfg, mesh=mesh)
    else:
        main_fn, greg_fn, dreg_fn = make_eg3d_train_step(cfg, mesh=mesh), None, None
    state = init_eg3d_state(g, disc, cfg, lazy=lazy)
    check_fade_sr_compat(g, cfg, img_resolution)
    cur_aug_p = float(cfg.aug_p)
    lead = run_dir is not None
    if resume:
        _, ckpt_cfg, _ = load_train_state(resume, state)
        if ckpt_cfg and "aug_p_live" in ckpt_cfg:
            cur_aug_p = float(ckpt_cfg["aug_p_live"])
        if lead:
            print(f"Resumed EG3D training state from {resume} at kimg "
                  f"{state.cur_nimg / 1000:.1f}")
    put_replicated((state.g, state.g_ema, state.disc), mesh)

    dataset = _dataset(dataset_name, data, real_data, img_resolution)
    batches = _shard_batches(dataset, batch, seed + state.cur_nimg, mesh)

    def snapshot(name):
        ckpt_lib.save_checkpoint(os.path.join(run_dir, name),
                                 {"G_ema": state.g_ema, "G": state.g, "D": state.disc},
                                 config=options)

    def save_state():
        save_train_state(os.path.join(run_dir, "training-state-latest.npz"), state,
                         config={**options, "aug_p_live": cur_aug_p})

    tb_writer = _tb_writer(run_dir) if lead else None
    collector = Collector()
    cur_nimg = state.cur_nimg
    tick_idx = cur_nimg // tick_nimg
    tick_start = start = time.time()
    pending = next(batches)
    ada = AdaController(cfg, batch, cur_aug_p)
    if lead:
        print(f"EG3D pretraining for {train_cfg.total_kimg} kimg in {run_dir} "
              f"(aug={cfg.aug}, p0={cur_aug_p}) ...")
    try:
        with _stop_on_signals() as stop_requested:
            while cur_nimg < total_nimg and not _any_rank(stop_requested["flag"], mesh, device):
                stats, next_aug_p = eg3d_loop_step(state, (main_fn, greg_fn, dreg_fn), cfg,
                                                   pending, seed, cur_aug_p, ada, batch=batch,
                                                   device=device, mesh=mesh)
                pending = next(batches)
                cur_nimg = state.cur_nimg
                for name, value in stats.items():
                    collector.report(name, value)
                collector.report("Progress/augment", cur_aug_p)
                cur_aug_p = next_aug_p
                if cur_nimg >= (tick_idx + 1) * tick_nimg or cur_nimg >= total_nimg:
                    tick_idx = max(tick_idx + 1, cur_nimg // tick_nimg)
                    if not lead:
                        continue
                    now = time.time()
                    fields = collector.update()
                    msg = " ".join(f"{k.split('/')[-1]} {v['mean']:.4f}"
                                   for k, v in fields.items())
                    print(f"tick {tick_idx:<4d} kimg {cur_nimg / 1000:<7.1f} "
                          f"sec/tick {now - tick_start:<7.1f} {msg}")
                    collector.write_jsonl(os.path.join(run_dir, "stats.jsonl"),
                                          extra={"kimg": cur_nimg / 1000})
                    if tb_writer is not None:
                        for name, v in fields.items():
                            tb_writer.add_scalar(name, v["mean"], global_step=cur_nimg)
                        tb_writer.flush()
                    try:  # a full disk costs snapshots, not the run
                        snapshot("network-snapshot-latest.npz")
                        snap = train_cfg.snapshot_ticks
                        if snap > 0 and tick_idx % snap == 0:
                            snapshot(f"network-snapshot-{cur_nimg // 1000:06d}.npz")
                        save_state()
                    except OSError as err:
                        print(f"WARNING: snapshot write failed: {err}")
                    tick_start = now
    finally:
        if tb_writer is not None:
            tb_writer.close()
    if not lead:
        return None
    try:
        snapshot("network-snapshot-final.npz")
        save_state()
    except OSError as err:
        print(f"WARNING: final snapshot failed: {err}")
    if cur_nimg < total_nimg:
        print(f"preempted at {cur_nimg / 1000:.1f} kimg — full state saved; resume with "
              f"--resume {os.path.join(run_dir, 'training-state-latest.npz')}")
    print(f"done in {time.time() - start:.1f}s")
    return run_dir


@click.command()
@click.option("--outdir", type=str, required=True)
@click.option("--dataset_name", type=str, default="synthetic")
@click.option("--data", type=str, default="")
@click.option("--real_data", type=str, default="")
@click.option("--batch", type=int, default=8)
@click.option("--glr", type=float, default=1e-3)
@click.option("--dlr", type=float, default=8e-6)
@click.option("--gamma", type=float, default=1.0)
@click.option("--kimg", type=int, default=4000)
@click.option("--tick", type=int, default=2)
@click.option("--snap", type=int, default=50)
@click.option("--seed", type=int, default=0)
@click.option("--z_dim", type=int, default=512)
@click.option("--train_gen", type=bool, default=False)
@click.option("--train_en", type=bool, default=True)
@click.option("--gan_depth", type=bool, default=True)
@click.option("--resume", type=str, default="")
@click.option("--dry-run", "dry_run", is_flag=True, default=False)
@click.option("--gen_pose_cond", type=bool, default=False)
@click.option("--c_scale", type=float, default=1.0)
@click.option("--sr_module", type=str, default="")
@click.option("--sr_noise_mode", type=str, default="none")
@click.option("--density_reg", type=float, default=0.25)
@click.option("--decoder_lr_mul", type=float, default=1.0)
@click.option("--dtype", type=click.Choice(["fp32", "bf16"]), default="fp32",
              help="forward-pass precision (optimizers and compositing stay fp32)")
@click.option("--lpips-weights", "lpips_weights", type=str, default="",
              help="converted vgg16.pt npz (python -m gnerf_tpu_torch.tools.convert_vgg16_lpips); "
                   "empty = RANDOM VGG features (loudly flagged)")
@click.option("--objective", type=click.Choice(["gnerf", "eg3d"]), default="gnerf",
              help="gnerf = encoder-inversion training; eg3d = EG3D GAN pretraining of G")
@click.option("--aug", type=click.Choice(["noaug", "ada", "fixed"]), default="noaug",
              help="EG3D-objective D augmentation (unused by gnerf): ada = the bgc pipe "
                   "with the adaptive p controller, fixed = the pipe at p = --aug_p")
@click.option("--aug_p", type=float, default=0.0)
@click.option("--freezed", type=int, default=0)
@click.option("--ray_shards", type=int, default=1,
              help="ranks that split each render's rays (must divide the world size)")
@click.option("--neural_rendering_resolution_final", type=int, default=0)
@click.option("--neural_rendering_resolution_fade_kimg", type=float, default=1000.0)
@click.option("--style_mixing_prob", type=float, default=0.0)
@click.option("--ada_target", type=float, default=0.6)
@click.option("--density_reg_every", type=int, default=4)
@click.option("--d_reg_interval", type=int, default=16)
@click.option("--preset", type=str, default="",
              help="rendering/SR/resolution recipe (a RENDERING_PRESETS key; default "
                   "= dataset_name's own); --dataset_name synthetic --preset ffhq trains "
                   "the full-width 512^2 / 8XDC / 48+48 shape on procedural data")
@click.option("--chain", type=int, default=1, help="only 1 (raises otherwise)")
@click.option("--chain_dreg_split", type=bool, default=False)
@click.option("--ada_kimg", type=float, default=500.0)
@click.option("--device", type=str, default=None,
              help="torch device; default CUDA (refuses to run without a card)")
def main(**kwargs):
    run_training(**kwargs)


if __name__ == "__main__":
    main()
