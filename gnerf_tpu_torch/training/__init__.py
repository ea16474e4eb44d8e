"""Training: datasets, losses, the G-NeRF and EG3D train steps and their CLI.

Port of `gnerf_tpu/training` for both objectives. Not ported yet: the ADA
augmentation pipeline, FID / KID and the Inception features (ROADMAP.md);
not ported at all: the EG3D objective's chained relay cycles."""

from .dataset import (
    Afhqv2Dataset,
    Afhqv2TestDataset,
    FFHQGenDataset,
    ImageFolderDataset,
    ShapeNetDataset,
    ShapeNetTestDataset,
    SyntheticDataset,
    TestDataset,
    collate,
    data_iterator,
    held_out_partition,
)
from .eg3d_loss import (
    EG3DLossConfig,
    EG3DState,
    init_eg3d_state,
    make_eg3d_phase_steps,
    make_eg3d_train_step,
)
from .losses import (
    VGG16LPIPS,
    d_logistic_loss,
    g_nonsaturating_loss,
    load_lpips,
    lpips_distance,
    lpips_embed,
    lpips_params_or_warn,
    lpips_training_distance,
    masked_mean,
    r1_penalty,
    ssim,
)
from .metrics import psnr
from .train_loop import (
    TrainConfig,
    TrainState,
    init_train_state,
    load_train_state,
    make_optimizers,
    make_train_step,
    save_snapshot,
    save_train_state,
)

__all__ = [
    "Afhqv2Dataset", "Afhqv2TestDataset", "EG3DLossConfig", "EG3DState", "FFHQGenDataset",
    "ImageFolderDataset", "ShapeNetDataset", "ShapeNetTestDataset", "SyntheticDataset",
    "TestDataset", "TrainConfig", "TrainState", "VGG16LPIPS", "collate", "d_logistic_loss",
    "data_iterator", "g_nonsaturating_loss", "held_out_partition", "init_eg3d_state",
    "init_train_state", "load_lpips", "load_train_state", "lpips_distance", "lpips_embed",
    "lpips_params_or_warn", "lpips_training_distance", "make_eg3d_phase_steps",
    "make_eg3d_train_step", "make_optimizers", "make_train_step", "masked_mean", "psnr",
    "r1_penalty", "save_snapshot", "save_train_state", "ssim",
]
