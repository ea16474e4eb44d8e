"""Training: datasets, losses, the ADA pipe, the G-NeRF and EG3D train steps
and their CLI, PTI, and the evaluation metrics and CLI.

Port of `gnerf_tpu/training`; not ported: the EG3D objective's chained relay
cycles (one step is one Python call here)."""

from .augment import AugmentPipe
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
    BGC_SPEC,
    AdaController,
    EG3DLossConfig,
    EG3DState,
    ada_update_p,
    init_eg3d_state,
    make_augment_pipe,
    make_eg3d_phase_steps,
    make_eg3d_train_step,
)
from .inception import InceptionV3Features, load_inception
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
from .metrics import (
    feature_statistics,
    frechet_distance,
    frechet_feature_distance,
    make_inception_feature_fn,
    make_vgg_feature_fn,
    psnr,
    reconstruction_metrics,
)
from .pti import PTIConfig, init_pti_state, make_pti_step, morphed_w_code, project_w, run_pti
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
    "AdaController", "Afhqv2Dataset", "Afhqv2TestDataset", "AugmentPipe", "BGC_SPEC", "EG3DLossConfig",
    "EG3DState", "FFHQGenDataset", "ImageFolderDataset", "InceptionV3Features", "PTIConfig",
    "ShapeNetDataset", "ShapeNetTestDataset", "SyntheticDataset", "TestDataset", "TrainConfig",
    "TrainState", "VGG16LPIPS", "ada_update_p", "collate", "d_logistic_loss", "data_iterator",
    "feature_statistics", "frechet_distance", "frechet_feature_distance",
    "g_nonsaturating_loss", "held_out_partition", "init_eg3d_state", "init_pti_state",
    "init_train_state", "load_inception", "load_lpips", "load_train_state", "lpips_distance",
    "lpips_embed", "lpips_params_or_warn", "lpips_training_distance", "make_augment_pipe",
    "make_eg3d_phase_steps", "make_eg3d_train_step", "make_inception_feature_fn",
    "make_optimizers", "make_pti_step", "make_train_step", "make_vgg_feature_fn",
    "masked_mean", "morphed_w_code", "project_w", "psnr", "r1_penalty", "reconstruction_metrics",
    "run_pti", "save_snapshot", "save_train_state", "ssim",
]
