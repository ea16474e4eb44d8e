"""Low-level ops: plain PyTorch counterparts of `gnerf_tpu.ops`, plus the
hand-written CUDA kernels: the one that replaces the package's one Pallas
kernel, and those of the port's hot paths."""

from .bias_act import activation_funcs, bias_act
from .conv2d_resample import conv2d_resample
from .filtered_lrelu import filtered_lrelu
from .fma import fma
from .fused_decoder import osg_decode, osg_decode_ref
from .grid_sample import grid_sample_2d, grid_sample_3d
from .interpolate import interpolate_bilinear
from .modconv_epilogue import modconv_epilogue
from .triplane_sample import triplane_sample
from .upfirdn2d import (downsample2d, filter2d, setup_filter, upfirdn2d,
                        upfirdn2d_channels_last, upsample2d)

__all__ = [
    "activation_funcs", "bias_act", "conv2d_resample", "downsample2d", "filter2d",
    "filtered_lrelu", "fma", "grid_sample_2d", "grid_sample_3d", "interpolate_bilinear",
    "modconv_epilogue", "osg_decode", "osg_decode_ref", "setup_filter", "triplane_sample",
    "upfirdn2d", "upfirdn2d_channels_last", "upsample2d",
]
