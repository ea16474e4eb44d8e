"""Up-FIR-down 2D resampling: the hand-written kernel and its plain version.

Port of `gnerf_tpu/ops/upfirdn2d.py`: zero-insert upsample -> pad/crop ->
FIR filter (convolution unless `flip_filter`) scaled by `gain` -> keep
every `down`-th sample. Padding is given w.r.t. the upsampled image;
negative padding crops. The helpers `filter2d` / `upsample2d` /
`downsample2d` keep the reference padding conventions.

`upfirdn2d` launches `csrc/upfirdn2d.cu` for a CUDA tensor (one polyphase
pass, no zero-inserted or padded copy) or raises; a CPU tensor takes the
plain version (`_plain`: zero-insert, pad, depthwise `conv2d`). The
gradient is `_Upfirdn2d`: upfirdn2d again with up and down swapped, the
filter flipped and the padding derived, through the same Function, so it
is differentiable twice (R1), as the JAX op's `custom_vjp`.
`upfirdn2d.launches` counts the kernel's launches.

`upfirdn2d_channels_last` is the kernel's channels-last instance for the
modulated convolutions' up layers without a gradient (`models/stylegan2.py`,
the channels-last route): bf16 [N, H, W, C] up 2 through the 4x4 filter,
the convolution's input styles applied on the way in.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span


def _parse_scaling(scaling) -> tuple[int, int]:
    if isinstance(scaling, (int, np.integer)):
        scaling = [int(scaling), int(scaling)]
    sx, sy = scaling
    if sx < 1 or sy < 1:
        raise ValueError(f"scaling must be >= 1, got {scaling}")
    return int(sx), int(sy)


def _parse_padding(padding) -> tuple[int, int, int, int]:
    if isinstance(padding, (int, np.integer)):
        padding = [int(padding), int(padding)]
    padding = list(padding)
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    padx0, padx1, pady0, pady1 = padding
    return int(padx0), int(padx1), int(pady0), int(pady1)


def _get_filter_size(f: Optional[torch.Tensor]) -> tuple[int, int]:
    if f is None:
        return 1, 1
    return int(f.shape[-1]), int(f.shape[0])


def setup_filter(f, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1, separable: Optional[bool] = None,
                 device=None) -> torch.Tensor:
    """FIR filter for `upfirdn2d`: float32, normalized to unit DC gain.
    Accepts [taps] (separable if >= 8 taps), [h, w], a scalar or None."""
    if f is None:
        f = 1
    f = torch.as_tensor(f, dtype=torch.float32, device=device)
    if f.dim() == 0:
        f = f[None]
    if separable is None:
        separable = f.dim() == 1 and f.numel() >= 8
    if f.dim() == 1 and not separable:
        f = torch.outer(f, f)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip(list(range(f.dim())))
    return f * (gain ** (f.dim() / 2))


class _Conv2d(torch.autograd.Function):
    """F.conv2d with a backward made of a transposed convolution (input
    gradient) and a weight-gradient convolution (only when the weight needs
    one).

    The R1 penalty differentiates D's input gradient once more. Through
    F.conv2d's own backward that takes `_convolution_double_backward`, which
    forms a weight term even for a constant weight (the FIR filters), as a
    forward convolution whose kernel is the whole output gradient, and for
    a grouped convolution runs it once per group: together over half of a
    full-width training step (PERF.md, the train cell). Here the input
    gradient is an ordinary `conv_transpose2d`, whose own backward uses
    cuDNN's data- and weight-gradient kernels."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups)
        return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, groups = ctx.conf
        gx = gw = None
        if ctx.needs_input_grad[0]:
            extra = [x.shape[i] - ((gy.shape[i] - 1) * stride - 2 * padding + w.shape[i])
                     for i in (2, 3)]
            gx = F.conv_transpose2d(gy, w, stride=stride, padding=padding,
                                    output_padding=extra, groups=groups)
        if ctx.needs_input_grad[1]:
            gw = torch.nn.grad.conv2d_weight(x, w.shape, gy, stride=stride, padding=padding,
                                             groups=groups)
        return gx, gw, None, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0,
           groups: int = 1) -> torch.Tensor:
    """F.conv2d, through `_Conv2d` when autograd records it (training): the
    weight convolutions of `conv2d_resample` and `training/augment.py`, and
    the plain version's FIR convolutions."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv2d.apply(x, w, stride, padding, groups)
    return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)


def _plain(x: torch.Tensor, f: Optional[torch.Tensor], up: tuple, down: tuple,
           padding: tuple, flip_filter: bool, gain: float) -> torch.Tensor:
    """The plain version, differentiable through autograd (`conv2d`)."""
    if f is None:
        f = torch.ones([1, 1], dtype=torch.float32, device=x.device)
    (upx, upy), (downx, downy) = up, down
    padx0, padx1, pady0, pady1 = padding
    n, c, h, w = x.shape

    # Zero-insert after every sample.
    x = x.reshape(n, c, h, 1, w, 1)
    x = F.pad(x, [0, upx - 1, 0, 0, 0, upy - 1])
    x = x.reshape(n, c, h * upy, w * upx)
    # Pad, or crop for negative padding.
    x = F.pad(x, [max(padx0, 0), max(padx1, 0), max(pady0, 0), max(pady1, 0)])
    x = x[:, :, max(-pady0, 0): x.shape[2] - max(-pady1, 0),
          max(-padx0, 0): x.shape[3] - max(-padx1, 0)]

    f = (f * (gain ** (f.dim() / 2))).to(x.dtype)
    if not flip_filter:
        f = f.flip(list(range(f.dim())))
    f = f[None, None].repeat([c, 1] + [1] * f.dim())
    if f.dim() == 4:
        x = conv2d(x, f, groups=c)
    else:
        x = conv2d(x, f.unsqueeze(2), groups=c)
        x = conv2d(x, f.unsqueeze(3), groups=c)
    return x[:, :, ::downy, ::downx]


@functools.lru_cache(maxsize=None)
def _library():
    from .cuda_build import load

    lib = load("upfirdn2d")
    lib.upfirdn2d_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 16
                                     + [ctypes.c_float, ctypes.c_void_p])
    lib.upfirdn2d_launch.restype = ctypes.c_int
    lib.upfirdn2d_nhwc_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                                          + [ctypes.c_float, ctypes.c_void_p])
    lib.upfirdn2d_nhwc_launch.restype = ctypes.c_int
    return lib


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(x: torch.Tensor, f: Optional[torch.Tensor], up: tuple, down: tuple,
            padding: tuple, flip_filter: bool, gain: float) -> torch.Tensor:
    """One launch of `csrc/upfirdn2d.cu` on x's device and current stream."""
    if x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the upfirdn2d kernel takes float32 or bfloat16, not {x.dtype}")
    (upx, upy), (downx, downy) = up, down
    padx0, padx1, pady0, pady1 = padding
    fw, fh = _get_filter_size(f)
    n, c, h, w = x.shape
    oh = (h * upy + pady0 + pady1 - fh) // downy + 1
    ow = (w * upx + padx0 + padx1 - fw) // downx + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"upfirdn2d: the padded {h * upy}x{w * upx} image is smaller than "
                         f"the {fh}x{fw} filter")
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if max(n * c, h * w, oh * ow, h * upy, w * upx) >= 1 << 31:
        raise ValueError(f"upfirdn2d: {tuple(x.shape)} -> {tuple(y.shape)} needs 64-bit "
                         "indices within a plane")
    x = x.contiguous()
    if f is not None:
        f = f.to(device=x.device, dtype=torch.float32).contiguous()
    scale = float(gain ** ((2 if f is None else f.dim()) / 2))
    args = (x.data_ptr(), y.data_ptr(), 0 if f is None else f.data_ptr(),
            _KERNEL_DTYPES[x.dtype], n * c, h, w, oh, ow, upx, upy, downx, downy, padx0, pady0,
            fw, fh, int(f is not None and f.dim() == 1), int(flip_filter), scale)
    # The span gives the launch a host op to be charged to, as an ATen op
    # would be: in a profile its device time is counted in the spans around
    # the call (`sr`), not in the nearest enclosing `gnerf.` span.
    with span("upfirdn2d"), torch.cuda.device(x.device):
        err = _library().upfirdn2d_launch(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"upfirdn2d kernel launch failed: CUDA error {err}")
    with _count_lock:
        upfirdn2d.launches += 1
    return y


class _Upfirdn2d(torch.autograd.Function):
    """upfirdn2d with the gradient of the JAX op's `custom_vjp`: upfirdn2d of
    the output gradient with up and down swapped, the filter flipped and the
    padding derived, applied through this Function again, so that R1 can
    differentiate it once more. The filter takes no gradient."""

    @staticmethod
    def forward(ctx, x, f, up, down, padding, flip_filter, gain):
        y = _launch(x, f, up, down, padding, flip_filter, gain)
        ctx.save_for_backward(f)
        ctx.conf = (x.shape, y.shape, up, down, padding, flip_filter, gain)
        return y

    @staticmethod
    def backward(ctx, dy):
        (f,) = ctx.saved_tensors
        (_, _, ih, iw), (_, _, oh, ow), up, down, padding, flip_filter, gain = ctx.conf
        (upx, upy), (downx, downy) = up, down
        padx0, _, pady0, _ = padding
        fw, fh = _get_filter_size(f)
        p = (fw - padx0 - 1, iw * upx - ow * downx + padx0 - upx + 1,
             fh - pady0 - 1, ih * upy - oh * downy + pady0 - upy + 1)
        dx = _Upfirdn2d.apply(dy, f, down, up, p, not flip_filter, gain)
        return dx, None, None, None, None, None, None


def upfirdn2d(
    x: torch.Tensor,
    f: Optional[torch.Tensor],
    up: Union[int, Sequence[int]] = 1,
    down: Union[int, Sequence[int]] = 1,
    padding: Union[int, Sequence[int]] = 0,
    flip_filter: bool = False,
    gain: float = 1,
) -> torch.Tensor:
    """Pad, upsample, filter and downsample [N, C, H, W] images. A CUDA
    tensor launches the kernel (or raises); a CPU tensor takes the plain
    version. `upfirdn2d.launches` counts the kernel's launches."""
    if x.dim() != 4:
        raise ValueError(f"x must be [N, C, H, W], got {tuple(x.shape)}")
    if f is not None and f.dim() not in (1, 2):
        raise ValueError(f"f must be [taps] or [h, w], got {tuple(f.shape)}")
    args = (_parse_scaling(up), _parse_scaling(down), _parse_padding(padding),
            bool(flip_filter), float(gain))
    if x.device.type != "cuda":
        if x.device.type != "cpu":
            raise ValueError(f"upfirdn2d runs on cuda or cpu, not {x.device}")
        return _plain(x, f, *args)
    if f is not None and f.requires_grad:
        raise ValueError("upfirdn2d's kernel takes no gradient for the filter")
    return _Upfirdn2d.apply(x, f, *args)


_count_lock = threading.Lock()
upfirdn2d.launches = 0


def _styled(x: torch.Tensor, styles: Optional[torch.Tensor]) -> torch.Tensor:
    """x * styles [N, C], rounded to x's dtype, as `modulated_conv2d` scales
    its input."""
    return x if styles is None else x * styles.to(x.dtype)[:, :, None, None]


def upfirdn2d_channels_last(x: torch.Tensor, f: torch.Tensor, padding=0, gain: float = 1,
                            styles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`upfirdn2d(x * styles, f, up=2, padding=padding, gain=gain)` of
    channels-last bf16 images [N, C, H, W] through a 4x4 filter, without a
    gradient, as a channels-last tensor. `styles` [N, C], when given, scales
    the input first, rounded to bf16 as the plain chain's `x * styles`. A
    CUDA tensor takes one launch of the kernel's channels-last instance (or
    a ValueError), counted in `upfirdn2d.launches`; a CPU tensor takes the
    plain version."""
    if x.dim() != 4 or f is None or tuple(f.shape) != (4, 4):
        raise ValueError(f"upfirdn2d_channels_last takes [N, C, H, W] images and a 4x4 filter, "
                         f"not {tuple(x.shape)} and {None if f is None else tuple(f.shape)}")
    if styles is not None and tuple(styles.shape) != tuple(x.shape[:2]):
        raise ValueError(f"styles {tuple(styles.shape)} do not fit {tuple(x.shape)}")
    padding = _parse_padding(padding)
    if x.device.type != "cuda":
        y = _plain(_styled(x, styles), f, (2, 2), (1, 1), padding, False, float(gain))
        return y.contiguous(memory_format=torch.channels_last)
    n, c, h, w = x.shape
    padx0, padx1, pady0, pady1 = padding
    oh, ow = h * 2 + pady0 + pady1 - 3, w * 2 + padx0 + padx1 - 3
    if x.dtype != torch.bfloat16 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"upfirdn2d_channels_last's kernel takes channels-last bfloat16, not "
                         f"{x.dtype} with strides {x.stride()}")
    if c % 8 or c > 2048 or n > 65535 or x.data_ptr() % 16:
        raise ValueError(f"upfirdn2d_channels_last's kernel takes a multiple of 8 channels up "
                         f"to 2048, N up to 65535, 16-byte aligned; not {tuple(x.shape)}")
    if oh < 1 or ow < 1 or (oh + 2) // 2 > 65535 or max(h * w * c, oh * ow * c) >= 1 << 31:
        raise ValueError(f"upfirdn2d_channels_last: {tuple(x.shape)} at padding {padding} "
                         "is out of the kernel's range")
    if torch.is_grad_enabled() and (x.requires_grad or (styles is not None
                                                         and styles.requires_grad)):
        raise ValueError("upfirdn2d_channels_last records no gradient")
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    f = f.to(device=x.device, dtype=torch.float32).contiguous()
    s = None if styles is None else styles.to(device=x.device, dtype=x.dtype).contiguous()
    args = (x.data_ptr(), y.data_ptr(), f.data_ptr(), 0 if s is None else s.data_ptr(),
            n, h, w, c, oh, ow, padx0, pady0, float(gain))
    with span("upfirdn2d"), torch.cuda.device(x.device):
        err = _library().upfirdn2d_nhwc_launch(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"upfirdn2d channels-last kernel launch failed: CUDA error {err}")
    with _count_lock:
        upfirdn2d.launches += 1
    return y


def filter2d(x, f, padding=0, flip_filter=False, gain=1):
    """FIR-filter images; output is padded to match the input shape."""
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = (padx0 + fw // 2, padx1 + (fw - 1) // 2, pady0 + fh // 2, pady1 + (fh - 1) // 2)
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1):
    """Upsample images by `up` with FIR smoothing (output = input * up)."""
    upx, upy = _parse_scaling(up)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = (padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2)
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter, gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1):
    """Downsample images by `down` with FIR anti-aliasing."""
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = (padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
         pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2)
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter, gain=gain)
