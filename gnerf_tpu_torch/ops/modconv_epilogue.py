"""The epilogue of a modulated convolution: the hand-written kernel for the
channels-last route of `models/stylegan2.py` and its plain version.

On the convolution's output y [N, C, H, W], in this order: the
demodulation scale `dcoefs` [N, C], the noise ([N or 1, 1, H, W] or
[H, W], already times its strength), `bias_act` (bias [C], linear or
leaky ReLU, gain, clamp), and optionally `styles` [N, C], the next
convolution's input styles. Every vector is cast to y's dtype first, as
`modulated_conv2d` and `bias_act` cast them.

`modconv_epilogue` launches `csrc/modconv_epilogue.cu` for a CUDA tensor
(channels-last bf16, no gradient: one pass that writes the result over y,
equal to the plain chain bit for bit) or raises; a CPU tensor takes the
plain version (`_plain`: the chain of `modulated_conv2d` and `bias_act` as
the NCHW route runs it). `modconv_epilogue.launches` counts the kernel's
launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

from ..utils.profiling import span
from .bias_act import activation_funcs, bias_act

_ACTIVATIONS = {"linear": 0, "lrelu": 1}


def _plain(y, dcoefs, noise, bias, act, alpha, gain, clamp, styles) -> torch.Tensor:
    """The plain version: the NCHW route's chain, op by op."""
    if dcoefs is not None:
        y = y * dcoefs.to(y.dtype)[:, :, None, None]
    if noise is not None:
        y = y + noise.to(y.dtype)
    y = bias_act(y, bias, act=act, alpha=alpha, gain=gain, clamp=clamp)
    if styles is not None:
        y = y * styles.to(y.dtype)[:, :, None, None]
    return y


@functools.lru_cache(maxsize=None)
def _library():
    from .cuda_build import load

    lib = load("modconv_epilogue")
    lib.modconv_epilogue_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float,
           ctypes.c_void_p])
    lib.modconv_epilogue_launch.restype = ctypes.c_int
    return lib


def _vector(v: Optional[torch.Tensor], shape: tuple, name: str, like: torch.Tensor):
    """v as a contiguous tensor of y's dtype on y's device, checked to be
    `shape`; None stays None."""
    if v is None:
        return None
    if tuple(v.shape) != shape:
        raise ValueError(f"{name} {tuple(v.shape)} does not fit {tuple(like.shape)}: want {shape}")
    return v.to(device=like.device, dtype=like.dtype).contiguous()


def _launch(y, dcoefs, noise, bias, act, alpha, gain, clamp, styles) -> torch.Tensor:
    """One launch of `csrc/modconv_epilogue.cu` on y's device and current
    stream, over y."""
    n, c, h, w = y.shape
    if y.dtype != torch.bfloat16 or not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"the modconv_epilogue kernel takes channels-last bfloat16, not "
                         f"{y.dtype} with strides {y.stride()}")
    if c % 8 or c > 2048 or n > 65535 or y.data_ptr() % 16:
        raise ValueError(f"the modconv_epilogue kernel takes a multiple of 8 channels up to "
                         f"2048, N up to 65535, 16-byte aligned; not {tuple(y.shape)}")
    if act not in _ACTIVATIONS:
        raise ValueError(f"the modconv_epilogue kernel takes {sorted(_ACTIVATIONS)}, not {act!r}")
    dcoefs = _vector(dcoefs, (n, c), "dcoefs", y)
    bias = _vector(bias, (c,), "bias", y)
    styles = _vector(styles, (n, c), "styles", y)
    if noise is not None:
        shape = tuple(noise.shape)
        if noise.dim() == 2:
            noise = noise[None, None]
        if noise.dim() != 4 or noise.shape[0] not in (1, n) or tuple(noise.shape[1:]) != (1, h, w):
            raise ValueError(f"noise {shape} does not fit {tuple(y.shape)}")
        noise = noise.to(device=y.device, dtype=y.dtype).reshape(-1, h * w).contiguous()
    # The bound as PyTorch's clamp holds it: rounded to the tensor's type.
    bound = None if clamp is None else float(torch.tensor(clamp, dtype=y.dtype))

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    args = (y.data_ptr(), ptr(dcoefs), ptr(noise), ptr(bias), ptr(styles),
            n, h * w, c, int(noise is not None and noise.shape[0] > 1),
            _ACTIVATIONS[act], alpha, int(gain != 1), gain, int(bound is not None),
            0.0 if bound is None else bound)
    # The span gives the launch a host op to be charged to, as an ATen op
    # would be (see `upfirdn2d`).
    with span("modconv_epilogue"), torch.cuda.device(y.device):
        err = _library().modconv_epilogue_launch(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"modconv_epilogue kernel launch failed: CUDA error {err}")
    with _count_lock:
        modconv_epilogue.launches += 1
    return y


def modconv_epilogue(y: torch.Tensor, dcoefs: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                     act: str = "linear", alpha: Optional[float] = None,
                     gain: Optional[float] = None, clamp: Optional[float] = None,
                     styles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`bias_act(y * dcoefs + noise, bias, act, alpha, gain, clamp) * styles`
    over the convolution's output y [N, C, H, W], each link rounded to y's
    dtype as the plain chain rounds it; `alpha` and `gain` default to the
    activation's. A CUDA tensor takes one launch of the kernel, which writes
    the result over y and returns y (or a ValueError); it records no
    gradient. A CPU tensor takes the plain version (a new tensor).
    `modconv_epilogue.launches` counts the kernel's launches."""
    if y.dim() != 4:
        raise ValueError(f"y must be [N, C, H, W], got {tuple(y.shape)}")
    if clamp is not None and clamp < 0:
        raise ValueError(f"clamp must be >= 0, got {clamp}")
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    if y.device.type != "cuda":
        return _plain(y, dcoefs, noise, bias, act, alpha, gain, clamp, styles)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (y, dcoefs, noise, bias, styles)):
        raise ValueError("the modconv_epilogue kernel records no gradient")
    return _launch(y, dcoefs, noise, bias, act, alpha, gain, clamp, styles)


_count_lock = threading.Lock()
modconv_epilogue.launches = 0
