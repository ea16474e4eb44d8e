"""Bias + activation + gain + clamp, as plain PyTorch.

Port of `gnerf_tpu/ops/bias_act.py`: the activation registry maps name ->
(fn, default alpha, default gain); `def_gain=sqrt(2)` for relu/lrelu/swish
preserves signal variance in equalized-LR networks.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F


class ActivationSpec(NamedTuple):
    func: Callable
    def_alpha: float
    def_gain: float


activation_funcs: dict[str, ActivationSpec] = {
    "linear": ActivationSpec(lambda x, alpha: x, 0.0, 1.0),
    "relu": ActivationSpec(lambda x, alpha: F.relu(x), 0.0, float(np.sqrt(2))),
    "lrelu": ActivationSpec(lambda x, alpha: F.leaky_relu(x, alpha), 0.2, float(np.sqrt(2))),
    "tanh": ActivationSpec(lambda x, alpha: torch.tanh(x), 0.0, 1.0),
    "sigmoid": ActivationSpec(lambda x, alpha: torch.sigmoid(x), 0.0, 1.0),
    "elu": ActivationSpec(lambda x, alpha: F.elu(x), 0.0, 1.0),
    "selu": ActivationSpec(lambda x, alpha: F.selu(x), 0.0, 1.0),
    "softplus": ActivationSpec(lambda x, alpha: F.softplus(x), 0.0, 1.0),
    "swish": ActivationSpec(lambda x, alpha: torch.sigmoid(x) * x, 0.0, float(np.sqrt(2))),
}


def bias_act(
    x: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    dim: int = 1,
    act: str = "linear",
    alpha: Optional[float] = None,
    gain: Optional[float] = None,
    clamp: Optional[float] = None,
) -> torch.Tensor:
    """Add bias along `dim`, apply `act`, scale by `gain`, clamp to +-clamp."""
    if clamp is not None and clamp < 0:
        raise ValueError(f"clamp must be >= 0, got {clamp}")
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    if b is not None:
        if b.dim() != 1 or b.shape[0] != x.shape[dim]:
            raise ValueError(f"bias {tuple(b.shape)} does not fit dim {dim} of {tuple(x.shape)}")
        shape = [1] * x.dim()
        shape[dim] = -1
        x = x + b.to(x.dtype).reshape(shape)
    x = spec.func(x, alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x
