"""Filtered leaky ReLU (the StyleGAN3 alias-free op), as plain PyTorch.

Port of `gnerf_tpu/ops/filtered_lrelu.py`: bias -> zero-insert upsample ->
FIR fu -> gain -> leaky ReLU -> clamp -> FIR fd -> downsample, composed of
`bias_act` and `upfirdn2d` (on CUDA its kernel, `csrc/upfirdn2d.cu`, and
its Function's gradient; on the CPU autograd through the plain version's
convolutions). Fusing the two FIR passes and the activation into one pass
is later work.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .bias_act import bias_act
from .upfirdn2d import _parse_padding, upfirdn2d


def filtered_lrelu(
    x: torch.Tensor,
    fu: Optional[torch.Tensor] = None,
    fd: Optional[torch.Tensor] = None,
    b: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    gain: float = float(np.sqrt(2)),
    slope: float = 0.2,
    clamp: Optional[float] = None,
    flip_filter: bool = False,
) -> torch.Tensor:
    if x.dim() != 4:
        raise ValueError(f"x must be [N, C, H, W], got {tuple(x.shape)}")
    px0, px1, py0, py1 = _parse_padding(padding)
    x = bias_act(x, b)
    x = upfirdn2d(x, fu, up=up, padding=(px0, px1, py0, py1), gain=up ** 2,
                  flip_filter=flip_filter)
    x = bias_act(x, act="lrelu", alpha=slope, gain=gain, clamp=clamp)
    return upfirdn2d(x, fd, down=down, flip_filter=flip_filter)
