"""Fused multiply-add.

Port of `gnerf_tpu/ops/fma.py`, a plain function kept for API parity:
autograd handles the broadcasting that the reference's custom Function
unbroadcast by hand.
"""

import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return a * b + c
