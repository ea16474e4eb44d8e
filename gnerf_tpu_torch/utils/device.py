"""Device selection and the fp32 precision policy."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    Raises when no card is present and no device was asked for, so a run
    never carries on on the CPU unnoticed. Under torchrun (LOCAL_RANK set)
    an unnumbered CUDA device is the local rank's card, made current. On
    CUDA it turns TF32 off for matmuls and cuDNN convolutions: fp32 means
    true fp32 here, as in the JAX package, which runs fp32 products at
    HIGHEST precision."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        if device.index is None and "LOCAL_RANK" in os.environ:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def module_device(module: torch.nn.Module,
                  device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device `module` lives on, which must be of the type the caller
    asked for (under `resolve_device`'s rules: CUDA unless named)."""
    want = resolve_device(device)
    have = next(module.parameters()).device
    if have.type != want.type:
        raise ValueError(f"the model lives on {have}, the call asks for {want}")
    return have


def place(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """Move a module that was just built to `device`. On `meta` (a load
    builds so: nothing drawn) it stays as built, its parameters on `meta`
    and its constant buffers (resample filters, ...) where they were made,
    for `utils.checkpoint.load_jax_params` to give storage and fill."""
    if device.type != "meta":
        module.to(device)
    return module
