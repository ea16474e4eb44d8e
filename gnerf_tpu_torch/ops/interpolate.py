"""Bilinear image resize with optional anti-aliasing (torch semantics).

Port of `gnerf_tpu/ops/interpolate.py`: the separable resampling weights are
dense [out, in] matrices (triangle filter, stretched for an antialiased
downscale; taps outside the image dropped and the rest renormalized), and
the resize is two small products. This equals
`F.interpolate(mode="bilinear", align_corners=False, antialias=...)` and
keeps the JAX package's rounding in bf16 (weights cast to the image dtype).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    """[out_size, in_size] row-stochastic bilinear resampling matrix."""
    scale = in_size / out_size
    filter_scale = scale if (antialias and scale > 1.0) else 1.0
    support = filter_scale
    out = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale - 0.5
        lo = int(np.ceil(center - support))
        hi = int(np.floor(center + support))
        js = np.arange(lo, hi + 1)
        w = np.maximum(0.0, 1.0 - np.abs(js - center) / filter_scale)
        valid = (js >= 0) & (js < in_size)
        js, w = js[valid], w[valid]
        np.add.at(out[i], js, w)
        s = out[i].sum()
        if s > 0:
            out[i] /= s
    out = out.astype(np.float32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=None)
def _weights(in_size: int, out_size: int, antialias: bool, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
    """`_resize_weights` as a tensor on `device`, made once: a copy from the
    host waits for the card, and a CUDA graph cannot hold one. Never evicted,
    since a captured graph reads it where it is. Never an inference tensor,
    so that autograd may save it."""
    with torch.inference_mode(False):
        return torch.tensor(_resize_weights(in_size, out_size, antialias), dtype=dtype,
                            device=device)


def interpolate_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                         antialias: bool = False) -> torch.Tensor:
    """Resize [N, C, H, W] -> [N, C, out_h, out_w]."""
    _, _, h, w = x.shape
    if h == out_h and w == out_w:
        return x
    mh = _weights(h, out_h, antialias, x.dtype, x.device)
    mw = _weights(w, out_w, antialias, x.dtype, x.device)
    x = torch.einsum("oh,nchw->ncow", mh, x)
    return torch.einsum("pw,ncow->ncop", mw, x)
