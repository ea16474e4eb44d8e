"""2D convolution fused with FIR up/downsampling, as plain PyTorch.

Port of `gnerf_tpu/ops/conv2d_resample.py`, with the same three cases:

  up > 1:   upfirdn(up, f, gain=up^2) -> conv -> [optional FIR down]
  down > 1: FIR pad/filter -> strided conv
  else:     conv with symmetric padding (or explicit pad via upfirdn)

Padding is given w.r.t. the upsampled image. `flip_weight=False` flips the
kernel (true convolution), as `SynthesisLayer` asks for with `up > 1`.
"""

from __future__ import annotations

from typing import Optional

import torch

from .upfirdn2d import _get_filter_size, _parse_padding, conv2d, upfirdn2d


def _conv2d(x, w, stride=1, padding=0, groups=1, flip_weight=True):
    """Grouped NCHW conv. flip_weight=True -> correlation (torch conv2d)."""
    if not flip_weight and (w.shape[2] > 1 or w.shape[3] > 1):
        w = w.flip([2, 3])
    return conv2d(x, w.to(x.dtype), stride=stride, padding=padding, groups=groups)


def conv2d_resample(
    x: torch.Tensor,
    w: torch.Tensor,
    f: Optional[torch.Tensor] = None,
    up: int = 1,
    down: int = 1,
    padding=0,
    groups: int = 1,
    flip_weight: bool = True,
    flip_filter: bool = False,
) -> torch.Tensor:
    """Convolve [N, C, H, W] by [O, I // groups, kh, kw] with optional resampling."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError("x and w must be 4-D")
    kh, kw = w.shape[2], w.shape[3]
    fw, fh = _get_filter_size(f)
    px0, px1, py0, py1 = _parse_padding(padding)

    # Account for the implicit padding of the FIR resampling stages.
    if up > 1:
        px0 += (fw + up - 1) // 2
        px1 += (fw - up) // 2
        py0 += (fh + up - 1) // 2
        py1 += (fh - up) // 2
    if down > 1:
        px0 += (fw - down + 1) // 2
        px1 += (fw - down) // 2
        py0 += (fh - down + 1) // 2
        py1 += (fh - down) // 2

    if up > 1:
        x = upfirdn2d(x, f, up=up, padding=(px0, px1, py0, py1), gain=up ** 2,
                      flip_filter=flip_filter)
        x = _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        if down > 1:
            x = upfirdn2d(x, f, down=down, flip_filter=flip_filter)
        return x

    if down > 1:
        if kw == 1 and kh == 1:
            # A 1x1 conv commutes with the FIR downsample: downsample first.
            x = upfirdn2d(x, f, down=down, padding=(px0, px1, py0, py1), flip_filter=flip_filter)
            return _conv2d(x, w, groups=groups, flip_weight=flip_weight)
        x = upfirdn2d(x, f, padding=(px0, px1, py0, py1), flip_filter=flip_filter)
        return _conv2d(x, w, stride=down, groups=groups, flip_weight=flip_weight)

    if px0 == px1 and py0 == py1 and px0 >= 0 and py0 >= 0 and px0 == py0:
        return _conv2d(x, w, padding=px0, groups=groups, flip_weight=flip_weight)
    x = upfirdn2d(x, None, padding=(px0, px1, py0, py1))
    return _conv2d(x, w, groups=groups, flip_weight=flip_weight)
