"""Tri-plane sampling: the hand-written kernel for the render's lookup
(`render/renderer.py::sample_from_planes`) on CUDA tensors without a
gradient: points [N, M, 3] scaled by 2 / box_warp in fp32 and projected to
(x, y), (x, z), (z, x), the planes [N, 3, C, H, W] sampled bilinearly
(align_corners=False, zeros outside) in fp32 with bf16 planes widened
exactly, the result rounded once to the planes' type as a contiguous
[N, 3, M, C]. The arithmetic is `F.grid_sample`'s CUDA kernel's: source
index ((u + 1) * W - 1) / 2, corner weights as products of distances, the
four products summed nw, ne, sw, se.

`triplane_sample` launches `csrc/triplane_sample.cu` (one pass over
channels-last planes, no fp32 intermediate) or raises. Its plain version is
`render/renderer.py::grid_sample_planes`, the `F.grid_sample` route, which
every other call takes: CPU tensors, and calls that need a gradient. It
records no gradient. `triplane_sample.launches` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from ..utils.profiling import span


@functools.lru_cache(maxsize=None)
def _library():
    from .cuda_build import load

    lib = load("triplane_sample")
    lib.triplane_sample_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                                           + [ctypes.c_float, ctypes.c_void_p])
    lib.triplane_sample_launch.restype = ctypes.c_int
    return lib


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launch(planes: torch.Tensor, coords: torch.Tensor, box_warp: float) -> torch.Tensor:
    """One launch of `csrc/triplane_sample.cu` on the planes' device and
    current stream."""
    n, _, c, h, w = planes.shape
    m = coords.shape[1]
    if planes.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the triplane_sample kernel takes float32 or bfloat16 planes, "
                         f"not {planes.dtype}")
    if coords.device != planes.device:
        raise ValueError(f"coordinates on {coords.device}, planes on {planes.device}")
    if c % 8 or c > 2048:
        raise ValueError(f"the triplane_sample kernel takes a multiple of 8 channels up to "
                         f"2048, not {c}")
    if n > 65535 or m >= 1 << 31 or (h + 1) * (w + 1) * c >= 1 << 31:
        raise ValueError(f"triplane_sample: planes {tuple(planes.shape)} at {m} points "
                         "need 64-bit indices")
    out = torch.empty((n, 3, m, c), dtype=planes.dtype, device=planes.device)
    if out.numel() == 0:
        return out
    table = planes.permute(0, 1, 3, 4, 2).contiguous()  # [N, 3, H, W, C]
    coords = coords.float().contiguous()
    args = (table.data_ptr(), coords.data_ptr(), out.data_ptr(), _KERNEL_DTYPES[planes.dtype],
            n, m, c, h, w, 2.0 / box_warp)  # rounded to fp32, as the plain version's
    # The span gives the launch a host op to be charged to, as an ATen op
    # would be (see `upfirdn2d`).
    with span("triplane_sample"), torch.cuda.device(planes.device):
        err = _library().triplane_sample_launch(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"triplane_sample kernel launch failed: CUDA error {err}")
    with _count_lock:
        triplane_sample.launches += 1
    return out


def triplane_sample(planes: torch.Tensor, coords: torch.Tensor, box_warp: float) -> torch.Tensor:
    """Bilinear samples of the planes [N, 3, C, H, W] at points [N, M, 3]:
    [N, 3, M, C] contiguous in the planes' dtype, by one launch of the
    kernel on the planes' CUDA device (or a ValueError). It records no
    gradient. `triplane_sample.launches` counts the kernel's launches."""
    if planes.dim() != 5 or planes.shape[1] != 3:
        raise ValueError(f"planes must be [N, 3, C, H, W], got {tuple(planes.shape)}")
    if coords.dim() != 3 or coords.shape[0] != planes.shape[0] or coords.shape[2] != 3:
        raise ValueError(f"coordinates must be [{planes.shape[0]}, M, 3], "
                         f"got {tuple(coords.shape)}")
    if planes.device.type != "cuda":
        raise ValueError(f"the triplane_sample kernel runs on CUDA tensors, not on "
                         f"{planes.device} (the plain version: renderer.grid_sample_planes)")
    return _launch(planes, coords, box_warp)


_count_lock = threading.Lock()
triplane_sample.launches = 0
