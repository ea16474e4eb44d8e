"""Draws of the threefry key stream: the hand-written kernel and its plain version.

`utils/prng.py` draws every value of `jax.random`'s partitionable stream
here: element i of a draw of `shape` comes from threefry2x32(key,
(hi32(i), lo32(i))) with i its flat index, so a block of the draw (`part`,
a rank's share) is the same function at the block's counters.
`threefry_draw` launches `csrc/threefry.cu` for a draw on CUDA (one launch
writes the words, or the uniform or normal values made from them) and runs
the plain version for a draw on the CPU: `threefry2x32` in int64 torch ops
(~170 elementwise ops), then the float steps in torch (XLA's FMA rounding
for uniform, its erfinv polynomial for normal). A draw on `meta` is its
shape only. There is no other route. JAX leaves threefry to XLA, so this
kernel replaces no TPU kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_MAX_DIMS = 8

Part = Optional[Mapping[int, Tuple[int, int]]]


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """The plain version: the Threefry-2x32 block cipher (20 rounds) of the
    counter words (x0, x1) under `key` (its two words as tensors or ints):
    JAX's `threefry2x32_p`, word for word. x0 and x1 are int64 tensors of
    one shape, overwritten; returns them."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0.add_(ks[0]).bitwise_and_(MASK)
    x1.add_(ks[1]).bitwise_and_(MASK)
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            torch.bitwise_left_shift(x1, r, out=t).bitwise_and_(MASK)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
    return x0, x1


def _threefry_ints(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    """`threefry2x32` of one counter in Python integers."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & MASK, (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def _threefry_np(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray):
    """`threefry2x32` of uint32 counter arrays in numpy (arrays wrap)."""
    ks = [np.uint32(k) for k in (k0, k1, k0 ^ k1 ^ _PARITY)]
    x0, x1 = x0 + ks[0], x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + np.uint32((int(ks[(i + 2) % 3]) + i + 1) & MASK)
    return x0, x1


def host_pairs(k0: int, k1: int, idx) -> torch.Tensor:
    """The word pairs [n, 2] (int64 in [0, 2^32)) of the key (k0, k1) at
    the flat indices `idx` (Python integers): a split or a fold_in, which
    the training steps make by the dozen and which ~170 torch ops would
    cost ~0.5 ms each. A few counters in Python integers (~7 us each),
    more in numpy's uint32 arithmetic (~80 us in all)."""
    idx = list(idx)
    if len(idx) <= 8:
        pairs = [_threefry_ints(k0, k1, i >> 32, i & MASK) for i in idx]
        return torch.tensor(pairs, dtype=torch.int64).reshape(-1, 2)
    i = np.asarray(idx, np.uint64)
    x0, x1 = _threefry_np(k0, k1, (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(MASK)).astype(np.uint32))
    return torch.from_numpy(np.stack([x0, x1], -1).astype(np.int64))


def block_shape(shape: tuple, part: Part) -> tuple:
    """The shape of the block `part` ({dim: (start, size)}) of a draw of
    `shape`."""
    out = list(shape)
    for d, (start, size) in (part or {}).items():
        if not (0 <= start and 0 <= size and start + size <= shape[d]):
            raise ValueError(f"part {d}: [{start}, {start + size}) is not inside {shape[d]}")
        out[d] = size
    return tuple(out)


def counters(shape: tuple, part: Part, device):
    """(hi32(i), lo32(i)) for the flat indices i of the block `part` of a
    draw of `shape` (all of it without a part), in the block's order."""
    if not part:
        i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    else:
        i = torch.zeros((), dtype=torch.int64, device=device)
        stride = 1
        for d in reversed(range(len(shape))):
            start, size = part.get(d, (0, shape[d]))
            ax = torch.arange(start, start + size, dtype=torch.int64, device=device) * stride
            i = i + ax.reshape((size,) + (1,) * (len(shape) - 1 - d))
            stride *= shape[d]
        i = i.reshape(-1)
    return i >> 32, i & MASK


def _to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) as int32 bit patterns."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _fma(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """a * b + c rounded once to float32, as XLA contracts it: the float64
    product of two floats is exact, and so is the sum while the operands'
    exponents lie within 29 bits of each other (every use here)."""
    return (a.double() * b + c).float()


def _uniform_floats(words: torch.Tensor, lo: float, span: float) -> torch.Tensor:
    """The top 23 bits of int32 words as a float in [1, 2), minus 1, scaled
    to [lo, lo + span) and clamped below at lo (lo and span float32 values)."""
    floats = (((words >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0
    return _fma(floats, span, lo).clamp_min(lo)


# XLA's single-precision erfinv (`ErfInv32`, after Giles): a degree-8
# polynomial in w - 2.5 for w = -log1p(-x^2) < 5, in sqrt(w) - 3 beyond.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, _ERFINV_SMALL[0], _ERFINV_LARGE[0])
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        # c + p * w with one rounding (XLA contracts it to an FMA)
        p = p.double().mul_(w).add_(torch.where(small, a, b)).float()
    return p * x


KINDS = {"bits": 0, "pairs": 1, "uniform": 2, "normal": 3}
# normal draws sqrt(2) * erfinv(uniform(-1 + ulp, 1)), as jax.random.normal.
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _bounds(kind: str, minval: float, maxval: float) -> tuple[float, float]:
    """(lo, span) of a float draw as float32 values: span = hi - lo rounded
    to float32, as JAX subtracts them."""
    if kind == "normal":
        minval, maxval = NORMAL_LO, 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return float(lo), float(hi - lo)


def _plain(key: torch.Tensor, shape: tuple, part: Part, device, kind: str, lo: float,
           span: float) -> torch.Tensor:
    """The plain version, in torch ops on `device`: int32 words (kind bits),
    word pairs [.., 2] (pairs) or float32 values, flat."""
    if key.device == device:
        kw = (key[0], key[1])
    elif key.device.type == "cpu":
        kw = (int(key[0]), int(key[1]))
    else:
        kw = tuple(key.to(device))
    if kind == "pairs" and device.type == "cpu":
        hi, lo = counters(shape, part, device)
        return _to_int32(host_pairs(int(kw[0]), int(kw[1]), ((hi << 32) | lo).tolist()))
    x0, x1 = threefry2x32(kw, *counters(shape, part, device))
    if kind == "pairs":
        return _to_int32(torch.stack([x0, x1], dim=-1))
    words = _to_int32(x0 ^ x1)
    if kind == "bits":
        return words
    u = _uniform_floats(words, lo, span)
    return u if kind == "uniform" else math.sqrt(2) * _erfinv(u)


@functools.lru_cache(maxsize=None)
def _library():
    from .cuda_build import load

    fn = load("threefry").threefry_launch
    fn.argtypes = ([ctypes.c_uint32] * 2 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int]
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def _kernel(key: torch.Tensor, shape: tuple, part: Part, device, kind: str, lo: float,
            span: float, out: torch.Tensor) -> torch.Tensor:
    if len(shape) > _MAX_DIMS:
        raise ValueError(f"threefry kernel draws take at most {_MAX_DIMS} dimensions")
    n = math.prod(block_shape(shape, part))
    if n == 0:
        return out
    if key.device.type == "cpu":
        (k0, k1), key_ptr = key.tolist(), None
    else:
        key = key.to(device=device, dtype=torch.int64).contiguous()
        k0, k1, key_ptr = 0, 0, key.data_ptr()
    dims = len(shape) if part else 0
    sizes = block_shape(shape, part)[:dims]
    strides = [math.prod(shape[d + 1:]) for d in range(dims)]
    starts = [part.get(d, (0, shape[d]))[0] for d in range(dims)] if part else []
    arr = ctypes.c_int64 * max(dims, 1)
    fn = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(k0, k1, key_ptr, dims, arr(*sizes), arr(*starts), arr(*strides), n,
                 KINDS[kind], lo, span, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err}")
    with _count_lock:
        threefry_draw.launches += 1
    return out


def threefry_draw(key: torch.Tensor, shape: tuple, part: Part = None, device=None,
                  kind: str = "bits", minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """A draw of `shape` under `key`, or its block `part`, on `device`
    (default the key's). `kind`: "bits" (int32 bit patterns of x0 ^ x1),
    "pairs" (both words, a trailing dimension of 2), "uniform" (float32 in
    [minval, maxval)) or "normal" (float32). A draw on CUDA launches the
    kernel (or raises), on the CPU takes the plain version, on `meta` is
    its shape. `threefry_draw.launches` counts the kernel's launches."""
    device = key.device if device is None else torch.device(device)
    out_shape = block_shape(shape, part)
    lo, span = _bounds(kind, minval, maxval)
    dtype = torch.int32 if kind in ("bits", "pairs") else torch.float32
    full = out_shape + ((2,) if kind == "pairs" else ())
    if device.type == "meta":
        return torch.empty(full, dtype=dtype, device=device)
    if device.type == "cuda":
        out = torch.empty(full, dtype=dtype, device=device)
        return _kernel(key, shape, part, device, kind, lo, span, out)
    if device.type != "cpu":
        raise ValueError(f"threefry draws run on cuda or cpu, not {device}")
    return _plain(key, shape, part, device, kind, lo, span).reshape(full)


_count_lock = threading.Lock()
threefry_draw.launches = 0
