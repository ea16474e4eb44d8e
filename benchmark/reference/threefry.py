"""Plain threefry2x32 key stream, as `jax.random` draws it in its
partitionable form: element i of a draw is threefry2x32(key, (hi32(i),
lo32(i))). A frozen copy of the plain int64 path of `gnerf_tpu_torch`'s
`utils/prng.py` and `ops/threefry.py` (no kernel, no blocks of a draw).
Keys are int64 tensors of two words in [0, 2^32).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _cipher(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def _words(key: torch.Tensor, n: int, device):
    i = torch.arange(n, dtype=torch.int64, device=device)
    k0, k1 = (int(v) for v in key.tolist())
    return _cipher(k0, k1, i >> 32, i & MASK)


def PRNGKey(seed: int) -> torch.Tensor:
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    x0, x1 = _words(key, num, "cpu")
    return torch.stack([x0, x1], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    k0, k1 = (int(v) for v in key.tolist())
    x0, x1 = _cipher(k0, k1, torch.tensor([0]), torch.tensor([int(data)]))
    return torch.tensor([int(x0), int(x1)], dtype=torch.int64)


def _uniform_floats(bits: torch.Tensor, lo: float, span: float) -> torch.Tensor:
    words = (bits - ((bits >> 31) << 32)).to(torch.int32)
    floats = (((words >> 9) & 0x7FFFFF) | 0x3F800000).view(torch.float32) - 1.0
    return (floats.double() * span + lo).float().clamp_min(lo)  # one rounding, as XLA's FMA


def uniform(key: torch.Tensor, shape, device) -> torch.Tensor:
    """float32 draws in [0, 1)."""
    shape = tuple(shape)
    x0, x1 = _words(key, math.prod(shape), device)
    return _uniform_floats(x0 ^ x1, 0.0, 1.0).reshape(shape)


_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's single-precision erfinv polynomial (Giles)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, _SMALL[0], _LARGE[0])
    for a, b in zip(_SMALL[1:], _LARGE[1:]):
        p = p.double().mul_(w).add_(torch.where(small, a, b)).float()
    return p * x


def normal(key: torch.Tensor, shape, device) -> torch.Tensor:
    """Standard normal float32 draws: sqrt(2) erfinv(uniform(-1 + ulp, 1))."""
    shape = tuple(shape)
    x0, x1 = _words(key, math.prod(shape), device)
    lo = _NORMAL_LO
    span = float(np.float32(1.0) - np.float32(lo))
    return (math.sqrt(2) * _erfinv(_uniform_floats(x0 ^ x1, lo, span))).reshape(shape)
