"""A counter-based key stream equal to `jax.random`'s, so that a seed names
the same weights and draws in both packages.

The JAX package draws from threefry2x32 keys in the partitionable form
(`jax_threefry_partitionable`, JAX's default since 0.5): element i of a
draw is threefry2x32(key, (hi32(i), lo32(i))) with i the flat index, so a
draw depends only on its key and its shape. This module computes the same
words with torch integer ops:

- `PRNGKey(seed)` is [0, seed mod 2^32], as JAX's 32-bit mode gives it;
- `split(key, n)[i]` is threefry2x32(key, (0, i));
- `fold_in(key, d)` is threefry2x32(key, (0, d));
- `bits` is the xor of the two output words;
- `uniform` puts the top 23 bits in a float's mantissa in [1, 2), takes 1
  away, scales to [minval, maxval) and clamps below at minval;
- `normal` is sqrt(2) * erfinv(uniform(-1 + ulp, 1)) with XLA's
  single-precision erfinv polynomial (within an ulp or two of JAX's: its
  log1p differs from torch's in the last place).

A key is an int64 tensor of two words, each in [0, 2^32): torch's uint32
lacks most operators. Every word is computed on the key's device, so a key
on CUDA draws there and a key on `meta` draws nothing (the draw's shape
only: the load paths build their modules so).
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def PRNGKey(seed, device=None) -> torch.Tensor:
    """The key of an integer seed, as `jax.random.PRNGKey` gives it with
    64-bit types off: the seed as a signed 64-bit integer (OverflowError
    outside), cut to its low 32 bits. None is a ValueError and any other
    non-integer a TypeError, as there."""
    if seed is None:
        raise ValueError("None is not a valid PRNG key seed")
    if isinstance(seed, (bool, np.bool_)):
        seed = int(seed)
    if not isinstance(seed, (int, np.integer)):
        raise TypeError(f"PRNG key seed must be an integer; got {seed!r}")
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise OverflowError("Python int too large to convert to C long")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32, as XLA contracts it: the float64
    product of two floats is exact, and so is the sum while the operands'
    exponents lie within 29 bits of each other (every use here)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    (x0, x1) under `key`: JAX's `threefry2x32_p`, word for word. x0 and x1
    are int64 tensors of one shape, overwritten; returns them."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0.add_(ks[0]).bitwise_and_(_MASK)
    x1.add_(ks[1]).bitwise_and_(_MASK)
    t = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_MASK)
            torch.bitwise_left_shift(x1, r, out=t).bitwise_and_(_MASK)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(t).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_MASK)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(_MASK)
    return x0, x1


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)


def _counters(key: torch.Tensor, n: int):
    """(hi32(i), lo32(i)) for the flat indices i < n."""
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return i >> 32, i & _MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`num` new keys, [num, 2]."""
    x0, x1 = threefry2x32(key, *_counters(key, num))
    return torch.stack([x0, x1], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A new key from `key` and a 32-bit integer."""
    data = int(data)
    if not 0 <= data <= _MASK:
        raise OverflowError(f"fold_in data {data} does not fit in 32 unsigned bits")
    x0, x1 = threefry2x32(key, torch.zeros((), dtype=torch.int64, device=key.device),
                          torch.full((), data, dtype=torch.int64, device=key.device))
    return torch.stack([x0, x1])


def bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """Random 32-bit words of `shape` (int64 in [0, 2^32))."""
    shape = _shape(shape)
    x0, x1 = threefry2x32(key, *_counters(key, math.prod(shape)))
    return (x0 ^ x1).reshape(shape)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 draws in [minval, maxval)."""
    mantissa = (bits(key, shape) >> 9) | 0x3F800000
    floats = mantissa.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, _fma(floats, hi - lo, lo))


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


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """Standard normal float32 draws."""
    return math.sqrt(2) * _erfinv(uniform(key, shape, _NORMAL_LO, 1.0))
