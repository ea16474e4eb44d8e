"""A counter-based key stream equal to `jax.random`'s, so that a seed names
the same weights and draws in both packages.

The JAX package draws from threefry2x32 keys in the partitionable form
(`jax_threefry_partitionable`, JAX's default since 0.5): element i of a
draw is threefry2x32(key, (hi32(i), lo32(i))) with i the flat index, so a
draw depends only on its key and its shape. This module draws from those
words (`ops/threefry.py`: the hand-written kernel for a draw on CUDA, int64
torch ops for one on the CPU):

- `PRNGKey(seed)` is [0, seed mod 2^32], as JAX's 32-bit mode gives it;
- `split(key, n)[i]` is threefry2x32(key, (0, i));
- `fold_in(key, d)` is threefry2x32(key, (0, d));
- `bits` is the xor of the two output words;
- `uniform` puts the top 23 bits in a float's mantissa in [1, 2), takes 1
  away, scales to [minval, maxval) and clamps below at minval;
- `normal` is sqrt(2) * erfinv(uniform(-1 + ulp, 1)) with XLA's
  single-precision erfinv polynomial (within an ulp or two of JAX's: its
  log1p differs from torch's in the last place);
- `randint` is jax's modulus-based draw from two bit draws of a split key.

A key is an int64 tensor of two words, each in [0, 2^32): torch's uint32
lacks most operators. A draw is computed on `device`, by default the key's:
a key on CUDA draws there, a key on `meta` draws nothing (the draw's shape
only: the load paths build their modules so), and a key on the CPU may draw
on any device (its words go to the kernel as scalars, so the training steps
keep their keys on the host and split them there without waiting for the
card).

`part` asks for a block of a draw: {dim: (start, size)} names, for some
dimensions of the draw's `shape`, the slice to compute; every draw of a
block is the draw of the whole at the same position, since element i
depends only on the key and i. A rank computes its part of a sharded draw
so (`parallel.sharding.draw`).

`draw_many` makes a list of draws (`Draw`) in one launch of the kernel
where their keys are all known before the first value is needed (the ADA
pipe's per-sample parameters, a synthesis network's noise): the values are
those of the single draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.threefry import MASK as _MASK
from ..ops.threefry import Part, host_pairs, threefry_draw, threefry_draws

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


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(s) for s in shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`num` new keys, [num, 2]."""
    if key.device.type == "cpu":
        return host_pairs(*key.tolist(), range(num))
    return threefry_draw(key, (num,), kind="pairs").to(torch.int64) & _MASK


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """A new key from `key` and a 32-bit integer."""
    data = int(data)
    if not 0 <= data <= _MASK:
        raise OverflowError(f"fold_in data {data} does not fit in 32 unsigned bits")
    if key.device.type == "cpu":
        return host_pairs(*key.tolist(), (data,))[0]
    words = threefry_draw(key, (data + 1,), part={0: (data, 1)}, kind="pairs")
    return words[0].to(torch.int64) & _MASK


def bits(key: torch.Tensor, shape: Shape, part: Part = None, device=None) -> torch.Tensor:
    """Random 32-bit words of `shape` (int64 in [0, 2^32)), or of its block
    `part`, on `device` (default: the key's)."""
    return threefry_draw(key, _shape(shape), part, device).to(torch.int64) & _MASK


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0, part: Part = None, device=None) -> torch.Tensor:
    """float32 draws in [minval, maxval)."""
    return threefry_draw(key, _shape(shape), part, device, "uniform", minval, maxval)


def _int32_bound(v, name: str):
    """A randint bound as jax's 32-bit mode reads it: (value, dtype's
    (min, max)). A Python int outside int32 is an OverflowError; a numpy
    scalar keeps its type, but 64-bit types wrap to their 32-bit ones."""
    if isinstance(v, (bool, np.bool_)) or not isinstance(v, (int, np.integer)):
        raise TypeError(f"randint {name} must be an integer; got {v!r}")
    if not isinstance(v, np.integer):
        if not -2 ** 31 <= v < 2 ** 31:
            raise OverflowError(f"randint {name} {v} does not fit in int32")
        return int(v), (-2 ** 31, 2 ** 31 - 1)
    dtype = np.dtype({np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32}.get(
        v.dtype, v.dtype))
    info = np.iinfo(dtype)
    return int(np.asarray(v).astype(dtype)), (int(info.min), int(info.max))


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """a * b mod 2^32 for words in [0, 2^32), without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & _MASK) << 16
    return (lo + hi) & _MASK


def randint(key: torch.Tensor, shape: Shape, minval, maxval, part: Part = None,
            device=None) -> torch.Tensor:
    """int32 draws in [minval, maxval) (scalar integer bounds), as
    `jax.random.randint` gives them with 64-bit types off: the bounds
    clipped to int32, span = maxval - minval as an unsigned word (1 when
    maxval <= minval, one more when maxval lies past int32), and
    minval + (hi % span * (2^32 % span) + lo % span) % span in uint32
    arithmetic, hi and lo the bits of the two keys of split(key)."""
    lo_v, lo_range = _int32_bound(minval, "minval")
    hi_v, hi_range = _int32_bound(maxval, "maxval")
    out_of_range = hi_v > min(2 ** 31 - 1, hi_range[1])
    lo_v = min(max(lo_v, -2 ** 31), 2 ** 31 - 1)
    hi_v = min(max(hi_v, -2 ** 31), 2 ** 31 - 1)
    span = (hi_v - lo_v) & _MASK
    if hi_v <= lo_v:
        span = 1
    elif out_of_range:
        span = (span + 1) & _MASK
    k1, k2 = split(key)
    higher, lower = bits(k1, shape, part, device), bits(k2, shape, part, device)
    if span == 0:  # XLA's x % 0 is x: the offset is the low word alone
        offset = lower
    else:
        mult = (2 ** 16 % span) ** 2 & _MASK
        mult %= span
        offset = ((_mul32(higher % span, mult) + lower % span) & _MASK) % span
    out = (lo_v + offset) & _MASK
    return (out - ((out >> 31) << 32)).to(torch.int32)


def normal(key: torch.Tensor, shape: Shape = (), part: Part = None,
           device=None) -> torch.Tensor:
    """Standard normal float32 draws."""
    return threefry_draw(key, _shape(shape), part, device, "normal")


class Draw(NamedTuple):
    """One draw of `draw_many`: `kind` "uniform", "normal" or "bits", as
    those functions take their arguments."""

    kind: str
    key: torch.Tensor
    shape: tuple
    minval: float = 0.0
    maxval: float = 1.0
    part: Part = None


def draw_many(draws: Sequence[Draw], device: Optional[torch.device] = None) -> list:
    """Each of `draws` on `device` (default the first key's), equal to the
    single draw (`uniform`, `normal`, `bits`), in one launch of the kernel
    for up to 32 draws on CUDA."""
    if not draws:
        return []
    device = draws[0].key.device if device is None else device
    outs = threefry_draws([(d.key, _shape(d.shape), d.part, d.kind, d.minval, d.maxval)
                           for d in draws], device)
    return [out.to(torch.int64) & _MASK if d.kind == "bits" else out
            for d, out in zip(draws, outs)]
