"""Draws of the threefry key stream: the hand-written kernel and its plain version.

`utils/prng.py` draws every value of `jax.random`'s partitionable stream
here: element i of a draw of `shape` comes from threefry2x32(key,
(hi32(i), lo32(i))) with i its flat index, so a block of the draw (`part`,
a rank's share) is the same function at the block's counters.
`threefry_draw` launches `csrc/threefry.cu` for a draw on CUDA (one launch
writes the words, or the uniform or normal values made from them), and
`threefry_draws` one launch for up to 32 draws; on the CPU both run the
plain version: `threefry2x32` in int64 torch ops (~170 elementwise ops),
then the float steps in torch (XLA's FMA rounding for uniform, its erfinv
polynomial for normal). A draw on `meta` is its shape only. There is no
other route. JAX leaves threefry to XLA, so this kernel replaces no TPU
kernel.

The host side of a launch is a table the kernel takes by value: per draw
its output, key, kind and bounds, and its geometry (`geometry`: the
block's counters as a first counter plus strided coordinates, with a
multiply-high divisor per inner dimension, `divisor`), cached per (shape,
part); and the prefix of the draws' block counts (`block_prefix`).
"""
from __future__ import annotations

import ctypes
import functools
import math
import struct
import threading
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

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


@functools.lru_cache(maxsize=256)
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


# The kernel's launch geometry (csrc/threefry.cu): 256 threads a block, 4
# values a thread, an entry's blocks capped at one wave of an H100 (132 SMs x
# 8 resident blocks), up to 32 entries in one launch.
THREADS, VALUES, WAVE, MAX_ENTRIES = 256, 4, 132 * 8, 32
# The packed layout of csrc/threefry.cu's Entry and Table (its static_asserts
# hold the C side to the same sizes): an entry's head (out, key, k0, k1, lo,
# span, kind), then its geometry (ndim, n, base, sizes, strides, magic
# numbers, shifts) in 32-bit words for a `Narrow` entry (4 dimensions) and
# 64-bit ones for a `Wide` entry (8).
_HEAD = struct.Struct("<QQIIffi")
_NARROW = struct.Struct("<iII4I4I4I4I")
_WIDE = struct.Struct("<iQQ8Q8Q8I8I")
_NARROW_DIMS, _WIDE_DIMS = 4, 8
_TABLE_HEAD = {False: struct.Struct(f"<i{MAX_ENTRIES + 1}I"), True: struct.Struct("<i2I4x")}


def divisor(d: int) -> tuple[int, int]:
    """(magic, shift) with which the kernel divides a 32-bit j by d >= 2:
    t = umulhi(j, magic), j // d = (t + ((j - t) >> 1)) >> shift, exact
    for every j < 2^32 (Granlund and Montgomery's round-up method)."""
    if not 2 <= d < 1 << 32:
        raise ValueError(f"divisor {d} is not in [2, 2^32)")
    bits = (d - 1).bit_length()
    return ((1 << 32) * ((1 << bits) - d)) // d + 1, bits - 1


def geometry(shape: tuple, part: Part) -> tuple[int, tuple, tuple]:
    """(base, sizes, strides): the block's value j (row-major in the block)
    has the counter base + sum_d c_d * strides[d], c the coordinates of j in
    `sizes`. A dimension of the block of size 1 is folded into base, and a
    dimension whose span meets its outer neighbour's stride is merged into
    it, so a data-rank block is one dimension and a ray-rank block two."""
    sizes = block_shape(shape, part)
    strides = [math.prod(shape[d + 1:]) for d in range(len(shape))]
    base = sum((part or {}).get(d, (0, 0))[0] * strides[d] for d in range(len(shape)))
    dims = []
    for size, stride in zip(sizes, strides):
        if size == 1:
            continue
        if dims and dims[-1][1] == size * stride:
            dims[-1] = (dims[-1][0] * size, stride)
        else:
            dims.append((size, stride))
    sizes, strides = zip(*dims) if dims else ((1,), (1,))
    return base, sizes, strides


class _Plan(NamedTuple):
    shape: tuple  # the block's shape
    n: int
    wide: bool  # counters past 32 bits or more than 4 dimensions: the 64-bit entry
    geometry: Optional[bytes]  # the entry's packed bytes after its head; None past 8 dims


@functools.lru_cache(maxsize=1024)
def _cached_plan(shape: tuple, part: tuple) -> _Plan:
    part = dict(part)
    out_shape = block_shape(shape, part)
    n = math.prod(out_shape)
    if n == 0:
        return _Plan(out_shape, 0, False, b"")
    base, sizes, strides = geometry(shape, part)
    last = base + sum((s - 1) * st for s, st in zip(sizes, strides))
    wide = n >= 1 << 32 or last >= 1 << 32 or len(sizes) > _NARROW_DIMS
    if last >= 1 << 64:
        raise ValueError(f"threefry counters of {shape} reach past 2^64")
    if len(sizes) > _WIDE_DIMS:
        return _Plan(out_shape, n, True, None)
    dims = _WIDE_DIMS if wide else _NARROW_DIMS
    div = [divisor(s) if d and not wide else (0, 0) for d, s in enumerate(sizes)]
    pad = [0] * (dims - len(sizes))
    fields = ([len(sizes), n, base] + list(sizes) + pad + list(strides) + pad
              + [m for m, _ in div] + pad + [sh for _, sh in div] + pad)
    return _Plan(out_shape, n, wide, (_WIDE if wide else _NARROW).pack(*fields))


def plan_of(shape: tuple, part: Part) -> _Plan:
    """The cached plan of a draw of `shape`, or of its block `part`: the
    block's shape and size, whether it needs the 64-bit entry, and its
    packed geometry."""
    return _cached_plan(tuple(shape), tuple(sorted(part.items())) if part else ())


def block_prefix(counts: Sequence[int]) -> list[int]:
    """The table's `first`: entry k's blocks are [first[k], first[k + 1]),
    for entries of `counts` values each. An entry of n values has ceil(n /
    1024) blocks, at most one wave (a larger entry loops over its values)."""
    first = [0]
    for n in counts:
        first.append(first[-1] + min(-(-n // (THREADS * VALUES)), WAVE))
    return first


@functools.lru_cache(maxsize=None)
def _library():
    from .cuda_build import load

    lib = load("threefry")
    lib.threefry_launch.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
    lib.threefry_empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.threefry_launch.restype = lib.threefry_empty_launch.restype = ctypes.c_int
    return lib


def _call(fn, *args, device) -> None:
    """fn(*args, stream) on `device`'s current stream, inside its device
    context only when it is not the current device; raises on an error."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        err = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"threefry kernel launch failed: CUDA error {err}")


def empty_launch(blocks: int, device) -> None:
    """An empty kernel of `blocks` x 256 threads on `device`: the floor of a
    launch's device time (not counted as a draw)."""
    _call(_library().threefry_empty_launch, blocks, device=torch.device(device))


def entry(plan: _Plan, key: torch.Tensor, kind: str, lo: float, span: float,
          out: torch.Tensor, device, keep: list) -> bytes:
    """The packed table entry of one draw into `out`; a key on the card is
    appended to `keep`, alive until the launch."""
    if plan.geometry is None:
        raise ValueError(f"threefry kernel draws take at most {_WIDE_DIMS} dimensions (after "
                         "merging those a block takes whole)")
    if key.device.type == "cpu":
        (k0, k1), key_ptr = key.tolist(), 0
    else:
        key = key.to(device=device, dtype=torch.int64).contiguous()
        keep.append(key)
        k0, k1, key_ptr = 0, 0, key.data_ptr()
    return _HEAD.pack(out.data_ptr(), key_ptr, k0, k1, lo, span, KINDS[kind]) + plan.geometry


def table(entries: Sequence[tuple[bytes, int]], wide: bool) -> bytes:
    """The kernel's by-value table of `entries` (packed entry, values):
    their count, block prefix (`block_prefix`) and entries."""
    first = block_prefix([n for _, n in entries])
    slots = 1 if wide else MAX_ENTRIES
    if not 1 <= len(entries) <= slots:
        raise ValueError(f"a threefry table holds 1 to {slots} entries, not {len(entries)}")
    head = _TABLE_HEAD[wide].pack(len(entries), *first, *[0] * (slots + 1 - len(first)))
    return head + b"".join(e for e, _ in entries)


def _launch(entries: Sequence[tuple[bytes, int]], wide: bool, device) -> None:
    """One launch of the table of `entries`."""
    _call(_library().threefry_launch, table(entries, wide), int(wide), device=device)
    with _count_lock:
        threefry_draw.launches += 1


def _out_spec(plan: _Plan, kind: str) -> tuple[tuple, torch.dtype]:
    dtype = torch.int32 if kind in ("bits", "pairs") else torch.float32
    return plan.shape + ((2,) if kind == "pairs" else ()), dtype


def threefry_draw(key: torch.Tensor, shape: tuple, part: Part = None, device=None,
                  kind: str = "bits", minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """A draw of `shape` under `key`, or its block `part`, on `device`
    (default the key's). `kind`: "bits" (int32 bit patterns of x0 ^ x1),
    "pairs" (both words, a trailing dimension of 2), "uniform" (float32 in
    [minval, maxval)) or "normal" (float32). A draw on CUDA launches the
    kernel (or raises), on the CPU takes the plain version, on `meta` is
    its shape. `threefry_draw.launches` counts the kernel's launches (of
    this and of `threefry_draws`)."""
    device = key.device if device is None else torch.device(device)
    plan = plan_of(shape, part)
    lo, span = _bounds(kind, float(minval), float(maxval))
    full, dtype = _out_spec(plan, kind)
    if device.type == "meta":
        return torch.empty(full, dtype=dtype, device=device)
    if device.type == "cuda":
        out = torch.empty(full, dtype=dtype, device=device)
        if plan.n:
            keep = []
            _launch([(entry(plan, key, kind, lo, span, out, device, keep), plan.n)],
                    plan.wide, device)
        return out
    if device.type != "cpu":
        raise ValueError(f"threefry draws run on cuda or cpu, not {device}")
    return _plain(key, shape, part, device, kind, lo, span).reshape(full)


def threefry_draws(draws: Sequence[tuple], device) -> list:
    """Each of `draws`, (key, shape, part, kind, minval, maxval) as
    `threefry_draw` takes them, on `device`. On CUDA the draws share one
    buffer, each at a 16-byte-aligned offset, and up to 32 of them one
    launch (a longer list takes more; a draw needing 64-bit counters one of
    its own); on the CPU each takes the plain version; on `meta` each is its
    shape."""
    device = torch.device(device)
    specs = []
    for key, shape, part, kind, minval, maxval in draws:
        plan = plan_of(shape, part)
        specs.append((key, shape, part, kind, plan, _bounds(kind, float(minval), float(maxval)))
                     + _out_spec(plan, kind))
    if device.type == "meta":
        return [torch.empty(full, dtype=dtype, device=device) for *_, full, dtype in specs]
    if device.type == "cpu":
        return [_plain(key, shape, part, device, kind, *bounds).reshape(full)
                for key, shape, part, kind, _, bounds, full, _ in specs]
    if device.type != "cuda":
        raise ValueError(f"threefry draws run on cuda or cpu, not {device}")
    offsets, total = [], 0
    for *_, full, _ in specs:
        offsets.append(total)
        total += -(-math.prod(full) * 4 // 16) * 16
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    outs, narrow, wide, keep = [], [], [], []
    for (key, _, _, kind, plan, bounds, full, dtype), off in zip(specs, offsets):
        out = buf[off:off + math.prod(full) * 4].view(dtype).view(full)
        outs.append(out)
        if plan.n:
            packed = (entry(plan, key, kind, *bounds, out, device, keep), plan.n)
            (wide if plan.wide else narrow).append(packed)
    for i in range(0, len(narrow), MAX_ENTRIES):
        _launch(narrow[i:i + MAX_ENTRIES], False, device)
    for packed in wide:
        _launch([packed], True, device)
    return outs


_count_lock = threading.Lock()
threefry_draw.launches = 0
