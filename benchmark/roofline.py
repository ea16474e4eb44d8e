"""The yardstick's arithmetic: the H100's peaks, a kernel's bytes, and the
operations of a piece of work counted over the frozen reference.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates without sparsity. `decoder_bytes` counts every input of the OSG
decoder read once and its output written once (as `chip_smoke.py` does).
`count_flops` runs a function under a dispatch mode that prices every aten
op with `torch.utils.flop_counter`'s table: the multiply-adds of matrix
products and convolutions (2 per multiply-add, their backward included),
from their shapes, whatever implements them, and no elementwise work.
(`FlopCounterMode` itself tracks modules with hooks that `autograd.grad`,
which the training step uses, does not support.)
"""

from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


def decoder_bytes(n: int, m: int, c: int, h: int, d: int, bf16: bool) -> int:
    """Bytes `osg_decode` must move for [n, 3, m, c] features, hidden h, d outputs."""
    elem = 2 if bf16 else 4
    return n * 3 * m * c * elem + c * h * elem + (h + h * d + d) * 4 + n * m * d * 4


def decoder_bound_s(n: int, m: int, c: int, h: int, d: int, bf16: bool) -> float:
    """The least time of one call: its bytes at the HBM rate (the decoder is
    bound by bytes at every shape the program runs: 2 m c h operations a
    point against 3 c * 2 bytes)."""
    return decoder_bytes(n, m, c, h, d, bf16) / PEAK_BYTES_PER_S


def count_flops(fn, *args, **kwargs) -> tuple[int, object]:
    """(FLOPs of the products and convolutions in fn(*args), its result)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Count(TorchDispatchMode):
        total = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            price = flop_registry.get(func._overloadpacket)
            if price is not None:
                self.total += int(price(*args, **kwargs, out_val=out))
            return out

    with Count() as counter:
        out = fn(*args, **kwargs)
    return counter.total, out
