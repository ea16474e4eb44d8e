"""OSG tri-plane point decoder: the hand-written Hopper kernel and its plain version.

Replaces `gnerf_tpu/ops/fused_decoder.py::fused_osg_decode` (Pallas, TPU).
`osg_decode` launches `csrc/osg_decode.cu` on CUDA tensors and calls the
plain PyTorch version `osg_decode_ref` on CPU tensors; there is no other
route. At the main-path shape (one frame pass: N=1, M=64*64*96, C=32, H=64,
D=33) the call is memory-bound on an H100: 75.5 MB of bf16 features (151 MB
of fp32 ones) in and 51.9 MB out, ~38 us (~61 us) at 3.35 TB/s. Both feature
types take one tensor-core kernel body with both products on `mma.sync` and
the second in split fp16; layer 1 is bf16 x bf16 for bf16 features and
3xTF32 for fp32 ones (the plane sum split into tf32 hi + lo parts, hi.w_hi +
hi.w_lo + lo.w_hi), which keeps ~21-22 bits, within the fp32 tolerance. That
is not the TF32 mode that `resolve_device` turns off for torch's own fp32
products. See the kernel source for the design.

Training differentiates the decoder through `OSGDecode`, whose forward is
the same route and whose backward is plain PyTorch products
(`osg_decode_backward`), as the JAX package differentiates its plain XLA
decoder: the Pallas kernel has no VJP.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

_MAX_C, _MAX_H, _MAX_D = 64, 64, 64


def osg_decode_ref(feats: torch.Tensor, w1e: torch.Tensor, b1e: torch.Tensor,
                   w2e: torch.Tensor, b2e: torch.Tensor) -> torch.Tensor:
    """Plain version: [N, 3, M, C] features -> [N, M, D] fp32 [sigma | rgb].

    Inputs are widened to fp32 exactly (bf16 -> fp32 is lossless). The
    kernel sums in another order, keeps ~21-22 bits of fp32 features in its
    3xTF32 first product, rounds h and w2e to fp16 hi/lo pairs (~22 bits
    kept) and uses approximate exp2/log2, within rtol 1e-4, atol 1e-5 of
    this."""
    f = feats.float()
    w1 = w1e.float()
    acc = f[:, 0] @ w1 + f[:, 1] @ w1 + f[:, 2] @ w1
    x = acc / 3.0 + b1e.float()
    # F.softplus, as jax.nn.softplus: differentiated at x = 0 exactly (bf16
    # inputs reach it) it gives 1/2, where max(x, 0) + log1p(exp(-|x|))
    # would give 1.
    h = F.softplus(x)
    o = h @ w2e.float() + b2e.float()
    rgb = torch.sigmoid(o[..., 1:]) * (1 + 2 * 0.001) - 0.001
    return torch.cat([o[..., :1], rgb], dim=-1)


def _check(feats, w1e, b1e, w2e, b2e):
    if feats.dim() != 4 or feats.shape[1] != 3:
        raise ValueError(f"feats must be [N, 3, M, C], got {tuple(feats.shape)}")
    n, _, m, c = feats.shape
    h = w1e.shape[-1]
    d = w2e.shape[-1]
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"feats must be float32 or bfloat16, got {feats.dtype}")
    if w1e.dtype != feats.dtype:
        raise TypeError(f"w1e must have the features' dtype {feats.dtype}, got {w1e.dtype}")
    for name, t in (("b1e", b1e), ("w2e", w2e), ("b2e", b2e)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if (tuple(w1e.shape) != (c, h) or tuple(b1e.shape) != (h,)
            or tuple(w2e.shape) != (h, d) or tuple(b2e.shape) != (d,)):
        raise ValueError(
            f"weight shapes {tuple(w1e.shape)}, {tuple(b1e.shape)}, "
            f"{tuple(w2e.shape)}, {tuple(b2e.shape)} do not fit C={c}")
    if c % 8 or c > _MAX_C or h > _MAX_H or d > _MAX_D or n > 65535:
        raise ValueError(
            f"kernel limits: C % 8 == 0, C <= {_MAX_C}, H <= {_MAX_H}, "
            f"D <= {_MAX_D}, N <= 65535; got N={n} C={c} H={h} D={d}")
    for name, t in (("feats", feats), ("w1e", w1e), ("b1e", b1e), ("w2e", w2e), ("b2e", b2e)):
        if t.device != feats.device:
            raise ValueError(f"{name} is on {t.device}, feats on {feats.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if feats.data_ptr() % 16:
        raise ValueError("feats must be 16-byte aligned")


def _library():
    from .cuda_build import load

    lib = load("osg_decode")
    fn = lib.osg_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def osg_decode(feats: torch.Tensor, w1e: torch.Tensor, b1e: torch.Tensor,
               w2e: torch.Tensor, b2e: torch.Tensor) -> torch.Tensor:
    """[N, 3, M, C] features (fp32 or bf16) -> [N, M, D] fp32 [sigma | rgb].

    CUDA tensors launch the kernel (or raise); CPU tensors take
    `osg_decode_ref`. With grad mode on and an input that requires grad, the
    call goes through `OSGDecode`, so the result has a `grad_fn`.
    `osg_decode.launches` counts forward kernel launches, from every thread
    (the server launches from several)."""
    _check(feats, w1e, b1e, w2e, b2e)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (feats, w1e, b1e, w2e, b2e)):
        return OSGDecode.apply(feats, w1e, b1e, w2e, b2e)
    return _decode(feats, w1e, b1e, w2e, b2e)


def _decode(feats, w1e, b1e, w2e, b2e):
    """The forward route of checked inputs: the kernel or the plain version."""
    if feats.device.type == "cpu":
        return osg_decode_ref(feats, w1e, b1e, w2e, b2e)
    if feats.device.type != "cuda":
        raise ValueError(f"osg_decode runs on cuda or cpu, not {feats.device}")
    n, _, m, c = feats.shape
    h, d = w2e.shape
    out = torch.empty((n, m, d), dtype=torch.float32, device=feats.device)
    fn = _library()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = fn(feats.data_ptr(), w1e.data_ptr(), b1e.data_ptr(), w2e.data_ptr(),
                 b2e.data_ptr(), out.data_ptr(), n, m, c, h, d,
                 int(feats.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"osg_decode kernel launch failed: CUDA error {err}")
    with _count_lock:
        osg_decode.launches += 1
    return out


def osg_decode_backward(dout: torch.Tensor, feats: torch.Tensor, w1e: torch.Tensor,
                        b1e: torch.Tensor, w2e: torch.Tensor, b2e: torch.Tensor,
                        needs=(True,) * 5):
    """Gradients of `osg_decode_ref` given dL/d(out) [N, M, D]: (dfeats in the
    features' dtype, dw1e in w1e's, db1e, dw2e, db2e in fp32), None where
    `needs` says no. The hidden layer is recomputed: x = (f0 + f1 + f2) w1e / 3
    + b1e, h = softplus(x), o = h w2e + b2e, in fp32 (float64 inputs stay
    float64). The three planes share one feature gradient,
    ((do w2e^T) * sigmoid(x) / 3) w1e^T."""
    ct = torch.promote_types(feats.dtype, torch.float32)
    n, _, m, c = feats.shape
    s = feats.to(ct).sum(dim=1).reshape(n * m, c)
    w1, w2 = w1e.to(ct), w2e.to(ct)
    x = (s @ w1) / 3.0 + b1e.to(ct)
    h = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
    do = dout.to(ct).reshape(n * m, -1).clone()
    sig = torch.sigmoid(h @ w2[:, 1:] + b2e[1:].to(ct))
    do[:, 1:] *= sig * (1.0 - sig) * (1 + 2 * 0.001)
    dw2e = (h.t() @ do).to(w2e.dtype) if needs[3] else None
    db2e = do.sum(dim=0).to(b2e.dtype) if needs[4] else None
    dx = (do @ w2.t()) * torch.sigmoid(x)
    db1e = dx.sum(dim=0).to(b1e.dtype) if needs[2] else None
    dacc = dx / 3.0
    dw1e = (s.t() @ dacc).to(w1e.dtype) if needs[1] else None
    dfeats = None
    if needs[0]:
        ds = (dacc @ w1.t()).reshape(n, 1, m, c)
        dfeats = ds.expand(n, 3, m, c).to(feats.dtype)
    return dfeats, dw1e, db1e, dw2e, db2e


class OSGDecode(torch.autograd.Function):
    """`osg_decode` with a backward: the forward is the kernel on CUDA tensors
    (the plain version on CPU ones) and saves the inputs only; the backward
    is `osg_decode_backward`, plain PyTorch products."""

    @staticmethod
    def forward(ctx, feats, w1e, b1e, w2e, b2e):
        ctx.save_for_backward(feats, w1e, b1e, w2e, b2e)
        return _decode(feats, w1e, b1e, w2e, b2e)

    @staticmethod
    def backward(ctx, dout):
        return osg_decode_backward(dout, *ctx.saved_tensors, needs=ctx.needs_input_grad)


_count_lock = threading.Lock()
osg_decode.launches = 0
