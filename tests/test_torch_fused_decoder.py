"""The port's OSG decoder (`osg_decode` and its plain version) vs the JAX
Pallas kernel (interpret mode) and the JAX plain decoder, mirroring
tests/test_fused_decoder.py. The kernels' arithmetic (layer 1 in bf16 or in
3xTF32, split-fp16 layer 2) is emulated on the CPU and held to the plain
version's tolerance and to the Pallas kernel. The CUDA kernels themselves
are held against the plain version on the card (the `cuda` tests below, and
chip_smoke.py)."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread, t, to_np  # noqa: F401
from gnerf_tpu.models import OSGDecoder as JDecoder
from gnerf_tpu_torch.models import OSGDecoder
from gnerf_tpu_torch.ops.fused_decoder import OSGDecode, osg_decode, osg_decode_ref
from gnerf_tpu_torch.utils import prng
from gnerf_tpu_torch.utils.checkpoint import load_jax_params

TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(n_features, out_dim, lr_mul, seed):
    jdec = JDecoder(n_features=n_features, decoder_output_dim=out_dim, decoder_lr_mul=lr_mul)
    params = jdec.init(jax.random.PRNGKey(seed))
    dec = OSGDecoder(n_features=n_features, decoder_output_dim=out_dim, decoder_lr_mul=lr_mul)
    load_jax_params(dec, params)
    return jdec, params, dec


@pytest.mark.parametrize("n,m,c,out_dim,lr_mul", [
    (2, 4096, 32, 32, 1.0),   # aligned point count
    (2, 5000, 32, 32, 1.0),   # ragged point count
    (1, 4096, 8, 8, 0.5),     # narrow features, lr multiplier
])
def test_decoder_matches_jax(n, m, c, out_dim, lr_mul):
    jdec, params, dec = _pair(c, out_dim, lr_mul, seed=m)
    feats = np.random.RandomState(m).randn(n, 3, m, c).astype(np.float32)
    want_plain = jdec.apply(params, jax.numpy.asarray(feats), use_fused=False)
    want_pallas = np.asarray(jdec._apply_fused(params, jax.numpy.asarray(feats), interpret=True))
    got = dec(t(feats))
    assert got["rgb"].shape == (n, m, out_dim) and got["sigma"].shape == (n, m, 1)
    np.testing.assert_allclose(to_np(got["sigma"]), np.asarray(want_plain["sigma"]), **TOL)
    np.testing.assert_allclose(to_np(got["rgb"]), np.asarray(want_plain["rgb"]), **TOL)
    np.testing.assert_allclose(to_np(got["sigma"]), want_pallas[..., :1], **TOL)
    np.testing.assert_allclose(to_np(got["rgb"]), want_pallas[..., 1:], **TOL)


@pytest.mark.parametrize("n,m,c,out_dim,lr_mul", [
    (2, 4096, 32, 32, 1.0),
    (2, 5000, 32, 32, 1.0),
    (1, 4096, 8, 8, 0.5),
])
def test_decoder_bf16_matches_pallas(n, m, c, out_dim, lr_mul):
    """bf16 features (the main path's type): the Pallas kernel's three bf16
    dots with fp32 sums vs the port's plain version on the same bf16 values.
    bf16 x bf16 products are exact in fp32 on both sides, so they differ only
    in summation order; hence the fp32 tolerance."""
    jdec, params, dec = _pair(c, out_dim, lr_mul, seed=m)
    feats = np.random.RandomState(m + 1).randn(n, 3, m, c).astype(np.float32)
    want = np.asarray(jdec._apply_fused(
        params, jnp.asarray(feats).astype(jnp.bfloat16), interpret=True))
    got = dec(t(feats).bfloat16())
    np.testing.assert_allclose(to_np(got["sigma"]), want[..., :1], **TOL)
    np.testing.assert_allclose(to_np(got["rgb"]), want[..., 1:], **TOL)


def _split(x, dtype):
    hi = x.to(dtype).float()
    return hi, (x - hi).to(dtype).float()


def _tf32(x):
    """x rounded to tf32 as `cvt.rna.tf32.f32` rounds it: 10 mantissa bits,
    to nearest, ties away from zero (on the int32 view of fp32)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _kernel_emulation(feats, w1e, b1e, w2e, b2e, split_dtype=torch.float16):
    """The bf16 kernel's arithmetic (csrc/osg_decode.cu, osg_decode_tc) in
    plain PyTorch: layer 1 as one product of depth 3C (bf16 products, fp32
    sums), then `_kernel_tail`. `split_dtype` bfloat16 emulates the split the
    kernel does not use."""
    f = feats.float()
    w1 = w1e.float()
    acc = torch.cat([f[:, 0], f[:, 1], f[:, 2]], dim=-1) @ torch.cat([w1, w1, w1], dim=0)
    return _kernel_tail(acc, b1e, w2e, b2e, split_dtype)


def _kernel_emulation_f32(feats, w1e, b1e, w2e, b2e, passes=3):
    """The fp32 kernel's arithmetic (osg_decode_tf32) in plain PyTorch: the
    plane sum (f0 + f1) + f2 in fp32, its tf32 parts hi = rna(s) and
    lo = rna(s - hi), those of w1e likewise, layer 1 as hi.w_hi + hi.w_lo +
    lo.w_hi with fp32 sums, then `_kernel_tail`. `passes=1` emulates a single
    TF32 product hi.w_hi, which the kernel does not use."""
    f = feats.float()
    s = (f[:, 0] + f[:, 1]) + f[:, 2]
    sh = _tf32(s)
    sl = _tf32(s - sh)
    wh = _tf32(w1e)
    wl = _tf32(w1e.float() - wh)
    acc = sh @ wh if passes == 1 else sh @ wh + sh @ wl + sl @ wh
    return _kernel_tail(acc, b1e, w2e, b2e)


def _kernel_tail(acc, b1e, w2e, b2e, split_dtype=torch.float16):
    """What both kernels do after layer 1: softplus in log2 units (h / ln 2,
    with ln 2 folded into w2e); sigma as an fp32 dot; the rgb columns as
    h_hi.w_hi + h_hi.w_lo + h_lo.w_hi with fp16 hi/lo parts of h and of
    w2e * ln 2 * 2^s (max |w2e| * 2^s in [2^14, 2^15)), and rows whose
    largest h reaches 2^15 scaled by a power of two first. The kernels sum in
    another order and take exp2/log2 from approximate instructions; neither
    is emulated."""
    log2e, ln2 = math.log2(math.e), math.log(2.0)
    y = acc * (log2e / 3.0) + b1e * log2e
    h = torch.clamp_min(y, 0.0) + torch.log2(1.0 + torch.exp2(-y.abs()))
    sigma = h @ (w2e[:, :1] * ln2) + b2e[:1]
    _, row_exp = torch.frexp(h.amax(dim=-1, keepdim=True))
    row_shift = (row_exp - 15).clamp_min(0)
    h = torch.ldexp(h, -row_shift)
    _, w_exp = torch.frexp(w2e.abs().max())
    hh, hl = _split(h, split_dtype)
    wh, wl = _split(torch.ldexp(w2e[:, 1:] * ln2, 15 - w_exp), split_dtype)
    o = torch.ldexp(hh @ wh + hh @ wl + hl @ wh, row_shift + w_exp - 15) + b2e[1:]
    rgb = torch.sigmoid(o) * (1 + 2 * 0.001) - 0.001
    return torch.cat([sigma, rgb], dim=-1)


def _case(n, m, c, out_dim, lr_mul, scale, dtype=torch.bfloat16):
    dec = OSGDecoder(n_features=c, decoder_output_dim=out_dim, decoder_lr_mul=lr_mul,
                     key=prng.PRNGKey(m + c))
    weights = [w.detach() for w in dec.folded_weights(dtype)]
    feats = t(np.random.RandomState(m).randn(n, 3, m, c) * scale).to(dtype)
    return feats, weights


@pytest.mark.parametrize("n,m,c,out_dim,lr_mul,scale", [
    (1, 4096, 32, 32, 1.0, 1.0),
    (2, 5000, 32, 32, 1.0, 1.0),
    (1, 4096, 32, 32, 1.0, 20.0),   # softplus and sigmoid saturate
    (2, 5000, 32, 32, 1.0, 20.0),
    (1, 4096, 8, 8, 0.5, 20.0),     # K padded per plane, lr multiplier
])
def test_kernel_arithmetic_holds_tolerance(n, m, c, out_dim, lr_mul, scale):
    """The split-fp16 second layer keeps ~22 bits of h and w2e and holds the
    plain version's tolerance, also at x20 features."""
    feats, weights = _case(n, m, c, out_dim, lr_mul, scale)
    torch.testing.assert_close(_kernel_emulation(feats, *weights),
                               osg_decode_ref(feats, *weights), **TOL)


def test_bf16_split_misses_tolerance():
    """Why the second layer splits into fp16 and not bf16 parts: a bf16
    split keeps ~16 bits and leaves the tolerance at x20 features."""
    feats, weights = _case(1, 4096, 32, 32, 1.0, 20.0)
    want = osg_decode_ref(feats, *weights)
    got = _kernel_emulation(feats, *weights, split_dtype=torch.bfloat16)
    assert not torch.allclose(got, want, **TOL)


@pytest.mark.parametrize("n,m,c,out_dim,lr_mul,scale", [
    (1, 4096, 32, 32, 1.0, 1.0),
    (2, 5000, 32, 32, 1.0, 1.0),    # ragged, batch stride
    (1, 4096, 32, 32, 1.0, 20.0),   # softplus and sigmoid saturate
    (2, 5000, 32, 32, 1.0, 20.0),
    (1, 4096, 8, 8, 0.5, 1.0),      # one k8 step, lr multiplier
    (1, 4096, 8, 8, 0.5, 20.0),
])
def test_f32_kernel_arithmetic_holds_tolerance(n, m, c, out_dim, lr_mul, scale):
    """3xTF32 keeps ~21-22 bits of the first product and, with the shared
    split-fp16 second layer, holds the fp32 plain version's tolerance."""
    feats, weights = _case(n, m, c, out_dim, lr_mul, scale, torch.float32)
    torch.testing.assert_close(_kernel_emulation_f32(feats, *weights),
                               osg_decode_ref(feats, *weights), **TOL)


@pytest.mark.parametrize("n,m,c,out_dim,lr_mul,scale", [
    (2, 5000, 32, 32, 1.0, 1.0),
    (1, 4096, 32, 32, 1.0, 20.0),
    (1, 4096, 8, 8, 0.5, 20.0),
])
def test_f32_kernel_arithmetic_matches_pallas(n, m, c, out_dim, lr_mul, scale):
    """The fp32 kernel's arithmetic vs the Pallas kernel (interpret mode) on
    the same fp32 features and parameters."""
    jdec, params, dec = _pair(c, out_dim, lr_mul, seed=m)
    feats = (np.random.RandomState(m + 2).randn(n, 3, m, c) * scale).astype(np.float32)
    want = np.asarray(jdec._apply_fused(params, jnp.asarray(feats), interpret=True))
    weights = [w.detach() for w in dec.folded_weights(torch.float32)]
    np.testing.assert_allclose(to_np(_kernel_emulation_f32(t(feats), *weights)), want, **TOL)


def test_tf32_single_pass_misses_tolerance():
    """Why layer 1 takes three TF32 products: one keeps 11 bits of the
    features and of w1e and leaves the tolerance already at x1 features."""
    feats, weights = _case(1, 4096, 32, 32, 1.0, 1.0, torch.float32)
    want = osg_decode_ref(feats, *weights)
    assert torch.allclose(_kernel_emulation_f32(feats, *weights), want, **TOL)
    assert not torch.allclose(_kernel_emulation_f32(feats, *weights, passes=1), want, **TOL)


def _decode_f64(feats, w1e, b1e, w2e, b2e):
    f = feats.double()
    w1 = w1e.double()
    x = (f[:, 0] @ w1 + f[:, 1] @ w1 + f[:, 2] @ w1) / 3.0 + b1e.double()
    h = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
    o = h @ w2e.double() + b2e.double()
    return torch.cat([o[..., :1], torch.sigmoid(o[..., 1:]) * (1 + 2 * 0.001) - 0.001], -1)


@pytest.mark.parametrize("c,out_dim,lr_mul", [(32, 32, 1.0), (8, 8, 0.5)])
def test_kernel_arithmetic_scales_huge_rows(c, out_dim, lr_mul):
    """Features x65536 put h far beyond fp16 (up to ~1e5): the kernel's
    per-row power-of-two scaling keeps it finite and as close to the float64
    result as the fp32 plain version is (fp32 itself is off by ~2e-2 there,
    on outputs near 1e5)."""
    feats, weights = _case(1, 2048, c, out_dim, lr_mul, 65536.0)
    exact = _decode_f64(feats, *weights)
    got = _kernel_emulation(feats, *weights).double()
    plain_err = (osg_decode_ref(feats, *weights).double() - exact).abs().max()
    assert torch.isfinite(got).all()
    assert (got - exact).abs().max() <= 2.0 * plain_err


@pytest.mark.parametrize("c,out_dim,lr_mul", [(32, 32, 1.0), (8, 8, 0.5)])
def test_f32_kernel_arithmetic_scales_huge_rows(c, out_dim, lr_mul):
    """fp32 features x65536: 3xTF32 and the per-row scaling stay as close to
    the float64 result as the fp32 plain version is, within a factor 2."""
    feats, weights = _case(1, 2048, c, out_dim, lr_mul, 65536.0, torch.float32)
    exact = _decode_f64(feats, *weights)
    got = _kernel_emulation_f32(feats, *weights).double()
    plain_err = (osg_decode_ref(feats, *weights).double() - exact).abs().max()
    assert torch.isfinite(got).all()
    assert (got - exact).abs().max() <= 2.0 * plain_err


def test_wrapper_takes_plain_version_on_cpu():
    _, _, dec = _pair(32, 32, 1.0, seed=3)
    feats = t(np.random.RandomState(3).randn(1, 3, 300, 32))
    weights = dec.folded_weights(torch.float32)
    before = osg_decode.launches
    got = osg_decode(feats, *weights)
    assert osg_decode.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(got, osg_decode_ref(feats, *weights), rtol=0, atol=0)
    # bf16 features: the plain version widens them exactly.
    fb = feats.bfloat16()
    w1b = weights[0].bfloat16()
    got_b = osg_decode(fb, w1b, *weights[1:])
    want_b = osg_decode_ref(fb.float(), w1b.float(), *weights[1:])
    torch.testing.assert_close(got_b, want_b, rtol=0, atol=0)


@pytest.mark.parametrize("fault", ["dtype", "w1_dtype", "planes", "c_not_8", "too_wide", "shape"])
def test_wrapper_rejects(fault):
    c, h, d, m = 16, 64, 33, 10
    feats = torch.zeros(1, 3, m, c)
    w1, b1 = torch.zeros(c, h), torch.zeros(h)
    w2, b2 = torch.zeros(h, d), torch.zeros(d)
    if fault == "dtype":
        feats, w1 = feats.half(), w1.half()
    elif fault == "w1_dtype":
        w1 = w1.bfloat16()
    elif fault == "planes":
        feats = torch.zeros(1, 2, m, c)
    elif fault == "c_not_8":
        feats, w1 = torch.zeros(1, 3, m, 12), torch.zeros(12, h)
    elif fault == "too_wide":
        w1, b1, w2 = torch.zeros(c, 128), torch.zeros(128), torch.zeros(128, d)
    else:
        b2 = torch.zeros(d + 1)
    with pytest.raises((TypeError, ValueError)):
        osg_decode(feats, w1, b1, w2, b2)


# name: (dtype, N, M, C, out_dim, lr_mul, feature scale)
CARD_CASES = {
    "float32": ("float32", 1, 5000, 32, 32, 1.0, 1.0),
    "bfloat16": ("bfloat16", 1, 5000, 32, 32, 1.0, 1.0),
    "bf16_c8_lr_mul": ("bfloat16", 1, 4096, 8, 8, 0.5, 1.0),   # K padding
    "bf16_m1": ("bfloat16", 1, 1, 32, 32, 1.0, 1.0),            # less than one tile
    "bf16_m63": ("bfloat16", 1, 63, 32, 32, 1.0, 1.0),
    "bf16_m5003": ("bfloat16", 1, 5003, 32, 32, 1.0, 1.0),      # tail rows not a multiple of 4
    "bf16_n2": ("bfloat16", 2, 5000, 32, 32, 1.0, 1.0),         # batch stride
    "bf16_x20": ("bfloat16", 1, 64 * 64 * 96, 32, 32, 1.0, 20.0),  # main shape, saturating
    "bf16_server_mb4": ("bfloat16", 4, 64 * 64 * 96, 32, 32, 1.0, 1.0),  # micro-batch of 4
    "f32_shape_chunk": ("float32", 1, 1 << 20, 32, 32, 1.0, 1.0),  # shape-sweep chunk
    "f32_c8_lr_mul": ("float32", 1, 4096, 8, 8, 0.5, 1.0),      # one k8 step per row
    "f32_m1": ("float32", 1, 1, 32, 32, 1.0, 1.0),
    "f32_m63": ("float32", 1, 63, 32, 32, 1.0, 1.0),
    "f32_m5003": ("float32", 1, 5003, 32, 32, 1.0, 1.0),
    "f32_n2": ("float32", 2, 5000, 32, 32, 1.0, 1.0),
    "f32_x20": ("float32", 1, 64 * 64 * 96, 32, 32, 1.0, 20.0),
    "f32_c40": ("float32", 1, 5003, 40, 32, 1.0, 1.0),          # ring rows of 10 chunks
    "f32_c64_d49": ("float32", 1, 5003, 64, 48, 1.0, 1.0),      # 16 chunks; D > 33
    "bf16_c64_d49": ("bfloat16", 1, 5003, 64, 48, 1.0, 1.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_matches_plain_version_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype, n, m, c, out_dim, lr_mul, scale = CARD_CASES[case]
    _, _, dec = _pair(c, out_dim, lr_mul, seed=5)
    dec = dec.cuda()
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(m)
    feats = (torch.randn(n, 3, m, c, generator=gen) * scale).to("cuda", dt)
    weights = dec.folded_weights(dt)
    before = osg_decode.launches
    got = osg_decode(feats, *weights)
    torch.cuda.synchronize()
    assert osg_decode.launches == before + 1
    torch.testing.assert_close(got, osg_decode_ref(feats, *weights), **TOL)


def _huge_rows_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    feats, weights = _case(1, 2048, 32, 32, 1.0, 65536.0, dtype)
    feats, weights = feats.cuda(), [w.cuda() for w in weights]
    got = osg_decode(feats, *weights).double()
    exact = _decode_f64(feats, *weights)
    plain_err = (osg_decode_ref(feats, *weights).double() - exact).abs().max()
    assert torch.isfinite(got).all()
    assert (got - exact).abs().max() <= 4.0 * plain_err


@pytest.mark.cuda
def test_kernel_scales_huge_rows_on_card():
    """x65536 bf16 features take the kernel's per-row scaling path; it must
    stay as close to float64 as the fp32 plain version is, within a factor 4:
    the tensor cores' fp32 sums do not round to nearest."""
    _huge_rows_on_card(torch.bfloat16)


@pytest.mark.cuda
def test_f32_kernel_scales_huge_rows_on_card():
    """The same for x65536 fp32 features through the 3xTF32 kernel."""
    _huge_rows_on_card(torch.float32)


# ---------------------------------------------------------------------------
# Gradients (training differentiates the decoder through `OSGDecode`)

GRAD_CASES = [("float32", 1.0), ("float32", 20.0), ("bfloat16", 1.0), ("bfloat16", 20.0)]


def _grad_inputs(dtype, scale, n=2, m=600, c=32, out_dim=32, seed=4):
    jdec, params, dec = _pair(c, out_dim, 1.0, seed=seed)
    rs = np.random.RandomState(seed)
    feats = t(rs.randn(n, 3, m, c) * scale).to(getattr(torch, dtype))
    cot = t(rs.randn(n, m, out_dim + 1))
    return jdec, params, dec, feats, cot


@pytest.mark.parametrize("dtype,scale", GRAD_CASES)
def test_decoder_gradients_match_jax(dtype, scale):
    """The module's gradients (features, fc0 / fc1 weights and biases)
    against jax.grad of the JAX plain decoder. With bf16 features the port
    runs w1e in bf16 too, so the JAX decoder gets the bf16 values of the
    features and an fc0 weight whose folded w1e is the port's bf16 w1e; the
    feature and fc0 gradients then come back through bf16 (w1e's dtype) and
    are held to one bf16 ulp (rtol 2^-7)."""
    jdec, params, dec, feats, cot = _grad_inputs(dtype, scale)
    if dtype == "bfloat16":
        w1e = dec.folded_weights(torch.bfloat16)[0].float()
        params = dict(params, fc0=dict(params["fc0"], weight=jnp.asarray(
            to_np(w1e.t() * math.sqrt(dec.n_features)))))
    f = feats.detach().requires_grad_()
    out = dec(f)
    loss = (out["sigma"] * cot[..., :1]).sum() + (out["rgb"] * cot[..., 1:]).sum()
    got = torch.autograd.grad(loss, [f, dec.fc0.weight, dec.fc0.bias, dec.fc1.weight,
                                     dec.fc1.bias])

    def jloss(p, x):
        o = jdec.apply(p, x, use_fused=False)
        return (o["sigma"] * cot[..., :1].numpy()).sum() + (o["rgb"] * cot[..., 1:].numpy()).sum()

    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(to_np(feats.float())))
    assert got[0].dtype == feats.dtype
    loose = 2 ** -7 if dtype == "bfloat16" else 1e-4
    names = [("fc0", "weight"), ("fc0", "bias"), ("fc1", "weight"), ("fc1", "bias")]
    for g, want, name, rtol in zip(got, [gx] + [gp[a][b] for a, b in names],
                                   ["feats"] + [f"{a}/{b}" for a, b in names],
                                   [loose, loose, 1e-4, 1e-4, 1e-4]):
        want = np.asarray(want)
        np.testing.assert_allclose(to_np(g.float()), want, rtol=rtol,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("dtype,scale", GRAD_CASES)
def test_decoder_function_matches_plain_autograd(dtype, scale):
    """OSGDecode's gradients with respect to each of its five inputs equal
    autograd through `osg_decode_ref`."""
    _, _, dec, feats, cot = _grad_inputs(dtype, scale, seed=7)
    dt = getattr(torch, dtype)
    inputs = [x.detach().requires_grad_() for x in [feats, *dec.folded_weights(dt)]]
    out = osg_decode(*inputs)
    assert type(out.grad_fn).__name__ == "OSGDecodeBackward"
    got = torch.autograd.grad(out, inputs, cot)
    want = torch.autograd.grad(osg_decode_ref(*inputs), inputs, cot)
    for name, g, w in zip(["feats", "w1e", "b1e", "w2e", "b2e"], got, want):
        assert g.dtype == w.dtype, name
        tol = 2 ** -7 if g.dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                   atol=1e-5 * float(w.float().abs().max()), msg=name)


def test_plain_gradient_at_zero_preactivation_matches_jax():
    """Where the hidden pre-activation is exactly 0 (bf16 features and
    weights reach it: 2 of 50M units at the EG3D training shape), autograd
    through `osg_decode_ref` takes softplus' derivative 1/2, as
    jax.nn.softplus and OSGDecode do (here: zero features, zero fc0 bias)."""
    jdec, params, dec, feats, cot = _grad_inputs("float32", 1.0, m=16, seed=5)
    feats[:, :, :4] = 0
    assert not dec.fc0.bias.any()
    weights = [dec.fc0.weight, dec.fc0.bias, dec.fc1.weight, dec.fc1.bias]
    ref = torch.autograd.grad(osg_decode_ref(feats, *dec.folded_weights(torch.float32)),
                              weights, cot)
    fn = torch.autograd.grad(OSGDecode.apply(feats, *dec.folded_weights(torch.float32)),
                             weights, cot)

    def jloss(p):
        o = jdec.apply(p, jnp.asarray(to_np(feats)), use_fused=False)
        return (o["sigma"] * cot[..., :1].numpy()).sum() + (o["rgb"] * cot[..., 1:].numpy()).sum()

    gp = jax.grad(jloss)(params)
    for g, g_fn, (a, b) in zip(ref, fn, [("fc0", "weight"), ("fc0", "bias"), ("fc1", "weight"),
                                          ("fc1", "bias")]):
        want = np.asarray(gp[a][b])
        for got in (g, g_fn):
            np.testing.assert_allclose(to_np(got), want, rtol=1e-4,
                                       atol=1e-5 * np.abs(want).max(), err_msg=f"{a}/{b}")


def test_backward_formula_gradcheck():
    """`osg_decode_backward` in float64 against finite differences of the
    float64 decoder (torch.autograd.gradcheck)."""
    from gnerf_tpu_torch.ops.fused_decoder import osg_decode_backward

    class Decode64(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args)
            return _decode_f64(*args)

        @staticmethod
        def backward(ctx, dout):
            return osg_decode_backward(dout, *ctx.saved_tensors)

    g = torch.Generator().manual_seed(0)
    args = [torch.randn(s, generator=g, dtype=torch.float64, requires_grad=True)
            for s in [(2, 3, 5, 8), (8, 6), (6,), (6, 4), (4,)]]
    assert torch.autograd.gradcheck(Decode64.apply, args, eps=1e-6, atol=1e-8, rtol=1e-6)


def test_gradient_route_only_when_needed():
    """Without grad mode, or with no input requiring grad, osg_decode is the
    direct call (no graph); with one, the result has OSGDecode's grad_fn."""
    _, _, dec = _pair(32, 32, 1.0, seed=3)
    feats = t(np.random.RandomState(3).randn(1, 3, 64, 32))
    with torch.no_grad():
        assert dec(feats.requires_grad_())["rgb"].grad_fn is None
    with torch.inference_mode():
        assert dec(t(np.ones((1, 3, 8, 32))))["sigma"].grad_fn is None
    frozen = [w.detach() for w in dec.folded_weights(torch.float32)]
    assert osg_decode(feats.detach(), *frozen).grad_fn is None
    assert osg_decode(feats.detach().requires_grad_(), *frozen).grad_fn is not None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_gradients_match_plain_version_on_card(dtype):
    """On the card the forward is the kernel and the backward plain products:
    the gradients equal those through `osg_decode_ref`, at the tolerance of
    the kernel's forward (the backward recomputes from the inputs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    _, _, dec = _pair(32, 32, 1.0, seed=5)
    dec = dec.cuda()
    gen = torch.Generator().manual_seed(1)
    feats = torch.randn(2, 3, 50000, 32, generator=gen).to("cuda", dt).requires_grad_()
    cot = torch.randn(2, 50000, 33, generator=gen).cuda()
    weights = list(dec.folded_weights(dt))
    before = osg_decode.launches
    out = osg_decode(feats, *weights)
    got = torch.autograd.grad(out, [feats, dec.fc0.weight, dec.fc1.weight], cot)
    assert osg_decode.launches == before + 1 and out.grad_fn is not None
    want = torch.autograd.grad(osg_decode_ref(feats, *dec.folded_weights(dt)),
                               [feats, dec.fc0.weight, dec.fc1.weight], cot)
    # The feature and fc0 gradients come back through bf16 (the features'
    # and w1e's dtype) when the features are bf16: one bf16 ulp, 2^-7.
    for g, w, through_bf16 in zip(got, want, (True, True, False)):
        tol = 2 ** -7 if through_bf16 and dt == torch.bfloat16 else 1e-4
        torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                   atol=1e-5 * float(w.float().abs().max()))
