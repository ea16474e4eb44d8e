"""The channels-last route of the modulated convolutions
(`gnerf_tpu_torch/models/stylegan2.py`) and its epilogue kernel
(`gnerf_tpu_torch/csrc/modconv_epilogue.cu`, through
`ops/modconv_epilogue.py::modconv_epilogue`).

On the CPU: which calls take the route (bf16 on CUDA that autograd would
not record, and no other), that CPU, fp32 and gradient calls run the NCHW
chain, and the route itself against the NCHW chain with its kernels' plain
versions (the route forced on the CPU). On the card (`cuda`; these skip
without one, the kernel has no CPU mode): the kernel against the plain
chain bit for bit at the orbit chunk's shapes, and whole superresolution
and backbone forwards on the route against the NCHW route."""

import contextlib
import importlib
from unittest import mock

import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu_torch import ops
from gnerf_tpu_torch.models import stylegan2
from gnerf_tpu_torch.models.stylegan2 import Generator, SynthesisBlock, SynthesisLayer
from gnerf_tpu_torch.models.superresolution import SuperresolutionHybrid8XDC
from gnerf_tpu_torch.utils import prng

epilogue_mod = importlib.import_module("gnerf_tpu_torch.ops.modconv_epilogue")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _randomize(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Non-zero biases and noise strengths (both start at 0)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias") or name.endswith("noise_strength"):
                p.copy_(0.2 * torch.randn(p.shape, generator=g))
    return module


def _tiny_sr(clamp: bool = False):
    """A SuperresolutionHybrid8XDC at 8 channels into block64, w_dim 16,
    with random biases; 16^2 inputs (block64 runs at its input's size)."""
    sr = SuperresolutionHybrid8XDC(channels=8, img_resolution=512, w_dim=16,
                                   input_resolution=16, sr_num_fp16_res=4 if clamp else 0,
                                   key=prng.PRNGKey(5))
    return _randomize(sr, 6)


def _tiny_backbone():
    """The backbone's synthesis at tiny widths: blocks 4^2 to 32^2, 8 to 32
    channels, 9 image channels, noise strengths drawn."""
    g = Generator(16, 0, 16, img_resolution=32, img_channels=9, channel_base=512,
                  channel_max=32, key=prng.PRNGKey(2))
    return _randomize(g, 7)


def _sr_inputs(dev, n=2, seed=16):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, 8, 16, 16, generator=g, device=dev)
    rgb = torch.randn(n, 3, 16, 16, generator=g, device=dev)
    ws = torch.randn(n, 4, 16, generator=g, device=dev)
    return rgb, x, ws


def _forced_route(on: bool):
    """The route's choice fixed: on for every bf16 call (whatever its device
    and autograd state), or off."""
    return mock.patch.object(stylegan2, "channels_last_route",
                             lambda dtype, *a: on and dtype == torch.bfloat16)


class _Spy:
    """Counts the calls of the route's epilogue."""

    def __init__(self):
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return epilogue_mod.modconv_epilogue(*args, **kwargs)


# (dtype, device, grad mode, input needs a gradient, takes the route)
ROUTE_CASES = [
    (torch.bfloat16, "cuda", False, True, True),    # inference mode, a parameter that would learn
    (torch.bfloat16, "cuda", True, False, True),    # grad mode, nothing to differentiate
    (torch.bfloat16, "cuda", True, True, False),    # a gradient: the NCHW chain
    (torch.float32, "cuda", False, False, False),   # fp32: the train cells and EG3D's fakes
    (torch.float16, "cuda", False, False, False),
    (torch.bfloat16, "cpu", False, False, False),   # the CPU
]


@pytest.mark.parametrize("dtype,device,grad_mode,needs_grad,want", ROUTE_CASES)
def test_route_conditions(dtype, device, grad_mode, needs_grad, want):
    """The route engages for bf16 on CUDA that autograd would not record, and
    for nothing else."""
    t = torch.zeros(2, requires_grad=needs_grad)
    with torch.set_grad_enabled(grad_mode):
        got = stylegan2.channels_last_route(dtype, torch.device(device), None, t)
    assert got is want


@pytest.mark.parametrize("dtype,grad", [(torch.bfloat16, False), (torch.float32, False),
                                        (torch.float32, True)])
def test_calls_off_the_route_run_the_nchw_chain(dtype, grad):
    """CPU calls (bf16 or fp32, with a gradient or without) never enter the
    route and launch nothing: the superresolution and the backbone run the
    NCHW chain, and a gradient reaches ws through it."""
    sr, bb = _tiny_sr(), _tiny_backbone()
    rgb, x, ws = _sr_inputs("cpu")
    ws = ws.requires_grad_(grad)
    wb = torch.randn(2, bb.num_ws, 16).requires_grad_(grad)
    before = ops.modconv_epilogue.launches
    with mock.patch.object(SynthesisBlock, "_forward_channels_last",
                           side_effect=AssertionError("the route ran")), \
            torch.set_grad_enabled(grad):
        img, _ = sr(rgb, x, ws, noise_mode="none", dtype=dtype)
        planes = bb.synthesis(wb, noise_mode="const", dtype=dtype)
        if grad:
            (img.square().mean() + planes.square().mean()).backward()
    assert ops.modconv_epilogue.launches == before
    assert img.shape == (2, 3, 64, 64) and planes.shape == (2, 9, 32, 32)
    if grad:
        assert ws.grad is not None and bool(ws.grad.abs().sum() > 0)
        assert wb.grad is not None and bool(wb.grad.abs().sum() > 0)


@pytest.mark.parametrize("up", [1, 2])
@pytest.mark.parametrize("noise_mode", ["const", "random", "none"])
@pytest.mark.parametrize("clamp", [None, 0.5])
def test_layer_on_the_route_equals_the_nchw_layer(up, noise_mode, clamp):
    """One SynthesisLayer in fp32 on the CPU (the kernels' plain versions):
    `forward_channels_last` on channels-last x (scaled by its styles where
    it does not upsample) with the next layer's styles equals `forward` then
    the next style multiply, within fp32 rounding of the two layouts'
    convolutions (1e-5 of the largest value). The up layer's padding, flip
    and input styles included."""
    res = 16
    layer = _randomize(SynthesisLayer(8, 16, 12, res, up=up, conv_clamp=clamp,
                                      key=prng.PRNGKey(11)), 12)
    g = torch.Generator().manual_seed(13)
    x = torch.randn(3, 8, res // up, res // up, generator=g)
    w = torch.randn(3, 12, generator=g)
    nxt = torch.rand(3, 16, generator=g) + 0.5
    noise = torch.randn(3, 1, res, res, generator=g)
    with torch.no_grad():
        want = layer(x, w, noise_mode=noise_mode, noise=noise) * nxt[:, :, None, None]
        styles = layer.affine(w)
        xin = x if up > 1 else x * styles[:, :, None, None]
        got = layer.forward_channels_last(xin.contiguous(memory_format=torch.channels_last),
                                          styles, nxt, noise_mode=noise_mode, noise=noise)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


def test_route_on_the_cpu_matches_the_nchw_route():
    """The route forced on the CPU in bf16 (the kernels' plain versions, so
    the epilogue and the channels-last upfirdn2d round as the NCHW chain):
    a superresolution forward makes 6 epilogue calls (block64, block0,
    block1, two convolutions each) and a 4^2-to-32^2 backbone 7 (1 + 2 a
    block); both agree with the NCHW route within 2^-6 of their largest
    value. The products are the NCHW chain's, ToRGB's included; what may
    differ is the order of the sums: the convolutions on the other layout,
    ToRGB as a matrix product in place of a 1x1 convolution."""
    sr, bb = _tiny_sr(clamp=True), _tiny_backbone()
    rgb, x, ws = _sr_inputs("cpu")
    wb = torch.randn(2, bb.num_ws, 16, generator=torch.Generator().manual_seed(3))
    out = {}
    for on in (True, False):
        spy = _Spy()
        with torch.no_grad(), _forced_route(on), \
                mock.patch.object(stylegan2, "modconv_epilogue", spy):
            img, raw = sr(rgb, x, ws, noise_mode="none", dtype=torch.bfloat16)
            sr_calls = spy.calls
            planes = bb.synthesis(wb, noise_mode="random", rng=prng.PRNGKey(4),
                                  dtype=torch.bfloat16)
        out[on] = (img, raw, planes, sr_calls, spy.calls - sr_calls)
    assert out[True][3:] == (6, 7) and out[False][3:] == (0, 0)
    for a, b in zip(out[True][:3], out[False][:3]):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=2.0 ** -6 * b.abs().max().item())


# (name, shape [N, C, H, W], act, noise: None / "sample" / "shared", clamp, next styles)
KERNEL_CASES = [
    ("orbit_block1_conv1", (15, 128, 512, 512), "lrelu", None, None, False),
    ("orbit_block1_conv0", (15, 128, 512, 512), "lrelu", None, None, True),
    ("orbit_block0_conv1", (15, 256, 256, 256), "lrelu", None, None, False),
    ("orbit_block0_conv0_noise_clamp", (15, 256, 256, 256), "lrelu", "sample", 256.0, True),
    ("block0_linear_shared_noise", (15, 256, 256, 256), "linear", "shared", 1.5, False),
    ("backbone_const_noise", (1, 512, 8, 8), "lrelu", "shared", 256.0, True),
    ("ragged_24_channels", (3, 24, 7, 9), "lrelu", "sample", 0.75, True),
    ("linear_bare", (2, 8, 5, 3), "linear", None, None, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
def test_kernel_equals_the_plain_chain(card, case):
    """One launch over the convolution's channels-last output equals the
    plain chain (`* dcoefs`, `+ noise`, `bias_act`, `* styles`, each op in
    bf16 as PyTorch rounds it) bit for bit, written over its input. Values
    at 4x the unit scale, so the clamps bite."""
    _, shape, act, noise_kind, clamp, with_styles = case
    n, c, h, w = shape
    g = torch.Generator(device=card).manual_seed(n * c + h)
    y = (4 * torch.randn(shape, generator=g, device=card)).to(torch.bfloat16)
    y = y.contiguous(memory_format=torch.channels_last)
    dcoefs = torch.rand(n, c, generator=g, device=card) + 0.25
    bias = torch.randn(c, generator=g, device=card)
    styles = torch.randn(n, c, generator=g, device=card) if with_styles else None
    noise = None
    if noise_kind == "sample":
        noise = 0.3 * torch.randn(n, 1, h, w, generator=g, device=card)
    elif noise_kind == "shared":
        noise = 0.3 * torch.randn(h, w, generator=g, device=card)
    gain = 2 ** 0.5 if act == "lrelu" else 1.0
    want = epilogue_mod._plain(y, dcoefs, noise, bias, act, 0.2, gain, clamp, styles)
    before = ops.modconv_epilogue.launches
    got = ops.modconv_epilogue(y, dcoefs, noise, bias, act=act, clamp=clamp, styles=styles)
    torch.cuda.synchronize()
    assert ops.modconv_epilogue.launches == before + 1
    assert got.data_ptr() == y.data_ptr() and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(card):
    """NCHW or fp32 activations, channels not a multiple of 8, a gradient."""
    y = torch.randn(2, 16, 4, 4, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ops.modconv_epilogue(y)  # NCHW
    with pytest.raises(ValueError):
        ops.modconv_epilogue(y.float().contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError):
        ops.modconv_epilogue(torch.randn(2, 12, 4, 4, device=card, dtype=torch.bfloat16)
                             .contiguous(memory_format=torch.channels_last))
    with pytest.raises(ValueError):
        ops.modconv_epilogue(y.contiguous(memory_format=torch.channels_last),
                             bias=torch.zeros(16, device=card, requires_grad=True))


@pytest.mark.cuda
def test_superresolution_and_backbone_on_the_route(card):
    """A tiny SuperresolutionHybrid8XDC forward and a 4^2-to-32^2 backbone in
    bf16 without a gradient take the route on the card: 6 and 7 epilogue
    launches, the SR's 4 upfirdn2d launches (block0.conv0 and block1.conv0
    channels last, the two skip images NCHW). Both agree with the NCHW
    route within 2^-6 of their largest value: the same products, ToRGB's
    summed in another order (a matrix product, not cuDNN's 1x1
    convolution). fp32 calls and calls with a gradient launch no epilogue."""
    sr, bb = _tiny_sr(clamp=True).to(card), _tiny_backbone().to(card)
    rgb, x, ws = _sr_inputs(card)
    wb = torch.randn(2, bb.num_ws, 16, generator=torch.Generator(device=card).manual_seed(3),
                     device=card)
    out = {}
    for on in (True, False):
        with torch.no_grad(), contextlib.nullcontext() if on else _forced_route(False):
            n0, f0 = ops.modconv_epilogue.launches, ops.upfirdn2d.launches
            img, raw = sr(rgb, x, ws, noise_mode="none", dtype=torch.bfloat16)
            torch.cuda.synchronize()
            n1, f1 = ops.modconv_epilogue.launches, ops.upfirdn2d.launches
            planes = bb.synthesis(wb, noise_mode="const", dtype=torch.bfloat16)
            torch.cuda.synchronize()
        out[on] = (img, raw, planes, n1 - n0, f1 - f0, ops.modconv_epilogue.launches - n1)
    assert out[True][3:] == (6, 4, 7) and out[False][3:] == (0, 4, 0)
    for a, b in zip(out[True][:3], out[False][:3]):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0, atol=2.0 ** -6 * b.abs().max().item())
    before = ops.modconv_epilogue.launches
    with torch.no_grad():
        sr(rgb, x, ws, noise_mode="none", dtype=torch.float32)
    img, _ = sr(rgb, x, ws.clone().requires_grad_(), noise_mode="none", dtype=torch.bfloat16)
    img.float().square().mean().backward()
    torch.cuda.synchronize()
    assert ops.modconv_epilogue.launches == before
