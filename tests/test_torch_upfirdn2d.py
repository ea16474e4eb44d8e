"""The upfirdn2d kernel (`gnerf_tpu_torch/csrc/upfirdn2d.cu`, through
`ops/upfirdn2d.py::upfirdn2d`) against the plain version on the card: every
caller's case (the superresolution's up=2 layers at the orbit chunk's shapes,
the fp32 skip image, D's down=2 with and without a 1x1 convolution, pad-only
calls, negative padding, flip_filter, ADA's 12-tap separable filters,
filtered_lrelu's), odd and ragged sizes, a misaligned input, the first and
second derivatives, and the launches of one superresolution forward. Without
a card these skip: the kernel has no CPU mode (tests/test_torch_ops.py holds
the plain version to the JAX op and the gradient formula to autograd)."""

import importlib

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu_torch import ops
from gnerf_tpu_torch.models.stylegan3 import design_lowpass_filter

mod = importlib.import_module("gnerf_tpu_torch.ops.upfirdn2d")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain version's convolutions in fp32
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = tf32


def _filter(kind: str):
    """The callers' filters: StyleGAN2's [1, 3, 3, 1] (2-D 4x4), ADA's
    sym6 wavelet (12 separable taps), filtered_lrelu's Kaiser (separable)
    and jinc (radial, 2-D) filters at factors 2 and 4, a ragged 2-D one."""
    if kind == "none":
        return None
    if kind == "4x4":
        return ops.setup_filter([1, 3, 3, 1])
    if kind == "sym6":
        from gnerf_tpu_torch.training.augment import WAVELETS

        return ops.setup_filter(WAVELETS["sym6"])
    if kind == "blur13":  # EG3D's blur at sigma 2 (training/eg3d_loss.py): 13 taps, 1-D
        t = torch.arange(-6, 7, dtype=torch.float32)
        f = torch.exp2(-(t / 2.0).square())
        return f / f.sum()
    if kind.startswith("kaiser") or kind.startswith("jinc"):
        factor = int(kind[-1])
        f = design_lowpass_filter(6 * factor, 8.0, 9.0, 64, radial=kind.startswith("jinc"))
        return torch.as_tensor(f, dtype=torch.float32)
    return torch.tensor(np.random.RandomState(35).rand(3, 5), dtype=torch.float32)


# (name, shape, dtype, filter, up, down, padding, flip_filter, gain)
CASES = [
    ("sr_block1_up2", (15, 256, 256, 256), torch.bfloat16, "4x4", 2, 1, (3, 2, 3, 2), False, 4),
    ("sr_block0_up2", (15, 32, 128, 128), torch.bfloat16, "4x4", 2, 1, (3, 2, 3, 2), False, 4),
    ("skip_image_fp32", (15, 3, 256, 256), torch.float32, "4x4", 2, 1, (2, 1, 2, 1), False, 4),
    ("train_sr_up2_fp32", (4, 256, 256, 256), torch.float32, "4x4", 2, 1, (3, 2, 3, 2), False, 4),
    ("up2_grad_down2_flip", (4, 256, 514, 514), torch.float32, "4x4", 1, 2, (0, 0, 0, 0), True, 4),
    ("down2_1x1_conv", (4, 128, 64, 64), torch.float32, "4x4", 1, 2, (1, 1, 1, 1), False, 1),
    ("down2_3x3_conv_filter", (4, 128, 64, 64), torch.float32, "4x4", 1, 1, (2, 2, 2, 2), False, 1),
    ("down2_bf16", (3, 64, 65, 63), torch.bfloat16, "4x4", 1, 2, (1, 1, 1, 1), False, 1),
    ("pad_only", (2, 8, 17, 19), torch.float32, "none", 1, 1, (1, 0, 2, 1), False, 1),
    ("pad_only_crop", (2, 8, 17, 19), torch.bfloat16, "none", 1, 1, (-1, 2, 0, -3), False, 1),
    ("negative_padding_up2", (2, 5, 21, 23), torch.bfloat16, "4x4", 2, 1, (-1, 0, 1, -2), False, 4),
    ("flip_filter_2d", (2, 5, 21, 23), torch.float32, "ragged", 2, 1, (2, 3, 1, 2), True, 2),
    ("ada_sym6_up2", (4, 3, 100, 100), torch.float32, "sym6", 2, 1, (6, 5, 6, 5), False, 4),
    ("ada_sym6_down2", (4, 3, 200, 200), torch.float32, "sym6", 1, 2, (-7, -8, -7, -8), True, 1),
    ("lrelu_kaiser_up2", (2, 16, 36, 36), torch.float32, "kaiser2", 2, 1, (11, 10, 11, 10), False, 4),
    ("lrelu_kaiser_down2", (2, 16, 72, 72), torch.bfloat16, "kaiser2", 1, 2, (0, 0, 0, 0), False, 1),
    ("lrelu_kaiser_up4", (2, 8, 20, 20), torch.float32, "kaiser4", 4, 1, (23, 20, 23, 20), False, 16),
    ("lrelu_kaiser_down4", (2, 8, 80, 80), torch.float32, "kaiser4", 1, 4, (0, 0, 0, 0), True, 1),
    ("lrelu_jinc_up2", (2, 8, 36, 36), torch.bfloat16, "jinc2", 2, 1, (11, 10, 11, 10), False, 4),
    ("lrelu_jinc_down4", (2, 8, 80, 80), torch.float32, "jinc4", 1, 4, (1, 2, 3, 0), False, 1),
    ("eg3d_blur_13_taps", (4, 3, 64, 64), torch.float32, "blur13", 1, 1, (6, 6, 6, 6), False, 1),
    ("odd_tiny", (1, 1, 1, 1), torch.bfloat16, "4x4", 2, 1, (2, 1, 2, 1), False, 4),
    ("odd_ragged_up2", (3, 5, 7, 9), torch.bfloat16, "4x4", 2, 1, (3, 2, 3, 2), False, 4),
    ("odd_ragged_down2", (3, 5, 33, 65), torch.float32, "4x4", 1, 2, (1, 2, 2, 1), False, 1),
    ("asymmetric_factors", (2, 3, 19, 17), torch.float32, "ragged", (2, 1), (1, 3), (0, 1, 2, 0),
     False, 1),
    ("many_planes", (70000, 1, 4, 4), torch.bfloat16, "4x4", 2, 1, (2, 1, 2, 1), False, 4),
]


def _reference(x, f, up, down, padding, flip_filter, gain):
    """The plain version in float64 on the card, from the taps the kernel
    uses: f * gain^(f.dim() / 2) in fp32, rounded to x's dtype."""
    if f is not None:
        f = (f.to(x.device) * np.float32(gain ** (f.dim() / 2))).to(x.dtype).double()
    else:
        f = torch.full([1, 1], gain, dtype=torch.float32, device=x.device).to(x.dtype).double()
    return mod._plain(x.double(), f, mod._parse_scaling(up), mod._parse_scaling(down),
                      mod._parse_padding(padding), flip_filter, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain_version(card, case):
    """The kernel against the plain version in float64 from the same inputs
    and taps. fp32: the same products summed in another order, at most 576
    of them: within 1e-5 of the largest output (a few units of fp32's last
    place of the sums' magnitude). bf16: one rounding of an fp32 sum, so
    within half a bf16 step (2^-8 relative) plus that fp32 slack."""
    _, shape, dtype, kind, up, down, padding, flip_filter, gain = case
    g = torch.Generator(device=card).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    if case[0] == "pad_only_crop":  # a misaligned input: 2 bytes past a 16-byte boundary
        buf = torch.randn(x.numel() + 1, generator=g, device=card).to(dtype)
        x = buf[1:].view(shape)
    f = _filter(kind)
    f = None if f is None else f.to(card)
    before = ops.upfirdn2d.launches
    got = ops.upfirdn2d(x, f, up=up, down=down, padding=padding, flip_filter=flip_filter,
                        gain=gain)
    torch.cuda.synchronize()
    assert ops.upfirdn2d.launches == before + 1
    want = _reference(x, f, up, down, padding, flip_filter, gain)
    assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous()
    rtol = 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    atol = 1e-5 * want.abs().max().item()
    torch.testing.assert_close(got.double(), want, rtol=rtol, atol=atol)
    del want
    # The plain version in the working type, the route the kernel replaced.
    plain = mod._plain(x, f, mod._parse_scaling(up), mod._parse_scaling(down),
                       mod._parse_padding(padding), flip_filter, float(gain))
    slack = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), plain.float(), rtol=slack,
                               atol=slack * plain.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("kind,up,down,padding,flip", [
    ("4x4", 2, 1, (3, 2, 3, 2), False),        # SR's up=2 conv0 in training
    ("4x4", 1, 2, (1, 1, 1, 1), False),        # D's FIR downsampling (R1)
    ("sym6", 2, 1, (6, 5, 6, 5), False),       # ADA
    ("ragged", (2, 1), (1, 3), (0, 1, 2, 0), True),
])
def test_kernel_derivatives_match_autograd_of_plain_version(card, kind, up, down, padding, flip):
    """First and second derivatives (R1's double backward) of the kernel's
    Function against autograd through the plain version, fp32 on the card,
    TF32 off: within 1e-5 of each tensor's largest value (sums in another
    order)."""
    f = _filter(kind).to(card)
    g = torch.Generator(device=card).manual_seed(3)
    x0 = torch.randn(2, 6, 33, 30, generator=g, device=card)
    out = {}
    for route in ("kernel", "plain"):
        x = x0.clone().requires_grad_()
        if route == "kernel":
            before = ops.upfirdn2d.launches
            y = ops.upfirdn2d(x, f, up=up, down=down, padding=padding, flip_filter=flip, gain=2)
        else:
            y = mod._plain(x, f, mod._parse_scaling(up), mod._parse_scaling(down),
                           mod._parse_padding(padding), flip, 2.0)
        (gx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
        (ggx,) = torch.autograd.grad(gx.square().sum(), x)
        out[route] = (y, gx, ggx)
        if route == "kernel":
            torch.cuda.synchronize()
            assert ops.upfirdn2d.launches == before + 4  # forward, backward, and both again
    for a, b in zip(out["kernel"], out["plain"]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())


@pytest.mark.cuda
def test_superresolution_forward_launches_the_kernel(card):
    """One tiny SuperresolutionHybrid8XDC forward: block0 and block1 each
    upsample their features (conv0, up=2) and the skip image: 4 launches."""
    from gnerf_tpu_torch.models.superresolution import SuperresolutionHybrid8XDC
    from gnerf_tpu_torch.utils import prng

    sr = SuperresolutionHybrid8XDC(channels=32, img_resolution=512, w_dim=16,
                                   input_resolution=16, key=prng.PRNGKey(5)).to(card)
    g = torch.Generator(device=card).manual_seed(16)
    rgb = torch.randn(1, 3, 16, 16, generator=g, device=card)
    x = torch.randn(1, 32, 16, 16, generator=g, device=card)
    ws = torch.randn(1, 4, 16, generator=g, device=card)
    before = ops.upfirdn2d.launches
    with torch.no_grad():
        img, _ = sr(rgb, x, ws, noise_mode="none", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert tuple(img.shape) == (1, 3, 64, 64) and bool(torch.isfinite(img).all())
    assert ops.upfirdn2d.launches == before + 4


# (name, shape [N, C, H, W], padding, styles): the channels-last instance's
# calls, the route's up layers (`models/stylegan2.py`) at the orbit chunk's
# shapes, and the other paddings' quads.
CHANNELS_LAST_CASES = [
    ("orbit_block1_conv0", (15, 256, 256, 256), (3, 2, 3, 2), True),
    ("orbit_block0_conv0", (15, 32, 128, 128), (3, 2, 3, 2), True),
    ("backbone_b8_conv0", (1, 512, 4, 4), (3, 2, 3, 2), True),
    ("even_padding_no_styles", (2, 8, 17, 23), (2, 1, 2, 1), False),
    ("crop_and_mixed_parity", (3, 16, 9, 7), (-1, 2, 0, 3), True),
    ("odd_and_even_padding", (2, 24, 6, 5), (3, 2, 1, 4), True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CHANNELS_LAST_CASES, ids=[c[0] for c in CHANNELS_LAST_CASES])
def test_channels_last_instance_equals_nchw_kernel(card, case):
    """`upfirdn2d_channels_last` (one launch of the channels-last instance,
    the styles applied on the way in) equals the NCHW kernel on the input
    scaled the plain way (`x * styles` in bf16), bit for bit, as a
    channels-last tensor."""
    _, shape, padding, with_styles = case
    g = torch.Generator(device=card).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=card).to(torch.bfloat16)
    styles = torch.randn(shape[:2], generator=g, device=card) if with_styles else None
    f = ops.setup_filter([1, 3, 3, 1]).to(card)
    want = ops.upfirdn2d(mod._styled(x, styles), f, up=2, padding=padding, gain=4)
    xl = x.contiguous(memory_format=torch.channels_last)
    before = ops.upfirdn2d.launches
    got = ops.upfirdn2d_channels_last(xl, f, padding=padding, gain=4, styles=styles)
    torch.cuda.synchronize()
    assert ops.upfirdn2d.launches == before + 1
    assert got.shape == want.shape and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


def test_channels_last_plain_version():
    """On the CPU `upfirdn2d_channels_last` is the plain version of
    `upfirdn2d(x * styles, up=2)` (styles rounded to x's dtype first), as a
    channels-last tensor; it refuses a filter that is not 4x4."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 8, 6, 7, generator=g).to(torch.bfloat16)
    styles = torch.randn(2, 8, generator=g)
    f = ops.setup_filter([1, 3, 3, 1])
    got = ops.upfirdn2d_channels_last(x.contiguous(memory_format=torch.channels_last), f,
                                      padding=(3, 2, 3, 2), gain=4, styles=styles)
    want = ops.upfirdn2d(x * styles.to(x.dtype)[:, :, None, None], f, up=2,
                         padding=(3, 2, 3, 2), gain=4)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        ops.upfirdn2d_channels_last(x, ops.setup_filter([1, 2, 1]), padding=1)
