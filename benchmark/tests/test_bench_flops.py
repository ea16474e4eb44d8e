"""FLOP counts over the reference, against hand arithmetic."""

import math

import torch
import torch.nn.functional as F

from benchmark import roofline
from benchmark.reference import gnerf as ref


def test_one_convolution():
    x, w = torch.randn(2, 8, 16, 16), torch.randn(4, 8, 3, 3)
    flops, _ = roofline.count_flops(F.conv2d, x, w, padding=1)
    assert flops == 2 * 2 * 4 * 16 * 16 * 8 * 9


def test_convolution_backward_counts_both_gradients():
    x = torch.randn(2, 8, 16, 16, requires_grad=True)
    w = torch.randn(4, 8, 3, 3, requires_grad=True)

    def step():
        return torch.autograd.grad(F.conv2d(x, w, padding=1).sum(), [x, w])

    flops, _ = roofline.count_flops(step)
    assert flops == 3 * (2 * 2 * 4 * 16 * 16 * 8 * 9)


def test_decoder_mlp():
    n, m, c, h, d = 1, 1000, 32, 64, 33
    feats = torch.randn(n, 3, m, c)
    w1, b1, w2, b2 = torch.randn(c, h), torch.randn(h), torch.randn(h, d), torch.randn(d)
    flops, out = roofline.count_flops(ref.osg_decode_ref, feats, w1, b1, w2, b2)
    assert out.shape == (n, m, d)
    assert flops == 3 * (2 * m * c * h) + 2 * m * h * d


def test_tiny_frame_counts_its_convolutions():
    """A frame of a tiny generator: at least the 8XDC's 3x3 convolutions,
    counted by hand from their shapes, and the decoder's two passes."""
    from benchmark import weights

    g = ref.Generator(plane_resolution=16, channel_base=256, channel_max=16, neural_res=8,
                      depth_resolution=4, depth_resolution_importance=4)
    e = ref.Encoder(layers=(1, 1, 1, 1))
    trees = weights.draw({"G": g, "E": e}, 3, "cpu")
    ref.load_state(g, trees["G"], "cpu")
    ws = torch.randn(1, g.backbone.num_ws, 512)
    planes = g.planes(ws, torch.float32)
    flops, _ = roofline.count_flops(ref.frame, g, ws, planes, math.pi / 2, math.pi / 2,
                                    torch.float32)
    sr = 0
    for res, cin, cout in ((64, 32, 32), (64, 32, 32), (256, 32, 256), (256, 256, 256),
                           (512, 256, 128), (512, 128, 128)):
        sr += 2 * res * res * cout * cin * 9
    rays = 8 * 8
    decoder = 2 * (3 * 2 * rays * 4 * 32 * 64 + 2 * rays * 4 * 64 * 33)
    assert flops >= sr + decoder
    assert flops < 1.2 * (sr + decoder) + 2e8  # the rest: 1x1 ToRGB, affines, resizes
