"""The tri-plane sampling kernel (`gnerf_tpu_torch/csrc/triplane_sample.cu`,
through `ops/triplane_sample.py::triplane_sample`) against its plain version,
the `F.grid_sample` route (`renderer.grid_sample_planes`), on the card: fp32 and bf16 planes, N = 1 and 4, C = 8 and 32, square and
non-square planes, points inside, outside, on the planes' edges and at texel
centres, a ragged M; the inputs it refuses; and the renderer's route (no
gradient: one launch a call; a gradient: `F.grid_sample`, no launch).
Without a card these skip: the kernel has no CPU mode
(tests/test_torch_render.py holds the plain version to the JAX package)."""

import numpy as np
import pytest
import torch

from gnerf_tpu_torch.ops import triplane_sample
from gnerf_tpu_torch.render import renderer


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _points(n: int, m: int, box_warp: float, h: int, w: int, seed: int) -> torch.Tensor:
    """[N, M, 3]: random points over 1.3 boxes, every 7th on a texel centre,
    every 11th on a plane's edge."""
    rng = np.random.RandomState(seed)
    half = box_warp / 2
    pts = rng.uniform(-1.3 * half, 1.3 * half, (n, m, 3))
    pts[:, ::7, 0] = ((2 * rng.randint(0, w, pts[:, ::7, 0].shape) + 1) / w - 1) * half
    pts[:, ::7, 1] = ((2 * rng.randint(0, h, pts[:, ::7, 1].shape) + 1) / h - 1) * half
    pts[:, ::11, 2] = half * np.sign(pts[:, ::11, 2])
    return torch.tensor(pts, dtype=torch.float32)


# (n, m, c, h, w, dtype, box_warp)
CASES = [
    (1, 15 * 64 * 24, 32, 256, 256, torch.bfloat16, 1.0),
    (4, 4096 + 5, 32, 64, 64, torch.bfloat16, 1.0),
    (4, 3 * 1000, 32, 128, 128, torch.float32, 1.0),
    (1, 1 << 12, 8, 16, 48, torch.float32, 0.75),
    (2, 777, 8, 40, 24, torch.bfloat16, 2.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=[f"n{c[0]}-m{c[1]}-c{c[2]}-{c[3]}x{c[4]}-"
                                             f"{str(c[5])[6:]}" for c in CASES])
def test_kernel_matches_plain(card, case):
    """fp32 within 1e-6 of the largest output; bf16 within one ulp."""
    n, m, c, h, w, dtype, box_warp = case
    gen = torch.Generator(device="cuda").manual_seed(m + c)
    planes = torch.randn((n, 3, c, h, w), generator=gen, device=card).to(dtype)
    coords = _points(n, m, box_warp, h, w, seed=m).to(card)
    before = triplane_sample.launches
    got = triplane_sample(planes, coords, box_warp)
    want = renderer.grid_sample_planes(planes, coords, box_warp)
    torch.cuda.synchronize()
    assert triplane_sample.launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous()
    scale = want.float().abs().max().item()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-6
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=1e-6 * scale)


@pytest.mark.cuda
def test_kernel_refuses(card):
    planes = torch.zeros((1, 3, 12, 8, 8), device=card)
    coords = torch.zeros((1, 5, 3), device=card)
    with pytest.raises(ValueError, match="multiple of 8"):
        triplane_sample(planes, coords, 1.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        triplane_sample(torch.zeros((1, 3, 8, 8, 8), device=card, dtype=torch.float16),
                        coords, 1.0)
    with pytest.raises(ValueError, match="coordinates on"):
        triplane_sample(torch.zeros((1, 3, 8, 8, 8), device=card), coords.cpu(), 1.0)
    with pytest.raises(ValueError, match="coordinates must be"):
        triplane_sample(torch.zeros((2, 3, 8, 8, 8), device=card), coords, 1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        triplane_sample(planes.cpu(), coords.cpu(), 1.0)


@pytest.mark.cuda
def test_renderer_route(card):
    """Without a gradient `sample_from_planes` launches the kernel once; with
    one it stays on `F.grid_sample` (no launch) and gives the same values."""
    planes = torch.randn((2, 3, 32, 32, 32), device=card)
    coords = _points(2, 2000, 1.0, 32, 32, seed=3).to(card)
    before = triplane_sample.launches
    with torch.no_grad():
        fast = renderer.sample_from_planes(planes, coords, box_warp=1.0)
    assert triplane_sample.launches == before + 1
    slow = renderer.sample_from_planes(planes.requires_grad_(), coords, box_warp=1.0)
    torch.cuda.synchronize()
    assert triplane_sample.launches == before + 1 and slow.grad_fn is not None
    torch.testing.assert_close(fast, slow.detach(), rtol=1e-6, atol=1e-6)
