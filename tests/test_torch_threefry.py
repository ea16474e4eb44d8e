"""The threefry kernel (`gnerf_tpu_torch/csrc/threefry.cu`, through
`ops/threefry.py::threefry_draw`) against its plain version on the card:
the step's draw shapes, a rank's block at data=2 and at rays=2, edge sizes,
keys on the host and on the card, bits, uniform and normal draws, and the
key pairs of split and fold_in. Without a card these skip: the kernel has
no CPU mode (tests/test_torch_prng.py holds the plain version to
jax.random)."""

import pytest
import torch

from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu_torch.utils import prng


# The kernel (csrc/threefry.cu) against the plain version: the step's draw
# shapes, a rank's block at data=2 and at rays=2, and edge sizes.
KERNEL_DRAWS = [((4, 4096, 48, 1), None), ((16384, 48), None), ((4, 1, 512, 512), None),
                ((4, 1, 512, 512), {0: (2, 2)}), ((4, 4096, 48, 1), {1: (2048, 2048)}),
                ((0,), None), ((1,), None), ((5003,), None), (((1 << 24) + 3,), None)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,part", KERNEL_DRAWS, ids=str)
def test_threefry_kernel_matches_plain_version(shape, part):
    """Each kind of draw from the kernel against the plain version in torch
    ops on the card and on the CPU: bits and uniform bit for bit, normal
    within 1e-6 (both on the card take CUDA's log1pf; the CPU's log1p may
    differ from it in the last place)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gnerf_tpu_torch.ops import threefry as T

    dev = torch.device("cuda")
    for key in (prng.PRNGKey(5), prng.PRNGKey(5, device="cuda")):
        for kind, lo, hi in (("bits", 0.0, 1.0), ("uniform", -0.3, 2.5), ("normal", 0.0, 1.0)):
            before = T.threefry_draw.launches
            got = T.threefry_draw(key, shape, part, dev, kind, lo, hi)
            assert T.threefry_draw.launches == before + (got.numel() > 0)
            span = T._bounds(kind, lo, hi)
            on_card = T._plain(key, shape, part, dev, kind, *span).reshape(got.shape)
            on_cpu = T.threefry_draw(key.cpu(), shape, part, None, kind, lo, hi)
            if kind == "normal":
                torch.testing.assert_close(got, on_card, rtol=0, atol=1e-6)
                torch.testing.assert_close(got.cpu(), on_cpu, rtol=0, atol=1e-6)
            else:
                assert torch.equal(got, on_card) and torch.equal(got.cpu(), on_cpu)
    keys = prng.split(prng.PRNGKey(5, device="cuda"), 7)
    assert keys.is_cuda and torch.equal(keys.cpu(), prng.split(prng.PRNGKey(5), 7))
    assert torch.equal(prng.fold_in(keys[3], 2 ** 32 - 1).cpu(),
                       prng.fold_in(keys[3].cpu(), 2 ** 32 - 1))


def _bgc_table(n: int):
    """The bgc ADA pipe's draws at batch n (a 6-channel D input), one key of
    a split each, as (kind, key, shape)."""
    from gnerf_tpu_torch.training.augment import AugmentPipe
    from gnerf_tpu_torch.training.eg3d_loss import BGC_SPEC

    keys = prng.split(prng.PRNGKey(21), 32)
    return [(kind, keys[i], (n,) + shape)
            for i, (kind, shape) in enumerate(AugmentPipe(**BGC_SPEC)._draw_plan(6))]


def _noise_table(n: int):
    """The noise layers of a 256^2 backbone and an 8XDC SR module at batch n."""
    keys = prng.split(prng.PRNGKey(22), 10)
    out = []
    for res, k in zip([4, 8, 16, 32, 64, 128, 256, 64, 256, 512], keys):
        out += [("normal", kk, (n, 1, res, res)) for kk in prng.split(k)[:1 if res == 4 else 2]]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["bgc", "noise"])
@pytest.mark.parametrize("part", [None, "data=2", "rays=2"])
def test_batched_draws_equal_single_draws(table, part):
    """A table of draws in one `threefry_draws` launch (keys on the host, a
    rank's rows at data=2 or its half of dimension 1 at rays=2, where the
    draw has one) equals its single kernel draws bit for bit, and the
    normal draws the plain version within 1e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gnerf_tpu_torch.ops import threefry as T

    dev = torch.device("cuda")
    draws = []
    for kind, key, shape in (_bgc_table(4) if table == "bgc" else _noise_table(4)):
        p = None
        if part == "data=2":
            p = {0: (2, 2)}
        elif part == "rays=2" and len(shape) > 1 and shape[1] > 1:
            p = {1: (shape[1] // 2, shape[1] // 2)}
        draws.append((key, shape, p, kind, 0.0, 1.0))
    before = T.threefry_draw.launches
    got = T.threefry_draws(draws, dev)
    assert T.threefry_draw.launches == before + 1
    for (key, shape, p, kind, lo, hi), g in zip(draws, got):
        assert torch.equal(g, T.threefry_draw(key, shape, p, dev, kind, lo, hi))
        if kind == "normal":
            plain = T._plain(key, shape, p, dev, kind, *T._bounds(kind, lo, hi))
            torch.testing.assert_close(g.reshape(-1), plain, rtol=0, atol=1e-6)
