"""Seeded weights in the JAX param layout, drawn on the device in one call.

The leaf list comes from the frozen reference's modules (built on `meta`),
whose names are the JAX trees' and the program's. Every leaf is
`mean + std * N(0, 1)`, all of them from one `torch.randn` on the device;
`rule` gives (mean, std) by the leaf's name and shape. The draws keep the
program's initial scales (equalized-LR weights N(0, 1), the mapping's
N(0, 100), Kaiming convolutions in E), and give the biases, BN statistics
and noise strengths small random values so that no path is multiplied by
zero. Three departures make a random model whose frames depend on its
inputs, so that a wrong identity or pose shows in the comparison:
- the ToRGB weights are drawn at N(0, 0.2): at N(0, 1) two thirds of the
  pixels clip to 0 or 255, where no difference can show;
- the OSG decoder's weights at N(0, 4): at N(0, 1) densities stay low and
  colours near 0.5, every ray averages the same, and the rendered image is
  flat (frames of two poses differed by 0.4 uint8 levels on average);
- E's BatchNorm statistics are those of a batch of the run's photos
  (`fit_bn`): with statistics drawn at random, activations grow ~600-fold
  through the four stages and a common part swamps the photo, so that two
  photos gave nearly the same identity.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def rule(net: str, name: str, shape: tuple) -> tuple[float, float]:
    """(mean, std) of one leaf. `net` is the tree's root: "G", "E", "D" (the
    depth discriminator, drawn as G's StyleGAN2 layers are) or "V" (VGG)."""
    leaf = name.rsplit("/", 1)[-1]
    if net == "E":
        if name.startswith("fc/"):  # torch.nn.Linear's uniform init over fan-in 8192, by its std
            return 0.0, 1.0 / math.sqrt(3 * 2048 * 4)
        if leaf in ("scale", "var"):
            return 1.0, 0.1
        if leaf in ("bias", "mean"):
            return 0.0, 0.1
        return 0.0, math.sqrt(2.0 / math.prod(shape[1:]))
    if net == "V":  # the LPIPS VGG16: Kaiming convolutions, LPIPS' uniform lin weights
        if leaf.startswith("lin"):
            return 1.0 / shape[0], 0.1 / shape[0]
        return (0.0, 0.01) if leaf == "bias" else (0.0, math.sqrt(2.0 / math.prod(shape[1:])))
    if leaf == "weight" and "/torgb/" in f"/{name}":
        return 0.0, 0.2  # keeps frames and planes out of saturation
    if leaf == "weight" and name.startswith("decoder/"):
        return 0.0, 4.0  # densities and colours that vary along a ray
    if leaf == "noise_strength":
        return 0.0, 0.05
    if leaf == "bias":
        return (1.0, 0.1) if name.endswith("affine/bias") else (0.0, 0.1)
    if leaf == "weight" and "/mapping/fc" in f"/{name}":
        return 0.0, 100.0  # N(0, 1) / lr_multiplier 0.01
    return 0.0, 1.0


def draw(modules: dict[str, nn.Module], seed: int, device) -> dict[str, dict[str, torch.Tensor]]:
    """{root: {jax/path: tensor on `device`}} for each module (built on meta)."""
    plan = []
    for net, module in modules.items():
        for key, value in module.state_dict().items():
            name = key.replace(".", "/")
            plan.append((net, name, tuple(value.shape), *rule(net, name, tuple(value.shape))))
    sizes = [math.prod(shape) for _, _, shape, _, _ in plan]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    counts = torch.tensor(sizes, device=device)
    std = torch.repeat_interleave(torch.tensor([p[4] for p in plan], device=device), counts)
    mean = torch.repeat_interleave(torch.tensor([p[3] for p in plan], device=device), counts)
    flat = flat * std + mean
    out: dict[str, dict[str, torch.Tensor]] = {net: {} for net in modules}
    for (net, name, shape, _, _), part in zip(plan, flat.split(sizes)):
        out[net][name] = part.view(shape)
    return out


def fit_bn(enc: nn.Module, tree: dict, photos, device) -> None:
    """Set the BatchNorm running statistics in `tree` (E's) to those of a
    batch of uint8 photos [N, 3, H, W], layer by layer as a forward pass in
    train mode meets them. `enc` is the reference encoder on `meta`."""
    from benchmark.reference import gnerf as ref

    ref.load_state(enc, tree, device)
    for m in enc.modules():
        if isinstance(m, ref.BatchNorm):
            m.momentum = 1.0
    with torch.no_grad():
        enc(torch.as_tensor(photos, device=device).float() / 127.5 - 1.0, train=True)
    for key, value in enc.state_dict().items():
        if key.endswith((".mean", ".var")):
            tree[key.replace(".", "/")] = value.clone()


def to_host(trees: dict[str, dict[str, torch.Tensor]]) -> dict[str, dict]:
    """The same trees as numpy arrays, for the program's checkpoint load path."""
    return {net: {k: v.cpu().numpy() for k, v in tree.items()} for net, tree in trees.items()}
