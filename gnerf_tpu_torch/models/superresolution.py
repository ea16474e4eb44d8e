"""Superresolution: neural-render features -> final RGB image.

Port of `gnerf_tpu/models/superresolution.py`: StyleGAN2 SynthesisBlocks
conditioned on the last w (repeated x3 per block), with a torch-parity
bilinear (+ antialias) resize between stages. All seven variants:

  SuperresolutionHybrid8XDC     FFHQ/AFHQ 512^2, the shipped checkpoints' module
  SuperresolutionHybrid8X       EG3D-style 512^2
  SuperresolutionHybrid4X       256^2
  SuperresolutionHybrid2X       ShapeNet 128^2
  SuperresolutionHybridDeepfp32 legacy 256^2
  SuperresolutionHybrid8five    deeper 512^2
  SuperresolutionHybrid8seven   deepest 512^2

Every forward returns (image, image_raw); variants without a 64^2 raw branch
return the input rgb as image_raw. Blocks are named as in the JAX param
trees, so `load_jax_params` bridges them unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.interpolate import interpolate_bilinear
from ..utils import prng
from .stylegan2 import SynthesisBlock, draw_noise, root_key


def _block_ws(ws: torch.Tensor) -> torch.Tensor:
    """Last w broadcast to the 3 (conv0, conv1, torgb) slots of each block."""
    return ws[:, -1:, :].repeat(1, 3, 1)


class _SRBase(nn.Module):
    """Builds the blocks of `BLOCKS`, in order: (name, in channels, out
    channels, resolution, is_last, up); None stands for `channels`. Block
    i takes the i-th key of `key`'s split, as the JAX `init` does."""

    IMG_RESOLUTION = 512
    INPUT_RESOLUTION = 128
    BLOCKS: tuple = ()

    def __init__(self, channels: int, img_resolution: int, sr_num_fp16_res: int = 0,
                 sr_antialias: bool = True, w_dim: int = 512, use_noise: bool = True,
                 input_resolution: Optional[int] = None, key: Optional[torch.Tensor] = None):
        super().__init__()
        if img_resolution != self.IMG_RESOLUTION:
            raise ValueError(f"{type(self).__name__} produces {self.IMG_RESOLUTION}^2 images")
        self.channels = channels
        self.img_resolution = img_resolution
        self.sr_antialias = sr_antialias
        self.input_resolution = input_resolution or self.INPUT_RESOLUTION
        conv_clamp = 256 if sr_num_fp16_res > 0 else None
        keys = prng.split(root_key(key), len(self.BLOCKS))
        for (name, cin, cout, res, is_last, up), k in zip(self.BLOCKS, keys):
            self.add_module(name, SynthesisBlock(
                channels if cin is None else cin, channels if cout is None else cout, w_dim,
                res, img_channels=3, is_last=is_last, conv_clamp=conv_clamp, up=up,
                use_noise=use_noise, key=k))

    def _resize(self, x, rgb, antialias):
        r = self.input_resolution
        return (interpolate_bilinear(x, r, r, antialias=antialias),
                interpolate_bilinear(rgb, r, r, antialias=antialias))

    def _noise(self, rng, noise_mode, x):
        """Each block's noise (`draw_noise`: `rng` split into one key per
        block of `BLOCKS`, as the JAX `apply` splits it), drawn in one
        launch for random noise."""
        blocks = [getattr(self, name) for name, *_ in self.BLOCKS]
        return draw_noise(blocks, rng if noise_mode == "random" else None, x.shape[0], x.device)

    def _blocks(self, names, x, rgb, ws, noises, **kw):
        """The blocks `names` in turn: the image (every caller discards the
        last block's x)."""
        for i, (name, noise) in enumerate(zip(names, noises)):
            x, rgb = getattr(self, name)(x, rgb, ws, noise=noise, need_x=i + 1 < len(names), **kw)
        return rgb


class _DualConditioned(_SRBase):
    """block64 at the input resolution first ('DC': its raw image is
    image_raw and conditions the rest), then the remaining blocks."""

    def forward(self, rgb, x, ws, noise_mode="random", rng=None, dtype=torch.float32):
        ws = _block_ws(ws)
        noises = self._noise(rng, noise_mode, x)
        kw = dict(noise_mode=noise_mode, dtype=dtype)
        x_raw, image_raw = self.block64(x, rgb, ws, noise=noises[0], **kw)
        if x.shape[-1] != self.input_resolution:
            x, rgb = self._resize(x_raw, image_raw, self.sr_antialias)
        else:
            # Shipped quirk, mirrored: the no-interpolate branch keeps the
            # ORIGINAL x (not x_raw), while rgb aliases image_raw.
            rgb = image_raw
        names = [name for name, *_ in self.BLOCKS[1:]]
        rgb = self._blocks(names, x, rgb, ws, noises[1:], **kw)
        return rgb, image_raw


class SuperresolutionHybrid8XDC(_DualConditioned):
    """64^2 feature/rgb -> (512^2 image, 64^2 image_raw)."""

    BLOCKS = (("block64", None, None, 64, True, 1),
              ("block0", None, 256, 256, False, 2),
              ("block1", 256, 128, 512, True, 2))


class SuperresolutionHybrid8five(_DualConditioned):
    """Deeper 512^2 variant."""

    BLOCKS = (("block64", None, None, 64, True, 1),
              ("block0", None, 512, 128, False, 1),
              ("block1", 512, 256, 128, False, 1),
              ("block2", 256, 128, 256, False, 2),
              ("block3", 128, 64, 512, True, 2))


class SuperresolutionHybrid8seven(_DualConditioned):
    """Deepest 512^2 variant."""

    BLOCKS = (("block64", None, None, 64, True, 1),
              ("block0", None, 512, 128, False, 1),
              ("block1", 512, 256, 128, False, 1),
              ("block2", 256, 256, 256, False, 2),
              ("block3", 256, 128, 256, False, 1),
              ("block4", 128, 128, 512, False, 2),
              ("block5", 128, 64, 512, True, 1))


class _Resized(_SRBase):
    """The input resized to `input_resolution` (when `_needs_resize`), then
    block0 and block1; image_raw is the input rgb."""

    ANTIALIAS = True

    def _needs_resize(self, size: int) -> bool:
        return size != self.input_resolution

    def forward(self, rgb, x, ws, noise_mode="random", rng=None, dtype=torch.float32):
        ws = _block_ws(ws)
        image_raw = rgb
        if self._needs_resize(x.shape[-1]):
            x, rgb = self._resize(x, rgb, self.sr_antialias and self.ANTIALIAS)
        rgb = self._blocks(("block0", "block1"), x, rgb, ws, self._noise(rng, noise_mode, x),
                           noise_mode=noise_mode, dtype=dtype)
        return rgb, image_raw


class SuperresolutionHybrid8X(_Resized):
    """128^2 -> 512^2, EG3D-style."""

    BLOCKS = (("block0", None, 128, 256, False, 2),
              ("block1", 128, 64, 512, True, 2))


class SuperresolutionHybrid4X(_Resized):
    """-> 256^2; resizes only inputs smaller than `input_resolution`."""

    IMG_RESOLUTION = 256
    BLOCKS = (("block0", None, 128, 128, False, 1),
              ("block1", 128, 64, 256, True, 2))

    def _needs_resize(self, size: int) -> bool:
        return size < self.input_resolution


class SuperresolutionHybridDeepfp32(SuperresolutionHybrid4X):
    """Legacy 256^2 variant: 4X's blocks, resized without antialiasing."""

    ANTIALIAS = False


class SuperresolutionHybrid2X(_SRBase):
    """ShapeNet: 64^2 -> (128^2 image, 64^2 image_raw)."""

    IMG_RESOLUTION = 128
    INPUT_RESOLUTION = 64
    BLOCKS = (("block64", None, None, 64, True, 1),
              ("block0", None, 256, 128, False, 2),
              ("block1", 256, 128, 128, True, 1))

    def forward(self, rgb, x, ws, noise_mode="random", rng=None, dtype=torch.float32):
        ws = _block_ws(ws)
        noises = self._noise(rng, noise_mode, x)
        kw = dict(noise_mode=noise_mode, dtype=dtype)
        x_raw, image_raw = self.block64(x, rgb, ws, noise=noises[0], **kw)
        # block0 sees the accumulated raw image, not the input rgb (the
        # reference's in-place torgb add aliases the two).
        rgb = self._blocks(("block0", "block1"), x_raw, image_raw, ws, noises[1:], **kw)
        return rgb, image_raw


SR_REGISTRY = {cls.__name__: cls for cls in (
    SuperresolutionHybrid8XDC, SuperresolutionHybrid8X, SuperresolutionHybrid4X,
    SuperresolutionHybrid2X, SuperresolutionHybridDeepfp32, SuperresolutionHybrid8five,
    SuperresolutionHybrid8seven)}


def make_superresolution(name: str, **kwargs) -> nn.Module:
    """An SR module by (reference-compatible, possibly dotted) class name."""
    return SR_REGISTRY[name.split(".")[-1]](**kwargs)
