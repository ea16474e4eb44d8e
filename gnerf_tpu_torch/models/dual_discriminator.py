"""EG3D dual-discrimination discriminators, as PyTorch modules.

Port of `gnerf_tpu/models/dual_discriminator.py`: the EG3D trick of
discriminating the final image concatenated with the (resized) raw
neural-render image, so G cannot cheat the superresolution. Each class is the
port's `Discriminator` trunk (6 input channels for the dual forms), so its
parameter names are the JAX trees' and `load_jax_params` takes them
unchanged, and a `key` gives the JAX `init`'s parameters. `raw_fade` of
`DummyDualDiscriminator` is an explicit argument, and `disc_c_noise` draws
from the call's key, as the JAX `apply` draws it. Constructed on CUDA unless `device`
names another device.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import torch

from ..ops.interpolate import interpolate_bilinear
from ..ops.upfirdn2d import downsample2d, setup_filter, upsample2d
from ..parallel.sharding import draw, global_rows
from ..utils import prng
from ..utils.profiling import profiled_function
from .stylegan2 import Discriminator


def filtered_resizing(image: torch.Tensor, size: int, f: Optional[torch.Tensor] = None,
                      filter_mode: Union[str, float] = "antialiased") -> torch.Tensor:
    """Resize raw images to the final-image resolution: `antialiased`
    bilinear, `classic` (FIR upsample x2, bilinear to 2 size + 2, FIR
    downsample x2 with the filter flipped and one pixel cropped), `none`
    (plain bilinear) or a float in (0, 1) blending aliased and filtered."""
    if filter_mode == "antialiased":
        return interpolate_bilinear(image, size, size, antialias=True)
    if filter_mode == "classic":
        x = upsample2d(image, f, up=2)
        x = interpolate_bilinear(x, size * 2 + 2, size * 2 + 2, antialias=False)
        return downsample2d(x, f, down=2, flip_filter=True, padding=-1)
    if filter_mode == "none":
        return interpolate_bilinear(image, size, size, antialias=False)
    if not (isinstance(filter_mode, float) and 0 < filter_mode < 1):
        raise ValueError(f"unknown filter_mode {filter_mode!r}")
    filtered = interpolate_bilinear(image, size, size, antialias=True)
    aliased = interpolate_bilinear(image, size, size, antialias=False)
    return (1 - filter_mode) * aliased + filter_mode * filtered


def _resized_raw(img: Mapping[str, torch.Tensor], filter_mode) -> torch.Tensor:
    f = setup_filter([1, 3, 3, 1], device=img["image"].device)
    return filtered_resizing(img["image_raw"], size=img["image"].shape[-1], f=f,
                             filter_mode=filter_mode)


class SingleDiscriminator(Discriminator):
    """Plain StyleGAN2 D over the final image only."""

    def forward(self, img: Mapping[str, torch.Tensor], c: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return super().forward(img["image"], c, dtype=dtype)


class DualDiscriminator(Discriminator):
    """EG3D dual discrimination: concat(image, resized image_raw) -> a D over
    2x the channels. With `disc_c_noise` > 0 the labels get Gaussian noise
    scaled by their batch standard deviation, drawn from the key `rng`."""

    def __init__(self, c_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512,
                 conv_clamp: Optional[float] = 256, mbstd_group_size: Optional[int] = 4,
                 disc_c_noise: float = 0.0, filter_mode: Union[str, float] = "antialiased",
                 device=None, key: Optional[torch.Tensor] = None):
        super().__init__(c_dim, img_resolution, img_channels * 2, channel_base=channel_base,
                         channel_max=channel_max, conv_clamp=conv_clamp,
                         mbstd_group_size=mbstd_group_size, device=device, key=key)
        self.disc_c_noise = disc_c_noise
        self.filter_mode = filter_mode

    def forward(self, img: Mapping[str, torch.Tensor], c: Optional[torch.Tensor] = None,
                rng: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = torch.cat([img["image"], _resized_raw(img, self.filter_mode)], dim=1)
        if self.c_dim > 0 and self.disc_c_noise > 0:
            if rng is None:
                raise ValueError("disc_c_noise needs a key (rng)")
            noise = draw(prng.normal, rng, c.shape, device=c.device)
            c = c + noise * global_rows(c).std(dim=0, correction=0) * self.disc_c_noise
        return super().forward(x, c, dtype=dtype)

    @profiled_function("disc")
    def apply(self, img, c=None, rng=None, dtype=torch.float32) -> torch.Tensor:
        return self.forward(img, c, rng=rng, dtype=dtype)


class DummyDualDiscriminator(Discriminator):
    """Dual D whose raw branch fades out over training: the resized raw
    image is scaled by `raw_fade` (the caller's max(0, 1 - cur_nimg / 500000))."""

    def __init__(self, c_dim: int, img_resolution: int, img_channels: int,
                 channel_base: int = 32768, channel_max: int = 512,
                 conv_clamp: Optional[float] = 256, mbstd_group_size: Optional[int] = 4,
                 device=None, key: Optional[torch.Tensor] = None):
        super().__init__(c_dim, img_resolution, img_channels * 2, channel_base=channel_base,
                         channel_max=channel_max, conv_clamp=conv_clamp,
                         mbstd_group_size=mbstd_group_size, device=device, key=key)

    def forward(self, img: Mapping[str, torch.Tensor], c: Optional[torch.Tensor] = None,
                raw_fade: float = 1.0, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = torch.cat([img["image"], _resized_raw(img, "antialiased") * raw_fade], dim=1)
        return super().forward(x, c, dtype=dtype)

    @profiled_function("disc")
    def apply(self, img, c=None, raw_fade=1.0, dtype=torch.float32) -> torch.Tensor:
        return self.forward(img, c, raw_fade=raw_fade, dtype=dtype)
