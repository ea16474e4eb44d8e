"""TriPlaneGenerator: the flagship model (network G), as a PyTorch module.

Port of `gnerf_tpu/models/triplane.py`: StyleGAN2 backbone emitting a
256x256x96 tri-plane, two-pass volume renderer, OSG decoder MLP and a
superresolution module (8XDC by default). As in the JAX package the plane
cache is the explicit split `backbone_planes()` (once per identity) /
`render_planes()` (once per frame); `sample_mixed()` / `sample()` evaluate
the fields at arbitrary points. A call's key (`rng`, `utils.prng`) splits
as the JAX package splits it: `synthesis` into the backbone's and the
render's, `render_planes` into the rays' and the superresolution's.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import torch
from torch import nn

from ..ops.fused_decoder import osg_decode
from ..render.ray_sampler import sample_rays
from ..render.renderer import render_rays, run_model
from ..utils import prng
from ..utils.device import place, resolve_device
from ..utils.profiling import profiled_function, span
from .stylegan2 import FullyConnectedLayer, Generator, root_key
from .superresolution import make_superresolution


class OSGDecoder(nn.Module):
    """2-layer point decoder: plane features -> (sigma, rgb features).

    Mean over the 3 planes, FC -> softplus -> FC, MipNeRF sigmoid clamping
    on rgb, raw sigma. The whole MLP is one `osg_decode` call with the
    equalized-LR gains folded into the weights: the hand-written kernel on
    CUDA tensors, its plain version on CPU tensors. View directions are
    accepted and ignored (parity with the reference)."""

    def __init__(self, n_features: int = 32, hidden_dim: int = 64,
                 decoder_output_dim: int = 32, decoder_lr_mul: float = 1.0,
                 key: Optional[torch.Tensor] = None):
        super().__init__()
        k0, k1 = prng.split(root_key(key))
        self.n_features = n_features
        self.hidden_dim = hidden_dim
        self.lr_mul = decoder_lr_mul
        self.fc0 = FullyConnectedLayer(n_features, hidden_dim, lr_multiplier=decoder_lr_mul,
                                       key=k0)
        self.fc1 = FullyConnectedLayer(hidden_dim, 1 + decoder_output_dim,
                                       lr_multiplier=decoder_lr_mul, key=k1)

    def folded_weights(self, dtype: torch.dtype):
        """(w1e [C, H] in `dtype`, b1e [H], w2e [H, D], b2e [D] fp32): the
        kernel's operands, gains applied as in the JAX `_apply_fused`."""
        lr = self.lr_mul
        w1e = (self.fc0.weight * (lr / math.sqrt(self.n_features))).t().to(dtype).contiguous()
        b1e = (self.fc0.bias * lr).float().contiguous()
        w2e = (self.fc1.weight * (lr / math.sqrt(self.hidden_dim))).t().float().contiguous()
        b2e = (self.fc1.bias * lr).float().contiguous()
        return w1e, b1e, w2e, b2e

    def forward(self, sampled_features: torch.Tensor,
                ray_directions: Optional[torch.Tensor] = None) -> dict[str, torch.Tensor]:
        out = osg_decode(sampled_features.contiguous(),
                         *self.folded_weights(sampled_features.dtype))
        return {"rgb": out[..., 1:], "sigma": out[..., 0:1]}


DEFAULT_RENDERING_KWARGS = dict(
    image_resolution=512,
    disparity_space_sampling=False,
    clamp_mode="softplus",
    superresolution_module="SuperresolutionHybrid8XDC",
    c_gen_conditioning_zero=True,
    c_scale=0.0,
    superresolution_noise_mode="none",
    density_reg=0.25,
    density_reg_p_dist=0.004,
    reg_type="l1",
    decoder_lr_mul=1.0,
    sr_antialias=True,
    depth_resolution=48,
    depth_resolution_importance=48,
    ray_start=2.25,
    ray_end=3.3,
    box_warp=1.0,
    avg_camera_radius=2.7,
    avg_camera_pivot=(0, 0, 0.2),
    white_back=False,
    density_noise=0,
)


class TriPlaneGenerator(nn.Module):
    """Network G. Constructed on CUDA unless `device` names another device,
    from `key` (PRNGKey(0) when None) split as the JAX `init` splits it:
    the same key gives JAX's weights, drawn on that device. On `meta`
    nothing is drawn; `load_jax_params(g, tree, device=...)` fills it."""

    def __init__(self, z_dim: int = 512, c_dim: int = 25, w_dim: int = 512,
                 img_resolution: int = 512, img_channels: int = 3, sr_num_fp16_res: int = 0,
                 mapping_layers: int = 2, channel_base: int = 32768, channel_max: int = 512,
                 plane_resolution: int = 256, plane_channels: int = 32,
                 neural_rendering_resolution: int = 64,
                 rendering_kwargs: Optional[Mapping[str, Any]] = None,
                 use_noise: bool = True, device=None, key: Optional[torch.Tensor] = None):
        super().__init__()
        device = resolve_device(device)
        kb, kd, ks = prng.split(root_key(key).to(device), 3)
        self.rendering_kwargs = dict(
            DEFAULT_RENDERING_KWARGS if rendering_kwargs is None else rendering_kwargs)
        self.z_dim, self.c_dim, self.w_dim = z_dim, c_dim, w_dim
        self.plane_channels = plane_channels
        self.neural_rendering_resolution = neural_rendering_resolution
        rk = self.rendering_kwargs
        self.backbone = Generator(z_dim, c_dim, w_dim, img_resolution=plane_resolution,
                                  img_channels=plane_channels * 3,
                                  mapping_layers=mapping_layers, channel_base=channel_base,
                                  channel_max=channel_max, use_noise=use_noise, key=kb)
        self.decoder = OSGDecoder(n_features=plane_channels, decoder_output_dim=32,
                                  decoder_lr_mul=rk.get("decoder_lr_mul", 1.0), key=kd)
        extra = {}
        if rk.get("sr_input_resolution"):
            extra["input_resolution"] = int(rk["sr_input_resolution"])
        self.superresolution = make_superresolution(
            rk["superresolution_module"], channels=32, img_resolution=img_resolution,
            sr_num_fp16_res=sr_num_fp16_res, sr_antialias=rk.get("sr_antialias", True),
            w_dim=w_dim, use_noise=use_noise, key=ks, **extra)
        place(self, device)

    @property
    def num_ws(self) -> int:
        return self.backbone.num_ws

    @profiled_function("mapping")
    def mapping(self, z, c, truncation_psi=1.0, truncation_cutoff=None) -> torch.Tensor:
        """z (+ conditioning pose) -> broadcast ws; honours
        c_gen_conditioning_zero / c_scale."""
        if self.rendering_kwargs.get("c_gen_conditioning_zero", True):
            c = torch.zeros_like(c)
        c = c * self.rendering_kwargs.get("c_scale", 0.0)
        return self.backbone.mapping(z, c, truncation_psi=truncation_psi,
                                     truncation_cutoff=truncation_cutoff)

    def output_resolution(self) -> int:
        """The side of `synthesis`'s image: the SR module run once, without
        a gradient, on a zero feature image at the neural rendering
        resolution (reduced configurations emit less than img_resolution)."""
        dev = next(self.parameters()).device
        r = self.neural_rendering_resolution
        x = torch.zeros((1, 32, r, r), device=dev)
        with torch.no_grad():
            image, _ = self.superresolution(x[:, :3], x, torch.zeros(
                (1, self.num_ws, self.w_dim), device=dev), noise_mode="none")
        return int(image.shape[-1])

    @profiled_function("backbone")
    def backbone_planes(self, ws, noise_mode="const", rng=None,
                        dtype=torch.float32) -> torch.Tensor:
        """ws -> tri-plane features [N, 3, C, H, W] in `dtype`. The ToRGB skip
        accumulates in fp32, so the planes are cast explicitly."""
        planes = self.backbone.synthesis(ws, noise_mode=noise_mode, rng=rng, dtype=dtype)
        planes = planes.to(dtype)
        return planes.reshape(planes.shape[0], 3, self.plane_channels,
                              planes.shape[-2], planes.shape[-1])

    @profiled_function("render")
    def render_planes(self, planes, c, ws, neural_rendering_resolution=None,
                      noise_mode="const", rng=None, dtype=torch.float32,
                      rendering_kwargs=None, superres=True) -> dict[str, torch.Tensor]:
        """Volume-render cached planes under camera `c`, then superresolve."""
        opts = dict(self.rendering_kwargs)
        if rendering_kwargs:
            opts.update(rendering_kwargs)
        res = neural_rendering_resolution or self.neural_rendering_resolution
        cam2world = c[:, :16].reshape(-1, 4, 4)
        intrinsics = c[:, 16:25].reshape(-1, 3, 3)
        ray_origins, ray_dirs = sample_rays(cam2world, intrinsics, res)
        k_render, k_sr = prng.split(rng) if rng is not None else (None, None)
        feature_samples, depth_samples, _ = render_rays(
            planes, self.decoder, ray_origins, ray_dirs, opts, rng=k_render)
        n = feature_samples.shape[0]
        feature_image = feature_samples.permute(0, 2, 1).reshape(n, -1, res, res)
        depth_image = depth_samples.permute(0, 2, 1).reshape(n, 1, res, res)
        if not superres:
            return {"feature_image": feature_image, "image_depth": depth_image}
        sr_noise = opts.get("superresolution_noise_mode", "none")
        sr_noise = sr_noise if sr_noise in ("random", "const") else "none"
        with span("sr"):
            sr_image, rgb_image = self.superresolution(
                feature_image[:, :3], feature_image, ws, noise_mode=sr_noise, rng=k_sr,
                dtype=dtype)
        return {"image": sr_image, "image_raw": rgb_image, "image_depth": depth_image}

    def synthesis(self, ws, c, neural_rendering_resolution=None, noise_mode="const",
                  rng=None, dtype=torch.float32,
                  rendering_kwargs=None) -> dict[str, torch.Tensor]:
        """Full synthesis: backbone -> render -> SR."""
        k_bb, k_rest = prng.split(rng) if rng is not None else (None, None)
        planes = self.backbone_planes(ws, noise_mode=noise_mode, rng=k_bb, dtype=dtype)
        return self.render_planes(planes, c, ws,
                                  neural_rendering_resolution=neural_rendering_resolution,
                                  noise_mode=noise_mode, rng=k_rest, dtype=dtype,
                                  rendering_kwargs=rendering_kwargs)

    def sample_mixed(self, coordinates, directions, ws, noise_mode="const", rng=None,
                     dtype=torch.float32) -> dict[str, torch.Tensor]:
        """sigma and rgb features at arbitrary points [N, M, 3] given ws (the
        backbone runs again; the shape sweep caches its planes instead).
        `rng` reaches the density noise only, as in the JAX package."""
        planes = self.backbone_planes(ws, noise_mode=noise_mode, dtype=dtype)
        return run_model(planes, self.decoder, coordinates, directions,
                         self.rendering_kwargs, rng)

    def sample(self, coordinates, directions, z, c, truncation_psi=1.0,
               truncation_cutoff=None, noise_mode="const", rng=None) -> dict[str, torch.Tensor]:
        """Like `sample_mixed`, from z and the conditioning pose c."""
        ws = self.mapping(z, c, truncation_psi, truncation_cutoff)
        return self.sample_mixed(coordinates, directions, ws, noise_mode=noise_mode, rng=rng)

    def apply(self, z, c, truncation_psi=1.0, truncation_cutoff=None,
              neural_rendering_resolution=None, noise_mode="const", rng=None,
              dtype=torch.float32) -> dict[str, torch.Tensor]:
        """z + camera -> rendered frame dict. (Shadows `nn.Module.apply`, to
        keep the JAX package's name.)"""
        ws = self.mapping(z, c, truncation_psi, truncation_cutoff)
        return self.synthesis(ws, c, neural_rendering_resolution=neural_rendering_resolution,
                              noise_mode=noise_mode, rng=rng, dtype=dtype)

    forward = apply
