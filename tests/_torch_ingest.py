"""Stand-ins for published weights in the reference's layouts, and a runner
for the port's converters in a process where JAX cannot be imported.

Imports torch and numpy only: `chip_smoke.py` uses it on the card, where no
JAX is installed, and `tests/test_torch_convert.py` etc. on the CPU.

  * `write_reference_pickle` pickles a G (and E, D) as the reference's
    checkpoints hold them: {"G_ema": ..., "E": ..., "D": ...} of plain
    `nn.Module`s whose state_dict carries the reference's names (the inverse
    of `utils/checkpoint.py::convert_torch_*`, with the `resample_filter`
    buffers and BN counters those converters drop), G carrying `z_dim`,
    `c_dim`, `w_dim`, `img_resolution` and `rendering_kwargs`.
  * `LPIPSOracle` is a scriptable vgg16.pt-style LPIPS net (the layout of
    `tests/test_lpips_ingest.py::TorchLPIPSOracle`) at any VGG16-shaped
    config, full widths by default.
  * `run_without_jax` runs `python -m <module>` with `jax`, `jaxlib` and
    `gnerf_tpu` blocked in `sys.modules`.
"""

from __future__ import annotations

import os
import pickle
import re
import subprocess
import sys
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
             512, 512, 512)
LPIPS_LAYERS = (1, 3, 6, 9, 12)


def reference_module(state: dict, **attrs) -> nn.Module:
    """A plain `nn.Module` tree whose state_dict is `state` (dotted names,
    tensors), with `attrs` set on the root."""
    root = nn.Module()
    for name, value in state.items():
        *path, leaf = name.split(".")
        node = root
        for part in path:
            if not hasattr(node, part):
                node.add_module(part, nn.Module())
            node = getattr(node, part)
        node.register_buffer(leaf, value.detach().cpu().clone())
    for k, v in attrs.items():
        setattr(root, k, v)
    return root


def with_resample_filters(net: nn.Module, state: dict) -> dict:
    """The module's state plus the `resample_filter` buffers it keeps out of
    its state_dict (the reference saves them)."""
    out = dict(state)
    for name, buf in net.named_buffers():
        if name.endswith("resample_filter") and name not in out:
            out[name] = buf
    return out


def reference_generator_state(g: nn.Module) -> dict:
    """A port TriPlaneGenerator's state under the reference's names."""
    state = {re.sub(r"^decoder\.fc([01])\.",
                    lambda m: f"decoder.net.{2 * int(m.group(1))}.", k): v
             for k, v in g.state_dict().items()}
    return with_resample_filters(g, state)


def reference_encoder_state(enc: nn.Module) -> dict:
    """A port ResNeXt50Encoder's state under torchvision's names (`model.`,
    `fc.`), with a `num_batches_tracked` counter per BN."""
    leaf = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    state = {}
    for k, v in enc.state_dict().items():
        if k.startswith("fc."):
            state[k] = v
            continue
        m = re.match(r"layer(\d)_(\d+)\.(.*)$", k)
        prefix, rest = ((f"model.layer{m.group(1)}.{m.group(2)}.", m.group(3)) if m
                        else ("model.", k))
        rest = rest.replace("downsample_conv", "downsample.0").replace("downsample_bn",
                                                                      "downsample.1")
        parts = rest.split(".")
        if parts[-1] in leaf and len(parts) > 1:
            parts[-1] = leaf[parts[-1]]
        else:
            parts.append("weight")
        name = prefix + ".".join(parts)
        state[name] = v
        if name.endswith(".running_var"):
            state[name[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return state


def write_reference_pickle(path: str, g: nn.Module, img_resolution: int, enc=None,
                           d=None) -> None:
    """Pickles {"G_ema": g, "E": enc, "D": d} in the reference's layout (see
    the module docstring); E and D only when given."""
    data = {"G_ema": reference_module(
        reference_generator_state(g), z_dim=g.z_dim, c_dim=g.c_dim, w_dim=g.w_dim,
        img_resolution=img_resolution, rendering_kwargs=dict(g.rendering_kwargs))}
    if enc is not None:
        data["E"] = reference_module(reference_encoder_state(enc))
    if d is not None:
        data["D"] = reference_module(with_resample_filters(d, d.state_dict()))
    with open(path, "wb") as f:
        pickle.dump(data, f, protocol=4)


class LPIPSOracle(nn.Module):
    """vgg16.pt-style LPIPS net: [0, 255] NCHW in; `resize_images` -> 256^2
    bilinear with antialias; whitening; VGG features; `return_lpips` ->
    embeddings whose squared distance is the LPIPS distance. Weights are
    random from `seed` (He-scaled convs, LPIPS weights in [0.05, 1.05))."""

    def __init__(self, cfg=VGG16_CFG, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        convs, pool_before, in_c, pool = [], [], 3, False
        for v in cfg:
            if v == "M":
                pool = True
                continue
            conv = nn.Conv2d(in_c, v, 3, padding=1)
            with torch.no_grad():
                conv.weight.normal_(0.0, (2.0 / (in_c * 9)) ** 0.5, generator=g)
                conv.bias.normal_(0.0, 0.1, generator=g)
            convs.append(conv)
            pool_before.append(pool)
            in_c, pool = v, False
        self.convs = nn.ModuleList(convs)
        self.pool_before: List[bool] = pool_before
        self.taps: List[bool] = [i in LPIPS_LAYERS for i in range(len(convs))]
        self.lins = nn.ModuleList()
        for i in LPIPS_LAYERS:
            lin = nn.Conv2d(convs[i].out_channels, 1, 1, bias=False)
            with torch.no_grad():
                lin.weight.copy_(torch.rand(lin.weight.shape, generator=g) + 0.05)
            self.lins.append(lin)
        self.register_buffer("shift", torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1))

    def forward(self, x, resize_images: bool = False, return_lpips: bool = False):
        if resize_images:
            x = F.interpolate(x, size=(256, 256), mode="bilinear", align_corners=False,
                              antialias=True)
        x = (x / 255.0 * 2.0 - 1.0 - self.shift) / self.scale
        feats: List[torch.Tensor] = []
        for i, conv in enumerate(self.convs):
            if self.pool_before[i]:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(conv(x))
            if self.taps[i]:
                feats.append(x)
        outs: List[torch.Tensor] = []
        for j, lin in enumerate(self.lins):
            f = feats[j]
            n, c, h, w = f.shape
            fn = f / torch.sqrt((f * f).sum(1, keepdim=True) + 1e-10)
            w_lin = lin.weight.view(1, c, 1, 1).clamp(min=0).sqrt()
            outs.append((fn * w_lin / (h * w) ** 0.5).reshape(n, -1))
        return torch.cat(outs, 1)


def random_inception_state(seed: int = 0) -> dict:
    """A state dict under torchvision `inception_v3_google` names with random
    values: every tensor the converter reads, plus an aux head and `fc`
    (which it drops)."""
    from gnerf_tpu_torch.training.inception import inception_conv_shapes

    rng = np.random.default_rng(seed)
    state = {}
    for path, shape in inception_conv_shapes().items():
        c = shape[0]
        state[f"{path}.conv.weight"] = rng.standard_normal(shape, np.float32) * 0.1
        state[f"{path}.bn.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        state[f"{path}.bn.bias"] = rng.standard_normal(c, np.float32) * 0.1
        state[f"{path}.bn.running_mean"] = rng.standard_normal(c, np.float32) * 0.1
        state[f"{path}.bn.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        state[f"{path}.bn.num_batches_tracked"] = np.int64(0)
    state["AuxLogits.fc.weight"] = rng.standard_normal((1000, 768), np.float32)
    state["fc.weight"] = rng.standard_normal((1000, 2048), np.float32)
    state["fc.bias"] = np.zeros(1000, np.float32)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}


def run_without_jax(module: str, *args: str, timeout: float = 600) -> subprocess.CompletedProcess:
    """`python -m module args` from the repo root with `jax`, `jaxlib` and
    `gnerf_tpu` unimportable; raises with its output when it fails."""
    code = ("import runpy, sys\n"
            "for name in ('jax', 'jaxlib', 'gnerf_tpu'):\n"
            "    sys.modules[name] = None\n"
            f"runpy.run_module({module!r}, run_name='__main__', alter_sys=True)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{module} {' '.join(args)} failed ({proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc
