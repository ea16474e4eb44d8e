"""Checkpoint I/O in the JAX package's npz format, the weight bridge, and
the reference state_dict converters.

A checkpoint is one `.npz`: every leaf of every named tree (`G_ema`, `E`,
`E_state`, ...) under its `/`-joined path, plus a `__config__` JSON blob
(`gnerf_tpu/utils/checkpoint.py`). This module reads and writes it with
numpy alone. The port's modules name their parameters and buffers as the
JAX trees do, so `load_jax_params` is a rename (`.` -> `/`) plus a shape
check. `convert_torch_*` map the reference's torch state_dict names onto
those trees (offline, for `tools/convert_reference_pkl.py`), leaf for leaf
as the JAX package's converters do.
"""

from __future__ import annotations

import json
from typing import Any, Mapping, Optional

import numpy as np
import torch
from torch import nn

SEP = "/"


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}

    def rec(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                rec(v, f"{path}{SEP}{k}" if path else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, f"{path}{SEP}{i}" if path else str(i))
        else:
            out[path] = np.asarray(node)

    rec(tree, prefix)
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)
    return tree


def save_checkpoint(path: str, trees: Mapping[str, Any],
                    config: Optional[Mapping[str, Any]] = None) -> None:
    """Save named trees (e.g. {'G_ema': ..., 'E': ...}) + config."""
    flat: dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        if isinstance(tree, nn.Module):
            tree = module_params(tree)
        flat.update(flatten_tree(tree, prefix=name))
    if config is not None:
        flat["__config__"] = np.frombuffer(json.dumps(config).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_checkpoint(path: str) -> tuple[dict[str, Any], Optional[dict]]:
    """Returns ({name: nested dict of numpy arrays}, config or None)."""
    with np.load(path, allow_pickle=False) as data:
        config = None
        roots: dict[str, dict[str, np.ndarray]] = {}
        for key in data.files:
            if key == "__config__":
                config = json.loads(bytes(data[key]).decode())
            else:
                root, rest = key.split(SEP, 1)
                roots.setdefault(root, {})[rest] = data[key]
    return {r: unflatten_tree(f) for r, f in roots.items()}, config


def module_params(module: nn.Module) -> dict[str, np.ndarray]:
    """A module's persistent state as a flat {jax/path: ndarray} dict."""
    return {k.replace(".", SEP): v.detach().cpu().float().numpy()
            for k, v in module.state_dict().items()}


def encoder_trees(enc: nn.Module) -> dict[str, dict[str, np.ndarray]]:
    """An encoder's state as the JAX layout stores it: `E` (parameters) and
    `E_state` (the BN running statistics)."""
    e = module_params(enc)
    bn = {k for k in e if k.endswith(("/mean", "/var"))}
    return {"E": {k: v for k, v in e.items() if k not in bn}, "E_state": {k: e[k] for k in bn}}


def default_bn_state(enc: nn.Module) -> dict[str, np.ndarray]:
    """An encoder's BN running statistics at their init (mean 0, var 1), the
    `E_state` of a checkpoint that has none."""
    return {k.replace(".", SEP): (np.zeros if k.endswith(".mean") else np.ones)(
                tuple(v.shape), np.float32)
            for k, v in enc.state_dict().items() if k.endswith((".mean", ".var"))}


def materialize(module: nn.Module, device) -> nn.Module:
    """Give a module built on `meta` uninitialised storage on `device`
    (`to_empty`), keeping the values of the buffers that were not on `meta`
    (the constants its constructor computed)."""
    kept = {n: b for n, b in module.named_buffers() if not b.is_meta}
    loaded = set(module.state_dict())
    unfilled = [n for n, b in module.named_buffers() if b.is_meta and n not in loaded]
    if unfilled:
        raise ValueError(f"buffers on meta that no load fills: {unfilled[:8]}")
    module.to_empty(device=device)
    with torch.no_grad():
        for name, value in kept.items():
            module.get_buffer(name).copy_(value)
    return module


def load_jax_params(module: nn.Module, *trees: Any, device=None) -> nn.Module:
    """Copy JAX param trees (nested dicts or flat `/`-keyed dicts of arrays)
    into `module`'s parameters and buffers, in place.

    Several trees are merged first (e.g. the encoder's params and its BN
    state). Raises on any missing, extra, duplicate or mis-shaped key, so
    every parameter is filled. A module built on `meta` (nothing drawn) is
    first given storage on `device`, which it then needs."""
    if any(p.is_meta for p in module.parameters()):
        if device is None:
            raise ValueError("a module built on meta needs the device to load onto")
        materialize(module, torch.device(device))
    flat: dict[str, np.ndarray] = {}
    for tree in trees:
        for k, v in flatten_tree(tree).items():
            if k in flat:
                raise KeyError(f"duplicate parameter {k!r} across trees")
            flat[k] = v
    state = module.state_dict()
    wanted = {k.replace(".", SEP): k for k in state}
    missing = sorted(set(wanted) - set(flat))
    extra = sorted(set(flat) - set(wanted))
    if missing or extra:
        raise KeyError(f"parameter trees do not match the module: missing {missing[:8]}"
                       f"{'...' if len(missing) > 8 else ''}, extra {extra[:8]}"
                       f"{'...' if len(extra) > 8 else ''}")
    for jk, tk in wanted.items():
        value = np.asarray(flat[jk])
        if tuple(value.shape) != tuple(state[tk].shape):
            raise ValueError(f"shape mismatch at {jk}: checkpoint {tuple(value.shape)} "
                             f"vs module {tuple(state[tk].shape)}")
        with torch.no_grad():
            state[tk].copy_(torch.from_numpy(np.array(value, dtype=np.float32)))
    return module


def copy_params(module: nn.Module, tree: Any, keys: Optional[Any] = None,
                verbose: bool = True) -> nn.Module:
    """The JAX package's shape-tolerant resume copy (`copy_params`), in
    place: every entry of `module`'s state (or of its `keys`, `/`-joined)
    that `tree` holds with the same shape is taken from it; any other keeps
    its value, with a printed line. Entries of `tree` the module lacks are
    ignored. `load_jax_params` is the strict load."""
    src = flatten_tree(tree)
    state = module.state_dict()
    wanted = {k.replace(".", SEP): k for k in state}
    for jk in (wanted if keys is None else keys):
        dst = state[wanted[jk]]
        if jk in src and tuple(src[jk].shape) == tuple(dst.shape):
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.array(src[jk], dtype=np.float32)))
        elif verbose and jk in src:
            print(f"copy_params: shape mismatch at {jk}: "
                  f"{tuple(src[jk].shape)} vs {tuple(dst.shape)}, keeping dst")
        elif verbose:
            print(f"copy_params: {jk} missing in src, keeping dst")
    return module


# ---------------------------------------------------------------------------
# Reference state_dict conversion (offline tool; torch tensors arrive as numpy)

_JAX_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
               np.dtype(np.uint64): np.uint32, np.dtype(np.complex128): np.complex64}


def jax_tree(flat: Mapping[str, Any]) -> dict:
    """`unflatten_tree` with each leaf as the JAX package's `unflatten_tree`
    stores it (`jnp.asarray` in JAX's default 32-bit mode: 64-bit types
    narrowed to 32 bits, C order), so a converted tree saves to the bytes
    the JAX converters write."""
    out = {}
    for key, value in flat.items():
        a = np.asarray(value)
        out[key] = np.asarray(a, dtype=_JAX_NARROW.get(a.dtype, a.dtype), order="C")
    return unflatten_tree(out)


def convert_torch_encoder(state: Mapping[str, np.ndarray]) -> dict:
    """Map a reference ResNeXt50 encoder state_dict (torchvision names under
    `model.`, plus `fc.`) onto the ResNeXt50Encoder tree."""
    flat: dict[str, np.ndarray] = {}

    def bn(dst, src):
        flat[f"{dst}{SEP}scale"] = state[f"{src}.weight"]
        flat[f"{dst}{SEP}bias"] = state[f"{src}.bias"]

    flat["conv1"] = state["model.conv1.weight"]
    bn("bn1", "model.bn1")
    for stage in range(1, 5):
        b = 0
        while f"model.layer{stage}.{b}.conv1.weight" in state:
            src = f"model.layer{stage}.{b}"
            dst = f"layer{stage}_{b}"
            for i in (1, 2, 3):
                flat[f"{dst}{SEP}conv{i}"] = state[f"{src}.conv{i}.weight"]
                bn(f"{dst}{SEP}bn{i}", f"{src}.bn{i}")
            if f"{src}.downsample.0.weight" in state:
                flat[f"{dst}{SEP}downsample_conv"] = state[f"{src}.downsample.0.weight"]
                bn(f"{dst}{SEP}downsample_bn", f"{src}.downsample.1")
            b += 1
    flat[f"fc{SEP}weight"] = state["fc.weight"]
    flat[f"fc{SEP}bias"] = state["fc.bias"]
    return jax_tree(flat)


def convert_torch_encoder_state(state: Mapping[str, np.ndarray]) -> dict:
    """Running BN statistics for the encoder (the `E_state` tree)."""
    flat: dict[str, np.ndarray] = {}

    def bn(dst, src):
        flat[f"{dst}{SEP}mean"] = state[f"{src}.running_mean"]
        flat[f"{dst}{SEP}var"] = state[f"{src}.running_var"]

    bn("bn1", "model.bn1")
    for stage in range(1, 5):
        b = 0
        while f"model.layer{stage}.{b}.conv1.weight" in state:
            src = f"model.layer{stage}.{b}"
            dst = f"layer{stage}_{b}"
            for i in (1, 2, 3):
                bn(f"{dst}{SEP}bn{i}", f"{src}.bn{i}")
            if f"{src}.downsample.0.weight" in state:
                bn(f"{dst}{SEP}downsample_bn", f"{src}.downsample.1")
            b += 1
    return jax_tree(flat)


def convert_torch_generator(state: Mapping[str, np.ndarray]) -> dict:
    """Map a reference TriPlaneGenerator state_dict onto the G tree.

    Name correspondences (reference -> ours):
      backbone.mapping.fcN.*          -> backbone/mapping/fcN/*
      backbone.mapping.w_avg          -> backbone/mapping/w_avg
      backbone.synthesis.bR.*        -> backbone/synthesis/bR/*
      decoder.net.0/2.*               -> decoder/fc0|fc1/*
      superresolution.blockX.*        -> superresolution/blockX/*
    Noise constants ride along so noise_mode='const' is reproducible; the
    `resample_filter` buffers are dropped (the modules compute them).
    """
    flat: dict[str, np.ndarray] = {}
    for name, value in state.items():
        n = name
        n = n.replace("backbone.mapping.", f"backbone{SEP}mapping{SEP}")
        n = n.replace("backbone.synthesis.", f"backbone{SEP}synthesis{SEP}")
        n = n.replace("decoder.net.0.", f"decoder{SEP}fc0{SEP}")
        n = n.replace("decoder.net.2.", f"decoder{SEP}fc1{SEP}")
        n = n.replace("superresolution.", f"superresolution{SEP}")
        n = n.replace(".", SEP)
        if n.endswith(f"{SEP}resample_filter"):
            continue
        flat[n] = value
    return jax_tree(flat)
