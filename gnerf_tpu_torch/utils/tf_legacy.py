"""TF-era (tflib StyleGAN/StyleGAN2) pickle conversion, numpy only.

The port's copy of `gnerf_tpu/utils/tf_legacy.py`: the same remap tables,
guards and error text, writing the trees the JAX package writes (each leaf
as `utils.checkpoint.jax_tree` stores it), so the port's
`tools/convert_reference_pkl.py` needs no JAX.

The reference's `legacy.py` accepts two checkpoint generations: modern
torch pickles, and the original TensorFlow codebase's `(G, D, Gs)` tuple of
`dnnlib.tflib.network.Network` records (the reference's `legacy.py:24-33`).
The TF record is pure data — `{version, static_kwargs, variables,
components}` — so conversion needs no TensorFlow and no torch op: this
module remaps TF variable names and layouts straight onto the
`models.stylegan2` param trees in numpy
(reference remap tables: generator `legacy.py:110-207`, discriminator
`legacy.py:211-292`).

Layout rules (reference `legacy.py:174-206`):

  dense    TF [in, out]         -> ours [out, in]           (transpose)
  conv     TF [kh, kw, in, out] -> ours [out, in, kh, kw]   (transpose(3,2,0,1))
  up-conv  TF stores spatially pre-flipped taps             ([::-1, ::-1] first)
  mod_bias TF centers style scales at 0                     (affine bias + 1)
  const    TF [1, C, 4, 4]      -> ours [C, 4, 4]
  noise<K> TF [1, 1, r, r]      -> ours [r, r]; K = 2*log2(r) - 5 for conv0,
                                  2*log2(r) - 4 for conv1, 0 for the 4x4 conv

Unsupported static_kwargs (non-lrelu nonlinearity, custom resample kernels,
custom mapping widths) raise ValueError rather than converting silently;
unknown kwargs raise like the reference (`legacy.py:156-158`).
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import numpy as np

from .checkpoint import SEP, jax_tree


def _field(net: Any, name: str):
    """TF network records may arrive as attribute-objects (unpickled stubs)
    or plain dicts — accept both (the reference's stub is an EasyDict)."""
    if isinstance(net, Mapping) and name in net:
        return net[name]
    return getattr(net, name)


def collect_tf_params(tf_net: Any) -> dict[str, np.ndarray]:
    """Flatten `variables` across nested `components`
    (reference `legacy.py:76-85`)."""
    params: dict[str, np.ndarray] = {}

    def recurse(prefix: str, net: Any) -> None:
        for name, value in _field(net, "variables"):
            params[prefix + name] = np.asarray(value)
        for name, comp in dict(_field(net, "components")).items():
            recurse(prefix + name + "/", comp)

    recurse("", tf_net)
    return params


def _dense(v: np.ndarray) -> np.ndarray:
    return np.asarray(v).transpose()


def _conv(v: np.ndarray) -> np.ndarray:
    return np.asarray(v).transpose(3, 2, 0, 1)


def _upconv(v: np.ndarray) -> np.ndarray:
    return np.asarray(v)[::-1, ::-1].transpose(3, 2, 0, 1)


class _Kwargs:
    """static_kwargs reader with the reference's unknown-kwarg check
    (`legacy.py:117-120,156-158`)."""

    def __init__(self, static_kwargs: Mapping[str, Any]):
        self.kw = dict(static_kwargs)
        self.known: set[str] = set()

    def get(self, name: str, default=None, none=None):
        self.known.add(name)
        val = self.kw.get(name, default)
        return val if val is not None else none

    def ignore(self, *names: str) -> None:
        self.known.update(names)

    def check_no_unknown(self) -> None:
        unknown = sorted(set(self.kw) - self.known)
        if unknown:
            raise ValueError(f"Unknown TensorFlow kwarg {unknown[0]!r}")


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"TF pickle uses an unsupported option: {what}")


def convert_tf_generator(tf_net: Any) -> tuple[dict, dict]:
    """TF generator record -> (our Generator ctor kwargs, param tree).

    Mirrors reference `legacy.py:110-207`; the returned tree loads into
    `models.stylegan2.Generator(**kwargs)`'s parameters (`load_jax_params`).
    """
    if int(_field(tf_net, "version")) < 4:
        raise ValueError("TensorFlow pickle version too low")
    kw = _Kwargs(_field(tf_net, "static_kwargs"))

    z_dim = int(kw.get("latent_size", 512))
    c_dim = int(kw.get("label_size", 0))
    w_dim = int(kw.get("dlatent_size", 512))
    img_resolution = int(kw.get("resolution", 1024))
    img_channels = int(kw.get("num_channels", 3))
    channel_base = int(kw.get("fmap_base", 16384)) * 2
    channel_max = int(kw.get("fmap_max", 512))
    conv_clamp = kw.get("conv_clamp", None)
    architecture = str(kw.get("architecture", "skip"))
    mapping_layers = int(kw.get("mapping_layers", 8))
    use_noise = bool(kw.get("use_noise", True))

    _require(str(kw.get("nonlinearity", "lrelu")) == "lrelu",
             "generator nonlinearity != lrelu")
    _require(str(kw.get("mapping_nonlinearity", "lrelu")) == "lrelu",
             "mapping nonlinearity != lrelu")
    _require(list(kw.get("resample_kernel", [1, 3, 3, 1],
                         none=[1, 3, 3, 1])) == [1, 3, 3, 1],
             "resample_kernel != [1,3,3,1]")
    _require(float(kw.get("mapping_lrmul", 0.01)) == 0.01,
             "mapping_lrmul != 0.01")
    _require(kw.get("label_fmaps", None) in (None, w_dim),
             "label_fmaps != dlatent_size")
    _require(kw.get("mapping_fmaps", None) in (None, w_dim),
             "mapping_fmaps != dlatent_size")
    # Inference-irrelevant / torch-side-only knobs the reference also
    # accepts-and-drops (`legacy.py:133,145,150-155`).
    kw.ignore("num_fp16_res", "w_avg_beta", "truncation_psi",
              "truncation_cutoff", "style_mixing_prob", "structure",
              "conditioning", "fused_modconv")
    kw.check_no_unknown()

    tf_params = collect_tf_params(tf_net)
    # Progressive-era per-lod ToRGB heads => 'orig' architecture
    # (reference `legacy.py:162-167`).
    for name in list(tf_params):
        if name.startswith("ToRGB_lod"):
            lod, rest = name[len("ToRGB_lod"):].split("/", 1)
            r = img_resolution // (2 ** int(lod))
            tf_params[f"{r}x{r}/ToRGB/{rest}"] = tf_params[name]
            architecture = "orig"

    config = dict(
        z_dim=z_dim, c_dim=c_dim, w_dim=w_dim,
        img_resolution=img_resolution, img_channels=img_channels,
        mapping_layers=mapping_layers, channel_base=channel_base,
        channel_max=channel_max,
        conv_clamp=None if conv_clamp is None else float(conv_clamp),
        use_noise=use_noise, architecture=architecture,
    )

    flat: dict[str, np.ndarray] = {}
    flat[f"mapping{SEP}w_avg"] = np.asarray(tf_params["dlatent_avg"])
    if c_dim > 0:
        flat[f"mapping{SEP}embed{SEP}weight"] = _dense(
            tf_params["mapping/LabelEmbed/weight"])
        flat[f"mapping{SEP}embed{SEP}bias"] = tf_params["mapping/LabelEmbed/bias"]
    for i in range(mapping_layers):
        flat[f"mapping{SEP}fc{i}{SEP}weight"] = _dense(
            tf_params[f"mapping/Dense{i}/weight"])
        flat[f"mapping{SEP}fc{i}{SEP}bias"] = tf_params[f"mapping/Dense{i}/bias"]

    def conv_layer(dst: str, src: str, up: bool, noise_idx: int) -> None:
        w = tf_params[f"synthesis/{src}/weight"]
        flat[f"{dst}{SEP}weight"] = _upconv(w) if up else _conv(w)
        flat[f"{dst}{SEP}bias"] = tf_params[f"synthesis/{src}/bias"]
        flat[f"{dst}{SEP}affine{SEP}weight"] = _dense(
            tf_params[f"synthesis/{src}/mod_weight"])
        flat[f"{dst}{SEP}affine{SEP}bias"] = (
            np.asarray(tf_params[f"synthesis/{src}/mod_bias"]) + 1)
        if use_noise:
            flat[f"{dst}{SEP}noise_const"] = np.asarray(
                tf_params[f"synthesis/noise{noise_idx}"])[0, 0]
            flat[f"{dst}{SEP}noise_strength"] = np.asarray(
                tf_params[f"synthesis/{src}/noise_strength"])

    def torgb_layer(dst: str, src: str) -> None:
        flat[f"{dst}{SEP}weight"] = _conv(tf_params[f"synthesis/{src}/weight"])
        flat[f"{dst}{SEP}bias"] = tf_params[f"synthesis/{src}/bias"]
        flat[f"{dst}{SEP}affine{SEP}weight"] = _dense(
            tf_params[f"synthesis/{src}/mod_weight"])
        flat[f"{dst}{SEP}affine{SEP}bias"] = (
            np.asarray(tf_params[f"synthesis/{src}/mod_bias"]) + 1)

    syn = f"synthesis{SEP}"
    flat[f"{syn}b4{SEP}const"] = np.asarray(
        tf_params["synthesis/4x4/Const/const"])[0]
    conv_layer(f"{syn}b4{SEP}conv1", "4x4/Conv", up=False, noise_idx=0)
    if architecture == "skip" or img_resolution == 4:
        torgb_layer(f"{syn}b4{SEP}torgb", "4x4/ToRGB")
    log2_res = int(math.log2(img_resolution))
    for lg in range(3, log2_res + 1):
        r = 2 ** lg
        blk = f"{syn}b{r}"
        conv_layer(f"{blk}{SEP}conv0", f"{r}x{r}/Conv0_up", up=True,
                   noise_idx=2 * lg - 5)
        conv_layer(f"{blk}{SEP}conv1", f"{r}x{r}/Conv1", up=False,
                   noise_idx=2 * lg - 4)
        if architecture == "skip" or r == img_resolution:
            torgb_layer(f"{blk}{SEP}torgb", f"{r}x{r}/ToRGB")
        if architecture == "resnet":
            flat[f"{blk}{SEP}skip{SEP}weight"] = _upconv(
                tf_params[f"{r}x{r}/Skip/weight"])
    return config, jax_tree(flat)


def convert_tf_discriminator(tf_net: Any) -> tuple[dict, dict]:
    """TF discriminator record -> (our Discriminator ctor kwargs, tree).

    Mirrors reference `legacy.py:211-292`.
    """
    if int(_field(tf_net, "version")) < 4:
        raise ValueError("TensorFlow pickle version too low")
    kw = _Kwargs(_field(tf_net, "static_kwargs"))

    c_dim = int(kw.get("label_size", 0))
    img_resolution = int(kw.get("resolution", 1024))
    img_channels = int(kw.get("num_channels", 3))
    architecture = str(kw.get("architecture", "resnet"))
    channel_base = int(kw.get("fmap_base", 16384)) * 2
    channel_max = int(kw.get("fmap_max", 512))
    conv_clamp = kw.get("conv_clamp", None)
    cmap_dim = kw.get("mapping_fmaps", None)
    mbstd_group_size = kw.get("mbstd_group_size", None)
    mapping_layers = int(kw.get("mapping_layers", 0))

    _require(str(kw.get("nonlinearity", "lrelu")) == "lrelu",
             "discriminator nonlinearity != lrelu")
    _require(list(kw.get("resample_kernel", [1, 3, 3, 1],
                         none=[1, 3, 3, 1])) == [1, 3, 3, 1],
             "resample_kernel != [1,3,3,1]")
    _require(int(kw.get("mbstd_num_features", 1)) == 1,
             "mbstd_num_features != 1")
    _require(int(kw.get("freeze_layers", 0)) == 0, "freeze_layers != 0")
    _require(float(kw.get("mapping_lrmul", 0.1)) == 0.1,
             "mapping_lrmul != 0.1")
    kw.ignore("num_fp16_res", "structure", "conditioning")
    kw.check_no_unknown()

    tf_params = collect_tf_params(tf_net)
    for name in list(tf_params):
        if name.startswith("FromRGB_lod"):
            lod, rest = name[len("FromRGB_lod"):].split("/", 1)
            r = img_resolution // (2 ** int(lod))
            tf_params[f"{r}x{r}/FromRGB/{rest}"] = tf_params[name]
            architecture = "orig"

    config = dict(
        c_dim=c_dim, img_resolution=img_resolution,
        img_channels=img_channels, architecture=architecture,
        channel_base=channel_base, channel_max=channel_max,
        conv_clamp=None if conv_clamp is None else float(conv_clamp),
        cmap_dim=None if cmap_dim is None else int(cmap_dim),
        mbstd_group_size=(None if mbstd_group_size is None
                          else int(mbstd_group_size)),
        mapping_layers=mapping_layers,
    )

    flat: dict[str, np.ndarray] = {}
    log2_res = int(math.log2(img_resolution))
    for lg in range(log2_res, 2, -1):
        r = 2 ** lg
        blk = f"b{r}"
        if r == img_resolution or architecture == "skip":
            flat[f"{blk}{SEP}fromrgb{SEP}weight"] = _conv(
                tf_params[f"{r}x{r}/FromRGB/weight"])
            flat[f"{blk}{SEP}fromrgb{SEP}bias"] = tf_params[
                f"{r}x{r}/FromRGB/bias"]
        flat[f"{blk}{SEP}conv0{SEP}weight"] = _conv(
            tf_params[f"{r}x{r}/Conv0/weight"])
        flat[f"{blk}{SEP}conv0{SEP}bias"] = tf_params[f"{r}x{r}/Conv0/bias"]
        flat[f"{blk}{SEP}conv1{SEP}weight"] = _conv(
            tf_params[f"{r}x{r}/Conv1_down/weight"])
        flat[f"{blk}{SEP}conv1{SEP}bias"] = tf_params[
            f"{r}x{r}/Conv1_down/bias"]
        if architecture == "resnet":
            flat[f"{blk}{SEP}skip{SEP}weight"] = _conv(
                tf_params[f"{r}x{r}/Skip/weight"])
    if c_dim > 0:
        flat[f"mapping{SEP}embed{SEP}weight"] = _dense(
            tf_params["LabelEmbed/weight"])
        flat[f"mapping{SEP}embed{SEP}bias"] = tf_params["LabelEmbed/bias"]
        for i in range(mapping_layers):
            flat[f"mapping{SEP}fc{i}{SEP}weight"] = _dense(
                tf_params[f"Mapping{i}/weight"])
            flat[f"mapping{SEP}fc{i}{SEP}bias"] = tf_params[f"Mapping{i}/bias"]
    if architecture == "skip":
        flat[f"b4{SEP}fromrgb{SEP}weight"] = _conv(
            tf_params["4x4/FromRGB/weight"])
        flat[f"b4{SEP}fromrgb{SEP}bias"] = tf_params["4x4/FromRGB/bias"]
    flat[f"b4{SEP}conv{SEP}weight"] = _conv(tf_params["4x4/Conv/weight"])
    flat[f"b4{SEP}conv{SEP}bias"] = tf_params["4x4/Conv/bias"]
    flat[f"b4{SEP}fc{SEP}weight"] = _dense(tf_params["4x4/Dense0/weight"])
    flat[f"b4{SEP}fc{SEP}bias"] = tf_params["4x4/Dense0/bias"]
    flat[f"b4{SEP}out{SEP}weight"] = _dense(tf_params["Output/weight"])
    flat[f"b4{SEP}out{SEP}bias"] = tf_params["Output/bias"]
    return config, jax_tree(flat)


def is_tf_network_tuple(data: Any) -> bool:
    """True for the TF-era `(G, D, Gs)` pickle payload
    (reference `legacy.py:28`). Each element must look like a tflib
    Network record (has version/static_kwargs/variables)."""
    if not (isinstance(data, tuple) and len(data) == 3):
        return False

    def looks_tf(net: Any) -> bool:
        try:
            _field(net, "version")
            _field(net, "static_kwargs")
            _field(net, "variables")
            return True
        except (AttributeError, KeyError):
            return False

    return all(looks_tf(net) for net in data)
