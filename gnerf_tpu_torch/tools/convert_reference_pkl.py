"""OFFLINE converter: original G-NeRF checkpoint pickle -> the npz both
packages read, without JAX (the port's `tools/convert_reference_pkl.py`).

The reference distributes checkpoints as source-embedding pickles
(`legacy.py` + `torch_utils/persistence.py`) that execute embedded module
source on load. That is never allowed in the serving path, so conversion is
an explicit offline step:

    python -m gnerf_tpu_torch.tools.convert_reference_pkl --pkl network.pkl \
        --reference /path/to/g_nerf --out gnerf.npz

`--reference` points at the original repo package so the unpickler can
resolve module names the pickle references; the pickle itself supplies the
class source. The npz carries G_ema / E / E_state / D param trees plus the
rendering config, key for key and bit for bit what the JAX package's tool
writes.

TF-era pickles (the original tflib `(G, D, Gs)` tuple, reference
`legacy.py:24-33`) are detected and converted too: that path is numpy only
(`utils/tf_legacy.py`), and the tflib Network records are unpickled as
inert attribute bags.
"""

from __future__ import annotations

import argparse
import pickle
import sys

from ..utils import checkpoint as ckpt
from ..utils import tf_legacy


def state_dict_numpy(module) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


class _TFNetworkStub:
    """Inert attribute bag standing in for dnnlib.tflib.network.Network
    (reference `legacy.py:65-72`): the TF record is pure data."""


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "dnnlib.tflib.network" and name == "Network":
            return _TFNetworkStub
        return super().find_class(module, name)


def convert(pkl: str, out: str, encoder_pkl: str | None = None) -> list[str]:
    """Converts the checkpoint `pkl` (and E from `encoder_pkl` when given)
    into the npz `out`; returns the names of the trees written."""
    with open(pkl, "rb") as f:
        data = _Unpickler(f).load()

    trees = {}
    config = {}

    if tf_legacy.is_tf_network_tuple(data):
        tf_G, tf_D, tf_Gs = data
        gcfg, trees["G"] = tf_legacy.convert_tf_generator(tf_G)
        _, trees["G_ema"] = tf_legacy.convert_tf_generator(tf_Gs)
        dcfg, trees["D"] = tf_legacy.convert_tf_discriminator(tf_D)
        config["stylegan2_generator"] = gcfg
        config["stylegan2_discriminator"] = dcfg
        ckpt.save_checkpoint(out, trees, config=config)
        print(f"wrote {out} (TF-era): " + ", ".join(sorted(trees)))
        return sorted(trees)

    if "G_ema" in data:
        G = data["G_ema"]
        trees["G_ema"] = ckpt.convert_torch_generator(state_dict_numpy(G))
        config["generator"] = {
            "z_dim": int(G.z_dim),
            "c_dim": int(G.c_dim),
            "w_dim": int(G.w_dim),
            "img_resolution": int(G.img_resolution),
            "rendering_kwargs": {
                k: v for k, v in G.rendering_kwargs.items()
                if isinstance(v, (int, float, str, bool, list, tuple))
            },
        }

    enc_source = data
    if encoder_pkl:
        with open(encoder_pkl, "rb") as f:
            enc_source = pickle.load(f)
    if "E" in enc_source:
        sd = state_dict_numpy(enc_source["E"])
        trees["E"] = ckpt.convert_torch_encoder(sd)
        trees["E_state"] = ckpt.convert_torch_encoder_state(sd)

    if "D" in data and data["D"] is not None:
        trees["D"] = ckpt.convert_torch_generator(state_dict_numpy(data["D"]))  # same flattening

    ckpt.save_checkpoint(out, trees, config=config)
    print(f"wrote {out}: " + ", ".join(sorted(trees)))
    return sorted(trees)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkl", required=True, help="reference checkpoint .pkl")
    ap.add_argument("--encoder-pkl", default=None,
                    help="separate encoder checkpoint (if E not in --pkl)")
    ap.add_argument("--reference", required=True,
                    help="path to the original g_nerf package dir")
    ap.add_argument("--out", required=True, help="output .npz path")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.reference)
    convert(args.pkl, args.out, args.encoder_pkl)


if __name__ == "__main__":
    main()
