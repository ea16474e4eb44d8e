"""The port's TF-era (tflib) pickle conversion vs the JAX package's.

`gnerf_tpu_torch/utils/tf_legacy.py` against `gnerf_tpu/utils/tf_legacy.py`
on the synthetic tflib records of `tests/test_tf_legacy.py`: the same
config, the same trees bit for bit, which load into the port's
`models.stylegan2` Generator / Discriminator and apply as JAX's within
1e-4; the same `ValueError`s from the kwarg guards; and the CLI round trip
of a pickled `(G, D, Gs)` tuple through the port's tool (JAX blocked),
whose npz equals the JAX tool's.
"""

import os
import pickle
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ingest as ingest
from _torch_port import one_torch_thread, to_np  # noqa: F401
from gnerf_tpu.models import stylegan2 as jsg
from gnerf_tpu.utils import tf_legacy as jtf
from gnerf_tpu_torch.models import stylegan2
from gnerf_tpu_torch.utils import tf_legacy
from gnerf_tpu_torch.utils.checkpoint import load_checkpoint, load_jax_params
from test_tf_legacy import make_tf_discriminator_stub, make_tf_generator_stub
from test_torch_convert import assert_npz_identical, assert_trees_identical


def _converted(kind, **stub_kw):
    """(port cfg, port tree, JAX cfg, JAX tree) of one stub, held equal."""
    make = make_tf_generator_stub if kind == "G" else make_tf_discriminator_stub
    seed = stub_kw.pop("seed")
    convert = "convert_tf_generator" if kind == "G" else "convert_tf_discriminator"
    cfg, tree = getattr(tf_legacy, convert)(make(np.random.default_rng(seed), **stub_kw))
    jcfg, jtree = getattr(jtf, convert)(make(np.random.default_rng(seed), **stub_kw))
    assert cfg == jcfg
    assert_trees_identical(tree, jtree)
    return cfg, tree, jtree


def test_tf_generator_structure_and_apply():
    cfg, tree, jtree = _converted("G", seed=0)
    g = load_jax_params(stylegan2.Generator(**cfg), tree, device="cpu")
    z = np.random.RandomState(0).randn(2, cfg["z_dim"]).astype(np.float32)
    got = g(torch.from_numpy(z), None, noise_mode="const")
    want = jsg.Generator(**cfg).apply(jtree, jnp.asarray(z), None, noise_mode="const")
    assert tuple(got.shape) == (2, 3, 16, 16)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("label,mapping_fmaps", [(0, None), (3, 16)])
def test_tf_discriminator_structure_and_apply(label, mapping_fmaps):
    """The unconditional D and the conditional one (a 16-wide label map)."""
    cfg, tree, jtree = _converted("D", seed=1 + label, label=label,
                                  mapping_fmaps=mapping_fmaps)
    if label:
        assert cfg["mapping_layers"] == 0 and cfg["cmap_dim"] == 16
    d = load_jax_params(stylegan2.Discriminator(**cfg, device="meta"), tree, device="cpu")
    rs = np.random.RandomState(label)
    img = rs.randn(4, 3, 16, 16).astype(np.float32)
    c = rs.randn(4, label).astype(np.float32) if label else None
    got = d.apply(torch.from_numpy(img), None if c is None else torch.from_numpy(c))
    want = jsg.Discriminator(**cfg).apply(jtree, jnp.asarray(img),
                                          None if c is None else jnp.asarray(c))
    assert tuple(got.shape) == (4, 1)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fault,match", [("version", "version too low"),
                                         ("unknown", "made_up_kwarg"),
                                         ("relu", "nonlinearity")])
def test_tf_kwarg_guards(fault, match):
    errors = []
    for module in (tf_legacy, jtf):
        stub = make_tf_generator_stub(np.random.default_rng(3))
        if fault == "version":
            stub.version = 3
        elif fault == "unknown":
            stub.static_kwargs["made_up_kwarg"] = 7
        else:
            stub.static_kwargs["nonlinearity"] = "relu"
        with pytest.raises(ValueError, match=match) as err:
            module.convert_tf_generator(stub)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def _write_tf_pickle(path, rng):
    """Pickles a tflib `(G, D, Gs)` tuple of `dnnlib.tflib.network.Network`
    records, with that module path made importable while it is written."""
    net_mod = types.ModuleType("dnnlib.tflib.network")
    network = type("Network", (), {"__module__": "dnnlib.tflib.network",
                                    "__qualname__": "Network"})
    net_mod.Network = network
    fakes = [("dnnlib", types.ModuleType("dnnlib")),
             ("dnnlib.tflib", types.ModuleType("dnnlib.tflib")),
             ("dnnlib.tflib.network", net_mod)]
    added = [n for n, m in fakes if sys.modules.setdefault(n, m) is m]
    sys.modules["dnnlib.tflib.network"].Network = network

    def as_network(stub):
        n = network()
        n.__dict__.update(version=stub.version, static_kwargs=stub.static_kwargs,
                          variables=stub.variables,
                          components={k: as_network(v) for k, v in stub.components.items()})
        return n

    try:
        nets = (as_network(make_tf_generator_stub(rng, res=8)),
                as_network(make_tf_discriminator_stub(rng, res=8)),
                as_network(make_tf_generator_stub(rng, res=8)))
        with open(path, "wb") as f:
            pickle.dump(nets, f)
    finally:
        for name in added:
            sys.modules.pop(name, None)


def test_tf_pkl_tool_roundtrip_matches_jax_tool(tmp_path):
    pkl = tmp_path / "tf_net.pkl"
    _write_tf_pickle(pkl, np.random.default_rng(4))
    want = tmp_path / "jax.npz"
    proc = subprocess.run(
        [sys.executable, os.path.join(ingest.ROOT, "tools/convert_reference_pkl.py"),
         "--pkl", str(pkl), "--reference", str(tmp_path), "--out", str(want)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = tmp_path / "port.npz"
    out = ingest.run_without_jax("gnerf_tpu_torch.tools.convert_reference_pkl", "--pkl", str(pkl),
                                 "--reference", str(tmp_path), "--out", str(got)).stdout
    assert "(TF-era): D, G, G_ema" in out
    assert_npz_identical(str(got), str(want))
    trees, config = load_checkpoint(str(got))
    assert set(trees) == {"G", "G_ema", "D"}
    assert config["stylegan2_generator"]["img_resolution"] == 8
    assert config["stylegan2_discriminator"]["architecture"] == "resnet"
    load_jax_params(stylegan2.Generator(**config["stylegan2_generator"]), trees["G_ema"],
                    device="cpu")
    load_jax_params(stylegan2.Discriminator(**config["stylegan2_discriminator"], device="meta"),
                    trees["D"], device="cpu")
