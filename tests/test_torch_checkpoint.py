"""The port reads and writes the JAX package's npz checkpoints, and the
weight bridge maps JAX param trees onto the port's modules exactly."""

import numpy as np
import pytest

import jax

from _torch_port import one_torch_thread, tiny_gen_cfg, to_np  # noqa: F401
from gnerf_tpu.models import ResNeXt50Encoder as JEncoder
from gnerf_tpu.models import TriPlaneGenerator as JGen
from gnerf_tpu.utils import checkpoint as jckpt
from gnerf_tpu_torch.models import ResNeXt50Encoder, TriPlaneGenerator
from gnerf_tpu_torch.utils import checkpoint as ckpt


@pytest.fixture(scope="module")
def jax_trees():
    g = JGen(**tiny_gen_cfg())
    enc = JEncoder(out_dim=32, layers=(1, 1, 1, 1))
    params_e, state_e = enc.init(jax.random.PRNGKey(1))
    return {"G_ema": g.init(jax.random.PRNGKey(0)), "E": params_e, "E_state": state_e}


def test_jax_save_port_load_identical(jax_trees, tmp_path):
    path = str(tmp_path / "net.npz")
    config = {"generator": {"z_dim": 32}, "note": "x"}
    jckpt.save_checkpoint(path, jax_trees, config=config)
    trees, got_config = ckpt.load_checkpoint(path)
    assert got_config == config
    assert set(trees) == set(jax_trees)
    for name, tree in jax_trees.items():
        want = jckpt.flatten_tree(tree)
        got = ckpt.flatten_tree(trees[name])
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_save_jax_load_identical(jax_trees, tmp_path):
    g = TriPlaneGenerator(**tiny_gen_cfg(), device="cpu")
    ckpt.load_jax_params(g, jax_trees["G_ema"])
    path = str(tmp_path / "port.npz")
    ckpt.save_checkpoint(path, {"G_ema": g}, config={"generator": {}})
    trees, config = jckpt.load_checkpoint(path)
    assert config == {"generator": {}}
    want = jckpt.flatten_tree(jax_trees["G_ema"])
    got = jckpt.flatten_tree(trees["G_ema"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_bridge_copies_every_array(jax_trees):
    g = TriPlaneGenerator(**tiny_gen_cfg(), device="cpu")
    ckpt.load_jax_params(g, jax_trees["G_ema"])
    want = jckpt.flatten_tree(jax_trees["G_ema"])
    got = ckpt.module_params(g)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    enc = ResNeXt50Encoder(out_dim=32, layers=(1, 1, 1, 1), device="cpu")
    ckpt.load_jax_params(enc, jax_trees["E"], jax_trees["E_state"])
    np.testing.assert_array_equal(to_np(enc.layer2_0.bn2.var),
                                  np.asarray(jax_trees["E_state"]["layer2_0"]["bn2"]["var"]))
    np.testing.assert_array_equal(to_np(enc.fc.weight), np.asarray(jax_trees["E"]["fc"]["weight"]))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "duplicate"])
def test_bridge_raises(jax_trees, fault):
    flat = dict(jckpt.flatten_tree(jax_trees["G_ema"]))
    trees = [flat]
    key = "decoder/fc0/weight"
    if fault == "missing":
        del flat[key]
    elif fault == "extra":
        flat["decoder/fc2/weight"] = flat[key]
    elif fault == "shape":
        flat[key] = flat[key][:, :-1]
    else:
        trees.append({key: flat[key]})
    g = TriPlaneGenerator(**tiny_gen_cfg(), device="cpu")
    with pytest.raises((KeyError, ValueError)):
        ckpt.load_jax_params(g, *trees)
