"""Shared set-up of the PTI and eval parity tests (tests/test_torch_pti.py,
test_torch_pti_project.py, test_torch_eval.py): the tiny G and VGG of
tests/test_pti.py and tests/test_eval_cli.py in both packages from the same
JAX parameters, and one batch of the JAX SyntheticDataset at the tiny G's
16^2 output."""

import numpy as np

import jax
import jax.numpy as jnp

from gnerf_tpu.models.triplane import DEFAULT_RENDERING_KWARGS
from gnerf_tpu.models.triplane import TriPlaneGenerator as JGen
from gnerf_tpu.training import VGG16LPIPS as JVGG
from gnerf_tpu.training import dataset as jds
from gnerf_tpu_torch.models import TriPlaneGenerator
from gnerf_tpu_torch.training import VGG16LPIPS
from gnerf_tpu_torch.utils.checkpoint import flatten_tree, load_jax_params, module_params

TINY_GEN_CFG = dict(
    z_dim=16, w_dim=16, img_resolution=128, plane_resolution=16, channel_base=256,
    channel_max=32, mapping_layers=2, neural_rendering_resolution=8,
    rendering_kwargs=dict(DEFAULT_RENDERING_KWARGS,
                          superresolution_module="SuperresolutionHybrid2X",
                          depth_resolution=4, depth_resolution_importance=4),
)


def jax_vgg():
    """(JAX VGG at 32^2, its params)."""
    vgg = JVGG(resize_to=32)
    return vgg, vgg.init(jax.random.PRNGKey(1))


def jax_setup():
    """(JAX G, its params, JAX VGG at 32^2, its params)."""
    g = JGen(**TINY_GEN_CFG)
    return (g, g.init(jax.random.PRNGKey(0))) + jax_vgg()


def port_vgg(params_vgg):
    return load_jax_params(VGG16LPIPS(resize_to=32, device="meta"), params_vgg, device="cpu")


def port_networks(params_g, params_vgg):
    g = load_jax_params(TriPlaneGenerator(**TINY_GEN_CFG, device="meta"), params_g,
                        device="cpu")
    return g, port_vgg(params_vgg)


def tiny_targets(n=2, seed=0):
    """[-1, 1] loss images [n, 3, 16, 16] and their labels [n, 25]."""
    ds = jds.SyntheticDataset(resolution=16, depth_resolution=8, size=8)
    items = jds.collate([ds[i] for i in range(seed, seed + n)])
    return (np.asarray(items["loss_image"], np.float32) / 127.5 - 1.0,
            np.asarray(items["loss_c"], np.float32))


def pivot_ws(g, params_g, n=2, seed=2):
    z = jax.random.normal(jax.random.PRNGKey(seed), (n, g.z_dim))
    return np.asarray(g.mapping(params_g, z, jnp.zeros((n, 25))))


def assert_g_matches(jax_params, module, check_trained):
    """Every leaf of the JAX tree against the port module: trained weights
    through `check_trained(name, jax_value, param)`, the rest at rtol 1e-4 /
    atol 1e-5."""
    params = {n.replace(".", "/"): p for n, p in module.named_parameters()}
    bufs = module_params(module)
    flat = flatten_tree(jax_params)
    assert set(flat) == set(bufs), sorted(set(flat) ^ set(bufs))[:5]
    for k, v in flat.items():
        if k in params and params[k].requires_grad:
            check_trained(k, v, params[k])
        else:
            np.testing.assert_allclose(bufs[k], np.asarray(v), rtol=1e-4, atol=1e-5, err_msg=k)
