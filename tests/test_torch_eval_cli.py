"""The port's eval CLI (gnerf_tpu_torch.training.eval.run_eval).

Reconstruction route: a JAX-written tiny snapshot (G_ema, E, E_state) with
converted LPIPS weights at 32^2 gives the JAX CLI's summary within 1e-4
(PSNR, SSIM, LPIPS means, the item count) and writes the same jsonl.
Generative route (no E): z from the same threefry keys as the JAX CLI, the
VGG Frechet distance with its warning against the JAX CLI's, or FID over
InceptionV3 features from an npz the test writes. The random-VGG fallback
and the fallback G of a snapshot without a `generator` config are the JAX
CLI's."""

import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401
from _torch_pti import TINY_GEN_CFG, jax_setup
from gnerf_tpu.models import ResNeXt50Encoder as JEnc
from gnerf_tpu.utils import checkpoint as jckpt


@pytest.fixture(scope="module")
def jax_snapshots(tmp_path_factory):
    """(snapshot with E, snapshot without E, LPIPS npz) written by the JAX
    package."""
    tmp = tmp_path_factory.mktemp("eval")
    _, params_g, _, params_vgg = jax_setup()
    params_e, state_e = JEnc(out_dim=16).init(jax.random.PRNGKey(1))
    full, gen_only = str(tmp / "full.npz"), str(tmp / "g.npz")
    config = {"generator": TINY_GEN_CFG}
    jckpt.save_checkpoint(full, {"G_ema": params_g, "E": params_e, "E_state": state_e},
                          config=config)
    jckpt.save_checkpoint(gen_only, {"G_ema": params_g}, config=config)
    flat = {k: np.asarray(v) for k, v in jckpt.flatten_tree(params_vgg).items()}
    flat["__meta__"] = np.frombuffer(json.dumps({"resize_to": 32}).encode(), np.uint8)
    lpips = str(tmp / "lpips.npz")
    np.savez(lpips, **flat)
    return full, gen_only, lpips


def test_reconstruction_route_matches_jax(jax_snapshots, tmp_path):
    from gnerf_tpu.training.eval import run_eval as jax_eval
    from gnerf_tpu_torch.training.eval import run_eval

    full, _, lpips = jax_snapshots
    kw = dict(network=full, dataset_name="synthetic", max_items=5, batch=2,
              lpips_weights=lpips)
    want = jax_eval(**kw, out=str(tmp_path / "jax.jsonl"))
    got = run_eval(**kw, out=str(tmp_path / "port.jsonl"), device="cpu")
    assert sorted(got) == sorted(want) == ["lpips", "num_items", "psnr", "ssim"]
    assert got["num_items"] == want["num_items"] == 4
    for k in ("psnr", "ssim", "lpips"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4, err_msg=k)
    lines = {name: [json.loads(x) for x in open(tmp_path / f"{name}.jsonl")]
             for name in ("jax", "port")}
    assert len(lines["port"]) == len(lines["jax"]) == 3


def test_generative_route_vgg_frechet(jax_snapshots, capsys):
    from gnerf_tpu.training.eval import run_eval as jax_eval
    from gnerf_tpu_torch.training.eval import run_eval

    _, gen_only, lpips = jax_snapshots
    kw = dict(network=gen_only, max_items=8, batch=4, lpips_weights=lpips)
    summary = run_eval(**kw, device="cpu")
    assert sorted(summary) == ["frechet_vgg", "num_items"] and summary["num_items"] == 8
    assert np.isfinite(summary["frechet_vgg"]) and summary["frechet_vgg"] > 0
    assert "NOT canonical FID" in capsys.readouterr().out
    np.testing.assert_allclose(summary["frechet_vgg"], jax_eval(**kw)["frechet_vgg"],
                               rtol=1e-3)


@pytest.mark.parametrize("start", [0, 4, 60])
def test_generative_z_matches_jax(start):
    from gnerf_tpu_torch.training.eval import generative_z

    want = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(0), start), (4, 16))
    np.testing.assert_allclose(generative_z(start, 4, 16, "cpu").numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)


def test_random_vgg_lpips_matches_jax():
    """With no LPIPS weights and no `VGG` tree both CLIs take random VGG16
    weights from PRNGKey(1): the same distances."""
    import torch

    from gnerf_tpu.training.losses import VGG16LPIPS as JVGG
    from gnerf_tpu.training.losses import lpips_distance as jdist
    from gnerf_tpu_torch.training.losses import lpips_distance, lpips_from_checkpoint

    vgg = lpips_from_checkpoint({}, "", "cpu")
    rng = np.random.RandomState(4)
    a, b = (rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32) for _ in range(2))
    want = jdist(JVGG(), JVGG().init(jax.random.PRNGKey(1)), jnp.asarray(a), jnp.asarray(b))
    got = lpips_distance(vgg, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_snapshot_without_generator_config_matches_jax(tmp_path, monkeypatch):
    """A snapshot with no config gets the JAX CLI's fallback G (128^2,
    SuperresolutionHybrid2X, 12 + 12 samples) in both CLIs. Both packages'
    default G is narrowed to tiny widths, which the fallback keeps."""
    import gnerf_tpu.models
    import gnerf_tpu_torch.models
    from gnerf_tpu.training.eval import run_eval as jax_eval
    from gnerf_tpu_torch.training.eval import run_eval

    narrow = dict(z_dim=16, w_dim=16, plane_resolution=16, channel_base=256, channel_max=32,
                  mapping_layers=2, neural_rendering_resolution=8)
    for mod in (gnerf_tpu.models, gnerf_tpu_torch.models):
        monkeypatch.setattr(mod, "TriPlaneGenerator",
                            functools.partial(mod.TriPlaneGenerator, **narrow))
    jg = gnerf_tpu.models.TriPlaneGenerator(img_resolution=128, rendering_kwargs=dict(
        gnerf_tpu.models.TriPlaneGenerator().rendering_kwargs,
        superresolution_module="SuperresolutionHybrid2X",
        depth_resolution=12, depth_resolution_importance=12))
    net = str(tmp_path / "bare.npz")
    jckpt.save_checkpoint(net, {"G_ema": jg.init(jax.random.PRNGKey(2))})
    _, _, params_vgg = jax_setup()[1:]
    lpips = str(tmp_path / "lpips.npz")
    flat = {k: np.asarray(v) for k, v in jckpt.flatten_tree(params_vgg).items()}
    flat["__meta__"] = np.frombuffer(json.dumps({"resize_to": 32}).encode(), np.uint8)
    np.savez(lpips, **flat)
    kw = dict(network=net, max_items=4, batch=2, lpips_weights=lpips)
    got = run_eval(**kw, device="cpu")
    want = jax_eval(**kw)
    assert got["num_items"] == want["num_items"] == 4
    np.testing.assert_allclose(got["frechet_vgg"], want["frechet_vgg"], rtol=1e-3)


def test_generative_route_fid_with_inception_weights(jax_snapshots, tmp_path):
    """FID over 299^2 InceptionV3 features from weights the test writes."""
    from gnerf_tpu_torch.training.eval import run_eval
    from gnerf_tpu_torch.training.inception import InceptionV3Features
    from gnerf_tpu_torch.utils import prng
    from gnerf_tpu_torch.utils.checkpoint import module_params, save_checkpoint

    _, gen_only, lpips = jax_snapshots
    net = InceptionV3Features(device="cpu", key=prng.PRNGKey(3))
    path = str(tmp_path / "inception.npz")
    save_checkpoint(path, {"inception": module_params(net)})
    summary = run_eval(network=gen_only, max_items=4, batch=2, lpips_weights=lpips,
                       inception_weights=path, device="cpu")
    assert sorted(summary) == ["fid", "num_items"] and np.isfinite(summary["fid"])
