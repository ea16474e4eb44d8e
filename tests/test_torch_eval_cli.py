"""The port's eval CLI (gnerf_tpu_torch.training.eval.run_eval).

Reconstruction route: a JAX-written tiny snapshot (G_ema, E, E_state) with
converted LPIPS weights at 32^2 gives the JAX CLI's summary within 1e-4
(PSNR, SSIM, LPIPS means, the item count) and writes the same jsonl.
Generative route (no E): the VGG Frechet distance with its warning, or FID
over InceptionV3 features from an npz the test writes; its z are the port's
own draws, so the values are checked for being finite, not against JAX."""

import json

import numpy as np
import pytest

import jax

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
    from gnerf_tpu_torch.training.eval import run_eval

    _, gen_only, lpips = jax_snapshots
    summary = run_eval(network=gen_only, max_items=8, batch=4, lpips_weights=lpips,
                       device="cpu")
    assert sorted(summary) == ["frechet_vgg", "num_items"] and summary["num_items"] == 8
    assert np.isfinite(summary["frechet_vgg"]) and summary["frechet_vgg"] > 0
    assert "NOT canonical FID" in capsys.readouterr().out


def test_generative_route_fid_with_inception_weights(jax_snapshots, tmp_path):
    """FID over 299^2 InceptionV3 features from weights the test writes."""
    import torch

    from gnerf_tpu_torch.training.eval import run_eval
    from gnerf_tpu_torch.training.inception import InceptionV3Features
    from gnerf_tpu_torch.utils.checkpoint import module_params, save_checkpoint

    _, gen_only, lpips = jax_snapshots
    net = InceptionV3Features(device="cpu", generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "inception.npz")
    save_checkpoint(path, {"inception": module_params(net)})
    summary = run_eval(network=gen_only, max_items=4, batch=2, lpips_weights=lpips,
                       inception_weights=path, device="cpu")
    assert sorted(summary) == ["fid", "num_items"] and np.isfinite(summary["fid"])
