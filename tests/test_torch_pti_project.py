"""The port's w projector and PTI CLI (gnerf_tpu_torch.training.pti).

`project_w` from the same seed (LPIPS + L2) gives the JAX projector's loss
history at rtol 1e-4 and its ws at rtol 1e-4 / atol 1e-5: with its noise
factor at 0 from the same start ws, and with the noise and the w_avg start,
which draw from the seed's keys in both packages.
`run_pti_cli` on a tiny snapshot writes `network-pti.npz` in the JAX
layout: the JAX checkpoint reader loads it and its G_ema fills a JAX G's
tree; the SR module is bitwise the input's and the rest of G moved."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread, t, to_np  # noqa: F401
from _torch_pti import TINY_GEN_CFG, jax_setup, pivot_ws, port_networks, tiny_targets
from gnerf_tpu.training import pti as JP
from gnerf_tpu_torch.training import pti as P


def test_project_w_matches_jax_without_noise():
    g, params_g, vgg, params_vgg = jax_setup()
    target, c = tiny_targets(n=2, seed=3)
    start = pivot_ws(g, params_g, n=2, seed=5)
    # l2_lambda 1: with the random VGG alone the w gradient is ~1e-6, near
    # Adam's eps, where fp32 rounding of its smallest entries shows.
    kw = dict(num_steps=4, w_avg_samples=16, initial_lr=0.05, initial_noise_factor=0.0,
              l2_lambda=1.0)
    ws, hist = JP.project_w(g, params_g, vgg, params_vgg, jnp.asarray(target), jnp.asarray(c),
                            start_ws=jnp.asarray(start), rng=jax.random.PRNGKey(3), **kw)
    tg, tvgg = port_networks(params_g, params_vgg)
    got, got_hist = P.project_w(tg, tvgg, t(target), t(c), start_ws=t(start), seed=3, **kw)
    np.testing.assert_allclose(got_hist, hist, rtol=1e-4)
    assert got_hist[-1] < got_hist[0]
    np.testing.assert_allclose(to_np(got), np.asarray(ws), rtol=1e-4, atol=1e-5)
    assert got.shape == (2, tg.num_ws, tg.w_dim)


@pytest.mark.parametrize("seed", [0, 4])
def test_project_w_matches_jax_from_seed(seed):
    """The w_avg start over 16 mapping draws and the noise of every step."""
    g, params_g, vgg, params_vgg = jax_setup()
    target, c = tiny_targets(n=2, seed=3)
    kw = dict(num_steps=4, w_avg_samples=16, initial_lr=0.05, initial_noise_factor=0.5,
              l2_lambda=1.0)
    ws, hist = JP.project_w(g, params_g, vgg, params_vgg, jnp.asarray(target), jnp.asarray(c),
                            rng=jax.random.PRNGKey(seed), **kw)
    tg, tvgg = port_networks(params_g, params_vgg)
    got, got_hist = P.project_w(tg, tvgg, t(target), t(c), seed=seed, **kw)
    np.testing.assert_allclose(got_hist, hist, rtol=1e-4)
    np.testing.assert_allclose(to_np(got), np.asarray(ws), rtol=1e-4, atol=1e-5)


def _snapshot(tmp_path):
    """A tiny port snapshot (G_ema, a (1, 1, 1, 1) E with its BN state)."""
    from gnerf_tpu_torch.models import ResNeXt50Encoder
    from gnerf_tpu_torch.utils import checkpoint as ckpt
    from gnerf_tpu_torch.utils import prng

    _, params_g, _, params_vgg = jax_setup()
    g, _ = port_networks(params_g, params_vgg)
    enc = ResNeXt50Encoder(out_dim=16, layers=(1, 1, 1, 1), device="cpu",
                           key=prng.PRNGKey(2))
    path = str(tmp_path / "snap.npz")
    ckpt.save_checkpoint(path, {"G_ema": g, **ckpt.encoder_trees(enc)},
                         config={"generator": json.loads(json.dumps(TINY_GEN_CFG)),
                                 "encoder": {"layers": [1, 1, 1, 1]}})
    return path, g


def test_run_pti_cli_writes_jax_layout(tmp_path, capsys):
    from gnerf_tpu.models.triplane import TriPlaneGenerator as JGen
    from gnerf_tpu.utils import checkpoint as jckpt

    path, g = _snapshot(tmp_path)
    out, history = P.run_pti_cli(network=path, dataset_name="synthetic",
                                 outdir=str(tmp_path / "pti"), steps=3, max_items=2,
                                 pivot="project", project_steps=2, locality=True, device="cpu")
    assert len(history) == 3 and np.isfinite(history).all()
    printed = capsys.readouterr().out
    assert "project_w: loss" in printed and "random-VGG" in printed
    trees, config = jckpt.load_checkpoint(out)
    assert set(trees) == {"G_ema", "E", "E_state"}
    assert config["pti"] == {"steps": 3, "num_items": 2, "locality": True}
    fresh = JGen(**TINY_GEN_CFG).init(jax.random.PRNGKey(9))
    copied = jckpt.flatten_tree(jckpt.copy_params(trees["G_ema"], fresh, verbose=False))
    tuned = jckpt.flatten_tree(trees["G_ema"])
    assert set(copied) == set(tuned) == set(jckpt.flatten_tree(fresh))
    before = {k.replace(".", "/"): to_np(v) for k, v in g.state_dict().items()}
    for k, v in tuned.items():
        if k.startswith("superresolution/"):
            np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert not np.array_equal(tuned["decoder/fc0/weight"], before["decoder/fc0/weight"])
    assert not np.array_equal(tuned["backbone/synthesis/b16/conv1/weight"],
                              before["backbone/synthesis/b16/conv1/weight"])


def test_run_pti_cli_refuses_encoder_pivot_without_encoder_and_align_without_data(tmp_path):
    from gnerf_tpu_torch.utils import checkpoint as ckpt

    _, g = _snapshot(tmp_path)
    path = str(tmp_path / "g_only.npz")
    ckpt.save_checkpoint(path, {"G_ema": g},
                         config={"generator": json.loads(json.dumps(TINY_GEN_CFG))})
    with pytest.raises(ValueError, match="--pivot project"):
        P.run_pti_cli(network=path, outdir=str(tmp_path / "a"), device="cpu")
    with pytest.raises(ValueError, match="--align_lm needs --data"):
        P.run_pti_cli(network=path, outdir=str(tmp_path / "b"), pivot="project",
                      align_lm=str(tmp_path), device="cpu")
