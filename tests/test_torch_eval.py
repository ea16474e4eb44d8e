"""The port's metrics and InceptionV3 (gnerf_tpu_torch.training.{metrics,
inception}) vs the JAX package's, on numpy-made inputs and one numpy-made
weight tree: reconstruction metrics and pooled VGG features at rtol 1e-4 /
atol 1e-5, the host-side Frechet distance exactly, and the Inception
features against JAX and against the torchvision-layout oracle
(tests/_inception_shim.py) at rtol 1e-4 / atol 1e-5 of the largest
feature; the converter and the npz loader give the same net."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _inception_shim import InceptionV3Trunk
from _torch_port import one_torch_thread, t, to_np  # noqa: F401
from _torch_pti import jax_vgg, port_vgg
from gnerf_tpu.training import inception as JI
from gnerf_tpu.training import metrics as JM
from gnerf_tpu_torch.training import inception as I
from gnerf_tpu_torch.training import metrics as M
from gnerf_tpu_torch.utils import prng
from gnerf_tpu_torch.utils.checkpoint import flatten_tree, load_jax_params


def _images(n, side, seed):
    return np.random.RandomState(seed).rand(n, 3, side, side).astype(np.float32) * 2 - 1


@pytest.fixture(scope="module")
def vggs():
    vgg, params_vgg = jax_vgg()
    return vgg, params_vgg, port_vgg(params_vgg)


def test_reconstruction_metrics_match_jax(vggs):
    jvgg, params_vgg, vgg = vggs
    real, fake = _images(3, 16, 0), _images(3, 16, 1)
    want = JM.reconstruction_metrics(jvgg, params_vgg, jnp.asarray(real), jnp.asarray(fake))
    got = M.reconstruction_metrics(vgg, t(real), t(fake))
    assert sorted(got) == sorted(want) == ["lpips", "psnr", "ssim"]
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=1e-5, err_msg=k)


def test_vgg_feature_fn_matches_jax(vggs):
    jvgg, params_vgg, vgg = vggs
    x = _images(4, 16, 2)
    want = np.asarray(JM.make_vgg_feature_fn(jvgg, params_vgg)(jnp.asarray(x)))
    got = to_np(M.make_vgg_feature_fn(vgg)(x))
    assert got.shape == (4, 64 + 128 + 256 + 512 + 512)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_frechet_distance_and_statistics_match_jax():
    rs = np.random.RandomState(3)
    a, b = rs.randn(40, 12), rs.randn(40, 12) * 1.3 + 0.2
    for f in (a, b):
        for got, want in zip(M.feature_statistics(f), JM.feature_statistics(f)):
            np.testing.assert_array_equal(got, want)
    (ma, sa), (mb, sb) = M.feature_statistics(a), M.feature_statistics(b)
    assert M.frechet_distance(ma, sa, mb, sb) == JM.frechet_distance(ma, sa, mb, sb) > 0
    assert abs(M.frechet_distance(ma, sa, ma, sa)) < 1e-6

    def feature_fn(x):
        return torch.as_tensor(np.asarray(x)).flatten(1)

    batches = [rs.randn(5, 3, 2, 2).astype(np.float32) for _ in range(6)]
    want = JM.frechet_feature_distance(lambda x: np.asarray(x).reshape(len(x), -1),
                                       batches[:3], batches[3:], max_items=12)
    assert M.frechet_feature_distance(feature_fn, batches[:3], batches[3:], max_items=12) == want


@pytest.fixture(scope="module")
def inception_tree():
    """One numpy-made torchvision-layout state (BN statistics randomized so
    the fold is exercised), converted by the JAX converter."""
    torch.manual_seed(0)
    net = InceptionV3Trunk().eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.02)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.02)
    state = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    return net, state, JI.convert_torch_inception(state)


def test_inception_features_match_jax_and_the_oracle(inception_tree):
    shim, state, jparams = inception_tree
    net = I.InceptionV3Features(resize_to=96, device="meta")
    load_jax_params(net, I.convert_torch_inception(state), device="cpu")
    x = _images(2, 64, 1)
    got = to_np(net.features(t(x)))
    assert got.shape == (2, I.FEATURE_DIM)
    want = np.asarray(JI.InceptionV3Features(resize_to=96).features(jparams, jnp.asarray(x)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale)
    with torch.no_grad():
        y = torch.nn.functional.interpolate(t(x), size=(96, 96), mode="bilinear",
                                            align_corners=False)
        mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
        std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
        oracle = to_np(shim(((y + 1) * 0.5 - mean) / std))
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-5 * scale)


def test_inception_shapes_converter_and_loader(inception_tree, tmp_path):
    """The shape table and the converter equal JAX's; an npz the JAX
    package writes loads into the port's net with the converter's weights;
    a key names the random weights; a mis-shaped weight raises."""
    from gnerf_tpu.utils import checkpoint as jckpt

    _, state, jparams = inception_tree
    assert I.inception_conv_shapes() == JI.inception_conv_shapes()
    ours = flatten_tree(I.convert_torch_inception(state))
    theirs = flatten_tree(jparams)
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)
    path = str(tmp_path / "inception.npz")
    jckpt.save_checkpoint(path, {"inception": jparams}, config={"pretrained": True})
    net = I.load_inception(path, device="cpu")
    assert net.resize_to == 299 and not any(p.requires_grad for p in net.parameters())
    loaded = {k.replace(".", "/"): to_np(v) for k, v in net.state_dict().items()}
    assert loaded.keys() == ours.keys()
    for k, v in ours.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    a = I.InceptionV3Features(device="cpu", key=prng.PRNGKey(5))
    b = I.InceptionV3Features(device="cpu", key=prng.PRNGKey(5))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.Conv2d_1a_3x3.conv.weight,
                           I.InceptionV3Features(device="cpu").Conv2d_1a_3x3.conv.weight)
    bad = dict(state, **{"Mixed_5b.branch1x1.conv.weight": np.zeros((64, 192, 3, 3))})
    with pytest.raises(ValueError, match="Mixed_5b.branch1x1"):
        I.convert_torch_inception(bad)
