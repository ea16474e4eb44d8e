"""Port networks vs gnerf_tpu.models (fp32, CPU, bridged JAX params)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread, t, tiny_gen_cfg, to_np, with_noise_strength  # noqa: F401
from gnerf_tpu.models import ResNeXt50Encoder as JEncoder
from gnerf_tpu.models import TriPlaneGenerator as JGen
from gnerf_tpu.models import stylegan2 as jsg
from gnerf_tpu.models.superresolution import SuperresolutionHybrid8XDC as JSR
from gnerf_tpu.ops import setup_filter as jsetup_filter
from gnerf_tpu.utils import camera as jcam
from gnerf_tpu_torch.models import ResNeXt50Encoder, TriPlaneGenerator, stylegan2
from gnerf_tpu_torch.models.superresolution import SuperresolutionHybrid8XDC
from gnerf_tpu_torch.ops import setup_filter
from gnerf_tpu_torch.utils.checkpoint import load_jax_params


@pytest.mark.parametrize("up,demodulate,noise", [(1, True, False), (2, True, True),
                                                 (1, False, False)])
def test_modulated_conv2d_matches_jax(up, demodulate, noise):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 8, 8).astype(np.float32)
    w = rng.randn(5, 6, 3, 3).astype(np.float32)
    s = rng.randn(2, 6).astype(np.float32)
    res = 8 * up
    nz = rng.randn(res, res).astype(np.float32) if noise else None
    kw = dict(up=up, padding=1, demodulate=demodulate, flip_weight=up == 1)
    want = jsg.modulated_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(s),
                                noise=None if nz is None else jnp.asarray(nz),
                                resample_filter=jsetup_filter([1, 3, 3, 1]) if up > 1 else None,
                                **kw)
    got = stylegan2.modulated_conv2d(t(x), t(w), t(s), noise=None if nz is None else t(nz),
                                     resample_filter=setup_filter([1, 3, 3, 1]) if up > 1 else None,
                                     **kw)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("psi,cutoff", [(1.0, None), (0.7, None), (0.5, 2)])
def test_mapping_network_matches_jax(psi, cutoff):
    jmap = jsg.MappingNetwork(z_dim=16, c_dim=25, w_dim=24, num_ws=5, num_layers=3)
    params = jmap.init(jax.random.PRNGKey(0))
    params["w_avg"] = jnp.asarray(np.random.RandomState(1).randn(24).astype(np.float32))
    m = stylegan2.MappingNetwork(z_dim=16, c_dim=25, w_dim=24, num_ws=5, num_layers=3)
    load_jax_params(m, params)
    rng = np.random.RandomState(2)
    z, c = rng.randn(3, 16).astype(np.float32), rng.randn(3, 25).astype(np.float32)
    want = jmap.apply(params, jnp.asarray(z), jnp.asarray(c), truncation_psi=psi,
                      truncation_cutoff=cutoff)
    got = m(t(z), t(c), truncation_psi=psi, truncation_cutoff=cutoff)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_synthesis_network_const_noise_matches_jax():
    kw = dict(w_dim=16, img_resolution=16, img_channels=12, channel_base=256, channel_max=32)
    jsyn = jsg.SynthesisNetwork(**kw)
    params = with_noise_strength(jsyn.init(jax.random.PRNGKey(3)))
    syn = stylegan2.SynthesisNetwork(**kw)
    load_jax_params(syn, params)
    assert syn.num_ws == jsyn.num_ws
    ws = np.random.RandomState(4).randn(2, jsyn.num_ws, 16).astype(np.float32)
    want = jsyn.apply(params, jnp.asarray(ws), noise_mode="const")
    got = syn(t(ws), noise_mode="const")
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("in_res", [8, 16])  # 8: interpolate branch; 16: the quirk branch
def test_superresolution_8xdc_matches_jax(in_res):
    jsr = JSR(channels=32, img_resolution=512, w_dim=16, input_resolution=16)
    params = jsr.init(jax.random.PRNGKey(5))
    sr = SuperresolutionHybrid8XDC(channels=32, img_resolution=512, w_dim=16, input_resolution=16)
    load_jax_params(sr, params)
    rng = np.random.RandomState(in_res)
    rgb = rng.randn(1, 3, in_res, in_res).astype(np.float32)
    x = rng.randn(1, 32, in_res, in_res).astype(np.float32)
    ws = rng.randn(1, 4, 16).astype(np.float32)
    want_img, want_raw = jsr.apply(params, jnp.asarray(rgb), jnp.asarray(x), jnp.asarray(ws),
                                   noise_mode="none")
    got_img, got_raw = sr(t(rgb), t(x), t(ws), noise_mode="none")
    assert tuple(got_img.shape) == (1, 3, 64, 64)
    np.testing.assert_allclose(to_np(got_raw), np.asarray(want_raw), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(got_img), np.asarray(want_img), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,img_res,in_res,out_res", [
    ("SuperresolutionHybrid8X", 512, 8, 64),
    ("SuperresolutionHybrid4X", 256, 8, 32),
    ("SuperresolutionHybrid2X", 128, 8, 16),
    ("SuperresolutionHybridDeepfp32", 256, 8, 32),
    ("SuperresolutionHybrid8five", 512, 8, 64),
    ("SuperresolutionHybrid8five", 512, 16, 64),   # no-interpolate branch
    ("SuperresolutionHybrid8seven", 512, 8, 64),
])
def test_superresolution_variants_match_jax(name, img_res, in_res, out_res):
    """The other six SR modules, built by (dotted) name through
    `make_superresolution`, with JAX parameters bridged unchanged."""
    from gnerf_tpu.models.superresolution import make_superresolution as jmake
    from gnerf_tpu_torch.models import make_superresolution

    kw = dict(channels=32, img_resolution=img_res, w_dim=16,
              input_resolution=64 if name.endswith("2X") else 16)
    jsr = jmake(name, **kw)
    params = jsr.init(jax.random.PRNGKey(len(name)))
    sr = make_superresolution("training.superresolution." + name, **kw)
    assert type(sr).__name__ == name
    load_jax_params(sr, params)
    rng = np.random.RandomState(in_res)
    rgb = rng.randn(1, 3, in_res, in_res).astype(np.float32)
    x = rng.randn(1, 32, in_res, in_res).astype(np.float32)
    ws = rng.randn(1, 4, 16).astype(np.float32)
    want_img, want_raw = jsr.apply(params, jnp.asarray(rgb), jnp.asarray(x), jnp.asarray(ws),
                                   noise_mode="none")
    got_img, got_raw = sr(t(rgb), t(x), t(ws), noise_mode="none")
    assert tuple(got_img.shape) == (1, 3, out_res, out_res)
    np.testing.assert_allclose(to_np(got_raw), np.asarray(want_raw), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(got_img), np.asarray(want_img), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def encoder_pair():
    jenc = JEncoder(out_dim=24, layers=(1, 1, 1, 1), groups_as_dense=False)
    params, state = jenc.init(jax.random.PRNGKey(6))
    rng = np.random.RandomState(7)
    # Non-trivial BN statistics so the eval-mode normalization is exercised.
    state = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape).astype(np.float32)), state)
    enc = ResNeXt50Encoder(out_dim=24, layers=(1, 1, 1, 1), device="meta")
    load_jax_params(enc, params, state, device="cpu")
    img = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    return jenc, params, state, enc, img


@pytest.mark.parametrize("groups_as_dense,atol", [(False, 1e-4), (True, 1e-3)])
def test_encoder_matches_jax(encoder_pair, groups_as_dense, atol):
    """groups_as_dense=True (the JAX default) sums the grouped conv in
    another order through a 32x wider dense conv, hence the looser bound."""
    jenc, params, state, enc, img = encoder_pair
    jenc = JEncoder(out_dim=24, layers=(1, 1, 1, 1), groups_as_dense=groups_as_dense)
    want, _ = jenc.apply(params, state, jnp.asarray(img), train=False)
    got = enc.apply(t(img), train=False)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=atol)


@pytest.fixture(scope="module")
def generator_pair():
    cfg = tiny_gen_cfg()
    jg = JGen(**cfg)
    params = with_noise_strength(jg.init(jax.random.PRNGKey(8)))
    g = TriPlaneGenerator(**cfg, device="meta")
    load_jax_params(g, params, device="cpu")
    return jg, params, g


def test_triplane_synthesis_matches_jax(generator_pair):
    jg, params, g = generator_pair
    rng = np.random.RandomState(9)
    z = rng.randn(1, 32).astype(np.float32)
    c = np.asarray(jcam.pose_to_label(jcam.lookat_sample(1.3, 1.5, radius=2.7),
                                      jcam.FFHQ_INTRINSICS))
    ws = jg.mapping(params, jnp.asarray(z), jnp.asarray(c))
    want = jg.synthesis(params, ws, jnp.asarray(c), noise_mode="const")
    got = g.synthesis(t(np.asarray(ws)), t(c), noise_mode="const")
    np.testing.assert_allclose(to_np(g.mapping(t(z), t(c))), np.asarray(ws), rtol=1e-5, atol=1e-5)
    assert tuple(got["image"].shape) == (1, 3, 64, 64)
    for name, atol in (("image_depth", 1e-4), ("image_raw", 1e-4), ("image", 1e-4)):
        np.testing.assert_allclose(to_np(got[name]), np.asarray(want[name]), rtol=1e-4,
                                   atol=atol, err_msg=name)


def _smooth_photos(n, res, seed):
    from PIL import Image

    rs = np.random.RandomState(seed)
    return np.stack([np.asarray(Image.fromarray(rs.randint(0, 256, (8, 8, 3), np.uint8))
                                .resize((res, res), Image.BILINEAR)).transpose(2, 0, 1)
                     for _ in range(n)]).astype(np.float32) / 127.5 - 1.0


def test_encoder_train_mode_matches_jax(encoder_pair):
    """Batch statistics (fp32 moments as E[x^2] - E[x]^2): z and the updated
    running mean and unbiased variance against JAX apply(train=True)."""
    from gnerf_tpu_torch.utils.checkpoint import module_params

    jenc, params, state, _, _ = encoder_pair
    enc = ResNeXt50Encoder(out_dim=24, layers=(1, 1, 1, 1), device="meta")
    load_jax_params(enc, params, state, device="cpu")
    img = _smooth_photos(2, 64, seed=3)
    want, new_state = jenc.apply(params, state, jnp.asarray(img), train=True)
    got = enc.apply(t(img), train=True)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    buffers = module_params(enc)
    from gnerf_tpu_torch.utils.checkpoint import flatten_tree

    for k, v in flatten_tree(new_state).items():
        np.testing.assert_allclose(buffers[k], np.asarray(v), rtol=1e-4, atol=1e-5, err_msg=k)
    assert not np.allclose(buffers["bn1/mean"], np.asarray(state["bn1"]["mean"]))


@pytest.mark.parametrize("n,group,arch,cmap", [
    (2, 4, "resnet", None),   # group min(4, 2) = 2
    (4, 4, "resnet", None),   # group 4
    (4, 2, "resnet", None),   # two groups of 2
    (4, None, "skip", 16),    # one group of N; skip architecture; explicit cmap_dim
])
def test_discriminator_matches_jax(n, group, arch, cmap):
    """Depth D logits against the JAX Discriminator, through the minibatch
    std group cases and both architectures."""
    kw = dict(c_dim=25, img_resolution=16, img_channels=1, channel_base=256, channel_max=32,
              mbstd_group_size=group, architecture=arch, cmap_dim=cmap)
    jd = jsg.Discriminator(**kw)
    params = jd.init(jax.random.PRNGKey(n))
    d = stylegan2.Discriminator(**kw, device="meta")
    load_jax_params(d, params, device="cpu")
    rs = np.random.RandomState(n)
    img = (2.25 + rs.rand(n, 1, 16, 16) * 1.05).astype(np.float32)
    c = rs.randn(n, 25).astype(np.float32)
    want = jd.apply(params, jnp.asarray(img), jnp.asarray(c))
    got = d.apply(t(img), t(c))
    assert tuple(got.shape) == (n, 1)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-5)
