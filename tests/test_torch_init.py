"""Parameter init from a threefry key vs the JAX `init(PRNGKey(s))`, leaf by
leaf, for each of the JAX package's 24 `init`s at a tiny config, and for the
full-width G and E of `load_networks(None, seed_init=0)`.

Constant leaves (zeros, ones, full) and uniform draws must be equal; leaves
drawn from `normal` lie within atol 1e-6 times the leaf's init scale (its
standard deviation: 1/lr_multiplier for a mapping layer, sqrt(2/fan_in) for
a He-normal convolution) and rtol 2e-6, the gap of the erfinv polynomials'
last-place roundings (`tests/test_torch_prng.py`)."""

import numpy as np
import pytest
import torch

import jax

from _torch_port import ENC_UNIFORM, assert_init_matches, one_torch_thread  # noqa: F401
from gnerf_tpu.models import dual_discriminator as jdd
from gnerf_tpu.models import encoder as jenc
from gnerf_tpu.models import stylegan2 as jsg
from gnerf_tpu.models import stylegan3 as jsg3
from gnerf_tpu.models import superresolution as jsr
from gnerf_tpu.models import triplane as jtri
from gnerf_tpu.training import inception as jinc
from gnerf_tpu.training import losses as jlosses
from gnerf_tpu_torch.models import dual_discriminator as tdd
from gnerf_tpu_torch.models import encoder as tenc
from gnerf_tpu_torch.models import stylegan2 as tsg
from gnerf_tpu_torch.models import stylegan3 as tsg3
from gnerf_tpu_torch.models import superresolution as tsr
from gnerf_tpu_torch.models import triplane as ttri
from gnerf_tpu_torch.training import inception as tinc
from gnerf_tpu_torch.training import losses as tlosses
from gnerf_tpu_torch.utils import prng
from gnerf_tpu_torch.utils.checkpoint import flatten_tree

def _sl(**kw):
    return dict(w_dim=8, is_torgb=False, is_critically_sampled=False, in_channels=6,
                out_channels=5, in_size=20, out_size=36, in_sampling_rate=16.0,
                out_sampling_rate=32.0, in_cutoff=4.0, out_cutoff=8.0, in_half_width=4.0,
                out_half_width=8.0, **kw)


TINY_G = dict(z_dim=16, c_dim=25, w_dim=16, img_resolution=512, plane_resolution=16,
              plane_channels=32, channel_base=512, channel_max=32, mapping_layers=2,
              rendering_kwargs=dict(jtri.DEFAULT_RENDERING_KWARGS, sr_input_resolution=16))
SG3 = dict(z_dim=16, c_dim=0, w_dim=16, img_resolution=32, img_channels=3, channel_base=1024,
           channel_max=16, num_layers=4)
D_KW = dict(c_dim=25, img_resolution=32, img_channels=3, channel_base=256, channel_max=32)

# (case, JAX module, port constructor; both from the same keyword arguments,
# the port's taking `key` and, for top-level networks, `device`).
CASES = [
    ("sg2.FullyConnectedLayer", jsg.FullyConnectedLayer, tsg.FullyConnectedLayer,
     dict(in_features=7, out_features=5, lr_multiplier=0.01, bias_init=1.0)),
    ("sg2.Conv2dLayer", jsg.Conv2dLayer, tsg.Conv2dLayer,
     dict(in_channels=4, out_channels=6, kernel_size=3)),
    ("sg2.MappingNetwork", jsg.MappingNetwork, tsg.MappingNetwork,
     dict(z_dim=8, c_dim=25, w_dim=12, num_ws=4, num_layers=3)),
    ("sg2.SynthesisLayer", jsg.SynthesisLayer, tsg.SynthesisLayer,
     dict(in_channels=6, out_channels=5, w_dim=8, resolution=8, up=2)),
    ("sg2.ToRGBLayer", jsg.ToRGBLayer, tsg.ToRGBLayer,
     dict(in_channels=6, out_channels=3, w_dim=8)),
    ("sg2.SynthesisBlock", jsg.SynthesisBlock, tsg.SynthesisBlock,
     dict(in_channels=6, out_channels=5, w_dim=8, resolution=8, img_channels=3,
          is_last=True, architecture="resnet")),
    ("sg2.SynthesisNetwork", jsg.SynthesisNetwork, tsg.SynthesisNetwork,
     dict(w_dim=8, img_resolution=16, img_channels=6, channel_base=128, channel_max=16)),
    ("sg2.Generator", jsg.Generator, tsg.Generator,
     dict(z_dim=8, c_dim=4, w_dim=8, img_resolution=16, img_channels=3, mapping_layers=2,
          channel_base=128, channel_max=16)),
    ("sg2.DiscriminatorBlock", jsg.DiscriminatorBlock, tsg.DiscriminatorBlock,
     dict(in_channels=0, tmp_channels=6, out_channels=8, resolution=16, img_channels=3)),
    ("sg2.DiscriminatorEpilogue", jsg.DiscriminatorEpilogue, tsg.DiscriminatorEpilogue,
     dict(in_channels=8, cmap_dim=6, resolution=4, img_channels=3, architecture="skip")),
    ("sg2.Discriminator", jsg.Discriminator, tsg.Discriminator,
     dict(c_dim=25, img_resolution=16, img_channels=1, channel_base=128, channel_max=16)),
    ("sr.SuperresolutionHybrid8XDC", jsr.SuperresolutionHybrid8XDC,
     tsr.SuperresolutionHybrid8XDC, dict(channels=32, img_resolution=512, w_dim=8)),
    ("tri.OSGDecoder", jtri.OSGDecoder, ttri.OSGDecoder,
     dict(n_features=8, hidden_dim=16, decoder_output_dim=32, decoder_lr_mul=0.5)),
    ("tri.TriPlaneGenerator", jtri.TriPlaneGenerator, ttri.TriPlaneGenerator, TINY_G),
    ("enc.ResNeXt50Encoder", jenc.ResNeXt50Encoder, tenc.ResNeXt50Encoder,
     dict(out_dim=16, layers=(1, 2, 1, 1))),
    ("dd.SingleDiscriminator", jdd.SingleDiscriminator, tdd.SingleDiscriminator, D_KW),
    ("dd.DualDiscriminator", jdd.DualDiscriminator, tdd.DualDiscriminator, D_KW),
    ("dd.DummyDualDiscriminator", jdd.DummyDualDiscriminator, tdd.DummyDualDiscriminator,
     D_KW),
    ("losses.VGG16LPIPS", jlosses.VGG16LPIPS, tlosses.VGG16LPIPS, dict(resize_to=32)),
    ("inception.InceptionV3Features", jinc.InceptionV3Features, tinc.InceptionV3Features,
     dict(resize_to=75)),
    ("sg3.SynthesisInput", jsg3.SynthesisInput, tsg3.SynthesisInput,
     dict(w_dim=8, channels=6, size=20, sampling_rate=16.0, bandwidth=2.0)),
    ("sg3.SynthesisLayer", jsg3.SynthesisLayer, tsg3.SynthesisLayer, _sl()),
    ("sg3.SynthesisNetwork", jsg3.SynthesisNetwork, tsg3.SynthesisNetwork,
     dict(w_dim=16, img_resolution=32, img_channels=3, channel_base=1024, channel_max=16,
          num_layers=4)),
    ("sg3.Generator", jsg3.Generator, tsg3.Generator, SG3),
]
TOP_LEVEL = (tsg.Discriminator, ttri.TriPlaneGenerator, tenc.ResNeXt50Encoder,
             tdd.SingleDiscriminator, tdd.DualDiscriminator, tdd.DummyDualDiscriminator,
             tlosses.VGG16LPIPS, tinc.InceptionV3Features, tsg3.Generator)


def _build(cls, kw, key):
    if cls in TOP_LEVEL:
        return cls(**kw, device="cpu", key=key)
    return cls(**kw, key=key)


def _jax_init(jcls, kw, seed):
    tree = jcls(**kw).init(jax.random.PRNGKey(seed))
    if isinstance(tree, tuple):  # the encoder: (params, BN state)
        tree = {**flatten_tree(tree[0]), **flatten_tree(tree[1])}
    return tree


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("case,jcls,tcls,kw", CASES, ids=[c[0] for c in CASES])
def test_init_matches_jax(case, jcls, tcls, kw, seed):
    assert_init_matches(_build(tcls, kw, prng.PRNGKey(seed)), _jax_init(jcls, kw, seed),
                        uniform=ENC_UNIFORM if tcls is tenc.ResNeXt50Encoder else ())


@pytest.mark.parametrize("name", sorted(tsr.SR_REGISTRY))
def test_every_superresolution_init_matches_jax(name):
    """`_SRBase.init` splits one key per block in `block_names()` order."""
    res = {"SuperresolutionHybrid4X": 256, "SuperresolutionHybridDeepfp32": 256,
           "SuperresolutionHybrid2X": 128}.get(name, 512)
    kw = dict(channels=32, img_resolution=res, w_dim=8)
    assert_init_matches(tsr.make_superresolution(name, **kw, key=prng.PRNGKey(3)),
                        jsr.make_superresolution(name, **kw).init(jax.random.PRNGKey(3)))


def test_meta_build_draws_nothing_and_loads():
    """A module built on `meta` holds no storage; `load_jax_params` gives it
    storage on the device, keeps its constant buffers and fills every leaf."""
    from gnerf_tpu_torch.utils.checkpoint import load_jax_params

    g = ttri.TriPlaneGenerator(**TINY_G, device="meta")
    assert all(p.is_meta for p in g.parameters())
    with pytest.raises(ValueError, match="device"):
        load_jax_params(g, _jax_init(jtri.TriPlaneGenerator, TINY_G, 2))
    load_jax_params(g, _jax_init(jtri.TriPlaneGenerator, TINY_G, 2), device="cpu")
    assert_init_matches(g, _jax_init(jtri.TriPlaneGenerator, TINY_G, 2))
    drawn = ttri.TriPlaneGenerator(**TINY_G, device="cpu", key=prng.PRNGKey(2))
    for (name, a), (_, b) in zip(g.named_buffers(), drawn.named_buffers()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_full_width_seed_init_matches_jax():
    """`load_networks(None, seed_init=0)`: G from PRNGKey(0) and E from
    PRNGKey(1), as the JAX `generate_videos` builds them."""
    from gnerf_tpu_torch.infer.gen_videos import load_networks

    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        g, enc = load_networks(None, seed_init=0, device="cpu", double_sampling=False)
    finally:
        torch.set_num_threads(threads)
    assert_init_matches(g, jtri.TriPlaneGenerator().init(jax.random.PRNGKey(0)))
    del g
    assert_init_matches(enc, _jax_init(jenc.ResNeXt50Encoder, dict(out_dim=512), 1),
                        uniform=ENC_UNIFORM)
