"""The port's OSG decoder (`osg_decode` and its plain version) vs the JAX
Pallas kernel (interpret mode) and the JAX plain decoder, mirroring
tests/test_fused_decoder.py. The CUDA kernel itself is held against the
plain version on the card (the `cuda` test below, and chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax

from _torch_port import one_torch_thread, t, to_np  # noqa: F401
from gnerf_tpu.models import OSGDecoder as JDecoder
from gnerf_tpu_torch.models import OSGDecoder
from gnerf_tpu_torch.ops.fused_decoder import osg_decode, osg_decode_ref
from gnerf_tpu_torch.utils.checkpoint import load_jax_params

TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(n_features, out_dim, lr_mul, seed):
    jdec = JDecoder(n_features=n_features, decoder_output_dim=out_dim, decoder_lr_mul=lr_mul)
    params = jdec.init(jax.random.PRNGKey(seed))
    dec = OSGDecoder(n_features=n_features, decoder_output_dim=out_dim, decoder_lr_mul=lr_mul)
    load_jax_params(dec, params)
    return jdec, params, dec


@pytest.mark.parametrize("n,m,c,out_dim,lr_mul", [
    (2, 4096, 32, 32, 1.0),   # aligned point count
    (2, 5000, 32, 32, 1.0),   # ragged point count
    (1, 4096, 8, 8, 0.5),     # narrow features, lr multiplier
])
def test_decoder_matches_jax(n, m, c, out_dim, lr_mul):
    jdec, params, dec = _pair(c, out_dim, lr_mul, seed=m)
    feats = np.random.RandomState(m).randn(n, 3, m, c).astype(np.float32)
    want_plain = jdec.apply(params, jax.numpy.asarray(feats), use_fused=False)
    want_pallas = np.asarray(jdec._apply_fused(params, jax.numpy.asarray(feats), interpret=True))
    got = dec(t(feats))
    assert got["rgb"].shape == (n, m, out_dim) and got["sigma"].shape == (n, m, 1)
    np.testing.assert_allclose(to_np(got["sigma"]), np.asarray(want_plain["sigma"]), **TOL)
    np.testing.assert_allclose(to_np(got["rgb"]), np.asarray(want_plain["rgb"]), **TOL)
    np.testing.assert_allclose(to_np(got["sigma"]), want_pallas[..., :1], **TOL)
    np.testing.assert_allclose(to_np(got["rgb"]), want_pallas[..., 1:], **TOL)


def test_wrapper_takes_plain_version_on_cpu():
    _, _, dec = _pair(32, 32, 1.0, seed=3)
    feats = t(np.random.RandomState(3).randn(1, 3, 300, 32))
    weights = dec.folded_weights(torch.float32)
    before = osg_decode.launches
    got = osg_decode(feats, *weights)
    assert osg_decode.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(got, osg_decode_ref(feats, *weights), rtol=0, atol=0)
    # bf16 features: the plain version widens them exactly.
    fb = feats.bfloat16()
    w1b = weights[0].bfloat16()
    got_b = osg_decode(fb, w1b, *weights[1:])
    want_b = osg_decode_ref(fb.float(), w1b.float(), *weights[1:])
    torch.testing.assert_close(got_b, want_b, rtol=0, atol=0)


@pytest.mark.parametrize("fault", ["dtype", "w1_dtype", "planes", "c_not_8", "too_wide", "shape"])
def test_wrapper_rejects(fault):
    c, h, d, m = 16, 64, 33, 10
    feats = torch.zeros(1, 3, m, c)
    w1, b1 = torch.zeros(c, h), torch.zeros(h)
    w2, b2 = torch.zeros(h, d), torch.zeros(d)
    if fault == "dtype":
        feats, w1 = feats.half(), w1.half()
    elif fault == "w1_dtype":
        w1 = w1.bfloat16()
    elif fault == "planes":
        feats = torch.zeros(1, 2, m, c)
    elif fault == "c_not_8":
        feats, w1 = torch.zeros(1, 3, m, 12), torch.zeros(12, h)
    elif fault == "too_wide":
        w1, b1, w2 = torch.zeros(c, 128), torch.zeros(128), torch.zeros(128, d)
    else:
        b2 = torch.zeros(d + 1)
    with pytest.raises((TypeError, ValueError)):
        osg_decode(feats, w1, b1, w2, b2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, dec = _pair(32, 32, 1.0, seed=5)
    dec = dec.cuda()
    dt = getattr(torch, dtype)
    feats = torch.randn(1, 3, 5000, 32, device="cuda").to(dt)
    weights = dec.folded_weights(dt)
    before = osg_decode.launches
    got = osg_decode(feats, *weights)
    torch.cuda.synchronize()
    assert osg_decode.launches == before + 1
    torch.testing.assert_close(got, osg_decode_ref(feats, *weights), **TOL)
