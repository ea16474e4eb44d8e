"""Global-batch semantics of the port's models on gloo ranks on the CPU:
the encoder's train-mode BatchNorm over 4 ranks x 2 rows against JAX's
`_bn_apply` on the 8-row batch (forward, backward, running buffers),
`minibatch_std` over 2 ranks x 4 rows against JAX on 8 rows, with groups
that span the ranks and R1's double backward, alone and inside every
discriminator that uses it (against the port's world 1), and `render_rays`
split over 2 ranks by rows or by rays (against the port's world 1).

Gradient convention (gnerf_tpu_torch/parallel/collectives.py): each rank
differentiates its own rows' loss; a rank's input gradient is the global
loss's gradient at its rows, and the sum over ranks of a weight gradient is
the global loss's. Tolerance rtol 1e-4 / atol 1e-5 against JAX (as
tests/test_torch_training.py), atol 1e-5 between worlds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import _torch_ddp_workers as W
from _torch_dist import run_ranks
from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu.models.encoder import _bn_apply
from gnerf_tpu.models.stylegan2 import minibatch_std as jax_mbstd

TOL = dict(rtol=1e-4, atol=1e-5)
WORLDS = dict(rtol=0, atol=1e-5)


def test_synced_batchnorm_matches_jax_global_batch():
    rs = np.random.RandomState(0)
    x = (rs.randn(8, 6, 5, 5) * 2 + 1).astype(np.float32)
    w = rs.randn(8, 6, 5, 5).astype(np.float32)
    params = {"scale": (1 + 0.1 * rs.randn(6)).astype(np.float32),
              "bias": (0.1 * rs.randn(6)).astype(np.float32),
              "mean": (0.1 * rs.randn(6)).astype(np.float32),
              "var": (1 + 0.1 * rs.rand(6)).astype(np.float32)}
    p = {k: jnp.asarray(params[k]) for k in ("scale", "bias")}
    s = {k: jnp.asarray(params[k]) for k in ("mean", "var")}

    def loss(xx, pp):
        y, st = _bn_apply(pp, s, xx, True, momentum=0.1)
        return (y * w).sum(), (y, st)

    (_, (y, st)), (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), p)
    results = run_ranks(W.bn_case, 4, x, w, params, 0.1, timeout=300)
    for rank, (y_r, gx_r, _, _, mean_r, var_r) in enumerate(results):
        rows = slice(2 * rank, 2 * rank + 2)
        np.testing.assert_allclose(y_r, np.asarray(y)[rows], **TOL)
        np.testing.assert_allclose(gx_r, np.asarray(gx)[rows], **TOL)
        np.testing.assert_allclose(mean_r, np.asarray(st["mean"]), **TOL)
        np.testing.assert_allclose(var_r, np.asarray(st["var"]), **TOL)
    np.testing.assert_allclose(sum(r[2] for r in results), np.asarray(gp["scale"]), **TOL)
    np.testing.assert_allclose(sum(r[3] for r in results), np.asarray(gp["bias"]), **TOL)


def test_minibatch_std_groups_span_ranks_like_jax():
    """Group size 4 over the global 8 rows puts rows {j, j+2, j+4, j+6} in
    group j: every group spans both ranks."""
    rs = np.random.RandomState(1)
    x = rs.randn(8, 4, 3, 3).astype(np.float32)
    w = rs.randn(8, 5, 3, 3).astype(np.float32)
    k = np.float32(0.7)

    def r1(xx, kk):
        def logits_sum(x_):
            return jnp.tanh(jax_mbstd(x_, 4) * kk).sum()
        return jnp.square(jax.grad(logits_sum)(xx)).sum()

    xj = jnp.asarray(x)
    out = jax_mbstd(xj, 4)
    gx = jax.grad(lambda xx: (jax_mbstd(xx, 4) * w).sum())(xj)
    g1 = jax.grad(lambda xx: jnp.tanh(jax_mbstd(xx, 4) * k).sum())(xj)
    gk = jax.grad(r1, argnums=1)(xj, jnp.asarray(k))
    results = run_ranks(W.mbstd_case, 2, x, w, k, 4, timeout=300)
    for rank, (out_r, gx_r, g1_r, _) in enumerate(results):
        rows = slice(4 * rank, 4 * rank + 4)
        np.testing.assert_allclose(out_r, np.asarray(out)[rows], **TOL)
        np.testing.assert_allclose(gx_r, np.asarray(gx)[rows], **TOL)
        np.testing.assert_allclose(g1_r, np.asarray(g1)[rows], **TOL)
    np.testing.assert_allclose(sum(r[3] for r in results), np.asarray(gk), **TOL)


@pytest.fixture(scope="module")
def discs():
    rs = np.random.RandomState(2)
    img = rs.randn(8, 3, 16, 16).astype(np.float32)
    raw = rs.randn(8, 3, 8, 8).astype(np.float32)
    c = rs.randn(8, 25).astype(np.float32)
    want = {name: W.disc_logits_and_r1(name, *(torch.from_numpy(v) for v in (img, raw, c)))
            for name in W.DISCS}
    return want, run_ranks(W.disc_case, 2, img, raw, c, timeout=300)


@pytest.mark.parametrize("name", list(W.DISCS))
def test_discriminator_on_two_ranks_matches_world1(discs, name):
    """Each D with mbstd group 4 on 2 ranks x 4 rows: logits and R1's input
    gradient at the rank's rows, and the summed weight gradient of R1 (a
    double backward through the gather), equal the port's D on all 8 rows."""
    want, results = discs
    logits, g, wg = want[name]
    for rank, res in enumerate(results):
        rows = slice(4 * rank, 4 * rank + 4)
        got_logits, got_g, _ = res[name]
        np.testing.assert_allclose(got_logits, logits[rows], **WORLDS)
        np.testing.assert_allclose(got_g, g[rows], **WORLDS)
    for k, v in wg.items():
        np.testing.assert_allclose(sum(res[name][2][k] for res in results), v,
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def renders():
    """Rays aimed near the unit box so that some miss it ('auto' limits: the
    misses take the global extremes), jitter, importance draws and density
    noise from one seeded generator."""
    rs = np.random.RandomState(3)
    n, r = 4, 16
    origins = rs.randn(n, r, 3).astype(np.float32)
    origins = 2.5 * origins / np.linalg.norm(origins, axis=-1, keepdims=True)
    dirs = -origins + 1.2 * rs.randn(n, r, 3).astype(np.float32)
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    planes = rs.randn(n, 3, 4, 8, 8).astype(np.float32)
    options = dict(depth_resolution=4, depth_resolution_importance=4, ray_start="auto",
                   ray_end="auto", box_warp=1.0, clamp_mode="softplus", white_back=False,
                   disparity_space_sampling=False, density_noise=0.5)
    want = W.render_rays_seeded(*(torch.from_numpy(v) for v in (planes, origins, dirs)),
                                options)
    return want, run_ranks(W.render_case, 2, planes, origins, dirs, options, timeout=300)


@pytest.mark.parametrize("split", ["data2", "rays2"])
def test_render_rays_split_over_ranks_matches_world1(renders, split):
    """Each rank's rows (data=2), or the gathered rays (rays=2), equal one
    process's render of the whole batch, draws included; the planes'
    gradient is the rank's rows of world 1's (data=2), or, the gathered
    loss being on both ranks, twice world 1's summed over the ranks
    (rays=2: the adjoint that pmean_grads divides out)."""
    want, results = renders
    for rank, res in enumerate(results):
        rows = slice(2 * rank, 2 * rank + 2) if split == "data2" else slice(None)
        for got, ref in zip(res[split][:3], want[:3]):
            np.testing.assert_allclose(got, ref[rows], rtol=1e-5, atol=1e-6)
    grads = [res[split][3] for res in results]
    if split == "data2":
        np.testing.assert_allclose(np.concatenate(grads), want[3], rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(grads[0] + grads[1], 2 * want[3], rtol=1e-5, atol=1e-6)
