"""Port renderer vs gnerf_tpu.render (fp32, CPU, deterministic sampling)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread, t, to_np  # noqa: F401
from gnerf_tpu.models import OSGDecoder as JDecoder
from gnerf_tpu.models.triplane import DEFAULT_RENDERING_KWARGS
from gnerf_tpu.render import importance as jimp
from gnerf_tpu.render import math_utils as jmath
from gnerf_tpu.render import ray_marcher as jmarch
from gnerf_tpu.render import ray_sampler as jsamp
from gnerf_tpu.render import renderer as jrend
from gnerf_tpu.utils import camera as jcam
from gnerf_tpu_torch.models import OSGDecoder
from gnerf_tpu_torch.render import importance, math_utils, ray_marcher, ray_sampler, renderer
from gnerf_tpu_torch.utils import camera
from gnerf_tpu_torch.utils.checkpoint import load_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)


def _camera(yaw=0.3, pitch=-0.2):
    c2w = np.asarray(jcam.lookat_sample(np.pi / 2 + yaw, np.pi / 2 + pitch, radius=2.7))
    intr = np.asarray(jcam.FFHQ_INTRINSICS)
    return c2w, np.broadcast_to(intr, (1, 3, 3)).copy()


def test_camera_matches_jax():
    want = np.asarray(jcam.pose_to_label(jcam.lookat_sample(1.2, 1.4, radius=2.7),
                                         jcam.FFHQ_INTRINSICS))
    got = to_np(camera.pose_to_label(camera.lookat_sample(1.2, 1.4, radius=2.7),
                                     camera.FFHQ_INTRINSICS))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    want = np.asarray(jcam.lookat_sample_srn(0.4, 1.0, radius=2.0))
    np.testing.assert_allclose(to_np(camera.lookat_sample_srn(0.4, 1.0, radius=2.0)), want,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("sampler", ["gaussian_pose_sample", "uniform_pose_sample",
                                     "lookat_sample_origin"])
def test_pose_samplers_match_jax(sampler):
    """The rng-free path against JAX's to 1e-6; with stddev and a key, the
    drawn poses (h and v from split(key), normal or uniform in +-stddev)
    against JAX's from the same key, to 1e-6."""
    from gnerf_tpu_torch.utils import prng

    target = [[0.0, 0.0, 0.2]] if sampler == "lookat_sample_origin" else []
    jtarget = [jnp.asarray(p) for p in target]
    jfn, fn = getattr(jcam, sampler), getattr(camera, sampler)
    want = np.asarray(jfn(1.2, 1.4, *jtarget, radius=2.7,
                          batch_size=3, horizontal_stddev=0.3, vertical_stddev=0.2))
    got = to_np(fn(1.2, 1.4, *target, radius=2.7, batch_size=3, horizontal_stddev=0.3,
                   vertical_stddev=0.2))
    assert got.shape == (3, 4, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    for seed in (7, 2 ** 31 - 1):
        drawn = to_np(fn(1.2, 1.4, *target, 0.3, 0.2, radius=2.7, batch_size=5,
                         rng=prng.PRNGKey(seed)))
        want = np.asarray(jfn(1.2, 1.4, *jtarget, 0.3, 0.2, radius=2.7, batch_size=5,
                              rng=jax.random.PRNGKey(seed)))
        assert np.abs(drawn - got[:1]).max() > 1e-3  # the draws moved the poses
        np.testing.assert_allclose(drawn, want, rtol=0, atol=1e-6)


def test_sample_rays_and_ray_limits_match_jax():
    c2w, intr = _camera()
    jo, jd = jsamp.sample_rays(jnp.asarray(c2w), jnp.asarray(intr), 16)
    o, d = ray_sampler.sample_rays(t(c2w), t(intr), 16)
    np.testing.assert_allclose(to_np(o), np.asarray(jo), **TOL)
    np.testing.assert_allclose(to_np(d), np.asarray(jd), **TOL)
    # Rays from outside the box, some missing it.
    d_np = np.asarray(jd).copy()
    d_np[0, :7] = [0.0, 0.0, 1.0]
    js, je = jmath.get_ray_limits_box(jo, jnp.asarray(d_np), box_side_length=1.0)
    s, e = math_utils.get_ray_limits_box(o, t(d_np), box_side_length=1.0)
    np.testing.assert_allclose(to_np(s), np.asarray(js), **TOL)
    np.testing.assert_allclose(to_np(e), np.asarray(je), **TOL)


def test_sample_stratified_matches_jax():
    o = np.zeros((2, 5, 3), np.float32)
    want = jimp.sample_stratified(None, jnp.asarray(o), 2.25, 3.3, 12)
    got = importance.sample_stratified(None, t(o), 2.25, 3.3, 12)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)
    rng = np.random.RandomState(0)
    start = rng.uniform(1.0, 2.0, (2, 5, 1)).astype(np.float32)
    end = start + rng.uniform(0.5, 1.0, (2, 5, 1)).astype(np.float32)
    want = jimp.sample_stratified(None, jnp.asarray(o), jnp.asarray(start), jnp.asarray(end), 12)
    got = importance.sample_stratified(None, t(o), t(start), t(end), 12)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_sample_importance_matches_jax():
    rng = np.random.RandomState(1)
    z = np.sort(rng.uniform(2.0, 3.5, (2, 7, 16, 1)), axis=2).astype(np.float32)
    w = rng.exponential(size=(2, 7, 15, 1)).astype(np.float32)
    w[0, 0] = 0.0  # a ray with no weight: uniform pdf
    want = jimp.sample_importance(None, jnp.asarray(z), jnp.asarray(w), 16)
    got = importance.sample_importance(None, t(z), t(w), 16)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_march_rays_matches_jax():
    rng = np.random.RandomState(2)
    colors = rng.randn(2, 6, 10, 5).astype(np.float32)
    dens = (rng.randn(2, 6, 10, 1) * 3).astype(np.float32)
    depths = np.sort(rng.uniform(2.0, 3.0, (2, 6, 10, 1)), axis=2).astype(np.float32)
    for white_back in (False, True):
        opts = {"white_back": white_back}
        want = jmarch.march_rays(jnp.asarray(colors), jnp.asarray(dens), jnp.asarray(depths), opts)
        got = ray_marcher.march_rays(t(colors), t(dens), t(depths), opts)
        for g, w in zip(got, want):
            np.testing.assert_allclose(to_np(g), np.asarray(w), **TOL)


def test_sample_from_planes_matches_jax_plain_and_packed():
    rng = np.random.RandomState(3)
    planes = rng.randn(2, 3, 8, 16, 16).astype(np.float32)
    coords = rng.uniform(-0.65, 0.65, (2, 500, 3)).astype(np.float32)  # some outside
    got = to_np(renderer.sample_from_planes(t(planes), t(coords), box_warp=1.0))
    want = np.asarray(jrend.sample_from_planes(jnp.asarray(planes), jnp.asarray(coords), 1.0))
    np.testing.assert_allclose(got, want, **TOL)
    packed = jrend.pack_planes(jnp.asarray(planes))
    want_packed = np.asarray(jrend.sample_packed_planes(packed, jnp.asarray(coords), 1.0))
    np.testing.assert_allclose(got, want_packed, **TOL)
    uv = to_np(renderer.project_onto_planes(t(coords)))
    np.testing.assert_array_equal(uv, np.asarray(jrend.project_onto_planes(jnp.asarray(coords))))


def _plane_points(rng, n, box_warp, h, w):
    """[N, M, 3] points: random ones inside and outside the box, the planes'
    edges (u = +-1) and just past them, and exact texel centres of the
    H x W planes (powers of two, so the centres are exact in fp32)."""
    half = box_warp / 2
    pts = [rng.uniform(-1.3 * half, 1.3 * half, (300, 3))]
    edges = np.array([-half, half, -half * (1 + 2 ** -20), half * (1 + 2 ** -20), 0.0])
    pts.append(np.stack(np.meshgrid(edges, edges, edges), -1).reshape(-1, 3))
    cx = ((2 * np.arange(w) + 1) / w - 1) * half  # texel centres along W and along H
    cy = ((2 * np.arange(h) + 1) / h - 1) * half
    pts.append(np.stack([np.repeat(cx, h), np.tile(cy, w), np.tile(cy, w)], -1))
    one = np.concatenate(pts).astype(np.float32)
    return np.stack([one] + [rng.permutation(one) for _ in range(n - 1)])


@pytest.mark.parametrize("check,n,c,dtype,box_warp", [
    ("jax", 1, 8, "float32", 1.0), ("jax", 2, 32, "float32", 0.75),
    ("jax", 1, 32, "bfloat16", 1.0), ("jax", 2, 8, "bfloat16", 0.75),
    ("route_cpu", 2, 32, "bfloat16", 1.0), ("route_grad", 2, 8, "float32", 0.75),
])
def test_triplane_sample(check, n, c, dtype, box_warp):
    """`sample_from_planes` on the CPU (`grid_sample_planes`, the plain
    version the CUDA kernel is held to) equals the JAX `sample_from_planes`
    on points outside the box, on the planes' edges and at texel centres:
    fp32 within the file's tolerance, bf16 planes within one bf16 rounding
    of JAX on the widened planes. The route: CPU tensors launch no kernel,
    with or without a gradient, and `ops.triplane_sample` refuses them; a
    call that needs a gradient records one, and its values and gradients
    equal JAX's."""
    from gnerf_tpu_torch.ops import triplane_sample

    rng = np.random.RandomState(40 + n * c)
    h, w = 8, 16
    planes = t(rng.randn(n, 3, c, h, w)).to(getattr(torch, dtype))
    coords = t(_plane_points(rng, n, box_warp, h, w))
    jplanes, jcoords = jnp.asarray(to_np(planes.float())), jnp.asarray(to_np(coords))
    jwant = np.asarray(jrend.sample_from_planes(jplanes, jcoords, box_warp))
    before = triplane_sample.launches
    if check == "route_grad":
        pg, cg = planes.clone().requires_grad_(), coords.clone().requires_grad_()
        got = renderer.sample_from_planes(pg, cg, box_warp=box_warp)
        assert got.grad_fn is not None
        gy = rng.randn(*got.shape).astype(np.float32)
        grads = torch.autograd.grad(got, [pg, cg], t(gy))
        _, vjp = jax.vjp(lambda p, x: jrend.sample_from_planes(p, x, box_warp), jplanes, jcoords)
        jgrads = vjp(jnp.asarray(gy))
        np.testing.assert_allclose(to_np(got.detach()), jwant, **TOL)
        np.testing.assert_allclose(to_np(grads[0]), np.asarray(jgrads[0]), **TOL)
        # The coordinates' gradient jumps at texel centres (the corners
        # change there): compare it at the random points only.
        gx, jgx = to_np(grads[1])[:, :300], np.asarray(jgrads[1])[:, :300]
        np.testing.assert_allclose(gx, jgx, rtol=1e-4, atol=1e-4 * np.abs(jgx).max())
        assert triplane_sample.launches == before
        return
    got = renderer.sample_from_planes(planes, coords, box_warp=box_warp)
    assert triplane_sample.launches == before  # the CPU launches no kernel
    assert got.dtype == planes.dtype and got.shape == (n, 3, coords.shape[1], c)
    assert got.is_contiguous() and got.grad_fn is None
    if check == "route_cpu":
        with pytest.raises(ValueError, match="CUDA tensors"):
            triplane_sample(planes, coords, box_warp)
        traced = renderer.sample_from_planes(planes.clone().requires_grad_(), coords, box_warp)
        assert traced.grad_fn is not None and triplane_sample.launches == before
        torch.testing.assert_close(got, traced.detach(), rtol=0, atol=0)
        return
    zero = (got == 0).all(-1)  # a point outside a plane samples zeros there
    assert bool(zero.any()) and not bool(zero.all())
    if dtype == "float32":
        np.testing.assert_allclose(to_np(got), jwant, **TOL)
    else:  # one rounding of the fp32 samples to bf16
        np.testing.assert_allclose(to_np(got.float()), jwant, rtol=2.0 ** -8, atol=1e-6)


def test_unify_samples_is_stable_on_ties():
    rng = np.random.RandomState(4)
    d1 = np.sort(rng.uniform(2, 3, (1, 4, 6, 1)), axis=2).astype(np.float32)
    d2 = np.sort(rng.uniform(2, 3, (1, 4, 6, 1)), axis=2).astype(np.float32)
    d2[:, :, ::2] = d1[:, :, ::2]  # exact coarse/fine ties
    c1, c2 = rng.randn(1, 4, 6, 5).astype(np.float32), rng.randn(1, 4, 6, 5).astype(np.float32)
    s1, s2 = rng.randn(1, 4, 6, 1).astype(np.float32), rng.randn(1, 4, 6, 1).astype(np.float32)
    want = jrend.unify_samples(*(jnp.asarray(a) for a in (d1, c1, s1, d2, c2, s2)))
    got = renderer.unify_samples(*(t(a) for a in (d1, c1, s1, d2, c2, s2)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


def _decoder_pair():
    jdec = JDecoder(n_features=32, decoder_output_dim=32)
    params = jdec.init(jax.random.PRNGKey(0))
    dec = OSGDecoder(n_features=32, decoder_output_dim=32)
    load_jax_params(dec, params)
    return lambda f, d: jdec.apply(params, f, d), dec


@pytest.mark.parametrize("bf16", [False, True])
def test_one_identity_planes_across_cameras(bf16):
    """Planes of one identity [1, 3, C, H, W] under 3 cameras (the orbit
    chunk's shape): the folded lookup + decode equals 3 single-camera
    renders (and `run_model` on 3 point sets equals 3 calls), and the JAX
    packed path that broadcasts n=1 planes."""
    rng = np.random.RandomState(6)
    planes = t(rng.randn(1, 3, 32, 16, 16))
    if bf16:
        planes = planes.bfloat16()
    jdecode, dec = _decoder_pair()
    opts = dict(DEFAULT_RENDERING_KWARGS, depth_resolution=6, depth_resolution_importance=6)
    cams = [_camera(yaw, pitch) for yaw, pitch in ((0.3, -0.2), (-0.4, 0.1), (0.0, 0.25))]
    c2w = np.concatenate([c for c, _ in cams])
    intr = np.concatenate([i for _, i in cams])
    o, d = ray_sampler.sample_rays(t(c2w), t(intr), 8)
    got = renderer.render_rays(planes, dec, o, d, opts)
    singles = [renderer.render_rays(planes, dec, o[i:i + 1], d[i:i + 1], opts) for i in range(3)]
    for k, name in enumerate(("rgb", "depth", "weight_sum")):
        want = torch.cat([s[k] for s in singles])
        torch.testing.assert_close(got[k], want, rtol=1e-5, atol=1e-6, msg=name)
    pts = t(rng.uniform(-0.6, 0.6, (3, 700, 3)))
    fields = renderer.run_model(planes, dec, pts, torch.zeros_like(pts), opts)
    assert tuple(fields["rgb"].shape) == (3, 700, 32)
    assert tuple(fields["sigma"].shape) == (3, 700, 1)
    for i in range(3):
        single = renderer.run_model(planes, dec, pts[i:i + 1], torch.zeros_like(pts[:1]), opts)
        for k in ("rgb", "sigma"):
            torch.testing.assert_close(fields[k][i:i + 1], single[k], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="batch"):
        renderer.sample_from_planes(planes, pts, box_warp=1.0)
    if bf16:
        return
    want = jrend.render_rays(jrend.pack_planes(jnp.asarray(to_np(planes))), jdecode,
                             jnp.asarray(to_np(o)), jnp.asarray(to_np(d)), opts, rng=None)
    for name, g, w in zip(("rgb", "depth", "weight_sum"), got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("limits", ["fixed", "auto"])
def test_render_rays_matches_jax(limits):
    rng = np.random.RandomState(5)
    planes = rng.randn(1, 3, 32, 16, 16).astype(np.float32)
    jdec = JDecoder(n_features=32, decoder_output_dim=32)
    params = jdec.init(jax.random.PRNGKey(0))
    dec = OSGDecoder(n_features=32, decoder_output_dim=32)
    load_jax_params(dec, params)
    opts = dict(DEFAULT_RENDERING_KWARGS, depth_resolution=8, depth_resolution_importance=8)
    if limits == "auto":
        opts.update(ray_start="auto", ray_end="auto")
    c2w, intr = _camera()
    jo, jd = jsamp.sample_rays(jnp.asarray(c2w), jnp.asarray(intr), 8)
    if limits == "auto":  # a few rays that miss the box exercise the fix-up
        jd = jd.at[0, :5].set(jnp.asarray([0.0, 1.0, 0.0]))
    want = jrend.render_rays(jnp.asarray(planes), lambda f, d: jdec.apply(params, f, d),
                             jo, jd, opts, rng=None)
    got = renderer.render_rays(t(planes), dec, t(np.asarray(jo)), t(np.asarray(jd)), opts)
    for name, g, w in zip(("rgb", "depth", "weight_sum"), got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-4, atol=1e-5, err_msg=name)
