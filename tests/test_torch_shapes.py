"""The port's shape path vs gnerf_tpu.infer.shape_utils / crosssection and
TriPlaneGenerator.sample_mixed / sample (tiny G, fp32, CPU): the sigma grid
and the field samples within rtol 1e-4 / atol 1e-5; MRC, PLY and marching
tetrahedra identical."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread, t, tiny_gen_cfg, to_np, with_noise_strength  # noqa: F401
from gnerf_tpu.infer import crosssection as jcross
from gnerf_tpu.infer import shape_utils as jshape
from gnerf_tpu.models import TriPlaneGenerator as JGen
from gnerf_tpu.utils import camera as jcam
from gnerf_tpu_torch.infer import crosssection, shape_utils
from gnerf_tpu_torch.models import TriPlaneGenerator
from gnerf_tpu_torch.utils.checkpoint import load_jax_params

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def generator_pair():
    cfg = tiny_gen_cfg()
    jg = JGen(**cfg)
    params = with_noise_strength(jg.init(jax.random.PRNGKey(11)))
    g = TriPlaneGenerator(**cfg, device="meta")
    load_jax_params(g, params, device="cpu")
    g.requires_grad_(False)
    z = np.random.RandomState(12).randn(1, 32).astype(np.float32)
    ws = np.asarray(jg.mapping(params, jnp.asarray(z), jnp.zeros((1, 25))))
    return jg, params, g, z, ws


@pytest.mark.parametrize("n,cube_length", [(4, 2.0), (7, 1.0)])
def test_create_samples_matches_jax(n, cube_length):
    got, origin, voxel = shape_utils.create_samples(n, cube_length)
    want, want_origin, want_voxel = jshape.create_samples(n, cube_length)
    assert got.dtype == np.float32 and got.shape == (1, n ** 3, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(origin, want_origin)
    assert voxel == want_voxel


def test_extract_sigma_grid_matches_jax(generator_pair):
    jg, params, g, _, ws = generator_pair
    want = jshape.extract_sigma_grid(jg, params, jnp.asarray(ws), voxel_resolution=16,
                                     cube_length=1.0, max_batch=1000)
    got = shape_utils.extract_sigma_grid(g, t(ws), voxel_resolution=16, cube_length=1.0,
                                         max_batch=1000, device="cpu")
    assert got.shape == (16, 16, 16) and got.dtype == np.float32
    assert np.isfinite(got).all() and got.std() > 0
    np.testing.assert_allclose(got, want, **TOL)
    # One chunk (no ragged tail) gives the same volume.
    whole = shape_utils.extract_sigma_grid(g, t(ws), voxel_resolution=16, cube_length=1.0,
                                           max_batch=16 ** 3, device="cpu")
    np.testing.assert_allclose(whole, got, **TOL)
    with pytest.raises(ValueError, match="mesh"):
        shape_utils.extract_sigma_grid(g, t(ws), voxel_resolution=4, mesh=object(),
                                       device="cpu")


def test_sample_mixed_and_sample_match_jax(generator_pair):
    jg, params, g, z, ws = generator_pair
    rng = np.random.RandomState(13)
    coords = rng.uniform(-0.6, 0.6, (1, 500, 3)).astype(np.float32)
    dirs = np.zeros_like(coords)
    c = np.asarray(jcam.pose_to_label(jcam.lookat_sample(1.3, 1.5, radius=2.7),
                                      jcam.FFHQ_INTRINSICS))
    with torch.inference_mode():
        mixed = g.sample_mixed(t(coords), t(dirs), t(ws))
        sampled = g.sample(t(coords), t(dirs), t(z), t(c))
    want_mixed = jg.sample_mixed(params, jnp.asarray(coords), jnp.asarray(dirs), jnp.asarray(ws))
    want_sampled = jg.sample(params, jnp.asarray(coords), jnp.asarray(dirs), jnp.asarray(z),
                             jnp.asarray(c))
    for got, want in ((mixed, want_mixed), (sampled, want_sampled)):
        assert tuple(got["sigma"].shape) == (1, 500, 1)
        for k in ("sigma", "rgb"):
            np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_cross_section_matches_jax(generator_pair, axis):
    jg, params, g, _, ws = generator_pair
    got = crosssection.sample_cross_section(g, t(ws), resolution=12, axis=axis, offset=0.05)
    want = jcross.sample_cross_section(jg, params, jnp.asarray(ws), resolution=12, axis=axis,
                                       offset=0.05)
    assert tuple(got.shape) == (1, 12, 12)
    np.testing.assert_allclose(to_np(got), np.asarray(want), **TOL)


def test_mrc_round_trip_and_jax_files(tmp_path):
    vol = np.random.RandomState(0).rand(8, 9, 10).astype(np.float32)
    port, jaxf = str(tmp_path / "port.mrc"), str(tmp_path / "jax.mrc")
    shape_utils.write_mrc(port, vol)
    jshape.write_mrc(jaxf, vol)
    assert open(port, "rb").read() == open(jaxf, "rb").read()
    assert os.path.getsize(port) == 1024 + vol.size * 4
    np.testing.assert_array_equal(shape_utils.read_mrc(port), vol)
    np.testing.assert_array_equal(shape_utils.read_mrc(jaxf), vol)
    np.testing.assert_array_equal(jshape.read_mrc(port), vol)


def _sphere(n=24, radius=8.0):
    zz, yy, xx = np.meshgrid(*([np.arange(n) - n / 2 + 0.5] * 3), indexing="ij")
    r = np.sqrt(xx ** 2 + yy ** 2 + zz ** 2)
    return (20.0 * np.clip(radius + 0.5 - r, 0.0, 1.0)).astype(np.float32)


def test_marching_tetrahedra_and_ply_match_jax(tmp_path):
    vol = _sphere()
    verts, faces = shape_utils.marching_tetrahedra(vol, level=10.0, spacing=0.5)
    want_verts, want_faces = jshape.marching_tetrahedra(vol, level=10.0, spacing=0.5)
    assert len(faces) > 100 and faces.max() < len(verts)
    np.testing.assert_array_equal(verts, want_verts)
    np.testing.assert_array_equal(faces, want_faces)
    empty = shape_utils.marching_tetrahedra(np.zeros((4, 4, 4), np.float32))
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)

    port, jaxf = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    shape_utils.write_ply(port, verts, faces, offset=(1.0, 2.0, 3.0), scale=0.25)
    jshape.write_ply(jaxf, verts, faces, offset=(1.0, 2.0, 3.0), scale=0.25)
    assert open(port, "rb").read() == open(jaxf, "rb").read()

    # convert_mrc: .mrc -> .ply beside it, as the JAX CLI flow writes it.
    for name, mod in (("port", shape_utils), ("jax", jshape)):
        os.makedirs(tmp_path / name)
        mod.write_mrc(str(tmp_path / name / "s.mrc"), vol)
    out = shape_utils.convert_mrc(str(tmp_path / "port" / "s.mrc"), level=10.0)
    want = jshape.convert_mrc(str(tmp_path / "jax" / "s.mrc"), level=10.0)
    assert out.endswith("s.ply") and open(out, "rb").read() == open(want, "rb").read()
