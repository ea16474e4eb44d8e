"""The port's orbit-video entry point vs the JAX pipeline, end to end on a
tiny model: photo -> encoder -> mapping -> planes -> render -> 8XDC ->
uint8, three frames, within +-1 per pixel; the --gen_shapes volume and the
photo loading (--align_lm, resize) against the JAX CLI's. The port's CLI
writes the video with the numpy-only backend here."""

import dataclasses
import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread, tiny_gen_cfg, with_noise_strength  # noqa: F401
from gnerf_tpu.infer import gen_videos as jgv
from gnerf_tpu.models import ResNeXt50Encoder as JEncoder
from gnerf_tpu.models import TriPlaneGenerator as JGen
from gnerf_tpu.utils import checkpoint as jckpt
from gnerf_tpu_torch.infer import gen_videos, video_io


def _tiny_checkpoint(tmp_path):
    gen_cfg = tiny_gen_cfg()
    params_g = with_noise_strength(JGen(**gen_cfg).init(jax.random.PRNGKey(0)))
    params_e, state_e = JEncoder(out_dim=32, layers=(1, 1, 1, 1)).init(jax.random.PRNGKey(1))
    net = str(tmp_path / "tiny.npz")
    jckpt.save_checkpoint(net, {"G_ema": params_g, "E": params_e, "E_state": state_e},
                          config={"generator": gen_cfg, "encoder": {"layers": [1, 1, 1, 1]}})
    return net


def _jax_frames(gen_cfg, params_g, params_e, state_e, frames, res):
    g = JGen(**gen_cfg)
    rk = dict(g.rendering_kwargs)
    rk["depth_resolution"] *= 2
    rk["depth_resolution_importance"] *= 2
    g = dataclasses.replace(g, rendering_kwargs=rk)
    enc = JEncoder(out_dim=g.z_dim, layers=(1, 1, 1, 1), groups_as_dense=False)
    ids = np.random.RandomState(0).randint(0, 256, size=(1, 3, 512, 512), dtype=np.uint8)
    imgs = jnp.asarray(ids, jnp.float32) / 127.5 - 1.0
    z, _ = enc.apply(params_e, state_e, imgs, train=False)
    ws = g.mapping(params_g, z, jnp.zeros((1, 25)))
    planes = g.backbone_planes(params_g, ws, noise_mode="const", pack=True)

    @jax.jit
    def frame(c):
        out = g.render_planes(params_g, planes, c, ws, neural_rendering_resolution=res,
                              noise_mode="const")
        return [jnp.clip(out[k] * 127.5 + 128, 0, 255).astype(jnp.uint8)
                for k in ("image", "image_raw")]

    got = [frame(jgv.orbit_label(i, frames, "ffhq", rk)) for i in range(frames)]
    return [np.stack([np.asarray(f[k][0]).transpose(1, 2, 0) for f in got]) for k in (0, 1)]


def test_orbit_matches_jax_within_one(tmp_path, monkeypatch):
    gen_cfg = tiny_gen_cfg()
    net = _tiny_checkpoint(tmp_path)
    trees, _ = jckpt.load_checkpoint(net)
    params_g, params_e, state_e = trees["G_ema"], trees["E"], trees["E_state"]

    monkeypatch.setattr(video_io, "available_backends", lambda: ("npy",))
    out = str(tmp_path / "out")
    gen_videos.main.main(["--network", net, "--frames", "3", "--res", "8", "--fp32",
                          "--video_out_path", out, "--device", "cpu"], standalone_mode=False)
    got = [np.stack([np.load(p) for p in sorted(glob.glob(os.path.join(out, name, "*.npy")))])
           for name in ("seedinit_frames", "seedinit_raw_frames")]
    want = _jax_frames(gen_cfg, params_g, params_e, state_e, frames=3, res=8)
    for g, w, shape in zip(got, want, ((3, 64, 64, 3), (3, 8, 8, 3))):
        assert g.shape == shape and g.dtype == np.uint8
        assert np.abs(g.astype(int) - w.astype(int)).max() <= 1
        assert g.std() > 0  # not a constant image


def test_helpers_match_jax():
    from gnerf_tpu.models.triplane import DEFAULT_RENDERING_KWARGS

    rk = dict(DEFAULT_RENDERING_KWARGS)
    for i in (0, 7, 30):
        np.testing.assert_allclose(gen_videos.orbit_label(i, 120, "ffhq", rk).numpy(),
                                   np.asarray(jgv.orbit_label(i, 120, "ffhq", rk)),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gen_videos.orbit_label(5, 120, "shapenet", rk, "cars").numpy(),
                               np.asarray(jgv.orbit_label(5, 120, "shapenet", rk, "cars")),
                               rtol=1e-6, atol=1e-6)
    img = np.random.RandomState(2).uniform(-1.2, 1.2, (2, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(gen_videos.to_uint8(img), jgv.to_uint8(img))
    import torch

    np.testing.assert_array_equal(gen_videos.u8(torch.from_numpy(img)).permute(0, 2, 3, 1).numpy(),
                                  jgv.to_uint8(img))
    depth = np.linspace(2.0, 3.0, 16).reshape(4, 4)
    np.testing.assert_array_equal(gen_videos.normalize_depth(depth), jgv.normalize_depth(depth))


@pytest.mark.parametrize("backend", ["npy", "mjpeg"])
def test_video_writer_backends(tmp_path, monkeypatch, backend):
    if backend not in video_io.available_backends():
        pytest.skip(f"{backend} backend's imports do not work here")
    monkeypatch.setattr(video_io, "available_backends", lambda: (backend,))
    w = video_io.VideoWriter(str(tmp_path / "clip.mp4"), fps=24)
    frames = np.random.RandomState(1).randint(0, 255, (3, 16, 24, 3), np.uint8)
    for f in frames:
        w.append_data(f)
    w.close()
    if backend == "npy":
        assert w.output_path.endswith("clip_frames")
        got = np.stack([np.load(os.path.join(w.output_path, f"{i:05d}.npy")) for i in range(3)])
        np.testing.assert_array_equal(got, frames)
    else:
        blob = open(w.output_path, "rb").read()
        assert w.output_path.endswith(".avi") and blob[:4] == b"RIFF" and b"MJPG" in blob


def test_gen_shapes_writes_the_jax_runs_mrc(tmp_path, monkeypatch):
    """--gen_shapes: the sigma volume at shape_res 16 from the same
    checkpoint, written to <outdir>/<name>/<frames-1>.mrc by both CLIs."""
    import functools

    import gnerf_tpu.models
    from gnerf_tpu.infer.shape_utils import read_mrc as jread_mrc
    from gnerf_tpu_torch.infer.shape_utils import read_mrc

    net = _tiny_checkpoint(tmp_path)
    # The JAX CLI builds the full-depth encoder; give it the checkpoint's
    # (with per-group convolutions, the port's summation order).
    monkeypatch.setattr(gnerf_tpu.models, "ResNeXt50Encoder", functools.partial(
        JEncoder, layers=(1, 1, 1, 1), groups_as_dense=False))
    monkeypatch.setattr(video_io, "available_backends", lambda: ("npy",))
    common = dict(frames=2, res=8, gen_shapes=True, shape_res=16, fp32=True)
    jgv.generate_videos(net, video_out_path=str(tmp_path / "jv"), outdir=str(tmp_path / "jax"),
                        seed_init=None, **common)
    res = gen_videos.generate_videos(net, video_out_path=str(tmp_path / "pv"),
                                     outdir=str(tmp_path / "port"), device="cpu", **common)
    assert res["mrc"] == str(tmp_path / "port" / "seedinit" / "1.mrc")
    got, want = read_mrc(res["mrc"]), jread_mrc(str(tmp_path / "jax" / "seedinit" / "1.mrc"))
    assert got.shape == (16, 16, 16) and np.isfinite(got).all() and got.std() > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("source", ["prepared", "id_image"])
def test_align_lm_and_resize_match_jax(tmp_path, monkeypatch, source):
    """Photos with a landmark file are FFHQ-aligned, others decoded and
    resized by the native loader: the same [N, 3, size, size] uint8 as the
    JAX CLI's `_load_images`, with the library built and loaded in both."""
    import json

    from PIL import Image

    from _torch_port import load_native_loader
    from test_alignment import _smooth_image, _synthetic_landmarks

    load_native_loader(monkeypatch)
    photos, lms = tmp_path / "photos", tmp_path / "lms"
    photos.mkdir()
    lms.mkdir()
    Image.fromarray(_smooth_image(256, 256, seed=2)).save(photos / "a_face.png")
    Image.fromarray(_smooth_image(96, 136, seed=3)).save(photos / "b_odd.png")  # 136 x 96
    (lms / "a_face.json").write_text(json.dumps(
        _synthetic_landmarks(cx=128, cy=110, iod=24.0, tilt_deg=10.0).tolist()))
    kw = (dict(id_image=None, prepared=str(photos)) if source == "prepared"
          else dict(id_image=str(photos / "b_odd.png"), prepared=None))
    got = gen_videos._load_images(**kw, align_lm=str(lms), size=64)
    want = jgv._load_images(**kw, align_lm=str(lms), size=64)
    assert got.shape == ((2 if source == "prepared" else 1), 3, 64, 64) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert gen_videos._find_landmarks(str(lms), str(photos / "a_face.png")).endswith(".json")
    assert gen_videos._find_landmarks(str(lms), str(photos / "b_odd.png")) is None
