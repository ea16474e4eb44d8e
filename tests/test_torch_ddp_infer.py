"""The port's multi-device inference on gloo ranks on the CPU, as torchrun
would start it, at the tiny widths of tests/test_gen_videos.py's mesh test:
`generate_videos` over a (data=4) and a (data=2, rays=2) mesh, 5 frames so
that the chunk of 8 is padded, with the sigma sweep split over the 4 ranks,
against the port's world 1 (byte for byte; the volume within rtol 1e-4,
atol 1e-5) and the JAX CLI on its 8-device mesh (within 1 per uint8 pixel;
the volume likewise); --ray_shards 3 on 4 ranks is refused; and the
server's orbit over two CPU replicas against its one-device orbit."""

import functools

import numpy as np
import pytest
import torch

import jax

import _torch_ddp_workers as W
from _torch_dist import run_ranks
from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu.models import ResNeXt50Encoder as JEncoder
from gnerf_tpu.models import TriPlaneGenerator as JGen
from gnerf_tpu.models.triplane import DEFAULT_RENDERING_KWARGS
from gnerf_tpu.utils import checkpoint as jckpt

GEN_CFG = dict(z_dim=16, w_dim=16, img_resolution=128, plane_resolution=16, channel_base=256,
               channel_max=32, mapping_layers=2, neural_rendering_resolution=8,
               rendering_kwargs=dict(DEFAULT_RENDERING_KWARGS,
                                     superresolution_module="SuperresolutionHybrid2X",
                                     depth_resolution=4, depth_resolution_importance=4))
ENC_LAYERS = (1, 1, 1, 1)
RUN = dict(res=8, frames=5, fp32=True, gen_shapes=True, shape_res=16)


@pytest.fixture(scope="module")
def network(tmp_path_factory):
    params_g = JGen(**GEN_CFG).init(jax.random.PRNGKey(0))
    params_e, state_e = JEncoder(out_dim=16, layers=ENC_LAYERS).init(jax.random.PRNGKey(1))
    net = str(tmp_path_factory.mktemp("net") / "tiny.npz")
    jckpt.save_checkpoint(net, {"G_ema": params_g, "E": params_e, "E_state": state_e},
                          config={"generator": GEN_CFG, "encoder": {"layers": list(ENC_LAYERS)}})
    return net


def _port_world1(network, tmp_path, monkeypatch):
    from gnerf_tpu_torch.infer import gen_videos, shape_utils, video_io

    monkeypatch.setattr(video_io, "available_backends", lambda: ("npy",))
    out = str(tmp_path / "w1")
    res = gen_videos.generate_videos(network, video_out_path=out, outdir=out, device="cpu",
                                     **RUN)
    return res["frames"], res["frames_raw"], shape_utils.read_mrc(res["mrc"])


def _jax_mesh_run(network, tmp_path, monkeypatch):
    """The JAX CLI on the conftest's 8 devices (frames over 'data'): frames
    and raw frames as its video writers receive them, and the volume."""
    import gnerf_tpu.models
    from gnerf_tpu.infer import gen_videos as jgv
    from gnerf_tpu.infer import video_io as jvideo_io
    from gnerf_tpu.infer.shape_utils import read_mrc

    assert len(jax.devices()) == 8
    written = {}

    class Recorder:
        def __init__(self, path, fps=30):
            self.output_path = path
            written[path] = self.frames = []

        def append_data(self, frame):
            self.frames.append(np.asarray(frame))

        def close(self):
            pass

    monkeypatch.setattr(jvideo_io, "VideoWriter", Recorder)
    monkeypatch.setattr(gnerf_tpu.models, "ResNeXt50Encoder", functools.partial(
        JEncoder, layers=ENC_LAYERS, groups_as_dense=False))
    out = str(tmp_path / "jax")
    jgv.generate_videos(network, video_out_path=out, outdir=out, **RUN)
    frames, raws = (np.stack(written[f"{out}/seedinit{s}.mp4"]) for s in ("", "_raw"))
    return frames, raws, read_mrc(f"{out}/seedinit/4.mrc")


def test_mesh_orbit_and_sweep_match_world1_and_jax(network, tmp_path, monkeypatch):
    runs = [dict(network=network, video_out_path=str(tmp_path / name),
                 outdir=str(tmp_path / name), device="cpu", ray_shards=rays, **RUN)
            for name, rays in (("data4", 1), ("data2_rays2", 2), ("rays3", 3))]
    ranks = run_ranks(W.infer_case, 4, runs, timeout=300, init=False)
    assert all(r == [None, None, ranks[0][2]] for r in ranks[1:])
    assert ranks[0][2] == "--ray_shards 3 must divide device count 4"

    want = _port_world1(network, tmp_path, monkeypatch)
    jax_run = _jax_mesh_run(network, tmp_path, monkeypatch)
    for got in ranks[0][:2]:
        for g, w, j, shape in zip(got[:2], want[:2], jax_run[:2],
                                  ((5, 16, 16, 3), (5, 8, 8, 3))):
            assert g.shape == shape and g.dtype == np.uint8 and g.std() > 0
            np.testing.assert_array_equal(g, w)
            assert np.abs(g.astype(int) - j.astype(int)).max() <= 1
        vol = got[2]
        assert vol.shape == (16, 16, 16) and np.isfinite(vol).all() and vol.std() > 0
        np.testing.assert_allclose(vol, want[2], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(vol, jax_run[2], rtol=1e-4, atol=1e-5)


def test_server_orbit_over_two_replicas_equals_one_device(network):
    from gnerf_tpu_torch.infer.gen_videos import load_networks
    from gnerf_tpu_torch.infer.server import GNerfService

    g, enc = load_networks(network, device="cpu")
    z = np.random.RandomState(3).randn(1, 16).astype(np.float32)
    orbits = []
    for devices in (["cpu"], ["cpu", "cpu"]):
        svc = GNerfService(g, enc, dtype=torch.float32, devices=devices, microbatch=0)
        try:
            assert svc.frames_per_chunk == (15 if len(devices) == 1 else 4)
            assert len(svc.replicas) == len(devices)
            orbits.append(np.stack(svc.render_orbit(svc._register(z), frames=9)))
        finally:
            svc.close()
    assert orbits[0].shape == (9, 16, 16, 3) and orbits[0].std() > 0
    np.testing.assert_array_equal(orbits[1], orbits[0])
