"""The video cell (`orbit-shapenet128`): the reference's poses are the CLI's,
`correct` fails where it must, and the program without the CLI's frame loop
stops at once.

The planted runs go through the whole harness except its look for a card,
on the CPU at a tiny size; each fault is planted in the program. The
control at the cell's own size, and the CLI's own run, need the card
(`-m cuda`)."""

import io
import json
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.drivers import video
from benchmark.reference import gnerf_shapenet as ref_sn

from . import _tiny

WORKLOAD = "orbit-shapenet128"


def _cell(**kw):
    cell = _tiny.cell(WORKLOAD, seconds=1.0, **kw)
    cell.traffic.update(frames=4)
    return cell


def _result(cell) -> dict:
    out = io.StringIO()
    with redirect_stdout(out):
        assert bench_run.run(cell, _tiny.DEVICE) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_reference_poses_are_the_clis():
    from gnerf_tpu_torch.infer import gen_videos
    from gnerf_tpu_torch.models.triplane import DEFAULT_RENDERING_KWARGS

    for i in (0, 7, 59, 119):
        want = gen_videos.orbit_label(i, 120, "shapenet", dict(DEFAULT_RENDERING_KWARGS), "cars")
        assert torch.equal(ref_sn.label(*ref_sn.orbit_pose(i, 120), radius=1.3), want)


def _plant(monkeypatch, fault):
    """Break the program underneath the timed path."""
    from gnerf_tpu_torch.infer import gen_videos
    from gnerf_tpu_torch.models import superresolution, triplane

    if fault in ("white_back_dropped", "not_doubled"):
        render = triplane.TriPlaneGenerator.render_planes

        def broken(self, *args, rendering_kwargs=None, **kwargs):
            rk = dict(rendering_kwargs or {})
            if fault == "white_back_dropped":
                rk["white_back"] = False
            else:  # the samples of the source's training, not the doubled ones
                rk.update({k: self.rendering_kwargs[k] // 2
                           for k in ("depth_resolution", "depth_resolution_importance")})
            return render(self, *args, rendering_kwargs=rk, **kwargs)

        monkeypatch.setattr(triplane.TriPlaneGenerator, "render_planes", broken)
    elif fault == "ffhq_orbit":
        orbit = gen_videos.orbit_label
        monkeypatch.setattr(gen_videos, "orbit_label",
                            lambda i, n, dataset, rk, id_image="": orbit(i, n, "ffhq", rk))
    elif fault == "raw_not_passed":  # block0 takes the render's rgb, not block64's raw image
        def forward(self, rgb, x, ws, noise_mode="random", rng=None, dtype=torch.float32):
            ws = superresolution._block_ws(ws)
            noises = self._noise(rng, noise_mode, x)
            kw = dict(noise_mode=noise_mode, dtype=dtype)
            x_raw, image_raw = self.block64(x, rgb, ws, noise=noises[0], **kw)
            return self._blocks(("block0", "block1"), x_raw, rgb, ws, noises[1:], **kw), image_raw

        monkeypatch.setattr(superresolution.SuperresolutionHybrid2X, "forward", forward)


@pytest.mark.parametrize("fault", ["sound", "white_back_dropped", "ffhq_orbit", "not_doubled",
                                   "raw_not_passed"])
def test_a_broken_frame_loop_is_not_correct(monkeypatch, fault):
    _plant(monkeypatch, fault)
    result = _result(_cell())
    assert result["correct"] is (fault == "sound"), result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def test_fp8_control_fails_at_a_tiny_size():
    cell = _cell()
    drv = video.Driver(cell, lambda msg: None)
    drv.setup()
    drv.window(0.5)
    drv.release()
    r = drv.control()
    limits = cell.config["limits"]
    assert r["lower"] <= limits["frame_mad"] and r["lower_max_gap"] <= limits["frame_max_gap"], r
    assert r["lower_raw"] <= limits["raw_mad"], r
    assert r["upper"] > limits["frame_mad"] or r["upper_max_gap"] > limits["frame_max_gap"], r


def test_a_program_without_the_frame_loop_stops_in_setup(monkeypatch):
    from gnerf_tpu_torch.infer import gen_videos

    monkeypatch.delattr(gen_videos, "render_video")
    with pytest.raises(SystemExit, match="render_video"):
        video.Driver(_cell(), lambda msg: None).setup()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["white_back_dropped", "ffhq_orbit", "not_doubled",
                                   "raw_not_passed"])
def test_a_broken_frame_loop_is_not_correct_at_the_cell_size(monkeypatch, fault):
    _card()
    from benchmark import harness

    cell = harness.load_cell(WORKLOAD)
    cell.seed, cell.seconds = 2 ** 31 + 61, 3.0
    cell.traffic["warmup_videos"] = 1
    _plant(monkeypatch, fault)
    out = io.StringIO()
    with redirect_stdout(out):
        assert bench_run.run(cell, harness.card(1)) == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    print(fault, json.dumps(result["checks"]))
    assert result["correct"] is False, result["checks"]


@pytest.mark.cuda
def test_control_fails_at_the_cell_size():
    _card()
    from benchmark import harness

    limits = harness.load_cell(WORKLOAD).config["limits"]
    for seed in (31, 2 ** 31 + 32, 33):
        cell = harness.load_cell(WORKLOAD)
        cell.seed, cell.seconds = seed, 3.0
        drv = video.Driver(cell, lambda msg: None)
        drv.setup()
        drv.window(3.0)
        drv.release()
        r = drv.control()
        assert r["lower"] <= limits["frame_mad"] and r["lower_max_gap"] <= limits["frame_max_gap"]
        assert r["lower_raw"] <= limits["raw_mad"], r
        assert r["upper"] > limits["frame_mad"] or r["upper_max_gap"] > limits["frame_max_gap"], r


@pytest.mark.cuda
def test_cli_writes_the_shapenet_video(tmp_path):
    """`gen_videos --dataset shapenet --frames 120` from an npz of seeded
    weights with the configuration's G: 120 finite frames at 128^2 and 64^2,
    through `render_video`."""
    _card()
    from PIL import Image

    from benchmark import harness, weights
    from gnerf_tpu_torch.infer import gen_videos
    from gnerf_tpu_torch.utils import checkpoint

    cfg = harness.load_cell(WORKLOAD).config
    rg, re_ = video.reference_modules(cfg)
    host = weights.to_host(weights.draw({"G": rg, "E": re_}, 41, "cuda"))
    bn = {k for k in host["E"] if k.endswith(("/mean", "/var"))}
    net = str(tmp_path / "shapenet.npz")
    checkpoint.save_checkpoint(
        net, {"G_ema": host["G"], "E": {k: v for k, v in host["E"].items() if k not in bn},
              "E_state": {k: host["E"][k] for k in bn}},
        config={"generator": video.generator_kwargs(cfg),
                "encoder": {"layers": cfg["encoder"]["layers"]}})
    photo = str(tmp_path / "cars_1.png")
    Image.fromarray(np.random.RandomState(0).randint(0, 256, (128, 128, 3), np.uint8)).save(photo)
    chunks = gen_videos.render_video.chunks
    out = gen_videos.generate_videos(net, id_image=photo, video_out_path=str(tmp_path / "v"),
                                     frames=120, dataset="shapenet")
    assert out["finite"] and gen_videos.render_video.chunks - chunks == 15
    assert out["frames"].shape == (120, 128, 128, 3) and out["frames_raw"].shape == (120, 64, 64, 3)
    assert out["frames"].std() > 0 and out["frames_raw"].std() > 0


# Parts of the hand kernels' names in a device trace: osg_decode,
# modconv_epilogue, triplane_sample, upfirdn2d (both instances).
HAND_KERNELS = ("osg_decode_t", "modconv_epilogue_kernel", "triplane_sample_kernel", "upfirdn2d")


def _device_launches(fn):
    """fn()'s result and, per HAND_KERNELS, the kernels that ran on the
    device, counted from a profile: a replayed CUDA graph's kernel nodes
    count as launches there, whichever wrapper recorded them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # A margin at each end: the kernels of a replay launched at once
        # after the trace's start went missing from it on the card.
        time.sleep(0.05)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return out, [sum(part in n for n in names) for part in HAND_KERNELS]


def _video_driver(seed: int):
    from benchmark import harness

    cell = harness.load_cell(WORKLOAD)
    cell.seed, cell.trace = seed, False
    cell.traffic["warmup_videos"] = 0
    drv = video.Driver(cell, lambda msg: None)
    drv.setup()
    return drv, cell.config["generator"]["neural_rendering_resolution"]


@pytest.mark.cuda
def test_graph_replays_equal_eager_frames_at_the_cell_size():
    """The loop's frames (the first video's first a warm-up and a capture,
    the rest and every frame of the next video replays of one CUDA graph)
    equal `render_frame`'s, one eager call a frame, bit for bit. On the
    device, a replayed frame runs each hand kernel as often as an eager
    one; the wrappers' `.launches` counters do not move on a replay."""
    _card()
    from gnerf_tpu_torch.ops.fused_decoder import osg_decode

    drv, res = _video_driver(51)
    gv, n = drv.gv, 20
    labels = drv.labels[:n].cuda()
    per_frame = None
    for photo in (0, 1):
        ws, planes = gv.prepare_identity(drv.g, drv.enc, drv.photos[photo:photo + 1],
                                         dtype=drv.dtype)
        eager, counts = _device_launches(lambda: [
            gv.render_frame(drv.g, planes, ws, labels[i:i + 1], res, drv.dtype)
            for i in range(n)])
        assert per_frame in (None, [c / n for c in counts])
        per_frame = [c / n for c in counts]
        frames = gv.IdentityFrames(drv.g, planes, ws, res, drv.dtype)
        first = 1 if photo == 0 else 0
        graphed = [frames(labels[0:1])] if first else []
        assert gv._GRAPHS[drv.g].key == frames.key
        wrapped = osg_decode.launches
        replays, counts = _device_launches(lambda: [frames(labels[i:i + 1])
                                                    for i in range(first, n)])
        assert osg_decode.launches == wrapped
        assert [c / (n - first) for c in counts] == per_frame
        for e, g in zip(eager, graphed + replays):
            assert all(torch.equal(a, b) for a, b in zip(e, g))
    assert per_frame[0] == 2 and per_frame[2] == 2  # two passes a frame


@pytest.mark.cuda
def test_frame_graphs_recapture_for_another_g_and_other_shapes():
    """A second G and one G's planes of another batch capture graphs of
    their own, then the first G's first key captures again; every frame
    equals `render_frame`'s bit for bit. A G's graph goes with its G."""
    _card()
    import gc
    import weakref

    drv, res = _video_driver(53)
    gv = drv.gv
    g2, _ = video.program(drv.cell.config, drv.host, "cuda")
    labels = drv.labels[:4].cuda()
    one = gv.prepare_identity(drv.g, drv.enc, drv.photos[:1], dtype=drv.dtype)
    two = gv.prepare_identity(drv.g, drv.enc, drv.photos[:2], dtype=drv.dtype)
    for g, (ws, planes) in ((drv.g, one), (g2, two), (drv.g, two), (drv.g, one)):
        frames = gv.IdentityFrames(g, planes, ws, res, drv.dtype)
        for i in range(4):
            got = frames(labels[i:i + 1])
            want = gv.render_frame(g, planes, ws, labels[i:i + 1], res, drv.dtype)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (tuple(planes.shape), i)
        assert gv._GRAPHS[g].key == frames.key
    assert gv._GRAPHS[drv.g].key != gv._GRAPHS[g2].key
    held, gone = len(gv._GRAPHS), weakref.ref(g2)
    del g2, g, frames
    gc.collect()
    assert gone() is None and len(gv._GRAPHS) == held - 1
