"""G-NeRF on ShapeNet Cars through the port's video CLI, against the plain
reference `benchmark/reference/gnerf_shapenet.py`, at tiny widths on the
CPU in fp32: SuperresolutionHybrid2X, the white background, the SRN orbit,
`image` and `image_raw`; and `generate_videos`' frames through
`render_video` against the frame loop as it stood inside `generate_videos`.

One checkpoint of seeded weights (`benchmark/weights.py`, the benchmark's
draw, which gives frames with content) and one CLI run serve every test."""

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import one_torch_thread  # noqa: F401
from benchmark import gnerf_infer, weights
from benchmark.drivers import video
from benchmark.reference import gnerf as ref
from benchmark.reference import gnerf_shapenet as ref_sn
from gnerf_tpu_torch.infer import gen_videos, video_io
from gnerf_tpu_torch.utils import checkpoint

FRAMES, RES = 10, 16  # two chunks, the second short; a 16^2 render, 32^2 out of SR2X


def _config() -> dict:
    """`gnerf-shapenet128` at tiny widths: the backbone, the planes, the
    render and E cut; SR2X, the ray limits, box_warp and the white
    background as configured."""
    import json

    from benchmark import harness

    cfg = json.loads((harness.BENCH / "configs" / "gnerf-shapenet128.json").read_text())
    cfg["generator"].update(z_dim=32, w_dim=32, plane_resolution=16, channel_base=512,
                            channel_max=32, neural_rendering_resolution=RES, depth_resolution=6,
                            depth_resolution_importance=6)
    cfg["encoder"].update(layers=[1, 1, 1, 1], out_dim=32)
    return cfg


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The checkpoint's host trees, the photo and the CLI's result."""
    tmp = tmp_path_factory.mktemp("shapenet")
    cfg = _config()
    side = cfg["encoder"]["image"]
    rg, re_ = video.reference_modules(cfg)
    trees = weights.draw({"G": rg, "E": re_}, 2 ** 31 + 7, "cpu")
    weights.fit_bn(re_, trees["E"], gnerf_infer.photos(3, 4, side, "cpu"), "cpu")
    host = weights.to_host(trees)
    bn = {k for k in host["E"] if k.endswith(("/mean", "/var"))}
    net = str(tmp / "tiny_shapenet.npz")
    checkpoint.save_checkpoint(
        net, {"G_ema": host["G"], "E": {k: v for k, v in host["E"].items() if k not in bn},
              "E_state": {k: host["E"][k] for k in bn}},
        config={"generator": video.generator_kwargs(cfg),
                "encoder": {"layers": cfg["encoder"]["layers"]}})
    photo = str(tmp / "cars_3.png")
    Image.fromarray(gnerf_infer.photos(5, 1, side, "cpu")[0].transpose(1, 2, 0)).save(photo)
    loop = gen_videos.render_video
    counts = loop.frames, loop.chunks
    mp = pytest.MonkeyPatch()
    mp.setattr(video_io, "available_backends", lambda: ("npy",))
    try:
        out = gen_videos.generate_videos(net, id_image=photo, video_out_path=str(tmp / "v"),
                                         res=RES, frames=FRAMES, dataset="shapenet",
                                         fp32=True, device="cpu")
    finally:
        mp.undo()
    return dict(cfg=cfg, host=host, net=net, photo=photo, out=out,
                counted=(loop.frames - counts[0], loop.chunks - counts[1]))


def test_generate_videos_yields_the_frames_of_the_loop_it_had(run):
    """The CLI's frames come through `render_video` (its counters moved by
    the video's frames and chunks), and equal bit for bit those of the loop
    as it stood in `generate_videos` (one `render_frame` call a frame, one
    copy a chunk of 8)."""
    out = run["out"]
    assert run["counted"] == (FRAMES, 2) and out["finite"]
    g, enc = gen_videos.load_networks(run["net"], device="cpu")
    ids = gen_videos._load_images(run["photo"], None, size=128)
    assert ids.shape == (1, 3, 128, 128)  # E sees the SRN photo at G's 128^2
    ws, planes = gen_videos.prepare_identity(g, enc, ids, dtype=torch.float32)
    labels = torch.cat([gen_videos.orbit_label(i, FRAMES, "shapenet", g.rendering_kwargs,
                                               run["photo"]) for i in range(FRAMES)])
    imgs, raws = [], []
    for start in range(0, FRAMES, gen_videos.CHUNK):
        chunk = [gen_videos.render_frame(g, planes, ws, labels[i: i + 1], RES, torch.float32)
                 for i in range(start, min(start + gen_videos.CHUNK, FRAMES))]
        for k, acc in ((0, imgs), (1, raws)):
            acc.append(torch.stack([f[k] for f in chunk]).permute(0, 3, 1, 4, 2)
                       .flatten(2, 3).cpu().numpy())
    np.testing.assert_array_equal(out["frames"], np.concatenate(imgs))
    np.testing.assert_array_equal(out["frames_raw"], np.concatenate(raws))
    assert out["frames"].shape == (FRAMES, 2 * RES, 2 * RES, 3)
    assert out["frames_raw"].shape == (FRAMES, RES, RES, 3)


@pytest.fixture(scope="module")
def reference(run):
    """The reference's G (white background on) and the photo's (ws, planes)."""
    g, e = video.reference_modules(run["cfg"])
    ref.load_state(g, run["host"]["G"], "cpu")
    ref.load_state(e, run["host"]["E"], "cpu")
    photo = torch.as_tensor(gen_videos._load_images(run["photo"], None, size=128)[0])
    return g, *ref.identity(g, e, photo, torch.float32)


def _frames(reference, labels, white_back=True) -> list:
    """The reference's uint8 (image, raw image) under each [1, 25] label."""
    g, ws, planes = reference
    g.white_back = white_back
    try:
        with torch.no_grad():
            return [tuple(ref_sn.to_u8(x) for x in g.render(planes, c, ws, torch.float32))
                    for c in labels]
    finally:
        g.white_back = True


def _srn_labels():
    return [ref_sn.label(*ref_sn.orbit_pose(i, FRAMES)) for i in range(FRAMES)]


def test_shapenet_frames_match_the_reference(run, reference):
    """Every frame, `image` (SR2X's 2x) and `image_raw` (block64's), within
    one uint8 level of the reference: both sides compute in fp32 on the CPU
    with the same formulas, in different orders of summation, so a value
    within rounding of a level's edge can truncate to either side; the mean
    gap stays far below the benchmark's limit."""
    out = run["out"]
    for i, (img, raw) in enumerate(_frames(reference, _srn_labels())):
        for got, want in ((out["frames"][i], img), (out["frames_raw"][i], raw)):
            gap = np.abs(got.astype(int) - want.numpy().astype(int))
            assert gap.max() <= 1 and gap.mean() < 0.02, (i, gap.max(), gap.mean())
            assert want.float().std() > 5  # a frame with content


@pytest.mark.parametrize("fault", ["black_background", "ffhq_orbit"])
def test_the_comparison_sees_the_background_and_the_orbit(run, reference, fault):
    """The reference on a black background, or at the FFHQ orbit's poses
    (y-up, FFHQ intrinsics), parts from the program's frames by more than a
    level on average in every frame: the comparison above holds the white
    background and the SRN poses."""
    labels = _srn_labels()
    if fault == "ffhq_orbit":
        rk = dict(gen_videos.load_networks(run["net"], device="cpu")[0].rendering_kwargs)
        labels = [gen_videos.orbit_label(i, FRAMES, "ffhq", rk) for i in range(FRAMES)]
    out = run["out"]
    for i, (img, raw) in enumerate(_frames(reference, labels, fault != "black_background")):
        for got, want in ((out["frames"][i], img), (out["frames_raw"][i], raw)):
            assert np.abs(got.astype(int) - want.numpy().astype(int)).mean() > 1, (fault, i)
