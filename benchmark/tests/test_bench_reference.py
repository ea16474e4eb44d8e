"""The frozen reference against gnerf_tpu_torch at a tiny size on the CPU:
the key stream, the synthetic data, served frames and the training step."""

import math

import numpy as np
import pytest
import torch

from benchmark import gnerf_infer, weights
from benchmark.drivers import train as train_driver
from benchmark.reference import gnerf as ref
from benchmark.reference import threefry as tf
from benchmark.reference import train as ref_train

from . import _tiny


def test_key_stream_matches_the_program():
    from gnerf_tpu_torch.utils import prng

    key = prng.fold_in(prng.PRNGKey(2 ** 31 + 9), 12)
    mine = tf.fold_in(tf.PRNGKey(2 ** 31 + 9), 12)
    assert key.tolist() == mine.tolist()
    assert prng.split(key, 5).tolist() == tf.split(mine, 5).tolist()
    assert torch.equal(prng.uniform(key, (3, 7, 5)), tf.uniform(mine, (3, 7, 5), "cpu"))
    assert torch.equal(prng.normal(key, (2, 1, 16, 16)), tf.normal(mine, (2, 1, 16, 16), "cpu"))


def test_synthetic_batches_match_the_program():
    from gnerf_tpu_torch.training.dataset import SyntheticDataset, data_iterator

    ds = SyntheticDataset(resolution=32, depth_resolution=8, size=64, seed=123)
    got = data_iterator(ds, batch_size=3, seed=2 ** 31 + 1)
    want = ref_train.batches(123, 2 ** 31 + 1, 3, 64, 32, 8)
    for _ in range(4):
        a, b = next(got), next(want)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
def test_frames_match_the_program(dtype):
    cell = _tiny.cell("orbit-ffhq512")
    cell.config["dtype"]["backbone"] = dtype
    g, e = gnerf_infer.reference_modules(cell.config)
    host = weights.to_host(weights.draw({"G": g, "E": e}, 77, "cpu"))
    svc = gnerf_infer.program(cell.config, host, "cpu", {})
    try:
        photos = gnerf_infer.photos(5, 1, 64, "cpu")
        ident = svc.encode_image(photos[0])
        orbit = svc.render_orbit(ident, frames=3)
        single = svc.render_frame(ident, yaw=1.3, pitch=1.7)
    finally:
        svc.close()
    poses = [(0, *ref.orbit_pose(i, 3)) for i in range(3)] + [(0, 1.3, 1.7)]
    want = gnerf_infer.reference_frames(cell, host, photos, poses, gnerf_infer.DTYPES[dtype])
    for got, w in zip(orbit + [single], want):
        assert gnerf_infer.worst_mad([got], [w]) < 0.01
        assert np.abs(got.astype(int) - w.astype(int)).max() <= 1
        assert w.std() > 5  # a frame with content, not a blank one


def test_training_steps_match_the_program():
    cell = _tiny.cell("train-gnerf-ffhq512")
    drv = train_driver.Driver(cell, lambda msg: None)
    drv.setup()
    drv.release()
    gaps = train_driver.compare(drv.readings, drv.reference_readings())
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-5
    assert gaps["update_gap"] < 1e-3
    assert gaps["update_gap_short"] < 1e-3
    assert not gaps["left_out"]


def test_orbit_poses_are_the_services():
    from gnerf_tpu_torch.utils import camera

    for i in (0, 7, 59):
        yaw, pitch = ref.orbit_pose(i, 120)
        want = camera.pose_to_label(camera.lookat_sample(
            math.pi / 2 + 0.7 * math.sin(2 * math.pi * i / 120),
            math.pi / 2 - 0.05 + 0.3 * math.cos(2 * math.pi * i / 120), radius=2.7),
            camera.FFHQ_INTRINSICS)
        assert torch.equal(ref.label(yaw, pitch), want)
