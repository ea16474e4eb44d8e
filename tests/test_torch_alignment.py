"""The port's copy of the FFHQ alignment (gnerf_tpu_torch/utils/alignment.py)
vs gnerf_tpu.utils.alignment: identical outputs on the fixtures of
tests/test_alignment.py."""

import json

import numpy as np
import pytest

from gnerf_tpu.utils import alignment as jalign
from gnerf_tpu_torch.utils import alignment
from test_alignment import _smooth_image, _synthetic_landmarks


@pytest.mark.parametrize("tilt", [0.0, 20.0])
def test_ffhq_quad_matches_jax(tilt):
    lm = _synthetic_landmarks(tilt_deg=tilt)
    quad, qsize = alignment.ffhq_quad(lm)
    want_quad, want_qsize = jalign.ffhq_quad(lm)
    np.testing.assert_array_equal(quad, want_quad)
    assert qsize == want_qsize


def test_quad_warp_matches_jax():
    img = _smooth_image(96, 112, seed=1).astype(np.float64)
    c, x, y = np.array([56.0, 48.0]), np.array([30.0, 10.0]), np.array([-10.0, 30.0])
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    np.testing.assert_array_equal(alignment.quad_warp(img, quad, 64),
                                  jalign.quad_warp(img, quad, 64))


@pytest.mark.parametrize("case", ["interior", "pad", "pad_disabled", "shrink"])
def test_align_face_matches_jax(case):
    img, lm, size, kw = {
        "interior": (_smooth_image(256, 256, seed=2),
                     _synthetic_landmarks(cx=128, cy=110, iod=24.0, tilt_deg=10.0), 64, {}),
        "pad": (_smooth_image(128, 128, seed=3), _synthetic_landmarks(cx=20, cy=24, iod=30.0),
                32, {}),
        "pad_disabled": (_smooth_image(128, 128, seed=3),
                         _synthetic_landmarks(cx=20, cy=24, iod=30.0), 32,
                         {"enable_padding": False}),
        "shrink": (_smooth_image(512, 512, seed=4), _synthetic_landmarks(cx=256, cy=240, iod=110.0),
                   32, {}),
    }[case]
    got = alignment.align_face(img, lm, output_size=size, **kw)
    assert got.shape == (size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jalign.align_face(img, lm, output_size=size, **kw))


@pytest.mark.parametrize("ext", ["json", "npy", "txt", "bad"])
def test_load_landmarks_formats_match_jax(tmp_path, ext):
    lm = _synthetic_landmarks()
    path = tmp_path / f"a.{ext}"
    if ext == "json":
        path.write_text(json.dumps(lm.tolist()))
    elif ext == "npy":
        np.save(str(path), lm)
    elif ext == "txt":
        np.savetxt(str(path), lm)
    else:
        path.write_text(json.dumps([[0, 0]] * 5))
        with pytest.raises(ValueError):
            alignment.load_landmarks(str(path))
        return
    np.testing.assert_array_equal(alignment.load_landmarks(str(path)),
                                  jalign.load_landmarks(str(path)))


def test_align_folder_matches_jax(tmp_path):
    import PIL.Image

    data, lms = tmp_path / "raw", tmp_path / "lms"
    data.mkdir()
    lms.mkdir()
    PIL.Image.fromarray(_smooth_image(256, 256)).save(data / "face1.png")
    PIL.Image.fromarray(_smooth_image(256, 256, seed=5)).save(data / "nolm.png")
    (lms / "face1.json").write_text(json.dumps(_synthetic_landmarks().tolist()))
    got = alignment.align_folder(str(data), str(lms), str(tmp_path / "port"), output_size=64)
    want = jalign.align_folder(str(data), str(lms), str(tmp_path / "jax"), output_size=64)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] == ["face1.png"]
    np.testing.assert_array_equal(np.asarray(PIL.Image.open(got[0])),
                                  np.asarray(PIL.Image.open(want[0])))
