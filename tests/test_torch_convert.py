"""The port's reference-checkpoint converters vs the JAX package's.

`gnerf_tpu_torch/utils/checkpoint.py::convert_torch_*` against
`gnerf_tpu/utils/checkpoint.py`'s on the same state dicts, bit for bit;
`python -m gnerf_tpu_torch.tools.convert_reference_pkl` (run with JAX
unimportable) against `tools/convert_reference_pkl.py` on one
reference-layout pickle of a tiny G + E + D (`tests/_torch_ingest.py`): the
npz files hold the same keys in the same order, the same bytes and the same
config. The port's npz then renders through the port's `generate_videos`
and the JAX tool's through JAX's renderer, within +-1 per uint8 pixel.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ingest as ingest
from _torch_port import one_torch_thread, tiny_gen_cfg  # noqa: F401
from gnerf_tpu.utils import checkpoint as jckpt
from gnerf_tpu_torch.utils import checkpoint as ckpt
from gnerf_tpu_torch.utils import prng

ROOT = ingest.ROOT


def assert_trees_identical(got, want):
    """Same leaves in the same order, each of the same dtype, shape and bytes."""
    got, want = ckpt.flatten_tree(got), jckpt.flatten_tree(want)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def assert_npz_identical(got_path, want_path):
    """Same members in the same order, each array of the same dtype, shape and
    bytes (the config's JSON included)."""
    with np.load(got_path) as got, np.load(want_path) as want:
        assert got.files == want.files
        for k in want.files:
            a, b = got[k], want[k]
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
        return len(want.files)


@pytest.fixture(scope="module")
def networks():
    """A tiny port G (noise strengths 0.5), E (random BN statistics) and
    depth D, from seeds."""
    from gnerf_tpu_torch.models import Discriminator, ResNeXt50Encoder, TriPlaneGenerator

    g = TriPlaneGenerator(**tiny_gen_cfg(), device="cpu", key=prng.PRNGKey(0))
    enc = ResNeXt50Encoder(out_dim=32, layers=(1, 1, 1, 1), device="cpu", key=prng.PRNGKey(1))
    d = Discriminator(c_dim=25, img_resolution=8, img_channels=1, channel_base=256,
                      channel_max=32, device="cpu", key=prng.PRNGKey(2))
    rs = np.random.RandomState(0)
    with torch.no_grad():
        for name, v in g.state_dict().items():
            if name.endswith("noise_strength"):
                v.fill_(0.5)
        for name, v in enc.state_dict().items():
            if name.endswith(".mean"):
                v.copy_(torch.from_numpy(rs.randn(*v.shape).astype(np.float32) * 0.1))
            elif name.endswith(".var"):
                v.copy_(torch.from_numpy(rs.uniform(0.5, 1.5, v.shape).astype(np.float32)))
    return g, enc, d


def _numpy(state):
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def _name_mapping_state():
    """The hand-written reference names of tests/test_utils.py (float64)."""
    return {
        "backbone.mapping.fc0.weight": np.ones((4, 4)),
        "backbone.synthesis.b4.conv1.weight": np.ones((3, 3, 3, 3)),
        "backbone.synthesis.b4.resample_filter": np.ones((4, 4)),
        "decoder.net.0.weight": np.ones((64, 32)),
        "decoder.net.2.bias": np.ones((33,)),
        "superresolution.block0.conv0.affine.weight": np.ones((32, 512)),
    }


@pytest.mark.parametrize("case", ["generator", "discriminator", "encoder", "encoder_state",
                                  "name_mapping"])
def test_state_dict_converters_match_jax(case, networks):
    g, enc, d = networks
    fn = {"encoder": "convert_torch_encoder",
          "encoder_state": "convert_torch_encoder_state"}.get(case, "convert_torch_generator")
    state = {"generator": lambda: _numpy(ingest.reference_generator_state(g)),
             "discriminator": lambda: _numpy(ingest.with_resample_filters(d, d.state_dict())),
             "encoder": lambda: _numpy(ingest.reference_encoder_state(enc)),
             "encoder_state": lambda: _numpy(ingest.reference_encoder_state(enc)),
             "name_mapping": _name_mapping_state}[case]()
    got = getattr(ckpt, fn)(state)
    assert_trees_identical(got, getattr(jckpt, fn)(state))
    if case == "name_mapping":
        assert got["backbone"]["mapping"]["fc0"]["weight"].dtype == np.float32
        assert "resample_filter" not in got["backbone"]["synthesis"]["b4"]
        assert got["decoder"]["fc0"]["weight"].shape == (64, 32)
        assert got["decoder"]["fc1"]["bias"].shape == (33,)
        return
    # The converters invert the reference's names: the port's own trees back.
    want = {"generator": lambda: ckpt.module_params(g),
            "discriminator": lambda: ckpt.module_params(d),
            "encoder": lambda: ckpt.encoder_trees(enc)["E"],
            "encoder_state": lambda: ckpt.encoder_trees(enc)["E_state"]}[case]()
    flat = ckpt.flatten_tree(got)
    assert sorted(flat) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def converted(tmp_path_factory, networks):
    """One reference-layout pickle of the tiny G + E + D, converted by the
    JAX tool and by the port's (JAX blocked)."""
    tmp = tmp_path_factory.mktemp("convert")
    g, enc, d = networks
    pkl = str(tmp / "network.pkl")
    ingest.write_reference_pickle(pkl, g, tiny_gen_cfg()["img_resolution"], enc, d)
    want = str(tmp / "jax.npz")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools/convert_reference_pkl.py"), "--pkl", pkl,
         "--reference", str(tmp), "--out", want], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = str(tmp / "port.npz")
    out = ingest.run_without_jax("gnerf_tpu_torch.tools.convert_reference_pkl", "--pkl", pkl,
                                 "--reference", str(tmp), "--out", got).stdout
    assert "D, E, E_state, G_ema" in out
    return got, want, (g, enc, d)


def test_reference_pickle_tool_matches_jax_tool(converted):
    got, want, (g, enc, d) = converted
    assert assert_npz_identical(got, want) == len(ckpt.module_params(g)) + len(
        ckpt.module_params(enc)) + len(ckpt.module_params(d)) + 1
    trees, config = ckpt.load_checkpoint(got)
    assert config == jckpt.load_checkpoint(want)[1]
    assert set(config["generator"]) == {"z_dim", "c_dim", "w_dim", "img_resolution",
                                        "rendering_kwargs"}
    assert config["generator"]["rendering_kwargs"]["sr_input_resolution"] == 16


def test_converted_npz_renders_as_jax(converted, monkeypatch, tmp_path):
    """The port's npz through the port's `generate_videos`, the JAX tool's
    through JAX's renderer (`test_torch_gen_videos._jax_frames`). The
    reference config names G's published widths only, so both packages'
    constructors take the tiny widths here."""
    import gnerf_tpu_torch.models
    from gnerf_tpu_torch.infer import gen_videos, video_io
    from test_torch_gen_videos import _jax_frames

    got_npz, want_npz, _ = converted
    widths = {k: v for k, v in tiny_gen_cfg().items()
              if k not in ("z_dim", "c_dim", "w_dim", "img_resolution", "rendering_kwargs")}
    monkeypatch.setattr(gnerf_tpu_torch.models, "TriPlaneGenerator", functools.partial(
        gnerf_tpu_torch.models.TriPlaneGenerator, **widths))
    monkeypatch.setattr(gnerf_tpu_torch.models, "ResNeXt50Encoder", functools.partial(
        gnerf_tpu_torch.models.ResNeXt50Encoder, layers=(1, 1, 1, 1)))
    monkeypatch.setattr(video_io, "available_backends", lambda: ("npy",))
    res = gen_videos.generate_videos(got_npz, frames=3, res=8, fp32=True, device="cpu",
                                     video_out_path=str(tmp_path))
    trees, config = jckpt.load_checkpoint(want_npz)
    want = _jax_frames(dict(config["generator"], **widths), trees["G_ema"], trees["E"],
                       trees["E_state"], frames=3, res=8)
    for got, w, shape in zip((res["frames"], res["frames_raw"]), want,
                             ((3, 64, 64, 3), (3, 8, 8, 3))):
        assert got.shape == shape and got.dtype == np.uint8
        assert np.abs(got.astype(int) - w.astype(int)).max() <= 1
        assert got.std() > 0
