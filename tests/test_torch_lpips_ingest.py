"""The port's LPIPS converter (`gnerf_tpu_torch/tools/convert_vgg16_lpips.py`)
vs the JAX package's (`tools/convert_vgg16_lpips.py`).

On the tiny VGG oracle of `tests/test_lpips_ingest.py` (13 convs, 4 pools,
5 LPIPS taps, small channels): the same parameter mapping bit for bit; the
port's calibration (its `VGG16LPIPS` on the CPU) picks the same resize,
antialias and whitening as JAX's, its error within 1e-6 of JAX's; and
`load_lpips` of the port's npz reproduces the oracle within the
calibration's rtol of 5e-3. Through `convert`: a TorchScript oracle
(`tests/_torch_ingest.py::LPIPSOracle` at the tiny config) and a plain
state_dict give the JAX tool's parameters and meta.
"""

import json

import numpy as np
import pytest
import torch

import gnerf_tpu.training.losses as jlosses
import gnerf_tpu_torch.training.losses as losses
import tools.convert_vgg16_lpips as jtool
from _torch_ingest import LPIPSOracle
from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu_torch.tools import convert_vgg16_lpips as tool
from test_lpips_ingest import TINY_CFG, TINY_CHANNELS, TINY_LPIPS_DIMS, TorchLPIPSOracle


@pytest.fixture()
def tiny_vgg(monkeypatch):
    """The tiny config in both packages' nets and both converters."""
    for mod in (jlosses, losses):
        monkeypatch.setattr(mod, "_VGG_CFG", TINY_CFG)
    monkeypatch.setattr(losses, "_LPIPS_DIMS", TINY_LPIPS_DIMS)
    for mod in (jtool, tool):
        monkeypatch.setattr(mod, "VGG_CHANNELS", TINY_CHANNELS)
        monkeypatch.setattr(mod, "LPIPS_DIMS", TINY_LPIPS_DIMS)
    return TorchLPIPSOracle()


def _flat(params):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update({f"{k}/{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


def _assert_params_identical(got, want):
    got, want = _flat(got), _flat(want)
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), k


def _npz(path):
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return flat, json.loads(flat.pop("__meta__").tobytes().decode())


def _oracle_distance(oracle, a, b):
    with torch.no_grad():
        fa = oracle(torch.from_numpy(a), resize_images=True, return_lpips=True)
        fb = oracle(torch.from_numpy(b), resize_images=True, return_lpips=True)
    return (fa - fb).square().sum(1).numpy()


def _pairs(seed, res=48, n=3):
    rng = np.random.RandomState(seed)
    a = rng.rand(n, 3, res, res).astype(np.float32) * 255.0
    b = np.clip(a + rng.randn(n, 3, res, res).astype(np.float32) * 40.0, 0.0, 255.0)
    return a, b


def _port_distance(path, a, b):
    net, meta = losses.load_lpips(path, device="cpu")
    with torch.no_grad():
        d = (net.apply(torch.from_numpy(a)) - net.apply(torch.from_numpy(b))).square().sum(1)
    return d.numpy(), net, meta


def test_map_params_matches_jax(tiny_vgg):
    sd = tool.extract_tensors(tiny_vgg)
    want_sd = jtool.extract_tensors(tiny_vgg)
    assert list(sd) == list(want_sd)
    params = tool.map_params(sd)
    assert set(params["preprocess"]) == {"shift", "scale"}
    _assert_params_identical(params, jtool.map_params(want_sd))


def test_calibration_matches_jax(tiny_vgg, tmp_path):
    params = tool.map_params(tool.extract_tensors(tiny_vgg))
    best = tool.calibrate(tiny_vgg, params, device="cpu")
    want = jtool.calibrate(tiny_vgg, jtool.map_params(jtool.extract_tensors(tiny_vgg)))
    for k in ("resize_to", "antialias", "whitening"):
        assert best[k] == want[k], k
    assert (best["resize_to"], best["antialias"]) == (256, True)
    assert abs(best["calibration_err"] - want["calibration_err"]) <= 1e-6
    assert best["calibration_err"] < 5e-3
    _assert_params_identical(best["_params"], want["_params"])

    out = str(tmp_path / "lpips_tiny.npz")
    tool.write_npz(out, best.pop("_params"), dict(best, pretrained=True))
    a, b = _pairs(3)
    got, net, meta = _port_distance(out, a, b)
    assert meta["pretrained"] is True and (net.resize_to, net.antialias) == (256, True)
    np.testing.assert_allclose(got, _oracle_distance(tiny_vgg, a, b), rtol=5e-3, atol=1e-5)


@pytest.mark.parametrize("source", ["torchscript", "state_dict"])
def test_convert_matches_jax_tool(tiny_vgg, tmp_path, source):
    """`convert` of both tools on one file: the same parameters; the same
    meta (a TorchScript's calibration error within 1e-6; a state_dict's
    uncalibrated meta exactly)."""
    pt = str(tmp_path / "vgg16.pt")
    oracle = LPIPSOracle(cfg=TINY_CFG, seed=1)
    if source == "torchscript":
        torch.jit.save(torch.jit.script(oracle), pt)
    else:
        torch.save(oracle.state_dict(), pt)
    got_path, want_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    meta = tool.convert(pt, got_path, device="cpu")
    want_meta = jtool.convert(pt, want_path)
    got, got_meta = _npz(got_path)
    want, jmeta = _npz(want_path)
    assert got_meta == meta
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    if source == "torchscript":
        assert abs(got_meta.pop("calibration_err") - jmeta.pop("calibration_err")) <= 1e-6
        want_meta.pop("calibration_err")
    assert got_meta == jmeta == want_meta
    if source == "torchscript":
        assert got_meta["whitening"] is True and got_meta["resize_to"] == 256
        a, b = _pairs(5, res=64, n=2)
        np.testing.assert_allclose(_port_distance(got_path, a, b)[0],
                                   _oracle_distance(oracle, a, b), rtol=5e-3, atol=1e-5)
    else:
        assert got_meta["calibration_err"] is None and "NOT calibrated" in got_meta["note"]


class _Scaled(torch.nn.Module):
    """An LPIPS net whose distances are 1.21x the oracle's: no candidate
    preprocessing reproduces it."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, x, resize_images: bool = False, return_lpips: bool = False):
        return 1.1 * self.net(x, resize_images=resize_images, return_lpips=return_lpips)


def test_convert_refuses_when_no_candidate_matches(tiny_vgg, tmp_path):
    """As JAX's, the port's tool raises and writes nothing when the best
    candidate misses the torchscript by more than rtol 5e-3."""
    pt, out = str(tmp_path / "vgg16.pt"), tmp_path / "lpips.npz"
    torch.jit.save(torch.jit.script(_Scaled(LPIPSOracle(cfg=TINY_CFG, seed=2))), pt)
    with pytest.raises(RuntimeError, match="calibration failed"):
        tool.convert(pt, str(out), device="cpu")
    assert not out.exists()
