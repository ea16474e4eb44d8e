"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread, tiny_gen_cfg  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "gnerf_tpu")


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import gnerf_tpu_torch, gnerf_tpu_torch.infer.gen_videos, gnerf_tpu_torch.models\n"
        "import gnerf_tpu_torch.ops, gnerf_tpu_torch.render, gnerf_tpu_torch.utils.checkpoint\n"
        "import gnerf_tpu_torch.infer.server, gnerf_tpu_torch.infer.shape_utils\n"
        "import gnerf_tpu_torch.infer.crosssection, gnerf_tpu_torch.utils.alignment\n"
        "import gnerf_tpu_torch.training, gnerf_tpu_torch.training.train\n"
        "import gnerf_tpu_torch.utils.misc, gnerf_tpu_torch.utils.stats\n"
        "import gnerf_tpu_torch.utils.logger, gnerf_tpu_torch.utils.native_loader\n"
        "import gnerf_tpu_torch.models.dual_discriminator, gnerf_tpu_torch.training.eg3d_loss\n"
        "import gnerf_tpu_torch.training.augment, gnerf_tpu_torch.training.inception\n"
        "import gnerf_tpu_torch.training.metrics, gnerf_tpu_torch.training.pti\n"
        "import gnerf_tpu_torch.training.eval, gnerf_tpu_torch.parallel\n"
        "import gnerf_tpu_torch.utils.tf_legacy, gnerf_tpu_torch.tools.convert_reference_pkl\n"
        "import gnerf_tpu_torch.tools.convert_vgg16_lpips, gnerf_tpu_torch.tools.convert_inception\n"
        "new = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'gnerf_tpu'))\n"
        "print(new)\n"
        "sys.exit(1 if new else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("tool", ["convert_reference_pkl", "convert_vgg16_lpips",
                                  "convert_inception"])
def test_converters_run_where_jax_cannot_be_imported(tool):
    """Each converter's CLI starts with `jax`, `jaxlib` and `gnerf_tpu`
    blocked (`tests/_torch_ingest.py::run_without_jax`)."""
    from _torch_ingest import run_without_jax

    assert "--out" in run_without_jax(f"gnerf_tpu_torch.tools.{tool}", "--help").stdout


def _python_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(ROOT, "gnerf_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_no_jax_import_statements():
    files = _python_files()
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                if _forbidden(node.module):
                    bad.append((path, node.module))
    assert not bad, bad


def _tiny_generator():
    from gnerf_tpu_torch.models import TriPlaneGenerator

    return TriPlaneGenerator(**tiny_gen_cfg())


def _encoder():
    from gnerf_tpu_torch.models import ResNeXt50Encoder

    return ResNeXt50Encoder(layers=(1, 1, 1, 1))


def _generate_videos(tmp_path):
    from gnerf_tpu_torch.infer.gen_videos import generate_videos

    return generate_videos(None, seed_init=0, frames=1, video_out_path=str(tmp_path))


def _service(g):
    from gnerf_tpu_torch.infer.server import GNerfService

    return GNerfService(g)


def _load_service(tmp_path):
    from gnerf_tpu_torch.infer.server import load_service

    return load_service(str(tmp_path / "g.npz"))


def _extract_sigma_grid(g):
    from gnerf_tpu_torch.infer.shape_utils import extract_sigma_grid

    return extract_sigma_grid(g, torch.zeros((1, g.num_ws, g.w_dim)), voxel_resolution=4)


def _discriminator():
    from gnerf_tpu_torch.models import Discriminator

    return Discriminator(c_dim=25, img_resolution=8, img_channels=1, channel_base=256,
                         channel_max=32)


def _dual_discriminator():
    from gnerf_tpu_torch.models import DualDiscriminator

    return DualDiscriminator(c_dim=25, img_resolution=8, img_channels=3, channel_base=256,
                             channel_max=32)


def _vgg():
    from gnerf_tpu_torch.training import VGG16LPIPS

    return VGG16LPIPS()


def _inception():
    from gnerf_tpu_torch.training import InceptionV3Features

    return InceptionV3Features()


def _run_pti_cli(tmp_path):
    from gnerf_tpu_torch.training.pti import run_pti_cli

    return run_pti_cli(str(tmp_path / "g.npz"), outdir=str(tmp_path / "pti"), pivot="project")


def _run_eval(tmp_path):
    from gnerf_tpu_torch.training.eval import run_eval

    return run_eval(str(tmp_path / "g.npz"))


def _init_distributed(monkeypatch):
    from gnerf_tpu_torch.parallel import init_distributed

    monkeypatch.setenv("WORLD_SIZE", "2")
    return init_distributed()


def _stylegan3_generator():
    from gnerf_tpu_torch.models import stylegan3

    return stylegan3.Generator(z_dim=16, c_dim=0, w_dim=32, img_resolution=32, img_channels=3,
                               channel_base=1024, channel_max=32, num_layers=6)


def _run_training(tmp_path):
    from gnerf_tpu_torch.training.train import run_training

    return run_training(outdir=str(tmp_path), dry_run=True)


ENTRIES = ["TriPlaneGenerator", "ResNeXt50Encoder", "generate_videos", "GNerfService",
           "load_service", "extract_sigma_grid", "Discriminator", "VGG16LPIPS", "run_training",
           "DualDiscriminator", "InceptionV3Features", "run_pti_cli", "run_eval",
           "init_distributed", "stylegan3.Generator"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_entry_points_refuse_cpu_without_request(entry, monkeypatch, tmp_path):
    """No card and no device asked for: every entry point raises before any
    work. With device="cpu" the service and the sweep run."""
    from gnerf_tpu_torch.models import TriPlaneGenerator

    g = TriPlaneGenerator(**tiny_gen_cfg(), device="cpu") if entry in ENTRIES[3:6] else None
    if g is not None:
        from gnerf_tpu_torch.utils import checkpoint

        checkpoint.save_checkpoint(str(tmp_path / "g.npz"), {"G_ema": g},
                                   config={"generator": tiny_gen_cfg()})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {"TriPlaneGenerator": _tiny_generator, "ResNeXt50Encoder": _encoder,
             "generate_videos": lambda: _generate_videos(tmp_path),
             "GNerfService": lambda: _service(g), "load_service": lambda: _load_service(tmp_path),
             "extract_sigma_grid": lambda: _extract_sigma_grid(g),
             "Discriminator": _discriminator, "VGG16LPIPS": _vgg,
             "run_training": lambda: _run_training(tmp_path),
             "DualDiscriminator": _dual_discriminator, "InceptionV3Features": _inception,
             "run_pti_cli": lambda: _run_pti_cli(tmp_path),
             "run_eval": lambda: _run_eval(tmp_path),
             "init_distributed": lambda: _init_distributed(monkeypatch),
             "stylegan3.Generator": _stylegan3_generator}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    if entry == "GNerfService":
        from gnerf_tpu_torch.infer.server import GNerfService

        GNerfService(g, device="cpu").close()
    elif entry == "load_service":
        from gnerf_tpu_torch.infer.server import load_service

        svc = load_service(str(tmp_path / "g.npz"), device="cpu")
        assert svc.device.type == "cpu"
        svc.close()
    elif entry == "extract_sigma_grid":
        from gnerf_tpu_torch.infer.shape_utils import extract_sigma_grid

        vol = extract_sigma_grid(g, torch.zeros((1, g.num_ws, g.w_dim)), voxel_resolution=4,
                                 device="cpu")
        assert vol.shape == (4, 4, 4)
    elif entry == "init_distributed":
        # Asked for the CPU, the group is gloo's; CUDA would be NCCL's.
        from gnerf_tpu_torch.parallel import init_distributed

        backends = []
        monkeypatch.setattr(torch.distributed, "init_process_group", backends.append)
        assert init_distributed("cpu") and backends == ["gloo"]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        assert init_distributed("cuda") and backends == ["gloo", "nccl"]
    elif entry == "run_training":
        from click.testing import CliRunner

        from gnerf_tpu_torch.training.train import main

        result = CliRunner().invoke(main, ["--outdir", str(tmp_path), "--dry-run",
                                           "--device", "cpu"])
        assert result.exit_code == 0, result.output
        assert "Dry run" in result.output
        failed = CliRunner().invoke(main, ["--outdir", str(tmp_path), "--dry-run"])
        assert isinstance(failed.exception, RuntimeError)


def test_decoder_wrapper_has_no_silent_fallback():
    """A tensor on neither the CPU nor CUDA raises instead of taking the
    plain version."""
    from gnerf_tpu_torch.ops.fused_decoder import osg_decode

    feats = torch.empty((1, 3, 16, 8), device="meta")
    w1 = torch.empty((8, 4), device="meta")
    b1 = torch.empty((4,), device="meta")
    w2 = torch.empty((4, 3), device="meta")
    b2 = torch.empty((3,), device="meta")
    before = osg_decode.launches
    with pytest.raises(ValueError):
        osg_decode(feats, w1, b1, w2, b2)
    assert osg_decode.launches == before


def test_cpu_entry_point_runs_when_asked():
    from gnerf_tpu_torch.models import TriPlaneGenerator

    g = TriPlaneGenerator(**tiny_gen_cfg(), device="cpu")
    assert next(g.parameters()).device.type == "cpu"
    assert np.isfinite(g.decoder.fc0.weight.detach().numpy()).all()
