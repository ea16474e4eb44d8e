"""Shared helpers of the full-state tests: the port's earlier full-state
writer (tests/test_torch_training.py), and a CLI run's saved state by the
port's names, read through a template of the run's state
(tests/test_torch_train_cli.py, test_torch_ddp_cli.py)."""

import json
import os

import numpy as np
import torch

_MODULES = ("g", "g_ema", "enc", "disc", "vgg")
_OPTS = ("opt_g", "opt_d")


def save_train_state_torch(path, state, config=None, best_ssim=None):
    """The port's full-state writer before it wrote the JAX layout: every
    module's state_dict, both optimizers' states in their own dtypes,
    cur_nimg and best_ssim under `train_state_torch` (kept to write the
    files older runs left, which the port still resumes)."""
    from gnerf_tpu_torch.utils import checkpoint as ckpt_lib

    def exact(t):
        return t.detach().cpu().numpy()

    tree = {"cur_nimg": np.asarray(state.cur_nimg, np.int64),
            "best_ssim": np.asarray(-100.0 if best_ssim is None else best_ssim, np.float64)}
    for name in _MODULES:
        module = getattr(state, name, None)
        if module is not None:
            tree[name] = {k.replace(".", ckpt_lib.SEP): exact(v)
                          for k, v in module.state_dict().items()}
    for name in _OPTS:
        opt = getattr(state, name)
        if opt is None:
            continue
        sd = opt.state_dict()
        tree[name] = {
            "param_groups": np.frombuffer(json.dumps(sd["param_groups"]).encode(), np.uint8),
            "state": {str(i): {k: exact(v) for k, v in s.items()}
                      for i, s in sd["state"].items()},
        }
    ckpt_lib.save_checkpoint(path, {"train_state_torch": tree}, config=config)


def cli_state(run_dir, objective="gnerf"):
    """The state the port's CLI builds for the run in `run_dir` (from its
    training_options.json; the networks on the CPU, nothing drawn), the
    template that names a full-state file's leaves. Call it where the
    CLI's networks are shrunk as the run's were."""
    from gnerf_tpu_torch.training import train
    from gnerf_tpu_torch.training.eg3d_loss import init_eg3d_state
    from gnerf_tpu_torch.training.train_loop import TrainConfig, init_train_state

    with open(os.path.join(run_dir, "training_options.json")) as fh:
        options = json.load(fh)
    gen = options["generator"]
    rk = options["rendering_kwargs"]
    fields = {k: v for k, v in options["config"].items() if k != "dtype"}
    cfg = TrainConfig(**fields, dtype=getattr(torch, options["config"]["dtype"]))
    dims = (gen["z_dim"], gen["w_dim"], gen["img_resolution"], rk)
    if objective == "eg3d":
        g, disc = train.eg3d_networks(cfg.random_seed, *dims, device="cpu", draw=False)
        return init_eg3d_state(g, disc, train.eg3d_loss_config(
            rk, cfg, g.neural_rendering_resolution))
    g, enc, disc, vgg, _ = train.gnerf_networks(cfg.random_seed, cfg, *dims, device="cpu",
                                                draw=False)
    return init_train_state(g, enc, disc, vgg, cfg)


def saved_state(run_dir, objective="gnerf"):
    """(the run's training-state-latest.npz by the port's names
    (`jax_state.named_trees`), its config)."""
    from gnerf_tpu_torch.training import jax_state
    from gnerf_tpu_torch.utils.checkpoint import load_checkpoint

    trees, config = load_checkpoint(os.path.join(run_dir, "training-state-latest.npz"))
    assert set(trees) == {"train_state"}, sorted(trees)
    return jax_state.named_trees(trees["train_state"], cli_state(run_dir, objective)), \
        config
