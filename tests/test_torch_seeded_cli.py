"""A two-step training run of the port's CLI from `--seed` vs the JAX CLI's
run from the same seed, for `--objective gnerf` (this file) and
`--objective eg3d --aug ada` (tests/test_torch_seeded_cli_eg3d.py).

Both CLIs run on the CPU at the tests' tiny widths (depth and widths
shrunk; the preset, the loop and every key their own), the JAX one on a
one-device mesh, as a single-process run. The synthetic dataset's photos
are smooth (8^2 noise upsampled), in both: on white-noise photos the
encoder's train-mode BatchNorm backward is ill-conditioned in fp32 in both
packages alike (tests/test_torch_training.py), and two Adam steps of E
then scatter with the order of sums. The runs start from
the same seeded networks and key every step alike (G-NeRF: fold_in(
PRNGKey(seed + 1), cur_nimg); EG3D: its split into z's key and the
phases'), so their stats.jsonl
lines (every stat's count and mean, the validation metrics) agree at
rtol 1e-4 / atol 1e-5 and their final snapshots at rtol 1e-4 / atol 1e-5
under the Adam-flip rule of tests/_torch_eg3d.py, with the gradients of
the port's run: Adam maps a gradient to about +-lr, so a weight whose
gradient lies within fp32 noise (below 3e-4 of its tensor's largest) in one
of its steps may move the other way in the other package, by up to two lr
for each step it took. Over two steps such a flip in the first step moves
the second step's gradients of other weights a little: those weights may
then be off by less than one step's lr, where a gradient of the wrong sign
would put them ~2 lr away. Every weight off the tolerance is one of these
two, and under 1 % of its network's weights are off (counted per network,
not per tensor: all 8 entries of a ToRGB bias of 96 may be off). A
G_ema weight is held to its G weight's steps, which it follows."""

import json
import os

import numpy as np
import pytest

import jax

from _torch_port import one_torch_thread  # noqa: F401


def smooth(cls):
    """`cls` (a SyntheticDataset) with smooth photos of its resolution."""
    from PIL import Image

    class Smooth(cls):
        def __getitem__(self, idx):
            item = super().__getitem__(idx)
            rs = np.random.RandomState(idx)
            small = Image.fromarray(rs.randint(0, 256, (8, 8, 3), np.uint8))
            img = np.asarray(small.resize((self.resolution,) * 2, Image.BILINEAR))
            img = np.ascontiguousarray(img.transpose(2, 0, 1))
            return dict(item, condition_image=img, loss_image=img, random_image=img,
                        flip_image=img[:, :, ::-1].copy())

    return Smooth


@pytest.fixture(autouse=True, scope="module")
def jax_compile_cache(tmp_path_factory):
    """JAX's persistent compilation cache for this module's runs: every JAX
    CLI run compiles its steps anew, and a later run's identical programs
    (a resumed run's step) are then read back instead of compiled again.
    The cache reads its options at its first use, so it is reset around
    the module; where a JAX lacks that private hook, the options take
    effect only if nothing compiled before."""
    try:
        from jax._src.compilation_cache import reset_cache
    except ImportError:
        def reset_cache():
            pass

    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
             "jax_persistent_cache_min_entry_size_bytes")
    prev = {n: getattr(jax.config, n) for n in names}
    jax.config.update(names[0], str(tmp_path_factory.mktemp("jax_compile_cache")))
    jax.config.update(names[1], 0)
    jax.config.update(names[2], 0)
    reset_cache()
    yield
    for n, v in prev.items():
        jax.config.update(n, v)
    reset_cache()


@pytest.fixture
def tiny_clis(monkeypatch):
    """Both CLIs' networks at the tiny widths, the JAX CLI on one device."""
    import gnerf_tpu.models as jmodels
    import gnerf_tpu.models.dual_discriminator as jdual
    import gnerf_tpu.training.dataset as jdataset
    import gnerf_tpu.training.losses as jlosses
    import gnerf_tpu_torch.models as models
    from gnerf_tpu_torch.training import dataset, losses

    def shrink(owner, name, **small):
        cls = getattr(owner, name)
        monkeypatch.setattr(owner, name, lambda *a, **kw: cls(*a, **{**kw, **small}))

    for owner in (jmodels, models):
        shrink(owner, "TriPlaneGenerator", plane_resolution=16, channel_base=512,
               channel_max=32)
        shrink(owner, "Discriminator", channel_base=256, channel_max=32)
    shrink(models, "ResNeXt50Encoder", layers=(1, 1, 1, 1))
    # The grouped convolutions as grouped convolutions (the port's), not as
    # the TPU's block-diagonal dense kernels.
    shrink(jmodels, "ResNeXt50Encoder", layers=(1, 1, 1, 1), groups_as_dense=False)
    shrink(models, "DualDiscriminator", channel_base=256, channel_max=32)
    shrink(jdual, "DualDiscriminator", channel_base=256, channel_max=32)
    shrink(losses, "VGG16LPIPS", resize_to=32)
    shrink(jlosses, "VGG16LPIPS", resize_to=32)
    for owner in (jdataset, dataset):
        monkeypatch.setattr(owner, "SyntheticDataset", smooth(owner.SyntheticDataset))
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)


class PortSteps:
    """What the port's run did, for the Adam-flip rule: its networks (the
    state its CLI built) and every gradient and lr its Adams stepped with."""

    def __init__(self):
        self.state = None
        self.grads = {}
        self.lr_sum = {}
        self.lr_max = {}

    def step_pre_hook(self, opt, args, kwargs):
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self.grads.setdefault(id(p), []).append(p.grad.detach().numpy().copy())
                    self.lr_sum[id(p)] = self.lr_sum.get(id(p), 0.0) + group["lr"]
                    self.lr_max[id(p)] = max(self.lr_max.get(id(p), 0.0), group["lr"])

    def modules(self):
        """{snapshot root: module} of the trained networks."""
        st = self.state
        out = {"G": st.g, "D": st.disc}
        if getattr(st, "enc", None) is not None:
            out["E"] = st.enc
        return out


@pytest.fixture
def port_steps(monkeypatch):
    """Keeps the port CLI's state and its Adam steps (a PortSteps)."""
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from gnerf_tpu_torch.training import eg3d_loss, train_loop

    log = PortSteps()
    for owner, name in ((train_loop, "init_train_state"), (eg3d_loss, "init_eg3d_state")):
        make = getattr(owner, name)

        def keep(*a, _make=make, **kw):
            log.state = _make(*a, **kw)
            return log.state

        monkeypatch.setattr(owner, name, keep)
    handle = register_optimizer_step_pre_hook(log.step_pre_hook)
    yield log
    handle.remove()


def run_both(tmp_path, **kw):
    """(port run dir, JAX run dir) of the same two-step run."""
    from gnerf_tpu.training.train import run_training as jax_run
    from gnerf_tpu_torch.training.train import run_training

    kw = {**dict(dataset_name="synthetic", batch=2, kimg=0.004, tick=1, snap=1, seed=3,
                 z_dim=32, w_dim=32), **kw}
    jax_dir = jax_run(outdir=str(tmp_path / "jax"), **kw)
    if jax_dir is None:
        jax_dir = os.path.join(str(tmp_path / "jax"), os.listdir(tmp_path / "jax")[0])
    return run_training(outdir=str(tmp_path / "port"), device="cpu", **kw), jax_dir


def _stats(run):
    with open(os.path.join(run, "stats.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def assert_stats_match(port_dir, jax_dir, skip=()):
    """Every stat of the runs' one stats.jsonl line but those named in `skip`."""
    got, want = _stats(port_dir), _stats(jax_dir)
    assert len(got) == len(want) == 1
    got, want = got[0], want[0]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k in skip:
            continue
        if isinstance(v, dict):
            assert got[k]["num"] == v["num"], k
            np.testing.assert_allclose(got[k]["mean"], v["mean"], rtol=1e-4, atol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def _snapshots(port_dir, jax_dir, roots):
    from gnerf_tpu.utils import checkpoint as jckpt

    snap = "network-snapshot-final.npz"
    got_trees, _ = jckpt.load_checkpoint(os.path.join(port_dir, snap))
    want_trees, _ = jckpt.load_checkpoint(os.path.join(jax_dir, snap))
    assert set(got_trees) == set(want_trees) >= set(roots)
    out = {}
    for root in roots:
        g_flat = jckpt.flatten_tree(got_trees[root])
        w_flat = jckpt.flatten_tree(want_trees[root])
        assert set(g_flat) == set(w_flat), root
        out[root] = (g_flat, w_flat)
    return out


def assert_weights_match(port_dir, jax_dir, roots, steps):
    """Every snapshot leaf of `roots` equals JAX's, a trained weight (or its
    G_ema copy) under the Adam-flip rule with the gradients in `steps`."""
    modules = steps.modules()
    for root, (g_flat, w_flat) in _snapshots(port_dir, jax_dir, roots).items():
        net = modules.get("G" if root == "G_ema" else root)
        params = {} if net is None else {n.replace(".", "/"): p
                                         for n, p in net.named_parameters()}
        n_off = n_all = 0
        for k, w in w_flat.items():
            g = g_flat[k]
            off = ~np.isclose(g, w, rtol=1e-4, atol=1e-5)
            n_all += off.size
            if not off.any():
                continue
            p = params.get(k) if root != "E_state" else None
            assert p is not None and id(p) in steps.grads, (root, k, int(off.sum()))
            tiny = np.zeros(off.shape, bool)
            for gr in steps.grads[id(p)]:
                tiny |= np.abs(gr) < 3e-4 * np.abs(gr).max()
            gap = np.abs(g - w)
            flipped = tiny & (gap <= 2 * steps.lr_sum[id(p)] + 1e-5)
            moved = gap < steps.lr_max[id(p)]
            assert (flipped | moved)[off].all(), (root, k, int((off & ~flipped & ~moved).sum()),
                                                  float(gap[off & ~flipped].max()))
            n_off += int(off.sum())
        assert n_off < 0.01 * n_all, (root, n_off, n_all)


def test_two_step_gnerf_run_matches_jax_cli(tmp_path, tiny_clis, port_steps):
    """`--train_gen True --train_en False`: all of G and the depth D train
    on every draw of the step's key (G's noise strengths move from 0 in the
    first step, so the second step's noise counts), E in eval mode. Stats
    and every weight (tests/test_torch_seeded_cli_encoder.py has the
    default objective, with E training)."""
    port_dir, jax_dir = run_both(tmp_path, train_en=False, train_gen=True)
    assert_stats_match(port_dir, jax_dir)
    assert_weights_match(port_dir, jax_dir, ("G_ema", "G", "E", "E_state", "D"), port_steps)


def set_state_config(path, **changes):
    """Rewrite the config of a full-state file, its leaves untouched."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    config = json.loads(bytes(flat["__config__"]).decode())
    flat["__config__"] = np.frombuffer(json.dumps({**config, **changes}).encode(), np.uint8)
    np.savez(path, **flat)


def resumed_both(tmp_path, first, state_path, **kw):
    """(port run dir, JAX run dir): each CLI's `--resume` of `state_path`
    (written by the run in `first`) for one step more."""
    from gnerf_tpu.training.train import run_training as jax_run
    from gnerf_tpu_torch.training.train import run_training

    kw = {**dict(dataset_name="synthetic", batch=2, kimg=0.004, tick=1, snap=1, seed=3,
                 z_dim=32, w_dim=32), **kw, "resume": state_path}
    jax_run(outdir=str(tmp_path / "jax_resumed"), **kw)
    jax_dir = os.path.join(str(tmp_path / "jax_resumed"),
                           os.listdir(tmp_path / "jax_resumed")[0])
    port_dir = run_training(outdir=str(tmp_path / "port_resumed"), device="cpu", **kw)
    for run in (jax_dir, port_dir):
        with open(os.path.join(run, "log.txt")) as fh:
            assert "Resumed" in fh.read() and first not in (jax_dir, port_dir)
    return port_dir, jax_dir


def first_step(tmp_path, package, **kw):
    """The run dir of a one-step run of `package`'s CLI ("jax" or "port")."""
    from gnerf_tpu.training.train import run_training as jax_run
    from gnerf_tpu_torch.training.train import run_training

    kw = {**dict(dataset_name="synthetic", batch=2, kimg=0.002, tick=1, snap=1, seed=3,
                 z_dim=32, w_dim=32), **kw}
    out = tmp_path / f"{package}_first"
    if package == "jax":
        jax_run(outdir=str(out), **kw)
        return os.path.join(str(out), os.listdir(out)[0])
    return run_training(outdir=str(out), device="cpu", **kw)


GEN_ONLY = dict(train_en=False, train_gen=True)


def test_jax_cli_state_resumes_in_port_cli(tmp_path, tiny_clis, port_steps):
    """The JAX CLI runs one step; the port CLI's `--resume` of its
    training-state-latest.npz runs one more and equals the JAX CLI's own
    `--resume` (stats; every weight under the rule above). The file's
    best_ssim, set above any SSIM, comes back in both: neither writes a best
    snapshot, and both save it again."""
    first = first_step(tmp_path, "jax", **GEN_ONLY)
    path = os.path.join(first, "training-state-latest.npz")
    set_state_config(path, best_ssim=2.0)
    port_dir, jax_dir = resumed_both(tmp_path, first, path, **GEN_ONLY)
    assert_stats_match(port_dir, jax_dir)
    assert_weights_match(port_dir, jax_dir, ("G_ema", "G", "E", "E_state", "D"), port_steps)
    for run in (port_dir, jax_dir):
        assert "network-snapshot-best.npz" not in os.listdir(run)
        with np.load(os.path.join(run, "training-state-latest.npz")) as data:
            assert json.loads(bytes(data["__config__"]).decode())["best_ssim"] == 2.0


def test_port_cli_state_resumes_in_jax_cli(tmp_path, tiny_clis, port_steps):
    """The reverse: the port CLI runs one step; the JAX CLI's `--resume` of
    the port's file runs one more and equals the port CLI's own `--resume`
    (stats; every weight under the rule above); both write final full
    states of the same leaves (shapes, dtypes), the Adam counts at 2 and
    cur_nimg at 4."""
    first = first_step(tmp_path, "port", **GEN_ONLY)
    path = os.path.join(first, "training-state-latest.npz")
    port_dir, jax_dir = resumed_both(tmp_path, first, path, **GEN_ONLY)
    assert_stats_match(port_dir, jax_dir)
    assert_weights_match(port_dir, jax_dir, ("G_ema", "G", "E", "E_state", "D"), port_steps)
    with np.load(os.path.join(jax_dir, "training-state-latest.npz")) as a, \
            np.load(os.path.join(port_dir, "training-state-latest.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k != "__config__":
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        count = [k for k in a.files if k != "__config__" and a[k].dtype == np.int32]
        assert {int(a[k]) for k in count} == {int(b[k]) for k in count} == {2, 4}
