"""The port's G-NeRF training (gnerf_tpu_torch.training) vs gnerf_tpu.training.

The tiny configuration of tests/test_training.py (z = w = 32, 16^2 planes,
channel_base 512 / max 32, 8^2 render, 4+4 depths, SR 2X, D with
channel_base 256 / max 32 / mbstd 1, VGG resized to 32, batch 2), the
encoder with one block per stage, fp32 on the CPU. Parameters are made with
the JAX `init` and bridged with `load_jax_params`; batches come from the
JAX package's SyntheticDataset, with smooth 64^2 identity photos (white
noise photos make the encoder's train-mode BatchNorm backward ill-conditioned
in fp32, in both packages alike). Tolerance rtol 1e-4 / atol 1e-5 unless a
case says otherwise.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import one_torch_thread, to_np  # noqa: F401
from _torch_state import save_train_state_torch
from gnerf_tpu.models import Discriminator as JD
from gnerf_tpu.models import ResNeXt50Encoder as JEnc
from gnerf_tpu.models import TriPlaneGenerator as JGen
from gnerf_tpu.training import dataset as jds
from gnerf_tpu.training import losses as JL
from gnerf_tpu.training import train_loop as JT
from gnerf_tpu.utils import checkpoint as jckpt
from gnerf_tpu_torch.models import Discriminator, ResNeXt50Encoder, TriPlaneGenerator
from gnerf_tpu_torch.training import dataset as tds
from gnerf_tpu_torch.training import jax_state
from gnerf_tpu_torch.training import losses as L
from gnerf_tpu_torch.training import train_loop as T
from gnerf_tpu_torch.training.train import step_key
from gnerf_tpu_torch.utils import prng
from gnerf_tpu_torch.utils.checkpoint import flatten_tree, load_jax_params, module_params

TOL = dict(rtol=1e-4, atol=1e-5)
TINY_G = dict(z_dim=32, w_dim=32, img_resolution=128, plane_resolution=16, channel_base=512,
              channel_max=32, mapping_layers=2, neural_rendering_resolution=8)
TINY_D = dict(c_dim=25, img_resolution=8, img_channels=1, channel_base=256, channel_max=32,
              mbstd_group_size=1)
ENC_LAYERS = (1, 1, 1, 1)


def tiny_rendering_kwargs():
    from gnerf_tpu.models.triplane import DEFAULT_RENDERING_KWARGS

    return dict(DEFAULT_RENDERING_KWARGS, superresolution_module="SuperresolutionHybrid2X",
                depth_resolution=4, depth_resolution_importance=4)


class JGenNoRng(JGen):
    """The JAX G with the step's key withheld from the synthesis: constant
    noise (noise_strength starts at 0) and deterministic sampling, the
    port's `rng=None` path."""

    def synthesis(self, params, ws, c, neural_rendering_resolution=None, noise_mode="const",
                  rng=None, **kw):
        return super().synthesis(params, ws, c,
                                 neural_rendering_resolution=neural_rendering_resolution,
                                 noise_mode="const", rng=None, **kw)


def smooth_photos(n, res, seed):
    from PIL import Image

    rs = np.random.RandomState(seed)
    return np.stack([np.asarray(Image.fromarray(rs.randint(0, 256, (8, 8, 3), np.uint8))
                                .resize((res, res), Image.BILINEAR)).transpose(2, 0, 1)
                     for _ in range(n)])


def tiny_batch(first=0):
    ds = jds.SyntheticDataset(resolution=16, depth_resolution=8, size=16)
    batch = jds.collate([ds[i] for i in range(first, first + 2)])
    batch["condition_image"] = smooth_photos(2, 64, seed=first)
    return batch


def jax_setup(train_gen):
    g = JGenNoRng(**TINY_G, rendering_kwargs=tiny_rendering_kwargs())
    enc = JEnc(out_dim=32, layers=ENC_LAYERS, groups_as_dense=False)
    disc = JD(**TINY_D)
    vgg = JL.VGG16LPIPS(resize_to=32)
    cfg = JT.TrainConfig(batch_size=2, neural_rendering_resolution=8, train_gen=train_gen,
                         remat_synthesis=False, remat_lpips=False)
    return g, enc, disc, vgg, cfg


def port_state(jstate, train_gen, **cfg_overrides):
    """The port's TrainState holding the JAX state's parameters."""
    g = TriPlaneGenerator(**TINY_G, rendering_kwargs=tiny_rendering_kwargs(), device="meta")
    load_jax_params(g, jstate.params_g, device="cpu")
    enc = ResNeXt50Encoder(out_dim=32, layers=ENC_LAYERS, device="meta")
    load_jax_params(enc, jstate.params_e, jstate.state_e, device="cpu")
    disc = Discriminator(**TINY_D, device="meta")
    load_jax_params(disc, jstate.params_d, device="cpu")
    vgg = L.VGG16LPIPS(resize_to=32, device="meta")
    load_jax_params(vgg, jstate.params_vgg, device="cpu")
    cfg = T.TrainConfig(batch_size=2, neural_rendering_resolution=8, train_gen=train_gen,
                        **cfg_overrides)
    return T.init_train_state(g, enc, disc, vgg, cfg), cfg


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


_JAX_STEPS = {}


def run_jax_step(train_gen):
    """One JAX step from a seeded init: (train_gen, init state, new state,
    stats, batch); the jitted step stays in `_JAX_STEPS[train_gen]` for a
    test to take another. The JAX compile takes most of a minute, so each
    setting of train_gen has a test file of its own
    (tests/test_torch_train_gen.py has the other) and the two run on two
    workers."""
    g, enc, disc, vgg, cfg = jax_setup(train_gen)
    state = JT.init_train_state(g, enc, disc, vgg, cfg, jax.random.PRNGKey(0))
    # Without weak types, as JAX's load_train_state gives the leaves back,
    # so a step from a loaded state reuses this compile (fp32: no value moves).
    state = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)), state)
    opt_g, opt_d = JT.make_optimizers(g, state.params_e, state.params_g, cfg)
    step = _JAX_STEPS[train_gen] = jax.jit(JT.make_train_step(g, enc, disc, vgg, opt_g, opt_d,
                                                              cfg))
    batch = tiny_batch()
    new, stats = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(1))
    return train_gen, state, new, {k: float(v) for k, v in stats.items()}, batch


def assert_adam_step_matches(name, jax_new, param, opt, grad=None):
    """The first Adam step moves a weight by lr * g / (|g| + eps), i.e. by
    +-lr wherever |g| >> eps, so a weight whose gradient lies within fp32
    summation noise may move the other way in the other package. Every
    weight off rtol 1e-4 / atol 1e-5 of the JAX result must have such a
    gradient (below 3e-4 of its tensor's largest), be within one step
    (2 lr) of it, and be one of under 1% of the tensor's weights. `grad` is
    the step's gradient (default: the first step's, exp_avg / 0.1)."""
    got, want = to_np(param), np.asarray(jax_new)
    off = ~np.isclose(got, want, **TOL)
    if not off.any():
        return
    if grad is None:
        grad = to_np(opt.state[param]["exp_avg"]) / 0.1
    grad = np.abs(grad)
    assert off.mean() < 0.01, (name, off.mean())
    assert grad[off].max() < 3e-4 * grad.max(), (name, grad[off].max() / grad.max())
    assert np.abs(got - want).max() <= 2 * opt.param_groups[0]["lr"] + 1e-5, name


@pytest.fixture(scope="module")
def jax_step():
    return run_jax_step(False)


def check_step_matches_jax(jax_step):
    """Every stat, E, G (+ G_ema), D and the BN running statistics after one
    step with rng=None equal the JAX make_train_step's."""
    train_gen, jstate, jnew, jstats, batch = jax_step
    state, cfg = port_state(jstate, train_gen)
    step = T.make_train_step(cfg)
    _, stats = step(state, torch_batch(batch), None)
    assert sorted(stats) == sorted(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), v, **TOL, err_msg=k)
    assert state.cur_nimg == int(jnew.cur_nimg) == 2

    def check(jtree_new, module, root):
        new_flat = flatten_tree(jtree_new)
        params = {n.replace(".", "/"): p for n, p in module.named_parameters()}
        bufs = module_params(module)
        assert set(new_flat) <= set(bufs), sorted(set(new_flat) - set(bufs))[:5]
        for k, v in new_flat.items():
            if k in params and state.opt_g is not None and params[k] in state.opt_g.state:
                assert_adam_step_matches(f"{root}/{k}", v, params[k], state.opt_g)
            else:
                np.testing.assert_allclose(bufs[k], np.asarray(v), **TOL, err_msg=f"{root}/{k}")

    check(jnew.params_e, state.enc, "E")
    check(jnew.state_e, state.enc, "E_state")
    check(jnew.params_g, state.g, "G")
    check(jnew.params_d, state.disc, "D")
    # G_ema moves by (1 - beta) = 1.4e-4 of each G update: rtol / atol.
    ema = module_params(state.g_ema)
    for k, v in flatten_tree(jnew.params_g_ema).items():
        np.testing.assert_allclose(ema[k], np.asarray(v), **TOL, err_msg=f"G_ema/{k}")


def test_train_step_matches_jax(jax_step):
    """G frozen (the G-NeRF default): E and G's mapping train."""
    check_step_matches_jax(jax_step)


def check_trainable_set(jax_step):
    """E trains; with G frozen only its mapping trains (z_dim != 512), and
    every other G weight stays bitwise where it was, in both packages; D's
    weights get one gradient per step, from the D loss alone (none from the
    G loss, though D runs inside it)."""
    train_gen, jstate, jnew, _, batch = jax_step
    state, cfg = port_state(jstate, train_gen)
    before = {k: v.clone() for k, v in state.g.state_dict().items()}
    assert all(p.requires_grad for p in state.enc.parameters())
    for name, p in state.g.named_parameters():
        assert p.requires_grad == (train_gen or name.startswith("backbone.mapping.")), name
    d_grads = {name: 0 for name, _ in state.disc.named_parameters()}
    for name, p in state.disc.named_parameters():
        p.register_hook(lambda g, name=name: d_grads.__setitem__(name, d_grads[name] + 1))
    T.make_train_step(cfg)(state, torch_batch(batch), None)
    assert set(d_grads.values()) == {1}, d_grads
    jold, jnew_flat = flatten_tree(jstate.params_g), flatten_tree(jnew.params_g)
    for k, v in state.g.state_dict().items():
        frozen = not train_gen and not k.startswith("backbone.mapping.")
        if frozen:
            assert torch.equal(v, before[k]), k
            jk = k.replace(".", "/")
            if jk in jold:
                assert np.array_equal(np.asarray(jold[jk]), np.asarray(jnew_flat[jk])), jk
        elif k.endswith("weight") and "mapping.fc" in k:
            assert not torch.equal(v, before[k]), k


def test_trainable_set_and_frozen_parameters(jax_step):
    check_trainable_set(jax_step)


def _fresh_port(seed=0, train_gen=True, **cfg_overrides):
    g, enc, disc, vgg, _ = jax_setup(train_gen)
    jstate = JT.init_train_state(g, enc, disc, vgg,
                                 JT.TrainConfig(batch_size=2, neural_rendering_resolution=8),
                                 jax.random.PRNGKey(seed))
    return port_state(jstate, train_gen, **cfg_overrides)


@pytest.fixture(scope="module")
def jax_init_state():
    g, enc, disc, vgg, cfg = jax_setup(True)
    return JT.init_train_state(g, enc, disc, vgg, cfg, jax.random.PRNGKey(0))


def _after_one_step(jstate, rng_seed, **cfg_overrides):
    state, cfg = port_state(jstate, True, **cfg_overrides)
    step = T.make_train_step(cfg)
    step(state, torch_batch(tiny_batch()), prng.PRNGKey(rng_seed))
    return state


def _state_tensors(state):
    out = {}
    for name in ("g", "g_ema", "enc", "disc"):
        out.update({f"{name}.{k}": v for k, v in getattr(state, name).state_dict().items()})
    for name in ("opt_g", "opt_d"):
        opt = getattr(state, name)
        for i, p in enumerate(p for grp in opt.param_groups for p in grp["params"]):
            for k, v in opt.state.get(p, {}).items():
                out[f"{name}.{i}.{k}"] = v
    return out


@pytest.mark.parametrize("what", ["synthesis", "lpips"])
def test_remat_gives_the_same_step(jax_init_state, what):
    """With a key (random noise, jittered and importance samples), the step
    with the synthesis or the fakes' VGG pass rematerialised equals the
    step without, bit for bit: the recompute draws from the forward's keys,
    so it redraws the forward's random numbers."""
    plain = _state_tensors(_after_one_step(jax_init_state, 11))
    remat = _state_tensors(_after_one_step(jax_init_state, 11, **{f"remat_{what}": True}))
    assert plain.keys() == remat.keys()
    for k in plain:
        torch.testing.assert_close(remat[k], plain[k], rtol=0, atol=0, msg=k)


def test_resume_is_bit_identical(jax_init_state, tmp_path):
    """step, save, load into fresh modules, step == two uninterrupted steps,
    bit for bit (parameters, buffers, G_ema, both Adam states, cur_nimg)."""
    batches = [torch_batch(tiny_batch(0)), torch_batch(tiny_batch(2))]

    def run(state, cfg, i):
        T.make_train_step(cfg)(state, batches[i], step_key(0, state.cur_nimg))

    a, cfg = port_state(jax_init_state, True)
    run(a, cfg, 0)
    run(a, cfg, 1)
    b, _ = port_state(jax_init_state, True)
    run(b, cfg, 0)
    path = str(tmp_path / "state.npz")
    T.save_train_state(path, b, config={"x": 1}, best_ssim=0.25)
    c, _ = _fresh_port(seed=3)
    _, config, best = T.load_train_state(path, c)
    assert config == {"x": 1, "best_ssim": 0.25} and best == 0.25 and c.cur_nimg == 2
    run(c, cfg, 1)
    assert c.cur_nimg == a.cur_nimg == 4
    sa, sc = _state_tensors(a), _state_tensors(c)
    assert sa.keys() == sc.keys()
    for k in sa:
        assert sa[k].dtype == sc[k].dtype and torch.equal(sa[k], sc[k]), k


def test_jax_full_state_resumes_in_port(jax_step, tmp_path):
    """JAX steps once and its `save_train_state` writes the file; the port's
    `load_train_state` reads it (every leaf bit for bit) and steps once
    more: equal to JAX's step from its own `load_train_state` of the file
    (stats, E, its BN statistics, G, G_ema, D, cur_nimg), the trained
    weights under the Adam-flip rule with the second step's gradient."""
    _, jstate, jnew, _, _ = jax_step
    path = str(tmp_path / "jax_state.npz")
    JT.save_train_state(path, jnew, config={"best_ssim": 0.3})
    resumed, config = JT.load_train_state(path, jnew)
    assert config == {"best_ssim": 0.3}
    batch = tiny_batch(2)
    jnext, jstats = _JAX_STEPS[False](resumed, {k: jnp.asarray(v) for k, v in batch.items()},
                                      jax.random.PRNGKey(2))

    state, cfg = port_state(jstate, False)
    _, config, best = T.load_train_state(path, state)
    assert best == 0.3 and state.cur_nimg == 2
    plan = jax_state.leaf_plan(state)
    for leaf, (path_, x) in zip(plan, jax.tree_util.tree_flatten_with_path(jnew)[0]):
        assert leaf.path == jax.tree_util.keystr(path_)
        np.testing.assert_array_equal(jax_state.leaf_value(leaf), np.asarray(x),
                                      err_msg=leaf.path)
    first = {id(p): to_np(state.opt_g.state[p]["exp_avg"]).copy()
             for p in state.opt_g.state}
    _, stats = T.make_train_step(cfg)(state, torch_batch(batch), None)
    assert sorted(stats) == sorted(jstats) and state.cur_nimg == int(jnext.cur_nimg) == 4
    for k, v in jstats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), **TOL, err_msg=k)
    params = {n.replace(".", "/"): p for m in (state.enc, state.g)
              for n, p in m.named_parameters()}

    def grad(p):  # beta1 = 0.9: m2 = 0.9 m1 + 0.1 g2
        return (to_np(state.opt_g.state[p]["exp_avg"]) - 0.9 * first[id(p)]) / 0.1

    for root, tree, module in (("E", jnext.params_e, state.enc), ("G", jnext.params_g, state.g),
                               ("E_state", jnext.state_e, state.enc),
                               ("D", jnext.params_d, state.disc)):
        got = module_params(module)
        for k, v in flatten_tree(tree).items():
            p = params.get(k) if root in ("E", "G") else None
            if p is not None and p in state.opt_g.state:
                assert_adam_step_matches(f"{root}/{k}", v, p, state.opt_g, grad=grad(p))
            else:
                np.testing.assert_allclose(got[k], np.asarray(v), **TOL, err_msg=f"{root}/{k}")
    ema = module_params(state.g_ema)
    for k, v in flatten_tree(jnext.params_g_ema).items():
        np.testing.assert_allclose(ema[k], np.asarray(v), **TOL, err_msg=f"G_ema/{k}")


def test_port_full_state_loads_in_jax(jax_init_state, tmp_path, capsys):
    """A file the port wrote after a step loads in the JAX `load_train_state`
    without a cast warning, every leaf equal to the port's tensor (module
    entries, Adam step and moments, cur_nimg) bit for bit, best_ssim in its
    config."""
    state, cfg = port_state(jax_init_state, True)
    T.make_train_step(cfg)(state, torch_batch(tiny_batch()), step_key(0, 0))
    path = str(tmp_path / "port_state.npz")
    T.save_train_state(path, state, config={"k": "v"}, best_ssim=0.4)
    capsys.readouterr()
    loaded, config = JT.load_train_state(path, jax_init_state)
    assert "WARNING" not in capsys.readouterr().out
    assert config == {"k": "v", "best_ssim": 0.4}
    params = {id(p) for grp in state.opt_g.param_groups for p in grp["params"]}
    leaves = jax.tree_util.tree_flatten_with_path(loaded)[0]
    plan = jax_state.leaf_plan(state)
    assert len(leaves) == len(plan) and {leaf.kind for leaf in plan} == {
        "entry", "exp_avg", "exp_avg_sq", "step", "cur_nimg"}
    for leaf, (path_, x) in zip(plan, leaves):
        x = np.asarray(x)
        if leaf.kind == "entry":
            want = to_np(leaf.tensor)
        elif leaf.kind == "cur_nimg":
            want = np.asarray(state.cur_nimg, np.int32)
        elif leaf.kind == "step":
            opt = leaf.owner
            want = np.asarray(int(opt.state[opt.param_groups[0]["params"][0]]["step"]),
                              np.int32)
            assert int(want) == 1
        elif leaf.tensor is None:  # w_avg: a buffer, no moment
            want = np.zeros(leaf.shape, np.float32)
        else:
            assert id(leaf.tensor) in params or leaf.owner is state.opt_d
            want = to_np(leaf.owner.state[leaf.tensor][leaf.kind])
        assert x.dtype == want.dtype and np.array_equal(x, want), leaf.path
        assert jax.tree_util.keystr(path_) == leaf.path


def test_old_layout_resumes_bit_for_bit(jax_init_state, tmp_path):
    """A `train_state_torch` file (the port's layout before it wrote JAX's,
    `tests/_torch_state.py`'s copy of that writer) still resumes bit for
    bit, and a file written after it is JAX's layout. Such a file holds no
    Adam state for G's noise_const (that port's Adam skipped a parameter
    the loss did not reach under random noise): the load gives it the
    others' step and zero moments, as optax holds it."""
    batches = [torch_batch(tiny_batch(0)), torch_batch(tiny_batch(2))]

    def run(state, cfg, i):
        T.make_train_step(cfg)(state, batches[i], step_key(0, state.cur_nimg))

    a, cfg = port_state(jax_init_state, True)
    run(a, cfg, 0)
    run(a, cfg, 1)
    b, _ = port_state(jax_init_state, True)
    run(b, cfg, 0)
    unreached = [p for n, p in b.g.named_parameters() if n.endswith("noise_const")]
    assert unreached
    for p in unreached:
        assert not b.opt_g.state[p]["exp_avg"].any()
        del b.opt_g.state[p]
    path = str(tmp_path / "old.npz")
    save_train_state_torch(path, b, config={"x": 1}, best_ssim=0.25)
    c, _ = _fresh_port(seed=3)
    _, config, best = T.load_train_state(path, c)
    assert config == {"x": 1} and best == 0.25 and c.cur_nimg == 2
    run(c, cfg, 1)
    sa, sc = _state_tensors(a), _state_tensors(c)
    assert sa.keys() == sc.keys()
    for k in sa:
        assert sa[k].dtype == sc[k].dtype and torch.equal(sa[k], sc[k]), k
    T.save_train_state(path, c)
    assert set(jckpt.load_checkpoint(path)[0]) == {"train_state"}
    d, _ = _fresh_port(seed=4)
    T.load_train_state(path, d)
    sd = _state_tensors(d)
    assert sd.keys() == sc.keys() and all(torch.equal(sd[k], sc[k]) for k in sc)


def test_port_snapshot_loads_in_jax(jax_init_state, tmp_path):
    """A port snapshot has the JAX key layout: every tree copies into fresh
    JAX trees with no missing or extra leaf."""
    state, _ = port_state(jax_init_state, False)
    path = str(tmp_path / "snap.npz")
    T.save_snapshot(path, state, config={"k": "v"})
    trees, config = jckpt.load_checkpoint(path)
    assert config == {"k": "v"}
    g, enc, disc, vgg, _ = jax_setup(False)
    params_e, state_e = enc.init(jax.random.PRNGKey(9))
    fresh = {"G_ema": g.init(jax.random.PRNGKey(9)), "G": g.init(jax.random.PRNGKey(9)),
             "E": params_e, "E_state": state_e, "D": disc.init(jax.random.PRNGKey(9))}
    assert set(trees) == set(fresh)
    for name, tree in fresh.items():
        assert set(jckpt.flatten_tree(trees[name])) == set(jckpt.flatten_tree(tree)), name
        copied = jckpt.flatten_tree(jckpt.copy_params(trees[name], tree, verbose=False))
        for k, v in jckpt.flatten_tree(trees[name]).items():
            assert np.array_equal(copied[k], v), (name, k)
    np.testing.assert_array_equal(jckpt.flatten_tree(trees["E_state"])["bn1/var"],
                                  to_np(state.enc.bn1.var))


def _jax_resume(jstate, path):
    """The JAX CLI's resume from a network snapshot
    (`gnerf_tpu/training/train.py:893-912`) on a JAX TrainState."""
    trees, _ = jckpt.load_checkpoint(path)
    if "G_ema" in trees:
        jstate = jstate.replace(
            params_g=jckpt.copy_params(trees["G_ema"], jstate.params_g),
            params_g_ema=jckpt.copy_params(trees["G_ema"], jstate.params_g_ema))
    if "E" in trees:
        jstate = jstate.replace(params_e=jckpt.copy_params(trees["E"], jstate.params_e))
    if "D" in trees:
        jstate = jstate.replace(params_d=jckpt.copy_params(trees["D"], jstate.params_d))
    return jstate


def _assert_resumed_as_jax(state, jstate):
    for module, trees in ((state.g, [jstate.params_g]), (state.g_ema, [jstate.params_g_ema]),
                          (state.enc, [jstate.params_e, jstate.state_e]),
                          (state.disc, [jstate.params_d])):
        got = module_params(module)
        want = {k: v for tree in trees for k, v in flatten_tree(tree).items()}
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


def test_jax_snapshot_resumes_port(jax_init_state, tmp_path):
    """A JAX-written snapshot (G_ema, E, E_state, D) starts the port's
    trainer as it starts the JAX one (E's BN statistics stay at init), and
    loads in the port's gen_videos.load_networks with its E_state."""
    from gnerf_tpu_torch.infer.gen_videos import load_networks
    from gnerf_tpu_torch.training.train import _resume

    rk = {k: list(v) if isinstance(v, tuple) else v for k, v in tiny_rendering_kwargs().items()}
    jstate = jax_init_state.replace(state_e=jax.tree_util.tree_map(
        lambda a: jnp.full_like(a, 0.75), jax_init_state.state_e))
    path = str(tmp_path / "jax_snap.npz")
    JT.save_snapshot(path, jstate, config={"generator": dict(TINY_G, rendering_kwargs=rk),
                                           "encoder": {"layers": list(ENC_LAYERS)}})
    state, _ = _fresh_port(seed=4)
    assert _resume(state, path, state.disc) is None
    g, enc, disc, vgg, _ = jax_setup(True)
    fresh = JT.init_train_state(g, enc, disc, vgg,
                                JT.TrainConfig(batch_size=2, neural_rendering_resolution=8),
                                jax.random.PRNGKey(4))
    _assert_resumed_as_jax(state, _jax_resume(fresh, path))
    np.testing.assert_array_equal(to_np(state.enc.bn1.var), np.ones(64, np.float32))
    g, enc = load_networks(path, device="cpu", double_sampling=False)
    np.testing.assert_array_equal(to_np(g.decoder.fc0.weight),
                                  np.asarray(jstate.params_g_ema["decoder"]["fc0"]["weight"]))
    np.testing.assert_array_equal(to_np(enc.bn1.mean), np.full(64, 0.75, np.float32))


def test_eg3d_snapshot_resumes_gnerf_as_jax_does(jax_init_state, tmp_path, capsys):
    """A snapshot whose D is another network (the EG3D dual D) and whose
    E_state is not at init, resumed into G-NeRF training by the port's
    `_resume` and by the JAX CLI's code from the same fresh state: the same
    state (every D leaf the snapshot lacks or holds at another shape keeps
    its init value, E's BN statistics stay at init) and the same
    copy_params lines."""
    from gnerf_tpu.models.dual_discriminator import DualDiscriminator as JDual
    from gnerf_tpu_torch.training.train import _resume

    dual = JDual(c_dim=25, img_resolution=16, img_channels=3, channel_base=256, channel_max=64)
    path = str(tmp_path / "eg3d_snap.npz")
    jckpt.save_checkpoint(path, {
        "G_ema": jax_init_state.params_g_ema, "G": jax_init_state.params_g,
        "E": jax_init_state.params_e,
        "E_state": jax.tree_util.tree_map(lambda a: jnp.full_like(a, 0.75),
                                          jax_init_state.state_e),
        "D": dual.init(jax.random.PRNGKey(8))})
    g, enc, disc, vgg, _ = jax_setup(True)
    fresh = JT.init_train_state(g, enc, disc, vgg,
                                JT.TrainConfig(batch_size=2, neural_rendering_resolution=8),
                                jax.random.PRNGKey(4))
    capsys.readouterr()
    want = _jax_resume(fresh, path)
    want_lines = set(capsys.readouterr().out.splitlines())
    state, _ = _fresh_port(seed=4)
    assert _resume(state, path, state.disc) is None
    got_lines = set(capsys.readouterr().out.splitlines())
    assert got_lines == want_lines and any("shape mismatch" in x for x in got_lines)
    assert any("missing in src" in x for x in got_lines)
    _assert_resumed_as_jax(state, want)


# ---------------------------------------------------------------------------
# Datasets


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


def test_synthetic_dataset_and_batches_match_jax():
    jd = jds.SyntheticDataset(resolution=32, depth_resolution=8, size=10, seed=3)
    td = tds.SyntheticDataset(resolution=32, depth_resolution=8, size=10, seed=3)
    assert len(jd) == len(td) == 10 and td.label_dim == 25
    for i in (0, 7):
        _assert_items_equal(td[i], jd[i])
    jit, tit = jds.data_iterator(jd, 3, seed=5), tds.data_iterator(td, 3, seed=5)
    for _ in range(4):
        _assert_items_equal(next(tit), next(jit))


@pytest.mark.parametrize("manifest", [False, True])
def test_held_out_partition_matches_jax(tmp_path, manifest):
    names = [f"/data/img{i:03d}.jpg" for i in range(40)]
    man = None
    if manifest:
        man = str(tmp_path / "held.txt")
        with open(man, "w") as fh:
            fh.write("img003.jpg\nimg017.jpg\n")
    assert tds.held_out_partition(names, 7, man) == jds.held_out_partition(names, 7, man)


def _write_ffhq_layout(root):
    """Synthesized pairs and real crops at the loader's resolution (16^2)."""
    from PIL import Image

    rs = np.random.RandomState(0)
    gen, real = os.path.join(root, "gen"), os.path.join(root, "real")
    poses, depths = {}, {}
    for i in range(3):
        name = f"{i:05d}"
        os.makedirs(os.path.join(gen, name))
        for side in ("f", "s"):
            Image.fromarray(rs.randint(0, 256, (16, 16, 3), np.uint8)).save(
                os.path.join(gen, name, f"{name}_{side}.jpg"), quality=90)
            poses[f"{name}_{side}.json"] = rs.randn(25).tolist()
            depths[f"{name}_{side}"] = rs.rand(1, 8, 8).astype(np.float32)
    with open(os.path.join(gen, "pose_labels.json"), "w") as fh:
        json.dump(poses, fh)
    np.save(os.path.join(gen, "depth_images.npy"), depths, allow_pickle=True)
    os.makedirs(os.path.join(real, "cropped_image"))
    os.makedirs(os.path.join(real, "label"))
    labels = {}
    for i in range(5):
        Image.fromarray(rs.randint(0, 256, (16, 16, 3), np.uint8)).save(
            os.path.join(real, "cropped_image", f"r{i}.jpg"), quality=90)
        labels[f"r{i}.png"] = rs.randn(25).tolist()
    with open(os.path.join(real, "label", "labels.json"), "w") as fh:
        json.dump(labels, fh)
    return gen, real


def test_ffhq_gen_dataset_matches_jax(tmp_path):
    gen, real = _write_ffhq_layout(str(tmp_path))
    kw = dict(path=gen, real_path=real, resolution=16, held_out=1, seed=2)
    jd, td = jds.FFHQGenDataset(**kw), tds.FFHQGenDataset(**kw)
    assert len(jd) == len(td) == 4
    for i in range(10):  # both branches; the item RNG stays in step
        _assert_items_equal(td[i % 4], jd[i % 4])
    jd, td = jds.FFHQGenDataset(**kw), tds.FFHQGenDataset(**kw)
    jit, tit = jds.data_iterator(jd, 2, seed=1), tds.data_iterator(td, 2, seed=1)
    for _ in range(3):
        _assert_items_equal(next(tit), next(jit))
