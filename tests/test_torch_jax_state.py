"""The port's full-state layout (gnerf_tpu_torch.training.jax_state) vs the
JAX package's training state, at the tiny widths of
tests/test_torch_training.py (G-NeRF) and tests/_torch_eg3d.py (EG3D).

JAX's states come from `jax.eval_shape` of its inits (no arrays are drawn,
nothing is jitted); the port's are built on `meta`. The port's leaf plan
equals `jax.tree_util.tree_flatten_with_path` of JAX's state: the key paths
as `keystr` prints them, every shape and dtype. A file of another config is
refused with the JAX `load_train_state`'s words, naming the leaf, and a
dtype is cast with its WARNING line.
"""

import numpy as np
import pytest
import torch

import jax

import _torch_eg3d as TE
import test_torch_training as TT
from _torch_port import one_torch_thread  # noqa: F401
from gnerf_tpu.models import Discriminator as JD
from gnerf_tpu.models import ResNeXt50Encoder as JEnc
from gnerf_tpu.training import eg3d_loss as JE
from gnerf_tpu.training import train_loop as JT
from gnerf_tpu.utils import checkpoint as jckpt
from gnerf_tpu_torch.models import (Discriminator, DualDiscriminator, ResNeXt50Encoder,
                                    TriPlaneGenerator)
from gnerf_tpu_torch.training import eg3d_loss as E
from gnerf_tpu_torch.training import jax_state
from gnerf_tpu_torch.training import losses as L
from gnerf_tpu_torch.training import train_loop as T
from gnerf_tpu_torch.utils.checkpoint import materialize

GNERF_CASES = {
    # z_dim 32 != 512: G's mapping trains beside E.
    "mapping": dict(z_dim=32),
    "train_gen": dict(z_dim=32, train_gen=True),
    # z_dim 512 with G frozen: E alone.
    "encoder_only": dict(z_dim=512),
    "no_d": dict(z_dim=32, disc=False),
    # Nothing trains: optax keeps the count of an empty tree.
    "nothing": dict(z_dim=32, train_en=False),
}
EG3D_CASES = {f"{mode}_freeze{n}": dict(lazy=mode == "lazy", freeze_d_layers=n)
              for mode in ("lazy", "fused") for n in (0, 2)}


def _gnerf_states(z_dim, train_gen=False, train_en=True, disc=True, device="meta"):
    """(JAX TrainState of ShapeDtypeStructs, the port's TrainState)."""
    g_kw = dict(TT.TINY_G, z_dim=z_dim)
    jg = TT.JGenNoRng(**g_kw, rendering_kwargs=TT.tiny_rendering_kwargs())
    jenc = JEnc(out_dim=z_dim, layers=TT.ENC_LAYERS, groups_as_dense=False)
    jdisc = JD(**TT.TINY_D) if disc else None
    jvgg = JT.L.VGG16LPIPS(resize_to=32)
    jcfg = JT.TrainConfig(batch_size=2, neural_rendering_resolution=8, train_gen=train_gen,
                          train_en=train_en, gan_depth=disc)
    jstate = jax.eval_shape(lambda: JT.init_train_state(jg, jenc, jdisc, jvgg, jcfg,
                                                        jax.random.PRNGKey(0)))

    def build(module):
        return module if device == "meta" else materialize(module, device)

    g = build(TriPlaneGenerator(**g_kw, rendering_kwargs=TT.tiny_rendering_kwargs(),
                                device="meta"))
    enc = build(ResNeXt50Encoder(out_dim=z_dim, layers=TT.ENC_LAYERS, device="meta"))
    d = build(Discriminator(**TT.TINY_D, device="meta")) if disc else None
    vgg = build(L.VGG16LPIPS(resize_to=32, device="meta"))
    cfg = T.TrainConfig(batch_size=2, neural_rendering_resolution=8, train_gen=train_gen,
                        train_en=train_en, gan_depth=disc)
    return jstate, T.init_train_state(g, enc, d, vgg, cfg)


def _eg3d_states(lazy, freeze_d_layers, device="meta"):
    g, disc, jcfg = TE.jax_networks(freeze_d_layers=freeze_d_layers)
    make = JE.make_eg3d_phase_steps if lazy else JE.make_eg3d_train_step
    opt_g, opt_d = make(g, disc, jcfg)[-2:]
    jstate = jax.eval_shape(lambda: JE.init_eg3d_state(g, disc, opt_g, opt_d,
                                                       jax.random.PRNGKey(0)))

    def build(module):
        return module if device == "meta" else materialize(module, device)

    pg = build(TriPlaneGenerator(**TE.TINY_G, rendering_kwargs=TE.tiny_rendering_kwargs(),
                                 device="meta"))
    pd = build(DualDiscriminator(**TE.TINY_D, device="meta"))
    cfg = E.EG3DLossConfig(**{**TE.CFG, "freeze_d_layers": freeze_d_layers})
    return jstate, E.init_eg3d_state(pg, pd, cfg, lazy=lazy)


def _jax_leaves(jstate):
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    return [(jax.tree_util.keystr(p), tuple(x.shape), np.dtype(x.dtype)) for p, x in flat]


def _assert_plan_is_jax(jstate, state):
    want = _jax_leaves(jstate)
    got = [(leaf.path, leaf.shape, leaf.dtype) for leaf in jax_state.leaf_plan(state)]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)


@pytest.mark.parametrize("case", sorted(GNERF_CASES))
def test_gnerf_leaf_plan_is_jax_flatten_order(case):
    jstate, state = _gnerf_states(**GNERF_CASES[case])
    _assert_plan_is_jax(jstate, state)
    opt_g = [leaf.name for leaf in jax_state.leaf_plan(state) if leaf.name.startswith("opt_g")]
    assert opt_g[0] == "opt_g/step" and (len(opt_g) == 1) == (case == "nothing")


@pytest.mark.parametrize("case", sorted(EG3D_CASES))
def test_eg3d_leaf_plan_is_jax_flatten_order(case):
    jstate, state = _eg3d_states(**EG3D_CASES[case])
    _assert_plan_is_jax(jstate, state)
    masked = EG3D_CASES[case]["freeze_d_layers"] > 0
    d_count = [leaf.path for leaf in jax_state.leaf_plan(state) if leaf.name == "opt_d/step"]
    assert d_count == ["['opt_state_d'].inner_states['train'].inner_state[0].count" if masked
                       else "['opt_state_d'][0].count"]


def _zeros_file(path, jstate, config=None):
    """A `train_state` file with JAX's leaves of `jstate` (zeros)."""
    leaves = [np.zeros(s, d) for _, s, d in _jax_leaves(jstate)]
    jckpt.save_checkpoint(path, {"train_state": {f"{i:05d}": x for i, x in enumerate(leaves)}},
                          config=config)
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jstate), leaves)


def _errors(fn):
    try:
        fn()
    except ValueError as err:
        return str(err)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("other", ["train_gen", "wider_d"])
def test_file_of_another_config_is_refused_as_jax_refuses_it(tmp_path, other):
    """A G-NeRF file of another config into the mapping-only template: the
    leaf count differs (train_gen) or, at the same count, a D leaf's shape
    (channel_max 64): the same ValueError as JAX's, naming the leaf; the
    port's state is left as it was."""
    jstate, state = _gnerf_states(z_dim=32, device="cpu")
    for p in state.disc.parameters():
        torch.nn.init.normal_(p)
    if other == "train_gen":
        file_state, _ = _gnerf_states(z_dim=32, train_gen=True)
    else:
        jd = JD(**dict(TT.TINY_D, channel_max=64))
        file_state = jstate.replace(
            params_d=jax.eval_shape(lambda: jd.init(jax.random.PRNGKey(0))),
            opt_state_d=jax.eval_shape(lambda: JT.optax.adam(1e-3).init(
                jd.init(jax.random.PRNGKey(0)))))
    path = str(tmp_path / "other.npz")
    _zeros_file(path, file_state)
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jstate)
    want = _errors(lambda: JT.load_train_state(path, template))
    before = {k: v.clone() for k, v in state.disc.state_dict().items()}
    got = _errors(lambda: T.load_train_state(path, state))
    assert got == want and "config mismatch" in got
    if other == "wider_d":
        assert "params_d" in got and "checkpoint leaf" in got
    for k, v in state.disc.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_dtype_is_cast_with_jax_warning(tmp_path, capsys):
    """An EG3D file whose cur_nimg is int64 and two of whose D moments are
    float64 (an x64 run): the port casts them with the lines the JAX loader
    prints under x64, word for word, and takes the values."""
    jstate, state = _eg3d_states(lazy=True, freeze_d_layers=2, device="cpu")
    leaves = [np.zeros(s, d) for _, s, d in _jax_leaves(jstate)]
    leaves[0] = np.asarray(6, np.int64)
    plan = jax_state.leaf_plan(state)
    wide = [i for i, leaf in enumerate(plan) if leaf.name.startswith("opt_d/exp_avg/")][:2]
    for i in wide:
        leaves[i] = np.full(leaves[i].shape, 0.5, np.float64)
    path = str(tmp_path / "x64.npz")
    jckpt.save_checkpoint(path, {"train_state": {f"{i:05d}": x for i, x in enumerate(leaves)}},
                          config={"aug_p_live": 0.25})
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jstate)
    capsys.readouterr()
    with jax.enable_x64(True):
        JT.load_train_state(path, template)
    want = capsys.readouterr().out
    _, config, best = T.load_train_state(path, state)
    got = capsys.readouterr().out
    assert got == want and got.count("WARNING: load_train_state casting") == 3
    assert "['cur_nimg'] int64 -> int32" in got
    assert state.cur_nimg == 6 and config == {"aug_p_live": 0.25} and best == -100.0
    moment = state.opt_d.state[plan[wide[0]].tensor]["exp_avg"]
    assert moment.dtype == torch.float32 and bool((moment == 0.5).all())


def test_nonzero_moment_of_a_buffer_is_refused(tmp_path):
    """w_avg is a buffer of the port's mapping (its EMA is not Adam's), and a
    leaf of JAX's moment trees with a zero gradient: a file where it is not
    zero cannot be continued, and says so."""
    jstate, state = _eg3d_states(lazy=True, freeze_d_layers=0, device="cpu")
    leaves = [np.zeros(s, d) for _, s, d in _jax_leaves(jstate)]
    plan = jax_state.leaf_plan(state)
    i = next(i for i, leaf in enumerate(plan) if leaf.name == "opt_g/exp_avg/g/backbone/"
             "mapping/w_avg")
    leaves[i][0] = 1.0
    path = str(tmp_path / "w_avg.npz")
    jckpt.save_checkpoint(path, {"train_state": {f"{k:05d}": x for k, x in enumerate(leaves)}})
    err = _errors(lambda: T.load_train_state(path, state))
    assert "['opt_state_g'][0].mu['backbone']['mapping']['w_avg']" in err


def test_step_disagreement_is_refused(tmp_path):
    """JAX's Adam keeps one count: a port optimizer whose parameters are at
    different steps cannot be written, and the writer names the parameter."""
    _, state = _gnerf_states(z_dim=32, disc=False, device="cpu")
    params = [p for grp in state.opt_g.param_groups for p in grp["params"]]
    for p in params:
        state.opt_g.state[p] = {"step": torch.tensor(3.0), "exp_avg": torch.zeros_like(p),
                                "exp_avg_sq": torch.zeros_like(p)}
    state.opt_g.state[params[5]]["step"] = torch.tensor(2.0)
    err = _errors(lambda: T.save_train_state(str(tmp_path / "s.npz"), state))
    assert "parameter 5" in err and "at 2" in err


def test_named_trees_give_the_port_names(tmp_path):
    """`named_trees` reads a file's leaves by the port's names: each module's
    state_dict, both optimizers' step and moments, cur_nimg."""
    _, state = _gnerf_states(z_dim=32, device="cpu")
    for p in state.g.parameters():
        torch.nn.init.normal_(p)
    state.cur_nimg = 8
    path = str(tmp_path / "named.npz")
    T.save_train_state(path, state, config={"k": 1}, best_ssim=0.5)
    trees, config = jckpt.load_checkpoint(path)
    assert set(trees) == {"train_state"} and config == {"k": 1, "best_ssim": 0.5}
    named = jax_state.named_trees(trees["train_state"], state)
    assert set(named) == {"cur_nimg", "g", "g_ema", "enc", "disc", "vgg", "opt_g", "opt_d"}
    assert int(named["cur_nimg"]) == 8 and int(named["opt_g"]["step"]) == 0
    np.testing.assert_array_equal(named["g"]["decoder"]["fc0"]["weight"],
                                  state.g.decoder.fc0.weight.detach().numpy())
    assert set(named["opt_g"]["exp_avg"]) == {"enc", "g"}
    assert set(named["opt_g"]["exp_avg"]["g"]) == {"backbone"}
    assert named["enc"]["bn1"].keys() == {"scale", "bias", "mean", "var"}
