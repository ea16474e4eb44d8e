"""The JAX package's full training state, leaf for leaf, without JAX.

`gnerf_tpu/training/train_loop.py::save_train_state` stores
`jax.tree_util.tree_leaves(state)` of a G-NeRF `TrainState` or an EG3D state
dict as `train_state/{i:05d}`, beside the run's options as `__config__`;
`load_train_state` restores them into a template state of the same config.
This module gives the port's `TrainState` / `EG3DState` that layout: its
`leaf_plan` lists, in JAX's flatten order, each leaf's JAX key path (as
`jax.tree_util.keystr` prints it), the port tensor or scalar behind it, and
its shape and dtype. Saving, loading and naming a file's leaves are built on
that plan.

JAX's flatten order, which the plan follows:

- A G-NeRF `TrainState` is a flax `PyTreeNode`: its fields in their order,
  `params_e`, `state_e`, `params_g`, `params_g_ema`, `params_d`,
  `params_vgg`, `opt_state_g`, `opt_state_d`, `cur_nimg` (int32).
- An EG3D state is a dict: its keys sorted, `cur_nimg`, `opt_state_d`,
  `opt_state_g`, `params_d`, `params_g`, `params_g_ema`.
- A parameter tree is a nested dict, flattened in sorted key order at every
  level; a module's `state_dict` names are its paths with `.` for `/`. E's
  tree splits into `params_e` and its BN statistics `state_e` as
  `checkpoint.encoder_trees` splits it.
- An Adam state is `ScaleByAdamState(count, mu, nu)`: the step count
  (int32), then the first and second moments over the optimizer's tree.
  Under `optax.multi_transform({"train": adam, "freeze": set_to_zero()})`
  (G-NeRF's `opt_g` over `{"e": E, "g": G}`; EG3D's `opt_d` under Freeze-D)
  it sits at `.inner_states['train'].inner_state[0]` and the moments cover
  the trainable leaves alone; the `freeze` branch has no leaves, and the
  count is there even when nothing trains. A plain `optax.adam` puts it at
  `[0]`.

The port's Adam holds `exp_avg` (= mu), `exp_avg_sq` (= nu) and `step`
(= count) per parameter. A buffer inside a trainable subtree (the mapping's
`w_avg`) is a leaf of JAX's moment trees, whose gradient is zero: the port
keeps no moment for it, writes zeros and refuses a nonzero one. With nothing
to train the port has no optimizer, and the count it writes is 0 (it scales
no update there). lr, betas and eps are not stored: both packages take them
from the run's config.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ..utils.checkpoint import unflatten_tree

_TRAIN = ".inner_states['train'].inner_state[0]"


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One leaf of JAX's full training state and what the port holds for it.

    `kind` is "entry" (a module's state_dict entry, `tensor`), "exp_avg" /
    "exp_avg_sq" (the Adam moment of parameter `tensor` in `owner`, an
    optimizer; `tensor` None for a buffer's moment), "step" (`owner`'s step,
    None without an optimizer) or "cur_nimg" (of `owner`, the state). `name`
    is the port's name for it, `/`-joined: `enc/bn1/mean`,
    `opt_g/exp_avg/g/backbone/...`, `opt_d/step`, `cur_nimg`."""

    path: str
    name: str
    kind: str
    owner: Any
    tensor: Optional[torch.Tensor]
    shape: tuple
    dtype: np.dtype


def _keystr(*keys: str) -> str:
    return "".join(f"[{k!r}]" for k in keys)


def _every(name: str) -> bool:
    return True


def _is_bn_stat(name: str) -> bool:
    return name.endswith((".mean", ".var"))


def _is_param_e(name: str) -> bool:
    return not _is_bn_stat(name)


def _stepped(opt) -> set:
    """ids of the parameters `opt` steps (none for no optimizer)."""
    return set() if opt is None else {id(p) for grp in opt.param_groups for p in grp["params"]}


def _sorted_entries(module: nn.Module, keep=_every) -> list[tuple[str, torch.Tensor]]:
    """A module's state_dict entries in JAX's order: sorted key by key."""
    entries = [(k, v) for k, v in module.state_dict(keep_vars=True).items() if keep(k)]
    return sorted(entries, key=lambda kv: tuple(kv[0].split(".")))


def _entry_leaves(prefix: str, attr: str, module: Optional[nn.Module],
                  keep=_every) -> list[Leaf]:
    if module is None:
        return []
    return [Leaf(prefix + _keystr(*k.split(".")), f"{attr}/{k.replace('.', '/')}", "entry",
                 module, v, tuple(v.shape), _np_dtype(v.dtype))
            for k, v in _sorted_entries(module, keep)]


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).replace("torch.", ""))


def _adam_tree(opt: Optional[torch.optim.Optimizer],
               trees: list[tuple[Optional[str], str, nn.Module, Any]]) -> list:
    """(JAX key path below mu / nu, port name, parameter or None) of each
    leaf of an Adam moment tree: each entry of `trees` is (the tree's key in
    the optimizer's params, or None for a bare tree; the module's attribute;
    the module; a filter of its state_dict names), in JAX's order. An entry
    is in the tree when the optimizer steps it, or, for a buffer, when it
    steps every parameter of the buffer's module (JAX's mask covers that
    subtree)."""
    stepped = _stepped(opt)
    out = []
    for key, attr, module, keep in trees:
        params = dict(module.named_parameters())
        for name, value in _sorted_entries(module, keep):
            if name in params:
                if id(params[name]) not in stepped:
                    continue
                tensor = params[name]
            else:
                owner = module.get_submodule(name.rpartition(".")[0])
                owned = [id(p) for p in owner.parameters()]
                if not owned or not set(owned) <= stepped:
                    continue
                tensor = None
            path = _keystr(*([key] if key else []), *name.split("."))
            out.append((path, f"{attr}/{name.replace('.', '/')}", tensor, value))
    return out


def _adam_leaves(prefix: str, attr: str, opt, trees) -> list[Leaf]:
    """count, mu, nu of one ScaleByAdamState at `prefix`."""
    tree = _adam_tree(opt, trees)
    leaves = [Leaf(f"{prefix}.count", f"{attr}/step", "step", opt, None, (), np.dtype(np.int32))]
    for moment, kind in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        leaves += [Leaf(f"{prefix}.{moment}{path}", f"{attr}/{kind}/{name}", kind, opt, tensor,
                        tuple(value.shape), np.dtype(np.float32))
                   for path, name, tensor, value in tree]
    return leaves


def leaf_plan(state) -> list[Leaf]:
    """The leaves of `state` (a G-NeRF `TrainState` or an `EG3DState`) in
    the order of `jax.tree_util.tree_leaves` of the JAX package's state of
    the same config (see the module docstring)."""
    from .eg3d_loss import EG3DState

    cur = Leaf(".cur_nimg", "cur_nimg", "cur_nimg", state, None, (), np.dtype(np.int32))
    if isinstance(state, EG3DState):
        # Freeze-D (a strict subset of D stepped) is optax's multi_transform.
        masked = not {id(p) for p in state.disc.parameters()} <= _stepped(state.opt_d)
        return [
            dataclasses.replace(cur, path="['cur_nimg']"),
            *_adam_leaves("['opt_state_d']" + (_TRAIN if masked else "[0]"), "opt_d",
                          state.opt_d, [(None, "disc", state.disc, _every)]),
            *_adam_leaves("['opt_state_g'][0]", "opt_g", state.opt_g,
                          [(None, "g", state.g, _every)]),
            *_entry_leaves("['params_d']", "disc", state.disc),
            *_entry_leaves("['params_g']", "g", state.g),
            *_entry_leaves("['params_g_ema']", "g_ema", state.g_ema),
        ]
    leaves = [
        *_entry_leaves(".params_e", "enc", state.enc, _is_param_e),
        *_entry_leaves(".state_e", "enc", state.enc, _is_bn_stat),
        *_entry_leaves(".params_g", "g", state.g),
        *_entry_leaves(".params_g_ema", "g_ema", state.g_ema),
        *_entry_leaves(".params_d", "disc", state.disc),
        *_entry_leaves(".params_vgg", "vgg", state.vgg),
        *_adam_leaves(".opt_state_g" + _TRAIN, "opt_g", state.opt_g,
                      [("e", "enc", state.enc, _is_param_e), ("g", "g", state.g, _every)]),
    ]
    if state.disc is not None:
        leaves += _adam_leaves(".opt_state_d[0]", "opt_d", state.opt_d,
                               [(None, "disc", state.disc, _every)])
    return leaves + [cur]


def _step_count(opt) -> int:
    """The step every parameter of `opt` has taken (0 before the first);
    raises, naming the parameter, when they disagree."""
    if opt is None:
        return 0
    params = [p for grp in opt.param_groups for p in grp["params"]]
    steps = [int(opt.state[p]["step"]) if p in opt.state else 0 for p in params]
    if any(s != steps[0] for s in steps):
        i = next(i for i, s in enumerate(steps) if s != steps[0])
        raise ValueError(f"the optimizer's parameters disagree on their step: parameter {i} "
                         f"{tuple(params[i].shape)} is at {steps[i]}, parameter 0 at "
                         f"{steps[0]}; JAX's Adam keeps one count")
    return steps[0]


def leaf_value(leaf: Leaf) -> np.ndarray:
    """The value the port holds for `leaf`, as the file stores it."""
    if leaf.kind == "entry":
        return leaf.tensor.detach().cpu().numpy()
    if leaf.kind == "cur_nimg":
        return np.asarray(leaf.owner.cur_nimg, np.int32)
    if leaf.kind == "step":
        return np.asarray(_step_count(leaf.owner), np.int32)
    moment = None if leaf.tensor is None else leaf.owner.state.get(leaf.tensor, {}).get(leaf.kind)
    if moment is None:  # never stepped, or a buffer: zero, as optax's init
        return np.zeros(leaf.shape, leaf.dtype)
    return moment.detach().cpu().numpy()


def state_leaves(state) -> dict[str, np.ndarray]:
    """{"00000": leaf, ...}: `state` as the JAX package's `save_train_state`
    stores it under `train_state`."""
    return {f"{i:05d}": leaf_value(leaf) for i, leaf in enumerate(leaf_plan(state))}


def checked_leaves(plan: list[Leaf], flat: dict) -> list[np.ndarray]:
    """The leaves of a `train_state` tree in plan order, checked as the JAX
    `load_train_state` checks them against its template: the leaf count and
    each leaf's shape (raising, in its words), and each dtype (cast, with
    its WARNING line)."""
    if len(flat) != len(plan):
        raise ValueError(f"checkpoint has {len(flat)} leaves, template has {len(plan)} "
                         "— config mismatch")
    out = []
    for i, leaf in enumerate(plan):
        arr = np.asarray(flat[f"{i:05d}"])
        if arr.shape != leaf.shape:
            raise ValueError(f"checkpoint leaf {i} ({leaf.path}) has shape {arr.shape}, "
                             f"template expects {leaf.shape} — config mismatch")
        if arr.dtype != leaf.dtype:
            print(f"WARNING: load_train_state casting {leaf.path} {arr.dtype} -> {leaf.dtype}")
            arr = arr.astype(leaf.dtype)
        out.append(arr)
    return out


def adam_step(count: int) -> torch.Tensor:
    """A step as torch's (non-fused) Adam keeps it: a CPU scalar of the
    default float dtype."""
    return torch.tensor(float(count), dtype=torch.get_default_dtype())


@torch.no_grad()
def restore_leaves(state, flat: dict) -> None:
    """Fill `state` in place from a `train_state` tree (JAX's layout):
    module entries, Adam moments and steps, cur_nimg. Every leaf is checked
    before any is written."""
    plan = leaf_plan(state)
    values = checked_leaves(plan, flat)
    for leaf, arr in zip(plan, values):
        if leaf.tensor is None and leaf.kind in ("exp_avg", "exp_avg_sq") and arr.any():
            raise ValueError(f"{leaf.path}: the port keeps no Adam moment for the buffer "
                             f"{leaf.name}, and the checkpoint's is not zero")
    for leaf, arr in zip(plan, values):
        if leaf.kind == "entry":
            leaf.tensor.copy_(torch.from_numpy(arr))
        elif leaf.kind == "cur_nimg":
            leaf.owner.cur_nimg = int(arr)
        elif leaf.kind == "step" and leaf.owner is not None:
            for grp in leaf.owner.param_groups:
                for p in grp["params"]:
                    leaf.owner.state[p]["step"] = adam_step(int(arr))
        elif leaf.kind in ("exp_avg", "exp_avg_sq") and leaf.tensor is not None:
            p = leaf.tensor
            leaf.owner.state[p][leaf.kind] = torch.from_numpy(arr).to(
                device=p.device, dtype=p.dtype).contiguous()


def named_trees(flat: dict, state) -> dict:
    """A `train_state` tree's leaves by the port's names, as nested dicts:
    `{"cur_nimg": ..., "g": {...}, "enc": {...}, "opt_g": {"step": ...,
    "exp_avg": {"g": ...}, ...}, ...}`, `state` giving the layout (a state
    built on `meta` will do)."""
    plan = leaf_plan(state)
    return unflatten_tree({leaf.name: arr for leaf, arr in zip(plan, checked_leaves(plan, flat))})
