"""Comparisons shared by the port's distributed train-step tests
(tests/test_torch_ddp_train.py, test_torch_ddp_eg3d.py).

A snapshot is `_torch_ddp_workers.state_snapshot`'s: {module: state_dict
as numpy, 'exp_avg': {module.param: Adam's first moment}, 'update':
{module.param: the last Adam step}}; a JAX state is turned into one by
`jax_snapshot`, from its optax state.

Trained weights: Adam moves a weight by lr * m / (sqrt(v) + eps), about
lr * sign(g) on the first step, so a gradient within fp32 noise of 0 (or
of eps) moves its weight by a different amount in each run. A trained
weight off the tolerance must be within the difference of the two runs'
Adam steps (summed over the steps) and one of under 1% of the tensor.

Gradients themselves are held to GRADS, 3e-2 of each tensor's largest: the
order of fp32 sums alone moves some gradients by ~1e-2 at these tiny
widths. The encoder's train-mode BatchNorm backward is ill-conditioned, so
world 1 itself moves when the rows of its batch are reordered
(test_torch_ddp_train.py::test_world1_gradient_noise_floor), and JAX's
sharded EG3D phase differs from its one-device phase by 1.0e-2 on a
noise_strength, a scalar summed over whole feature maps
(test_torch_ddp_eg3d.py::test_jax_sharded_main_phase_equals_one_device).
A fault of the distributed step (a moment or a group taken over one rank's
rows, a gradient counted k times) moves them by tens of percent.
"""

import numpy as np

TOL = dict(rtol=1e-4, atol=1e-5)      # against JAX, as tests/test_torch_training.py
WORLDS = dict(rtol=0, atol=1e-5)      # between worlds: reduction order alone
GRADS = 3e-2                          # gradients, relative to each tensor's largest


def adam_update(m, v, step, lr, b1, b2, eps):
    """The Adam step that produced first and second moments m, v at `step`."""
    return lr * (m / (1 - b1 ** step)) / (np.sqrt(v / (1 - b2 ** step)) + eps)


def jax_snapshot(state, trees, opt_roots, hyper):
    """A JAX state as a snapshot: `trees` {module: param tree} and, from
    each optax state in `opt_roots` {state key: {tree key or None: module}},
    the first moments and the last step with the hyper-parameters
    hyper[module] = (lr, b1, b2, eps) (w_avg, which JAX keeps in the param
    tree, skipped)."""
    import jax
    import optax

    from gnerf_tpu.utils.checkpoint import flatten_tree

    snap = {module: flatten_tree(tree) for module, tree in trees.items()}
    snap["exp_avg"], snap["update"] = {}, {}
    for key, roots in opt_roots.items():
        opt_state = state[key] if isinstance(state, dict) else getattr(state, key)
        adam = [x for x in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(x, optax.ScaleByAdamState)][0]
        step = int(adam.count)
        for sub, module in roots.items():
            mu = flatten_tree(adam.mu if sub is None else adam.mu[sub])
            nu = flatten_tree(adam.nu if sub is None else adam.nu[sub])
            for k, m in mu.items():
                if hasattr(m, "dtype") and m.dtype != object and not k.endswith("w_avg"):
                    name = f"{module}.{k.replace('/', '.')}"
                    snap["exp_avg"][name] = np.asarray(m)
                    snap["update"][name] = adam_update(np.asarray(m), np.asarray(nu[k]), step,
                                                       *hyper[module])
    return snap


def assert_after_adam(name, got, want, steps_got, steps_want, tol):
    """The trained-weight rule above; steps_* list each Adam step."""
    off = ~np.isclose(got, want, **tol)
    if not off.any():
        return
    # The steps' difference, and one rounding of the weight (mapping weights
    # are stored at 1 / lr_multiplier scale, ~1e2: an ulp is 1.5e-5).
    slack = sum(np.abs(a - b) for a, b in zip(steps_got, steps_want))
    slack = slack + np.spacing(np.abs(want).astype(np.float32))
    assert off.mean() < 0.01, (name, off.mean())
    bad = off & (np.abs(got - want) > slack + tol["atol"] + tol["rtol"] * np.abs(want))
    assert not bad.any(), (name, int(bad.sum()), float(np.abs(got - want)[bad].max()))


def _flat(tree):
    return {k.replace(".", "/"): np.asarray(v) for k, v in tree.items()}


def assert_snapshot_matches(snaps, wants, tol, modules=("g", "g_ema", "enc", "disc")):
    """The last of `snaps` against the last of `wants` (snapshots after each
    of the same Adam steps), every tensor of `modules`; trained weights
    under the rule above."""
    snap, want = snaps[-1], wants[-1]
    for module in modules:
        if module not in want:
            continue
        have, ref = _flat(snap[module]), _flat(want[module])
        assert set(ref) <= set(have), sorted(set(ref) - set(have))[:5]
        for k, v in ref.items():
            key = f"{module}.{k.replace('/', '.')}"
            steps = [(s["update"][key], w["update"][key]) for s, w in zip(snaps, wants)
                     if key in s.get("update", {}) and key in w.get("update", {})]
            if module == "g_ema" or not steps:
                np.testing.assert_allclose(have[k], v, **tol, err_msg=f"{module}/{k}")
            else:
                a, b = zip(*steps)
                assert_after_adam(f"{module}/{k}", have[k], v, a, b, tol)


def grad_gaps(snap, want) -> dict:
    """Per trained tensor: max |gradient difference| / max |gradient|, the
    latter at least Adam's eps (a tensor whose gradient is 0 in one run may
    get rounding residue in the other)."""
    out = {}
    for k, v in want["exp_avg"].items():
        if k in snap["exp_avg"]:
            out[k] = float(np.abs(snap["exp_avg"][k] - v).max() / max(np.abs(v).max(), 1e-8))
    return out


def assert_grads_match(snap, want):
    """The optimizers' first moments (the gradients after pmean_grads)."""
    assert set(snap["exp_avg"]) == set(want["exp_avg"])
    gaps = grad_gaps(snap, want)
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRADS, (worst, gaps[worst])


def assert_stats_match(stats, want, tol):
    assert sorted(stats) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(stats[k]), float(v), **tol, err_msg=k)
