"""A two-step `--objective eg3d --aug ada` run of the port's CLI from
`--seed` vs the JAX CLI's (tests/test_torch_seeded_cli.py has the set-up
and the rule): z drawn at the global batch from fold_in(kz, 0), Gmain +
Dmain on ks, Greg on fold_in(ks, 1) and Dreg on fold_in(ks, 2) in the first
step (sched_idx 0), the pipe at p = 0.5 in front of every D call. Then the
JAX CLI's full state of one step resumed by both CLIs."""

import json
import os

from _torch_port import one_torch_thread  # noqa: F401
from test_torch_seeded_cli import (assert_stats_match, assert_weights_match,  # noqa: F401
                                   first_step, jax_compile_cache, port_steps,
                                   resumed_both, run_both, set_state_config, tiny_clis)


def test_two_step_eg3d_ada_run_matches_jax_cli(tmp_path, tiny_clis, port_steps):  # noqa: F811
    port_dir, jax_dir = run_both(tmp_path, objective="eg3d", aug="ada", aug_p=0.5)
    assert_stats_match(port_dir, jax_dir)
    assert_weights_match(port_dir, jax_dir, ("G_ema", "G", "D"), port_steps)


def test_jax_cli_eg3d_state_resumes_in_port_cli(tmp_path, tiny_clis,  # noqa: F811
                                                port_steps):  # noqa: F811
    """The JAX CLI's `--aug ada` run takes one step (Gmain + Dmain, Greg,
    Dreg); the port CLI's `--resume` of its full state takes one more
    (Gmain + Dmain) and equals the JAX CLI's own `--resume` (stats; every
    weight under the rule). The live p comes back from the file's config in
    both: set to 0.25 there, while `--aug_p` says 0.5."""
    kw = dict(objective="eg3d", aug="ada", aug_p=0.5)
    first = first_step(tmp_path, "jax", **kw)
    path = os.path.join(first, "training-state-latest.npz")
    set_state_config(path, aug_p_live=0.25)
    port_dir, jax_dir = resumed_both(tmp_path, first, path, **kw)
    assert_stats_match(port_dir, jax_dir)
    assert_weights_match(port_dir, jax_dir, ("G_ema", "G", "D"), port_steps)
    for run in (port_dir, jax_dir):
        with open(os.path.join(run, "stats.jsonl")) as fh:
            assert json.loads(fh.readline())["Progress/augment"]["mean"] == 0.25
