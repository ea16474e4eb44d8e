"""A two-step `--objective eg3d --aug ada` run of the port's CLI from
`--seed` vs the JAX CLI's (tests/test_torch_seeded_cli.py has the set-up
and the rule): z drawn at the global batch from fold_in(kz, 0), Gmain +
Dmain on ks, Greg on fold_in(ks, 1) and Dreg on fold_in(ks, 2) in the first
step (sched_idx 0), the pipe at p = 0.5 in front of every D call."""

from _torch_port import one_torch_thread  # noqa: F401
from test_torch_seeded_cli import (assert_stats_match, assert_weights_match,  # noqa: F401
                                   port_steps, run_both, tiny_clis)


def test_two_step_eg3d_ada_run_matches_jax_cli(tmp_path, tiny_clis, port_steps):  # noqa: F811
    port_dir, jax_dir = run_both(tmp_path, objective="eg3d", aug="ada", aug_p=0.5)
    assert_stats_match(port_dir, jax_dir)
    assert_weights_match(port_dir, jax_dir, ("G_ema", "G", "D"), port_steps)
