"""The default `--objective gnerf` run (E, G's mapping and the depth D
train) of the port's CLI from `--seed` vs the JAX CLI's, two steps
(tests/test_torch_seeded_cli.py has the set-up and the rule).

Both steps' training stats, G, G_ema and D are held. E is held after one
step (tests/test_torch_seeded_gnerf.py), not after two: its train-mode
BatchNorm over batch 2 at 2^2 maps turns small changes of the first step
into large changes of the second step's gradients. Against JAX, where the
first step differs by Adam's flips, 6.5 % of E's weights end up to 3.79e-3
apart (lr 1e-3); against the port itself with 4 CPU threads instead of 1,
a change of summation order alone, 0.6 % end up to 1.96e-3 apart
(`tests/_seeded_cli_gap.py` prints both). The validation metrics, computed
from that E, are left out with it."""

from _torch_port import one_torch_thread  # noqa: F401
from test_torch_seeded_cli import (assert_stats_match, assert_weights_match,  # noqa: F401
                                   port_steps, run_both, tiny_clis)


def test_two_step_default_gnerf_run_matches_jax_cli(tmp_path, tiny_clis,  # noqa: F811
                                                    port_steps):  # noqa: F811
    port_dir, jax_dir = run_both(tmp_path)
    assert_stats_match(port_dir, jax_dir, skip=("Metrics/val_ssim", "Metrics/val_psnr"))
    assert_weights_match(port_dir, jax_dir, ("G_ema", "G", "D"), port_steps)
