"""The port's train step with all of G trainable (`train_gen`) vs the JAX
package's, at the tiny configuration of tests/test_torch_training.py (which
holds the default, G frozen; the two JAX compiles run on two workers)."""

import pytest

from _torch_port import one_torch_thread  # noqa: F401
from test_torch_training import check_step_matches_jax, check_trainable_set, run_jax_step


@pytest.fixture(scope="module")
def jax_step():
    return run_jax_step(True)


def test_train_step_matches_jax(jax_step):
    check_step_matches_jax(jax_step)


def test_trainable_set_and_frozen_parameters(jax_step):
    check_trainable_set(jax_step)
