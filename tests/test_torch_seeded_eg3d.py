"""The port's seeded EG3D phases vs the JAX package's, from the same key:
Gmain + Dmain on the step key, then Greg on fold_in(key, 1) and Dreg on
fold_in(key, 2), as both CLIs key them. JAX's G has its noise on; the pose
swap (probability 0.75), style mixing (0.5: the cutoff is a randint), the
synthesis noise, the render's jitter and importance samples and the
density points are all drawn from the keys in both packages, nothing
handed over. After each phase every stat, G (with w_avg), G_ema and D
match at rtol 1e-4 / atol 1e-5, the trained weights under the Adam-flip
rule (tests/_torch_eg3d.py)."""

import pytest

from _torch_eg3d import check_seeded_phases, seeded_jax_phases
from _torch_port import one_torch_thread  # noqa: F401

PHASES = ("main", "greg", "dreg")


@pytest.fixture(scope="module")
def jax_run():
    return seeded_jax_phases(PHASES)


def test_seeded_phases_match_jax(jax_run):
    check_seeded_phases(jax_run, PHASES)
