"""The port's seeded EG3D phases under ADA at p = 0.5 vs the JAX package's,
from the same key: Gmain + Dmain on the step key (the pipe in front of
every D call, its 32 keys split from the phase's augmentation keys), then
Dreg on fold_in(key, 2) (R1 through the pipe). At p = 0.5 every gate of the
bgc pipe fires for some samples and not for others. The set-up, the
tolerance and the Adam-flip rule are tests/_torch_eg3d.py's, as in
tests/test_torch_seeded_eg3d.py."""

import pytest

from _torch_eg3d import check_seeded_phases, seeded_jax_phases
from _torch_port import one_torch_thread  # noqa: F401

PHASES = ("main", "dreg")
ADA = dict(aug="ada", aug_p=0.5)


@pytest.fixture(scope="module")
def jax_run():
    return seeded_jax_phases(PHASES, **ADA)


def test_seeded_ada_phases_match_jax(jax_run):
    check_seeded_phases(jax_run, PHASES, **ADA)
